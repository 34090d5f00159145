from repro_torch.optim.adafactor import Adafactor
from repro_torch.optim.adamw import (AdamW, apply_updates, cosine_schedule,
                                     global_norm)

__all__ = ["AdamW", "Adafactor", "apply_updates", "cosine_schedule",
           "global_norm"]
