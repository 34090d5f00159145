from repro_torch.data.pipeline import (DataConfig, DataPipeline,
                                       MemmapSource, SyntheticSource)

__all__ = ["DataConfig", "SyntheticSource", "MemmapSource", "DataPipeline"]
