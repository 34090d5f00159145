from repro_torch.roofline.analysis import (HW, analyze_step, model_flops,
                                           roofline_report)

__all__ = ["HW", "analyze_step", "roofline_report", "model_flops"]
