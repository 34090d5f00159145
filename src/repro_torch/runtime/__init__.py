from repro_torch.runtime.compression import (ErrorFeedbackCompressor,
                                             compress_int8, decompress_int8)
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 RunnerConfig,
                                                 StragglerDetector,
                                                 TrainRunner)

__all__ = ["compress_int8", "decompress_int8", "ErrorFeedbackCompressor",
           "FailureInjector", "StragglerDetector", "TrainRunner",
           "RunnerConfig"]
