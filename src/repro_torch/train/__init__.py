"""Step functions (training, prefill, decode) and the fault-tolerant
training loop."""
from repro_torch.train.loop import TrainLoopConfig, fault_tolerant_train
from repro_torch.train.steps import (make_compressed_train_step,
                                     make_decode_fn, make_prefill_fn,
                                     make_train_step)

__all__ = ["TrainLoopConfig", "fault_tolerant_train",
           "make_compressed_train_step", "make_decode_fn",
           "make_prefill_fn", "make_train_step"]
