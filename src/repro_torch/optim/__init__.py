"""Optimizers + schedules + gradient compression."""
from repro_torch.optim.grad_compression import (compress_with_feedback,
                                                compressed_psum,
                                                init_residuals)
from repro_torch.optim.optimizers import (SGD, AdamW, AdamWState,
                                          cosine_schedule, global_norm)

__all__ = ["AdamW", "AdamWState", "SGD", "cosine_schedule", "global_norm",
           "compress_with_feedback", "compressed_psum", "init_residuals"]
