"""Training loop; train, prefill and decode steps."""
from repro_torch.train.steps import (TrainState, abstract_train_state,
                                     init_train_state,
                                     make_prefill_step, make_serve_step,
                                     make_train_step)
from repro_torch.train.trainer import (Trainer, TrainerConfig, TrainerReport,
                                       TransientError)

__all__ = ["TrainState", "abstract_train_state", "init_train_state", "make_train_step",
           "make_serve_step", "make_prefill_step",
           "Trainer", "TrainerConfig", "TrainerReport", "TransientError"]
