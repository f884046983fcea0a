"""repro_torch.train — step factories, the training loop and its metrics."""
from .steps import (TrainConfig, make_decode_step, make_encode_step,
                    make_eval_step, make_loss_and_grad, make_prefill_step,
                    make_train_step)

__all__ = ["TrainConfig", "make_decode_step", "make_encode_step",
           "make_eval_step", "make_loss_and_grad", "make_prefill_step",
           "make_train_step"]
