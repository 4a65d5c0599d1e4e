"""Training: the chunked cross-entropy (``loss``) and the train step
with microbatch accumulation (``step``)."""
from repro_torch.train.loss import chunked_cross_entropy
from repro_torch.train.step import (AUX_WEIGHT, init_train_state, loss_fn,
                                    make_train_step)

__all__ = ["AUX_WEIGHT", "chunked_cross_entropy", "init_train_state",
           "loss_fn", "make_train_step"]
