from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    apply_updates,
    apply_updates_,
    global_norm_clip,
    sgd,
)
from repro_torch.optim.schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = ["Optimizer", "adamw", "sgd", "apply_updates", "apply_updates_",
           "global_norm_clip",
           "constant", "cosine_decay", "linear_warmup_cosine"]
