from repro_torch.optim.optimizers import Optimizer, adamw, apply_updates, sgd
from repro_torch.optim.schedules import constant, cosine_decay

__all__ = ["Optimizer", "adamw", "sgd", "apply_updates", "constant",
           "cosine_decay"]
