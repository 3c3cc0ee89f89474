"""Optimizers over trees of tensors, updated in place: AdamW and Adafactor
with their LR schedules (the reference's ``optim``)."""
from repro_torch.optim.adafactor import Adafactor, AdafactorState
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["Adafactor", "AdafactorState", "AdamW", "AdamWState",
           "constant", "warmup_cosine", "make_optimizer"]


def make_optimizer(name: str, lr=None, **kw):
    lr = lr or constant(3e-4)
    if name == "adamw":
        return AdamW(lr=lr, **kw)
    if name == "adafactor":
        return Adafactor(lr=lr, **kw)
    raise ValueError(name)
