"""The optimizer — the port of `fac_fake_tpu/train/state.py`.

JAX chains ``optax.add_decayed_weights(wd)`` and ``optax.adam(lr)`` (`:21-32`,
the reference's ``torch.optim.Adam(weight_decay=…)``, `cvit_train.py:75`):
the decay ``wd·p`` is added to the gradient before the moments (coupled L2),
and ε sits outside the square root. ``torch.optim.Adam(lr, weight_decay=wd)``
does both, so the port takes it as it is, over one param group. The rest of
JAX's functional ``TrainState`` is the model's own state: parameters,
BatchNorm running stats and LinearNorm's counters are the module's
parameters and buffers.
"""
from __future__ import annotations

import torch
from torch import nn


def make_optimizer(model: nn.Module, lr: float, weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam over every parameter of ``model`` in one group; the fused CUDA
    update when the parameters lie on the card."""
    params = list(model.parameters())
    fused = bool(params) and params[0].is_cuda
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay, fused=fused)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    optimizer.param_groups[0]["lr"] = lr
