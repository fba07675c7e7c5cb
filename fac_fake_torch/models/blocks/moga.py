"""MOGA, multi-order gated aggregation — the port of
`fac_fake_tpu/models/blocks/moga.py` (`other/cvit_GGCA_ADD_MOGA.py:158-383`).

``proj_1`` (1×1), feature decomposition ``x + σ·(x − mean_HW(x))`` (σ a
learned per-channel scale, 1e-5 at the start), SiLU; then the SiLU of a 1×1
``gate`` times the SiLU of the multi-order ``value`` (a depthwise 5×5, then
a depthwise 5×5 at dilation 2 on 3/8 of its channels and a 7×7 at dilation 3
on 4/8, the first 1/8 passed on, and a 1×1 ``PW_conv``), ``proj_2`` (1×1),
plus the input. NCHW in and out; the module tree is the reference's
(``proj_1``, ``sigma.scale``, ``gate``, ``value.DW_conv0`` ...).
(The JAX package's ``ChannelAggregationFFN`` companion is wired into no
variant and is not ported.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fac_fake_torch.models.layers import Conv2d, FlatLoad


class ElementScale(FlatLoad, nn.Module):
    """``x · scale``, a learned (1, C, 1, 1) scale started at ``init``; the
    product in the promoted dtype (fp32 for a bf16 ``x``, as JAX's)."""

    _flat = ("scale",)

    def __init__(self, dim: int, init: float = 0.0):
        super().__init__()
        self.init = init
        self.scale = nn.Parameter(torch.empty(1, dim, 1, 1))

    def reset_own(self, gen: torch.Generator) -> None:
        self.scale.data.fill_(self.init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


def _dw(ch: int, k: int, dil: int) -> Conv2d:
    return Conv2d(ch, ch, k, padding=(1 + (k - 1) * dil) // 2, dilation=dil, groups=ch)


class MultiOrderDWConv(nn.Module):
    def __init__(self, dim: int, dilations=(1, 2, 3), channel_split=(1, 3, 4)):
        super().__init__()
        total = sum(channel_split)
        self.d1 = int(channel_split[1] / total * dim)
        self.d2 = int(channel_split[2] / total * dim)
        self.d0 = dim - self.d1 - self.d2
        self.DW_conv0 = _dw(dim, 5, dilations[0])
        self.DW_conv1 = _dw(self.d1, 5, dilations[1])
        self.DW_conv2 = _dw(self.d2, 7, dilations[2])
        self.PW_conv = Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = self.DW_conv0(x)
        d0, d1 = self.d0, self.d1
        x1 = self.DW_conv1(x0[:, d0:d0 + d1])
        x2 = self.DW_conv2(x0[:, x0.shape[1] - self.d2:])
        return self.PW_conv(torch.cat([x0[:, :d0], x1, x2], dim=1))


class MultiOrderGatedAggregation(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj_1 = Conv2d(dim, dim, 1)
        self.sigma = ElementScale(dim, 1e-5)
        self.gate = Conv2d(dim, dim, 1)
        self.value = MultiOrderDWConv(dim)
        self.proj_2 = Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut, dt = x, x.dtype
        x = self.proj_1(x)
        # the decomposition promotes to the scale's dtype (fp32 in a bf16
        # model, as JAX's); gate and value round it back, as flax's convs
        x = F.silu(x + self.sigma(x - x.mean(dim=(2, 3), keepdim=True))).to(dt)
        y = self.proj_2(F.silu(self.gate(x)) * F.silu(self.value(x)))
        return y + shortcut
