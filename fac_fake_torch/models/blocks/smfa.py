"""SMFA, self-modulated feature aggregation — the port of
`fac_fake_tpu/models/blocks/smfa.py` (`other/cvit_GGCA_SMFA.py:160-207`).

``linear_0`` (1×1) doubles the channels into a local half ``y`` and a
non-local half ``xs``. The non-local branch max-pools ``xs`` by
``down_scale`` (JAX's `adaptive_max_pool`, for sizes that divide; a
`MaxOver` module), runs a
depthwise 3×3, adds ``belt`` times the spatial variance of ``xs`` (biased,
as ``jnp.var``) to ``alpha`` times it, a 1×1 and an exact GELU, and its
nearest upsample (row ``i`` reads ``floor(i·oh/h)``, torch's rule) gates
``xs``. The local branch is DMlp (a 3×3 grouped by input channel to twice
the channels, a 1×1, GELU, a 1×1). ``linear_2`` (1×1) of their sum. NCHW
in and out; the module tree is the reference's (``linear_0``, ``dw_conv``,
``alpha``, ``belt``, ``lde.conv_0.0`` ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fac_fake_torch.models.layers import Conv2d, FlatLoad, MaxOver


class DMlp(nn.Module):
    def __init__(self, dim: int, growth: float = 2.0):
        super().__init__()
        hidden = int(dim * growth)
        self.conv_0 = nn.Sequential(Conv2d(dim, hidden, 3, padding=1, groups=dim),
                                    Conv2d(hidden, hidden, 1))
        self.conv_1 = Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_1(F.gelu(self.conv_0(x)))


class SMFA(FlatLoad, nn.Module):
    _flat = ("alpha", "belt")

    def __init__(self, dim: int, down_scale: int = 8):
        super().__init__()
        self.dim, self.down_scale = dim, down_scale
        self.linear_0 = Conv2d(dim, 2 * dim, 1)
        self.linear_1 = Conv2d(dim, dim, 1)
        self.linear_2 = Conv2d(dim, dim, 1)
        self.lde = DMlp(dim)
        self.dw_conv = Conv2d(dim, dim, 3, padding=1, groups=dim)
        self.alpha = nn.Parameter(torch.empty(1, dim, 1, 1))
        self.belt = nn.Parameter(torch.empty(1, dim, 1, 1))
        self.pool_max = MaxOver(3, 5)

    def reset_own(self, gen: torch.Generator) -> None:
        self.alpha.data.fill_(1.0)
        self.belt.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.shape
        y, xs = torch.split(self.linear_0(x), self.dim, dim=1)
        # adaptive_max_pool2d for sizes that divide (JAX's reshape and max)
        b, c, oh, ow = xs.shape[0], self.dim, h // self.down_scale, w // self.down_scale
        pooled = self.pool_max(xs.reshape(b, c, oh, h // oh, ow, w // ow)).reshape(b, c, oh, ow)
        x_s = self.dw_conv(pooled)
        x_v = torch.var(xs, dim=(2, 3), keepdim=True, correction=0)
        # the modulation in the parameters' dtype (fp32 in a bf16 model, as
        # JAX's promotion), rounded once by linear_1 as flax's conv rounds it
        gate = F.gelu(self.linear_1((x_s * self.alpha + x_v * self.belt).to(x.dtype)))
        oh, ow = gate.shape[2], gate.shape[3]
        rows = torch.arange(h, device=x.device) * oh // h
        cols = torch.arange(w, device=x.device) * ow // w
        gate = gate[:, :, rows][:, :, :, cols]
        return self.linear_2(xs * gate + self.lde(y))
