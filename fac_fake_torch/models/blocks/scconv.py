"""ScConv, spatial (SRU) and channel (CRU) reconstruction units — the port
of `fac_fake_tpu/models/blocks/scconv.py` (`other/cvit_GGCA_ADD_ScConv.py:159-357`).

SRU normalizes the map by 4 channel groups (a GroupNorm whose affine
weight, normalized to sum 1, also weighs the gates), gates it by the
sigmoid of that, splits each value into its part above the 0.5 gate and
below, and crosses the two halves of the channels. CRU squeezes the upper
and lower halves of the channels by 2, runs a grouped 3×3 plus a 1×1 on the
upper and a 1×1 on the lower, and sums the two halves of their concatenation
weighed by a softmax over the channels of its spatial mean. NCHW in and
out, in the input's dtype; the module tree is the reference's (``SRU.gn``,
``CRU.squeeze1`` ...).
"""
from __future__ import annotations

import torch
from torch import nn

from fac_fake_torch.models.layers import Conv2d

GN_EPS = 1e-5


class SRU(nn.Module):
    def __init__(self, channels: int, group_num: int = 4, gate_threshold: float = 0.5):
        super().__init__()
        self.group_num = group_num
        self.gate_threshold = gate_threshold
        self.gn = nn.GroupNorm(group_num, channels)

    def gate(self, rew: torch.Tensor) -> torch.Tensor:
        """Which values pass whole (``rew`` above the threshold); the rest
        are weighed by ``rew``. The forward steps here: a ``rew`` within
        rounding of the threshold is weighed 1 on one device and 0.5 on
        another, so a check that holds two devices' steps together makes
        one take the other's gates (`chip_smoke.py` `_route_pools`)."""
        return rew > self.gate_threshold

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        scale, bias = self.gn.weight, self.gn.bias
        xg = x.reshape(b, self.group_num, c // self.group_num, h, w)
        # the statistics and the normalize in x's dtype, the biased variance,
        # as jnp.mean / jnp.var
        var, mean = torch.var_mean(xg, dim=(2, 3, 4), keepdim=True, correction=0)
        xn = ((xg - mean) / torch.sqrt(var + GN_EPS)).reshape(b, c, h, w)
        view = lambda t: t.reshape(1, c, 1, 1)
        # the affine and the gates in the parameters' dtype (JAX's promotion
        # of a bf16 map by its fp32 scale); the halves' sums rounded once to
        # x's dtype, where JAX's CRU convs round them
        gn_x = xn * view(scale) + view(bias)
        rew = torch.sigmoid(gn_x * view(scale / scale.sum()))
        above = self.gate(rew)
        x1 = torch.where(above, torch.ones_like(rew), rew) * x
        x2 = torch.where(above, torch.zeros_like(rew), rew) * x
        half = c // 2
        return torch.cat([x1[:, :half] + x2[:, half:], x1[:, half:] + x2[:, :half]],
                         dim=1).to(x.dtype)


class CRU(nn.Module):
    def __init__(self, channels: int, alpha: float = 0.5, squeeze_radio: int = 2,
                 group_size: int = 2, group_kernel_size: int = 3):
        super().__init__()
        self.up_c = up_c = int(alpha * channels)
        low_c = channels - up_c
        up_s, low_s = up_c // squeeze_radio, low_c // squeeze_radio
        self.squeeze1 = Conv2d(up_c, up_s, 1, bias=False)
        self.squeeze2 = Conv2d(low_c, low_s, 1, bias=False)
        self.GWC = Conv2d(up_s, channels, group_kernel_size, padding=group_kernel_size // 2,
                          groups=group_size)
        self.PWC1 = Conv2d(up_s, channels, 1, bias=False)
        self.PWC2 = Conv2d(low_s, channels - low_s, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up, low = self.squeeze1(x[:, :self.up_c]), self.squeeze2(x[:, self.up_c:])
        y1 = self.GWC(up) + self.PWC1(up)
        y2 = torch.cat([self.PWC2(low), low], dim=1)
        out = torch.cat([y1, y2], dim=1)
        out = torch.softmax(out.mean(dim=(2, 3), keepdim=True), dim=1) * out
        half = out.shape[1] // 2
        return out[:, :half] + out[:, half:]


class ScConv(nn.Module):
    """SRU then CRU, ``channels`` in and out (a stem op, ``("scconv", ch)``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.SRU = SRU(channels)
        self.CRU = CRU(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.CRU(self.SRU(x))
