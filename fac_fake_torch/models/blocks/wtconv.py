"""WTConv2d, wavelet-domain depthwise convolution — the port of
`fac_fake_tpu/models/blocks/wtconv.py` (`other/cvit_GGCA_ADD_WTConv.py:167-329`).

One level of the Haar (db1) transform, as a stride-2 convolution with the
four outer-product filters grouped by channel, gives each channel's LL, LH,
HL and HH bands; a depthwise 5×5 conv and a learned scale (0.1 at the start)
run on the 4·C bands, and the inverse transform (a stride-2 transposed
convolution with the synthesis filters) brings them back to the map. A
depthwise 5×5 conv of the input with its own scale is added. The variant
uses one level and db1 only, so the filters are written out (no pywt).
NCHW in and out; the module tree is the reference's (``base_conv``,
``base_scale``, ``wavelet_convs.0``, ``wavelet_scale.0``).

In bf16 the convs compute in the input's dtype, the scales promote to fp32
(JAX's ``_Scale``), the inverse transform then runs on those fp32 bands,
and the output is rounded once to the input's dtype. The Haar filters take
the dtype of the map they transform (bf16's 1/√2 is 0.70703125). JAX's own
bf16 WTConv raises (its fp32 filters meet a bf16 map in
``lax.conv_general_dilated``); this is what it computes with its filters
cast to the map's dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fac_fake_torch.models.layers import Conv2d, FlatLoad

_S = 1.0 / math.sqrt(2.0)
# pywt db1 as the reference reads it: analysis lo/hi, synthesis lo/hi
_DEC_LO, _DEC_HI = (_S, _S), (_S, -_S)
_REC_LO, _REC_HI = (_S, _S), (_S, -_S)


class ChannelScale(FlatLoad, nn.Module):
    """``x · weight``, a learned (1, C, 1, 1) scale on NCHW ``x``, started at
    ``init`` (the reference's ``_ScaleModule``); the product in the
    promoted dtype (a bf16 ``x`` times the fp32 scale is fp32, as JAX's
    ``_Scale``)."""

    _flat = ("weight",)

    def __init__(self, channels: int, init: float = 1.0):
        super().__init__()
        self.init = init
        self.weight = nn.Parameter(torch.empty(1, channels, 1, 1))

    def reset_own(self, gen: torch.Generator) -> None:
        self.weight.data.fill_(self.init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight


def _bands(lo, hi) -> torch.Tensor:
    """(4, 2, 2) filters LL, LH, HL, HH: outer(rows, cols) of lo⊗lo,
    hi⊗lo, lo⊗hi, hi⊗hi (JAX `_wavelet_filters`)."""
    lo, hi = torch.tensor(lo), torch.tensor(hi)
    return torch.stack([torch.outer(lo, lo), torch.outer(hi, lo), torch.outer(lo, hi),
                        torch.outer(hi, hi)])


def wavelet_transform(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C, 4, H/2, W/2) Haar bands: output channel
    4·c + band of a stride-2 conv grouped by channel."""
    b, c, h, w = x.shape
    filt = _bands(_DEC_LO, _DEC_HI).to(x).repeat(c, 1, 1)[:, None]       # (4C, 1, 2, 2)
    return F.conv2d(x, filt, stride=2, groups=c).reshape(b, c, 4, h // 2, w // 2)


def inverse_wavelet_transform(y: torch.Tensor) -> torch.Tensor:
    """(B, C, 4, H/2, W/2) → (B, C, H, W): ``out[2i+di, 2j+dj] = Σ_band
    y[band, i, j] · rec[band, di, dj]``, a stride-2 transposed conv grouped
    by channel."""
    b, c, _, h2, w2 = y.shape
    filt = _bands(_REC_LO, _REC_HI).to(y).repeat(c, 1, 1)[:, None]       # (4C, 1, 2, 2)
    return F.conv_transpose2d(y.reshape(b, 4 * c, h2, w2), filt, stride=2, groups=c)


class WTConv2d(nn.Module):
    """``channels`` in and out (a stem op, ``("wtconv", ch)``)."""

    def __init__(self, channels: int, kernel_size: int = 5, wt_levels: int = 1):
        super().__init__()
        p = kernel_size // 2
        self.wt_levels = wt_levels
        self.base_conv = Conv2d(channels, channels, kernel_size, padding=p, groups=channels)
        self.base_scale = ChannelScale(channels, 1.0)
        self.wavelet_convs = nn.ModuleList(
            Conv2d(4 * channels, 4 * channels, kernel_size, padding=p, groups=4 * channels,
                   bias=False) for _ in range(wt_levels))
        self.wavelet_scale = nn.ModuleList(ChannelScale(4 * channels, 0.1)
                                           for _ in range(wt_levels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        base = self.base_scale(self.base_conv(x))
        lls, highs, shapes = [], [], []
        cur = x
        for conv, scale in zip(self.wavelet_convs, self.wavelet_scale):
            shapes.append(cur.shape)
            if cur.shape[2] % 2 or cur.shape[3] % 2:
                cur = F.pad(cur, (0, cur.shape[3] % 2, 0, cur.shape[2] % 2))
            sub = wavelet_transform(cur)
            cur = sub[:, :, 0]
            b, c, _, h2, w2 = sub.shape
            sub = scale(conv(sub.reshape(b, 4 * c, h2, w2))).reshape(b, c, 4, h2, w2)
            lls.append(sub[:, :, 0])
            highs.append(sub[:, :, 1:])
        next_ll = 0.0
        for _ in range(self.wt_levels):
            ll = lls.pop() + next_ll
            next_ll = inverse_wavelet_transform(torch.cat([ll[:, :, None], highs.pop()], dim=2))
            sh = shapes.pop()
            next_ll = next_ll[:, :, :sh[2], :sh[3]]
        return (base + next_ll).to(dt)
