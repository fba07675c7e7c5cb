"""UFFC, the modified Fourier unit — the port of
`fac_fake_tpu/models/blocks/uffc.py` (`other/cvit_GGCA_UFFC.py:387-482`).

The orthonormal real FFT over (H, W); its real and imaginary parts
interleaved per channel (channel ``2c`` the real part of input channel
``c``, ``2c + 1`` its imaginary part) with the learned location map as one
more channel; a 1×1 conv (``conv_layer_down55``), ``fftshift`` over H,
ReLU; the shifted location map again, a reflect pad of 2 and a 3×3 conv at
dilation 2 (``conv_layer_down55_shift``), ``fftshift`` over H; a blend with
the raw spectrum by ``sigmoid(lambda_base)``; the inverse FFT. The output is
moved to the input's mean and clipped to the input's range ± 0.5, both
taken over the whole batch, as the JAX package takes them (so a sample's
output depends on the batch it is scored in, and in training each sample's
gradient on the others'). ``locMap`` is sized by the map the block runs on
(``image_size``). NCHW in and out, in the input's dtype; in a bf16 model
the FFTs, the blend and the clip stay fp32 and the two convs compute in
bf16, as JAX's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fac_fake_torch.models.layers import Clip, Conv2d, FlatLoad, MaxOver, widen


class FourierUnitModified(FlatLoad, nn.Module):
    _flat = ("lambda_base",)

    def __init__(self, channels: int, image_size: int):
        super().__init__()
        self.conv_layer_down55 = Conv2d(2 * channels + 1, 2 * channels, 1, bias=False)
        self.conv_layer_down55_shift = Conv2d(2 * channels + 1, 2 * channels, 3, dilation=2,
                                              bias=False)
        self.locMap = nn.Parameter(torch.empty(image_size, image_size // 2 + 1))
        self.lambda_base = nn.Parameter(torch.empty(()))
        self.relu = nn.ReLU()
        # the clip's bounds, the input's batch-wide max and min (that of -x),
        # as modules: a near-tie for the largest value goes one way on one
        # device and the other way on another, and the bound's gradient
        # then reaches another element (`MaxOver`)
        self.x_max, self.neg_x_max = MaxOver(0, 1, 2, 3), MaxOver(0, 1, 2, 3)
        self.clip = Clip()

    def reset_own(self, gen: torch.Generator) -> None:
        self.locMap.data.uniform_(0.0, 1.0, generator=gen)
        self.lambda_base.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        wf = w // 2 + 1
        dt = x.dtype
        f = torch.fft.rfftn(widen(x), dim=(2, 3), norm="ortho")
        ff = torch.stack([f.real, f.imag], dim=2).reshape(b, 2 * c, h, wf)
        ff_copy = ff
        loc = self.locMap[:h, :wf].expand(b, 1, h, wf)
        # the two convs in x's dtype, as JAX's take ``dtype``: a bf16 model
        # convolves the fp32 spectrum rounded to bf16
        ff = self.conv_layer_down55(torch.cat([ff, loc], dim=1).to(dt))
        ff = self.relu(torch.fft.fftshift(ff, dim=2))
        cat = torch.cat([ff, torch.fft.fftshift(loc, dim=2)], dim=1).to(dt)
        ff = self.conv_layer_down55_shift(F.pad(cat, (2, 2, 2, 2), mode="reflect"))
        ff = torch.fft.fftshift(ff, dim=2)
        lb = torch.sigmoid(self.lambda_base)
        ff = (ff_copy * lb + widen(ff) * (1.0 - lb)).reshape(b, c, 2, h, wf)
        out = torch.fft.irfftn(torch.complex(ff[:, :, 0], ff[:, :, 1]), s=(h, w), dim=(2, 3),
                               norm="ortho")
        out = out - out.mean() + x.mean()
        return self.clip(out, -self.neg_x_max(-x) - 0.5, self.x_max(x) + 0.5).to(x.dtype)
