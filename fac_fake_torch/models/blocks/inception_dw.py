"""InceptionDWConv2d, an Inception-style depthwise mixer — the port of
`fac_fake_tpu/models/blocks/inception_dw.py` (`cvit_GGCA_ADD_DConv.py:157-177`).

The channels split into an identity part and three branches of an eighth
of the channels each: a depthwise 3×3, a depthwise 1×11 band and a
depthwise 11×1 band. NCHW in and out (a stem op, ``("idw", ch)``).
"""
from __future__ import annotations

import torch
from torch import nn

from fac_fake_torch.models.layers import Conv2d


class InceptionDWConv2d(nn.Module):
    def __init__(self, channels: int, square_kernel: int = 3, band_kernel: int = 11,
                 branch_ratio: float = 0.125):
        super().__init__()
        gc = int(channels * branch_ratio)
        self.split = (channels - 3 * gc, gc, gc, gc)
        sp, bp = square_kernel // 2, band_kernel // 2
        self.dwconv_hw = Conv2d(gc, gc, square_kernel, padding=sp, groups=gc)
        self.dwconv_w = Conv2d(gc, gc, (1, band_kernel), padding=(0, bp), groups=gc)
        self.dwconv_h = Conv2d(gc, gc, (band_kernel, 1), padding=(bp, 0), groups=gc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_id, x_hw, x_w, x_h = torch.split(x, self.split, dim=1)
        return torch.cat([x_id, self.dwconv_hw(x_hw), self.dwconv_w(x_w), self.dwconv_h(x_h)],
                         dim=1)
