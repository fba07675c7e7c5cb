"""ConvolutionalGLU, a depthwise-conv gated FFN on token sequences — the
port of `fac_fake_tpu/models/blocks/glu.py` (`other/cvit_GGCA_ADD_GLUconv.py:158-205`).

``fc1`` doubles the tokens to 2·hidden (hidden = ⌊2·dim/3⌋); the first half,
seen as an H × W map (tokens row-major), goes through a depthwise 3×3
(``dwconv.dwconv``) and an exact GELU and gates the second half; ``fc2``
projects back to dim. (B, N, dim) in and out, N = H·W.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fac_fake_torch.models.layers import Conv2d, Linear


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim)


class ConvolutionalGLU(nn.Module):
    def __init__(self, dim: int, hidden: int = 0):
        super().__init__()
        self.hidden = hidden or int(2 * dim / 3)
        self.fc1 = Linear(dim, 2 * self.hidden)
        self.dwconv = DWConv(self.hidden)
        self.fc2 = Linear(self.hidden, dim)

    def forward(self, tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, _ = tokens.shape
        x, v = torch.split(self.fc1(tokens), self.hidden, dim=-1)
        fm = self.dwconv.dwconv(x.reshape(b, h, w, self.hidden).permute(0, 3, 1, 2))
        x = F.gelu(fm.permute(0, 2, 3, 1).reshape(b, n, self.hidden)) * v
        return self.fc2(x)
