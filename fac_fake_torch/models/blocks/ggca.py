"""GGCA, global grouped coordinate attention — the port of
`fac_fake_tpu/models/blocks/ggca.py` (`cvit_GGCA_ADD_DEConv_RepBn8.py:144-207`).

The channels split into ``num_groups`` groups; each group's average and max
pools along W (one value a row) and along H (one a column) go through one
shared 1×1 bottleneck, ``shared_conv`` = conv (cg → max(1, cg/16)), BN,
ReLU, conv (→ cg), the reference's ``ggca.shared_conv.{0,1,3}``; the sigmoid
of the summed avg and max paths gates the rows and the columns:
``x · gate_h · gate_w``. NCHW in and out; the max pools are `MaxOver`
modules, whose argmax a check can route (`models/layers.py`).
"""
from __future__ import annotations

import torch
from torch import nn

from fac_fake_torch.models.layers import Conv2d, MaxOver, batch_norm


class GGCA(nn.Module):
    def __init__(self, channels: int, reduction: int = 16, num_groups: int = 4):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"GGCA: {channels} channels do not split into {num_groups} groups")
        self.num_groups = num_groups
        cg = channels // num_groups
        mid = max(1, cg // reduction)
        self.shared_conv = nn.Sequential(Conv2d(cg, mid, 1), batch_norm(mid), nn.ReLU(),
                                         Conv2d(mid, cg, 1))
        self.max_w, self.max_h = MaxOver(3), MaxOver(2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        xg = x.reshape(b * self.num_groups, c // self.num_groups, h, w)
        f = self.shared_conv
        y_h = f(xg.mean(3, keepdim=True)) + f(self.max_w(xg))   # (bg, cg, h, 1)
        y_w = f(xg.mean(2, keepdim=True)) + f(self.max_h(xg))   # (bg, cg, 1, w)
        att_h = torch.sigmoid(y_h).reshape(b, c, h, 1)
        att_w = torch.sigmoid(y_w).reshape(b, c, 1, w)
        return x * att_h * att_w
