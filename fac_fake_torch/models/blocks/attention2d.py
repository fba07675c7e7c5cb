"""MDFA and BFM attention blocks — the port of
`fac_fake_tpu/models/blocks/attention2d.py` (`other/cvit_BFM_GGCA_MDFA.py:153-379`).

* MDFA, multi-scale dilated fusion: a 1×1 branch, three 3×3 branches at
  dilations 6, 12 and 18 (times ``rate``) and a global branch on the spatial
  mean, each conv → BN → ReLU; their concatenation gated by the elementwise
  max of a channel excitation (``Hebing.tongdao``: the spatial mean through
  a 1×1 conv to one channel, ReLU) and a spatial one (``Hebing.kongjian``:
  a 1×1 conv to one channel, sigmoid), times itself, then ``conv_cat``
  (1×1, BN, ReLU).
* BFM, bi-feature fusion: a multi-scale extractor (3×3, 5×5, 7×7 convs,
  each ReLU'd, summed) shared by both inputs, then TFAM: ECA-style 1-D
  convs over the channels of the four pools (mean and max of each input)
  and 7×7 convs over its four spatial pools, each pair softmaxed over the
  two inputs, ``att = channel + spatial + 1`` weighing the sum.

The ReLUs are `nn.ReLU` modules, as the stems' are, and the maxima
`MaxOver` modules: a check that holds two devices' training steps together
replays one device's ReLU and argmax choices on the other (`chip_smoke.py`
`_route_pools`). NCHW in and out; in training the
BNs normalize by the batch and move their
running stats by flax's rule (`models/layers.py`), in eval they use them.
Every conv, the 1-D channel convs too, computes in its input's dtype, as
JAX's take ``dtype``: a bf16 input keeps both blocks in bf16. The module trees
are the reference's (``branch1.0``, ``conv_cat.1``, ``Hebing.tongdao.fc``;
``multi_scale_extractor.conv1``, ``tfam.channel_attention.channel_conv1``,
``tfam.spatial_attention.spatial_conv1``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from fac_fake_torch.models.layers import Conv1d, Conv2d, MaxOver, batch_norm


def _cbr(cin: int, cout: int, k: int, dilation: int) -> nn.Sequential:
    pad = dilation * (k // 2) if k > 1 else 0
    return nn.Sequential(Conv2d(cin, cout, k, padding=pad, dilation=dilation),
                         batch_norm(cout), nn.ReLU())


class ChannelExcite(nn.Module):     # the reference's `tongdao`
    def __init__(self, channels: int):
        super().__init__()
        self.fc = Conv2d(channels, 1, 1, bias=False)
        self.relu = nn.ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.relu(self.fc(x.mean(dim=(2, 3), keepdim=True)))


class SpatialExcite(nn.Module):     # `kongjian`
    def __init__(self, channels: int):
        super().__init__()
        self.Conv1x1 = Conv2d(channels, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.Conv1x1(x))


class ExciteMax(nn.Module):         # `hebing`
    def __init__(self, channels: int):
        super().__init__()
        self.tongdao = ChannelExcite(channels)
        self.kongjian = SpatialExcite(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.maximum(self.tongdao(x), self.kongjian(x))


class MDFA(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, rate: int = 1):
        super().__init__()
        self.branch1 = _cbr(dim_in, dim_out, 1, rate)
        self.branch2 = _cbr(dim_in, dim_out, 3, 6 * rate)
        self.branch3 = _cbr(dim_in, dim_out, 3, 12 * rate)
        self.branch4 = _cbr(dim_in, dim_out, 3, 18 * rate)
        self.branch5_conv = Conv2d(dim_in, dim_out, 1)
        self.branch5_bn = batch_norm(dim_out)
        self.branch5_relu = nn.ReLU()
        self.Hebing = ExciteMax(5 * dim_out)
        self.conv_cat = nn.Sequential(Conv2d(5 * dim_out, dim_out, 1), batch_norm(dim_out),
                                      nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1(x)
        g = self.branch5_relu(self.branch5_bn(self.branch5_conv(x.mean(dim=(2, 3),
                                                                        keepdim=True))))
        cat = torch.cat([b1, self.branch2(x), self.branch3(x), self.branch4(x),
                         g.expand_as(b1)], dim=1)
        return self.conv_cat(self.Hebing(cat) * cat)


def eca_kernel_size(c: int) -> int:
    k = int((math.log2(c) + 1) // 2)
    return k + 1 if k % 2 == 0 else k


class ChannelAttention(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        k = eca_kernel_size(channels)
        self.channel_conv1 = Conv1d(4, 1, k, padding=k // 2)
        self.channel_conv2 = Conv1d(4, 1, k, padding=k // 2)
        self.max = MaxOver(2, 3)

    def forward(self, t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
        """(2, B, C, 1, 1): the two inputs' channel weights."""
        pools = torch.stack([t1.mean(dim=(2, 3)), self.max(t1).flatten(1),
                             t2.mean(dim=(2, 3)), self.max(t2).flatten(1)], dim=1)   # (B, 4, C)
        att = torch.stack([self.channel_conv1(pools), self.channel_conv2(pools)])  # (2, B, 1, C)
        return torch.softmax(att, dim=0)[:, :, 0, :, None, None]


class SpatialAttention(nn.Module):
    def __init__(self):
        super().__init__()
        self.spatial_conv1 = Conv2d(4, 1, 7, padding=3)
        self.spatial_conv2 = Conv2d(4, 1, 7, padding=3)
        self.max = MaxOver(1)

    def forward(self, t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
        """(2, B, 1, H, W): the two inputs' spatial weights."""
        pools = torch.cat([t1.mean(dim=1, keepdim=True), self.max(t1),
                           t2.mean(dim=1, keepdim=True), self.max(t2)], dim=1)
        return torch.softmax(torch.stack([self.spatial_conv1(pools),
                                          self.spatial_conv2(pools)]), dim=0)


class TFAM(nn.Module):
    """Temporal fusion attention over two feature maps."""

    def __init__(self, channels: int):
        super().__init__()
        self.channel_attention = ChannelAttention(channels)
        self.spatial_attention = SpatialAttention()

    def forward(self, t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
        att = self.channel_attention(t1, t2) + self.spatial_attention(t1, t2) + 1.0
        return att[0] * t1 + att[1] * t2


class MultiScaleExtractor(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = Conv2d(channels, channels, 3, padding=1)
        self.conv2 = Conv2d(channels, channels, 5, padding=2)
        self.conv3 = Conv2d(channels, channels, 7, padding=3)
        self.relu = nn.ReLU()

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.relu(self.conv1(t)) + self.relu(self.conv2(t)) + self.relu(self.conv3(t))


class BFM(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.multi_scale_extractor = MultiScaleExtractor(channels)
        self.tfam = TFAM(channels)

    def forward(self, t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
        f = self.multi_scale_extractor
        return self.tfam(f(t1), f(t2))
