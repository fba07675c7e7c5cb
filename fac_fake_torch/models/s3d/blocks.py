"""S3D composite blocks — the port of `fac_fake_tpu/models/s3d/blocks.py`:
the Inception mix, the GCNet context block, and the msca family's MSCAN and
iFormer blocks.

Module names are the reference torch names (`S3D/model.py:84-342`,
`new_model/context_block_3d.py:5-88`, `new_model/msca_3d.py`,
`new_model/iformer_3d.py`), the ones `fac_fake_tpu/compat/torch_weights.py`
maps to: ``branch0.0``, ``branch1.{0,1}``, ``branch2.{0,1}``,
``branch3.{0 = MaxPool3d, 1}``; ``conv_mask`` and ``channel_add_conv.{0,1,3}``;
``norm1``/``norm2``, ``attn.{proj_1, spatial_gating_unit.{conv0, conv0_1,
conv1_1, conv3}, proj_2}``, ``mlp.{fc1, dwconv.dwconv, fc2}``, and the
iFormer mixer's ``inceptionmixer.{maxpool_fc.{0 = MaxPool3d, 1}, fc_dw.{0, 1,
2}, attn}``. GELU is the exact (erf) one, as JAX's ``approximate=False``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

import torch.nn.functional as F

from fac_fake_torch.models.layers import Conv3d, LayerNorm
from fac_fake_torch.models.s3d.layers import BN3D, BasicConv3d, DWSepConv3d, SepConv3d

# (b0, b1_reduce, b1_out, b2_reduce, b2_out, b3) channel plans, keyed by the
# reference class names (`S3D/model.py:84-342`; m5b/m5c: `msca_S3Dv1.py:130-184`)
INCEPTION_PLANS = {
    "3b": (64, 96, 128, 16, 32, 32),
    "3c": (128, 128, 192, 32, 96, 64),
    "4b": (192, 96, 208, 16, 48, 64),
    "4c": (160, 112, 224, 24, 64, 64),
    "4d": (128, 128, 256, 24, 64, 64),
    "4e": (112, 144, 288, 32, 64, 64),
    "4f": (256, 160, 320, 32, 128, 128),
    "5b": (256, 160, 320, 32, 128, 128),
    "5c": (384, 192, 384, 48, 128, 128),
    "m5b": (192, 96, 208, 16, 48, 64),
    "m5c": (384, 192, 384, 48, 128, 128),
}


class InceptionMix(nn.Module):
    """4-branch Inception: 1×1 | 1×1→sep3 | 1×1→sep3 | maxpool3→1×1,
    concatenated over channels."""

    def __init__(self, cin: int, plan: Tuple[int, int, int, int, int, int],
                 act: str = "relu", sep_spatial_bn: bool = True):
        super().__init__()
        b0, r1, o1, r2, o2, b3 = plan
        sep = dict(act=act, spatial_bn=sep_spatial_bn, spatial_act=sep_spatial_bn)
        self.branch0 = nn.Sequential(BasicConv3d(cin, b0, act=act))
        self.branch1 = nn.Sequential(BasicConv3d(cin, r1, act=act),
                                     SepConv3d(r1, o1, 3, 1, 1, **sep))
        self.branch2 = nn.Sequential(BasicConv3d(cin, r2, act=act),
                                     SepConv3d(r2, o2, 3, 1, 1, **sep))
        self.branch3 = nn.Sequential(nn.MaxPool3d(3, 1, 1), BasicConv3d(cin, b3, act=act))
        self.out_channels = b0 + o1 + o2 + b3

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], dim=1)


class ChannelLayerNorm(LayerNorm):
    """LayerNorm over the channels of a pooled (B, C, 1, 1, 1) context: the
    reference's ``LayerNorm([planes, 1, 1, 1])``, with its weight and bias
    kept as (planes,) as the JAX package keeps them."""

    def forward(self, x):
        return super().forward(x.flatten(1)).view_as(x)


class ContextBlock3d(nn.Module):
    """GCNet global-context attention with channel-add fusion
    (`context_block_3d.py:5-88`); ``pooling`` is ``avg`` or ``att``."""

    def __init__(self, cin: int, ratio: float = 1.0 / 16.0, pooling: str = "avg"):
        super().__init__()
        if pooling not in ("avg", "att"):
            raise ValueError(f"pooling must be avg|att, got {pooling!r}")
        planes = int(cin * ratio)
        self.pooling = pooling
        if pooling == "att":
            self.conv_mask = Conv3d(cin, 1, 1)
        self.channel_add_conv = nn.Sequential(
            Conv3d(cin, planes, 1), ChannelLayerNorm(planes, eps=1e-5), nn.ReLU6(),
            Conv3d(planes, cin, 1))

    def forward(self, x):
        b, c = x.shape[:2]
        if self.pooling == "att":
            mask = torch.softmax(self.conv_mask(x).reshape(b, -1), dim=1)
            ctx = torch.einsum("bcn,bn->bc", x.reshape(b, c, -1), mask)
            ctx = ctx.reshape(b, c, 1, 1, 1)
        else:
            ctx = x.mean(dim=(2, 3, 4), keepdim=True)
        return x + self.channel_add_conv(ctx)


def conv1(cin: int, cout: int) -> Conv3d:
    """1×1×1 conv with bias (the msca blocks' projections)."""
    return Conv3d(cin, cout, 1)


class Mlp3d(nn.Module):
    """SegNeXt conv-FFN: 1×1 → DW sep 3³ → GELU → 1×1 (`msca_3d.py:14-34`)."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.fc1 = conv1(cin, hidden)
        self.dwconv = nn.Module()
        self.dwconv.dwconv = DWSepConv3d(hidden, 3, 1, 1)
        self.fc2 = conv1(hidden, cout)

    def forward(self, x):
        return self.fc2(F.gelu(self.dwconv.dwconv(self.fc1(x))))


class AttentionModule3d(nn.Module):
    """Multi-kernel (3/5/7) depthwise gating (`msca_3d.py:36-67`)."""

    def __init__(self, dim: int, time_size: int):
        super().__init__()
        tp = time_size // 2
        self.conv0 = DWSepConv3d(dim, (time_size, 3, 3), 1, (tp, 1, 1))
        self.conv0_1 = DWSepConv3d(dim, (time_size, 5, 5), 1, (tp, 2, 2))
        self.conv1_1 = DWSepConv3d(dim, (time_size, 7, 7), 1, (tp, 3, 3))
        self.conv3 = conv1(dim, dim)

    def forward(self, x):
        a = self.conv0(x)
        a = a + self.conv0_1(a) + self.conv1_1(a)
        return self.conv3(a) * x


class SpatialAttention3d(nn.Module):
    """proj → GELU → AttentionModule → proj (`msca_3d.py:70-86`)."""

    def __init__(self, dim: int, time_size: int):
        super().__init__()
        self.proj_1 = conv1(dim, dim)
        self.spatial_gating_unit = AttentionModule3d(dim, time_size)
        self.proj_2 = conv1(dim, dim)

    def forward(self, x):
        return self.proj_2(self.spatial_gating_unit(F.gelu(self.proj_1(x))))


class MSCANHalf(nn.Module):
    """x + attn(BN(x)) (`msca_3d.py:88-100`)."""

    def __init__(self, dim: int, time_size: int):
        super().__init__()
        self.norm1 = BN3D(dim)
        self.attn = SpatialAttention3d(dim, time_size)

    def forward(self, x):
        return x + self.attn(self.norm1(x))


class MSCAN(MSCANHalf):
    """MSCANHalf, then the conv-FFN whose output replaces x: the reference's
    non-residual quirk (`msca_3d.py:102-122`), kept."""

    def __init__(self, dim: int, time_size: int, mlp_ratio: float = 4.0):
        super().__init__(dim, time_size)
        self.norm2 = BN3D(dim)
        self.mlp = Mlp3d(dim, int(dim * mlp_ratio), dim)

    def forward(self, x):
        return self.mlp(self.norm2(super().forward(x)))


def make_divisible(v, divisor=8, min_value=None, round_limit=0.9):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < round_limit * v:
        new_v += divisor
    return new_v


class InceptionMixer(nn.Module):
    """Channel-split mixer (`iformer_3d.py:18-54`): the first half of the
    high-frequency channels through maxpool → 1×1, the second through 1×1 →
    DW sep → BN, the low-frequency tail through spatial attention;
    concatenated [attn, pool, dw]."""

    def __init__(self, dim: int, tran_ratio: float, time_size: int):
        super().__init__()
        self.low = make_divisible(dim * tran_ratio, 32)
        self.high = dim - self.low
        h2 = self.high // 2
        tp = time_size // 2
        self.maxpool_fc = nn.Sequential(
            nn.MaxPool3d((time_size, 3, 3), 1, (tp, 1, 1)), BasicConv3d(h2, h2, act="relu6"))
        self.fc_dw = nn.Sequential(
            BasicConv3d(self.high - h2, h2, act="relu6"),
            DWSepConv3d(h2, (time_size, 3, 3), 1, (tp, 1, 1)), BN3D(h2))
        self.attn = SpatialAttention3d(self.low, time_size)

    def forward(self, x):
        c, h2 = x.shape[1], self.high // 2
        return torch.cat([self.attn(x[:, c - self.low:]), self.maxpool_fc(x[:, :h2]),
                          self.fc_dw(x[:, h2:self.high])], dim=1)


class IFormerBlock(nn.Module):
    """x + mixer(BN(x)); the full block then adds x + mlp(BN(x)), the light
    one ends in GELU (`iformer_3d.py:56-98`)."""

    def __init__(self, dim: int, tran_ratio: float, time_size: int, light: bool = False,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.light = light
        self.norm1 = BN3D(dim)
        self.inceptionmixer = InceptionMixer(dim, tran_ratio, time_size)
        if not light:
            self.norm2 = BN3D(dim)
            self.mlp = Mlp3d(dim, int(dim * mlp_ratio), dim)

    def forward(self, x):
        x = x + self.inceptionmixer(self.norm1(x))
        if self.light:
            return F.gelu(x)
        return x + self.mlp(self.norm2(x))
