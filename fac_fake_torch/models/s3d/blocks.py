"""S3D composite blocks — the port of the Inception mix and the GCNet context
block of `fac_fake_tpu/models/s3d/blocks.py`.

Module names are the reference torch names (`S3D/model.py:84-342`,
`new_model/context_block_3d.py:5-88`), the ones
`fac_fake_tpu/compat/torch_weights.py:219-225` maps to: ``branch0.0``,
``branch1.{0,1}``, ``branch2.{0,1}``, ``branch3.{0 = MaxPool3d, 1}``;
``conv_mask`` and ``channel_add_conv.{0,1,3}``.

The msca family's blocks (MSCAN, iFormer, Mlp3d, the depthwise-separable
convs) are not here yet (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from fac_fake_torch.models.s3d.layers import BasicConv3d, SepConv3d

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


class ChannelLayerNorm(nn.LayerNorm):
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
            self.conv_mask = nn.Conv3d(cin, 1, 1)
        self.channel_add_conv = nn.Sequential(
            nn.Conv3d(cin, planes, 1), ChannelLayerNorm(planes, eps=1e-5), nn.ReLU6(),
            nn.Conv3d(planes, cin, 1))

    def forward(self, x):
        b, c = x.shape[:2]
        if self.pooling == "att":
            mask = torch.softmax(self.conv_mask(x).reshape(b, -1), dim=1)
            ctx = torch.einsum("bcn,bn->bc", x.reshape(b, c, -1), mask)
            ctx = ctx.reshape(b, c, 1, 1, 1)
        else:
            ctx = x.mean(dim=(2, 3, 4), keepdim=True)
        return x + self.channel_add_conv(ctx)
