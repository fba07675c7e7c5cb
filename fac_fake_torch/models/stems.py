"""Convolutional stem DSL — the port of `fac_fake_tpu/models/stems.py` for
the plain op kinds.

A stem is data: a tuple of ops run in order by one `Stem` module,
``("conv", ch)`` 3×3 pad-1 conv · ``("qconv", ch)`` its int8 twin
(`compat/quantize.py` writes it) · ``("bn", ch)`` · ``("relu",)`` ·
``("pool",)`` 2×2 max-pool. Op ``i`` is ``features.{i}`` in the state dict,
as in the reference's ``nn.Sequential`` (relu and pool hold no weights).
"""
from __future__ import annotations

from typing import Tuple

from torch import nn

from fac_fake_torch.models.layers import QuantConv3x3, batch_norm, conv3x3

StemSpec = Tuple[Tuple, ...]

_VGG_STAGES = ((32, 3), (64, 3), (128, 3), (256, 4), (512, 4))

# op kinds of the JAX stem DSL that later slices port
_LATER = {
    "deconv": "ROADMAP queue 1 item 4 (flagship DEConv)",
    "scconv": "ROADMAP queue 1 item 14 (variant zoo)",
    "wtconv": "ROADMAP queue 1 item 14 (variant zoo)",
    "idw": "ROADMAP queue 1 item 14 (variant zoo)",
    "od": "ROADMAP queue 1 item 14 (variant zoo)",
}


def _cbr(ch: int, kind: str = "conv"):
    return ((kind, ch), ("bn", ch), ("relu",))


def _stage(ch: int, kinds) -> Tuple:
    spec: Tuple = ()
    for k in kinds:
        spec += _cbr(ch, k)
    return spec + (("pool",),)


def vgg_stem() -> StemSpec:
    """Reference CViT base stem: 17 convs, 5 maxpools, 224→7×7×512
    (`model/cvit.py:86-148`)."""
    spec: Tuple = ()
    for ch, n in _VGG_STAGES:
        spec += _stage(ch, ["conv"] * n)
    return spec


class Stem(nn.Sequential):
    """NCHW in, NCHW out. ``out_channels`` and ``pools`` describe the
    feature map the stem produces."""

    def __init__(self, spec: StemSpec, in_channels: int = 3):
        layers = []
        ch = in_channels
        pools = 0
        for op in spec:
            kind = op[0]
            if kind in ("conv", "qconv"):
                layers.append((conv3x3 if kind == "conv" else QuantConv3x3)(ch, op[1]))
                ch = op[1]
            elif kind == "bn":
                layers.append(batch_norm(op[1]))
            elif kind == "relu":
                layers.append(nn.ReLU())
            elif kind == "pool":
                layers.append(nn.MaxPool2d(2, 2))
                pools += 1
            elif kind in _LATER:
                raise NotImplementedError(f"stem op {kind!r} is {_LATER[kind]}")
            else:
                raise ValueError(f"unknown stem op {kind}")
        super().__init__(*layers)
        self.out_channels = ch
        self.pools = pools
