"""Convolutional stem DSL — the port of `fac_fake_tpu/models/stems.py` for
the plain op kinds.

A stem is data: a tuple of ops run in order by one `Stem` module,
``("conv", ch)`` 3×3 pad-1 conv · ``("qconv", ch)`` its int8 twin
(`compat/quantize.py` writes it) · ``("bn", ch)`` · ``("relu",)`` ·
``("pool",)`` 2×2 max-pool. Op ``i`` is ``features.{i}`` in the state dict,
as in the reference's ``nn.Sequential`` (relu and pool hold no weights).

A quantized stem runs its ``qconv`` chain as one int8 walk (`plan_walk`,
value-free, at construction): each qconv is K3 (`ops/quant.py
int8_conv3x3`) with the ReLU after it in its epilogue; where the next
qconv reads its output, directly or through one pool, the epilogue
quantizes it with that conv's ``x_scale``, and the pool runs on the int8
tensor. The quantizer is monotone, so it commutes with the ReLU and the
max: the values are those of the module-by-module chain. The first qconv
quantizes its fp input; the last writes the activation dtype, and the
ops after it run as modules. On the quantized `vgg_stem`: 17 convs, 16
of them quantizing for the next (4 through a pool), 1 quantize pass (from
an fp input), no fp ReLU, 4 int8 pools and 1 fp pool.

`Stem.forward_crops` starts from the uint8 NHWC crops: a walk's first
step is then K2's int8 entry (`ops/preprocess.py quantize_crops`, the
ImageNet normalize and the first qconv's quantize in one pass, the same
bytes), so the quantized `vgg_stem` runs no quantize pass; a stem without
a walk normalizes the crops with K2 and runs as modules.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from fac_fake_torch.models.layers import QuantConv3x3, batch_norm, conv3x3
from fac_fake_torch.ops import preprocess, quant

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


class WalkStep(NamedTuple):
    conv: int             # op index of the qconv
    relu: bool            # a ReLU follows it: in the epilogue
    to: Optional[int]     # op index of the qconv that reads the output, quantized for it
    pool: bool            # a 2×2 pool between the two, on the int8 tensor


def plan_walk(spec: StemSpec) -> Tuple[Tuple[WalkStep, ...], int]:
    """(steps, tail): the int8 walk over the qconv chain that starts at op
    0; the ops from ``tail`` on run as modules. No steps (the whole stem
    runs as modules) unless op 0 is a qconv."""
    kind = lambda i: spec[i][0] if i < len(spec) else None
    if kind(0) != "qconv":
        return (), 0
    steps, i = [], 0
    while True:
        relu = kind(i + 1) == "relu"
        j = i + 1 + relu
        pool = kind(j) == "pool" and kind(j + 1) == "qconv"
        nxt = j + pool
        if kind(nxt) != "qconv":
            return tuple(steps) + (WalkStep(i, relu, None, False),), j
        steps.append(WalkStep(i, relu, nxt, pool))
        i = nxt


def walk_counts(spec: StemSpec, crops: bool = False) -> dict:
    """What one forward of the stem runs: K3 launches (``convs``, one a
    qconv), those that quantize for the next conv (``fused``), quantize
    passes (the walk's one, and one a qconv run as a module), pools on int8
    and fp tensors, and fp ReLU passes. With ``crops``, the forward of
    `Stem.forward_crops`: the walk's quantize pass is then K2's int8 entry
    (``k2_int8``), and a stem without a walk normalizes the crops in K2's
    fp mode (``k2_fp``)."""
    steps, tail = plan_walk(spec)
    rest = spec[tail:]
    count = lambda ops, kind: sum(op[0] == kind for op in ops)
    entry = {"quantize": int(bool(steps)) + count(rest, "qconv")}
    if crops:
        entry = {"quantize": count(rest, "qconv"), "k2_int8": int(bool(steps)),
                 "k2_fp": int(not steps)}
    return {"convs": count(spec, "qconv"), "fused": sum(st.to is not None for st in steps),
            **entry, "int8_pools": sum(st.pool for st in steps),
            "fp_pools": count(rest, "pool"), "fp_relus": count(rest, "relu")}


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
        self.walk, self.walk_tail = plan_walk(tuple(spec))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.walk:
            return super().forward(x)
        dtype = quant._out_dtype(x, "the stem's int8 walk")
        return self._walk(self[0].quantize(x), dtype)

    def forward_crops(self, crops_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """uint8 NHWC (B, H, W, 3) crops → what `forward` gives for their
        ImageNet normalize in ``dtype``: the walk from K2's int8 entry, or
        without a walk K2's normalize, then the modules."""
        if not self.walk:
            return self(preprocess.normalize_imagenet(crops_u8, dtype))
        return self._walk(self[0].quantize_crops(crops_u8, dtype), dtype)

    def _walk(self, xq: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The int8 walk from op 0's int8 NHWC input, then the ops after it."""
        ops = list(self)
        for st in self.walk:
            if st.to is None:
                x = ops[st.conv].walk(xq, st.relu, dtype).permute(0, 3, 1, 2)
            else:
                xq = ops[st.conv].walk(xq, st.relu, dtype, ops[st.to].x_scale)
                if st.pool:
                    xq = quant.max_pool2x2_i8(xq)
        for op in ops[self.walk_tail:]:
            x = op(x)
        return x
