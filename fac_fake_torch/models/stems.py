"""Convolutional stem DSL — the port of `fac_fake_tpu/models/stems.py`.

A stem is data: a tuple of ops run in order by one `Stem` module,
``("conv", ch)`` 3×3 pad-1 conv · ``("qconv", ch)`` its int8 twin
(`compat/quantize.py` writes it) · ``("deconv", ch)`` a `DEConv`
(`models/blocks/deconv.py`) · ``("bn", ch)`` · ``("relu",)`` ·
``("pool",)`` 2×2 max-pool, and the variant zoo's mixers, each ``ch``
channels in and out: ``("scconv", ch)`` `ScConv` · ``("wtconv", ch)``
`WTConv2d` · ``("idw", ch)`` `InceptionDWConv2d` · ``("od", ch)`` an
`ODConv2d` (`models/blocks/`). Op ``i`` is ``features.{i}`` in the state
dict, as in the reference's ``nn.Sequential`` (relu and pool hold no
weights). The spec functions below are the JAX package's, each layout
taken from the reference Sequential it cites.

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
an fp input), no fp ReLU, 4 int8 pools and 1 fp pool. A qconv read
directly by the next, with no ReLU between them (the flagship's 128-stage
conv → deconv, `repbn8_stem1`), quantizes for it all the same.

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

from fac_fake_torch.models.blocks.deconv import DEConv
from fac_fake_torch.models.blocks.inception_dw import InceptionDWConv2d
from fac_fake_torch.models.blocks.odconv import ODConv2d
from fac_fake_torch.models.blocks.scconv import ScConv
from fac_fake_torch.models.blocks.wtconv import WTConv2d
from fac_fake_torch.models.layers import QuantConv3x3, batch_norm, conv3x3
from fac_fake_torch.ops import preprocess, quant

StemSpec = Tuple[Tuple, ...]

_VGG_STAGES = ((32, 3), (64, 3), (128, 3), (256, 4), (512, 4))

# the zoo's mixers: op kind -> module, ch channels in and out
MIXERS = {"scconv": ScConv, "wtconv": WTConv2d, "idw": InceptionDWConv2d,
          "od": lambda ch: ODConv2d(ch, ch, 3)}


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


def vgg_split(n_stages: int = 4) -> Tuple[StemSpec, StemSpec]:
    """The VGG stem split after ``n_stages`` stages, the ``features1`` /
    ``features2`` split most `other/` variants use (4 → 256ch/14², 2 →
    64ch/56²)."""
    first: Tuple = ()
    second: Tuple = ()
    for i, (ch, n) in enumerate(_VGG_STAGES):
        if i < n_stages:
            first += _stage(ch, ["conv"] * n)
        else:
            second += _stage(ch, ["conv"] * n)
    return first, second


def repbn8_stem1() -> StemSpec:
    """Flagship ``features1`` (`cvit_GGCA_ADD_DEConv_RepBn8.py:349-396`):
    14 convs, 4 pools, 224→14×14×256. The 128 stage keeps the reference's
    quirk: its last conv feeds a deconv with no BN or ReLU between them,
    and that deconv has no BN."""
    spec: Tuple = ()
    for ch in (32, 64):
        spec += _stage(ch, ["conv", "deconv", "deconv"])
    spec += _cbr(128) + _cbr(128, "deconv")
    spec += (("conv", 128), ("deconv", 128), ("relu",), ("pool",))
    spec += _stage(256, ["conv", "deconv", "deconv", "deconv"])
    return spec


def repbn8_stem2() -> StemSpec:
    """Flagship ``features2`` (`cvit_GGCA_ADD_DEConv_RepBn8.py:397-412`):
    4 convs, 1 pool, 14²×256 → 7×7×512."""
    return _stage(512, ["conv", "deconv", "deconv", "deconv"])


def deconv_stem1(tail_deconv: bool = True) -> StemSpec:
    """cvit_DEConv.py features1 == RepBn8's; RepBn4 swaps the last 256 deconv
    for a conv (`cvit_GGCA_ADD_DEConv_RepBn4.py`)."""
    spec = repbn8_stem1()
    if tail_deconv:
        return spec
    last = max(i for i, op in enumerate(spec) if op == ("deconv", 256))
    return spec[:last] + (("conv", 256),) + spec[last + 1:]


def deconv_stem2() -> StemSpec:
    return repbn8_stem2()


def repbn_stem1() -> StemSpec:
    """cvit_GGCA_ADD_DEConv_RepBn.py features1: one DEConv per early stage."""
    spec: Tuple = _stage(32, ["conv", "conv", "deconv"])
    spec += _stage(64, ["conv", "deconv", "conv"])
    spec += _stage(128, ["conv", "deconv", "conv"])
    spec += _stage(256, ["conv", "deconv", "deconv", "conv"])
    return spec


def repbn3_stems() -> dict:
    """cvit_GGCA_ADD_DEConv_RepBn3.py: three stems, GGCA add at 64ch/56²."""
    s1 = _stage(32, ["conv", "conv", "deconv"]) + _stage(64, ["conv", "deconv", "conv"])
    s2 = _stage(128, ["conv", "deconv", "conv"]) \
        + _stage(256, ["conv", "deconv", "deconv", "conv"])
    s3 = _stage(512, ["conv"] * 4)
    return dict(stem_spec=s1, stem2_spec=s2, stem3_spec=s3, slot1=("ggca", "add", 64))


def repbn4_stem2() -> StemSpec:
    """cvit_GGCA_ADD_DEConv_RepBn4.py features2."""
    return _stage(512, ["conv", "conv", "deconv", "conv"])


def scconv_stem1() -> StemSpec:
    """other/cvit_GGCA_ADD_ScConv.py features1."""
    spec: Tuple = _stage(32, ["conv"] * 3)
    spec += _stage(64, ["conv", "scconv", "conv"])
    spec += _stage(128, ["conv", "scconv", "conv"])
    spec += _stage(256, ["conv", "scconv", "conv", "scconv"])
    return spec


def wtconv_stem() -> StemSpec:
    """other/cvit_GGCA_ADD_WTConv.py features (single stem)."""
    spec: Tuple = ()
    for ch, n in ((32, 3), (64, 3), (128, 3)):
        spec += _stage(ch, ["conv"] + ["wtconv"] * (n - 1))
    spec += _stage(256, ["conv", "wtconv", "wtconv", "wtconv"])
    spec += _stage(512, ["conv"] * 4)
    return spec


def idw_stem() -> StemSpec:
    """cvit_GGCA_ADD_DConv.py features (InceptionDW mixers)."""
    spec: Tuple = ()
    for ch, n in ((32, 3), (64, 3), (128, 3)):
        spec += _stage(ch, ["conv"] + ["idw"] * (n - 1))
    spec += _stage(256, ["conv", "idw", "idw", "idw"])
    spec += _stage(512, ["conv"] * 4)
    return spec


def odconv_stem1() -> StemSpec:
    """other/cvit_GGCA_ADD_ODConv.py features1 (ODConv as a stem op)."""
    spec: Tuple = _stage(32, ["conv"] * 3)
    spec += _stage(64, ["conv", "od", "conv"])
    spec += _stage(128, ["conv", "od", "conv"])
    spec += _stage(256, ["conv", "od", "conv", "od"])
    return spec


def sla_stems() -> dict:
    """other/cvit_GGCA_SLA.py: only 3 pools (28² features), GGCA add post."""
    s1: Tuple = _stage(32, ["conv"] * 3) + _stage(64, ["conv"] * 3) \
        + _stage(128, ["conv"] * 3)
    s1 += _cbr(256) * 4                 # 256 stage WITHOUT pool
    s2: Tuple = _cbr(512) * 4           # 512 stage WITHOUT pool
    return dict(stem_spec=s1, stem2_spec=s2, slot2=("ggca", "add", 512))


def glu_stem() -> StemSpec:
    """other/cvit_GGCA_ADD_GLUconv.py features: only 2 pools (56² output)."""
    spec: Tuple = _stage(32, ["conv"] * 3) + _stage(64, ["conv"] * 3)
    spec += _cbr(128) * 3 + _cbr(256) * 4 + _cbr(512) * 4
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
    qconv), those that quantize for the next conv (``fused``) and those of
    them with no ReLU between the two convs (``no_relu_fused``), quantize
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
            "no_relu_fused": sum(st.to is not None and not st.relu for st in steps), **entry, "int8_pools": sum(st.pool for st in steps),
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
            elif kind == "deconv":
                layers.append(DEConv(op[1]))
                ch = op[1]
            elif kind == "bn":
                layers.append(batch_norm(op[1]))
            elif kind == "relu":
                layers.append(nn.ReLU())
            elif kind == "pool":
                layers.append(nn.MaxPool2d(2, 2))
                pools += 1
            elif kind in MIXERS:
                layers.append(MIXERS[kind](op[1]))
                ch = op[1]
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
