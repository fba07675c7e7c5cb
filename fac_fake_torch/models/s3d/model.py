"""S3D model family, assembled from spec lists — the port of
`fac_fake_tpu/models/s3d/model.py`.

  * ``s3d``    — `S3D/model.py:6-48` (separable-3D Inception, 20-frame clip
                 → 1 logit; optional 30-channel SRM input, `model.py:10-16`);
  * ``ca_s3d`` — `S3D/CA_S3D.py:9-60` (+ GCNet ContextBlock3d after six of
                 the Inception stages), the reference's default
                 ``--model_type 0``;
  * ``msca_s3d`` — `msca_S3D.py:17-72` / `msca_S3Dv1.py:74-129` (iFormer
                 hybrid at 320 channels, reduced 5b/5c tail, ReLU6);
  * ``msca_s3d_srm`` — `msca_S3Dv1.py:17-72` (the residual 3-filter SRM
                 input ``x + SRM(x)`` and an MSCAN_half stem block);
  * ``msca_s3d_v2`` — all-full iFormer blocks (`msca_S3Dv2.py:85-104`);
  * ``msca_s3d_srm_v2`` — the v1 residual-SRM structure without the stem
                 MSCAN_half.

``self.base`` is an ``nn.Sequential`` whose indices are the spec's indices
(a pool takes a slot, as ``nn.MaxPool3d`` does in the reference), and
``self.fc`` is ``nn.Sequential(nn.Conv3d(C, num_class, 1))``, so a
reference ``.pth`` loads by name.

Input: (B, 3, T, H, W) float, raw 0–255, in ``channels_last_3d`` memory (the
JAX package's (B, T, H, W, 3) permuted). Output: (B, num_class) fp32 logits
(temporal-mean head, `model.py:37-48`).

``dtype`` (``model.dtype`` of the config) is the compute dtype, as JAX's
``S3DNet.dtype``: the clips are cast to it and every layer follows its
input's dtype (`models/layers.py`); the parameters stay fp32. At the
default fp32 the model computes in its parameters' dtype (a float64 copy,
``.double()``, computes in float64). In bf16 the
frozen SRM bank runs in fp32 on the fp32 clips and the result is cast,
as JAX's int8 engine runs it (JAX's bf16 model cannot: its
``lax.conv_general_dilated`` refuses the bf16 clips against the fp32
bank).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from fac_fake_torch.core.config import torch_dtype
from fac_fake_torch.core.registry import register
from fac_fake_torch.models.layers import Conv3d, widen
from fac_fake_torch.models.s3d.blocks import (INCEPTION_PLANS, ContextBlock3d, IFormerBlock,
                                              InceptionMix, MSCANHalf)
from fac_fake_torch.models.s3d.layers import (BasicConv3d, SepConv3d, avg_pool3d, srm_filter,
                                              srm_weight)

_P133 = (("pool", (1, 3, 3), (1, 2, 2), (0, 1, 1)),)
_P333 = (("pool", (3, 3, 3), (2, 2, 2), (1, 1, 1)),)
_P222 = (("pool", (2, 2, 2), (2, 2, 2), (0, 0, 0)),)


def s3d_spec(act: str = "relu") -> Tuple:
    return (
        ("sep", 64, 7, 2, 3, act, True),
    ) + _P133 + (
        ("basic", 64, 1, 1, 0, act),
        ("sep", 192, 3, 1, 1, act, True),
    ) + _P133 + (
        ("mix", "3b", act, True), ("mix", "3c", act, True),
    ) + _P333 + (
        ("mix", "4b", act, True), ("mix", "4c", act, True),
        ("mix", "4d", act, True), ("mix", "4e", act, True),
        ("mix", "4f", act, True),
    ) + _P222 + (
        ("mix", "5b", act, True), ("mix", "5c", act, True),
    )


def ca_s3d_spec() -> Tuple:
    act = "relu"
    ctx = ("ctx", 1.0 / 16.0, "avg")
    return (
        ("sep", 64, 7, 2, 3, act, True),
    ) + _P133 + (
        ("basic", 64, 1, 1, 0, act),
        ("sep", 192, 3, 1, 1, act, True),
    ) + _P133 + (
        ("mix", "3b", act, True), ctx, ("mix", "3c", act, True),
    ) + _P333 + (
        ("mix", "4b", act, True), ctx, ("mix", "4c", act, True), ctx,
        ("mix", "4d", act, True), ctx, ("mix", "4e", act, True), ctx,
        ("mix", "4f", act, True),
    ) + _P222 + (
        ("mix", "5b", act, True), ctx, ("mix", "5c", act, True),
    )


def msca_spec(stem_mscan: bool = False, all_full: bool = False) -> Tuple:
    """The msca_S3D layer plans (`msca_S3D.py:85-115`, `msca_S3Dv1.py`):
    light-light-full iFormer triplets at 320 channels; ``all_full``: the v2
    re-plan (`msca_S3Dv2.py:85-104`, two full blocks a ratio); ``stem_mscan``:
    the v1-SRM stem MSCAN_half (`msca_S3Dv1.py:31`)."""
    act = "relu6"
    spec: Tuple = (("sep", 64, 7, 2, 3, act, True),) + _P133
    if stem_mscan:
        spec += (("mscan_half", 1),)
    spec += (
        ("basic", 64, 1, 1, 0, act),
        ("sep", 192, 3, 1, 1, act, True),
    ) + _P133
    if all_full:
        spec += (("iformer", 0.25, 1, False),) * 2
        spec += (("basic", 320, 1, 1, 0, act),) + _P333
        for ratio in (1 / 3, 1 / 2, 2 / 3):
            spec += (("iformer", ratio, 3, False),) * 2
    else:
        spec += (("iformer", 0.25, 1, True), ("iformer", 0.25, 1, False),
                 ("basic", 320, 1, 1, 0, act)) + _P333
        for ratio in (1 / 3, 1 / 2, 2 / 3):
            spec += (("iformer", ratio, 3, True),) * 2 \
                + (("iformer", ratio, 3, False),)
    spec += _P222 + (
        ("mix", "m5b", act, False),
        ("mix", "m5c", act, True),
    )
    return spec


class S3DNet(nn.Module):
    memory_format = torch.channels_last_3d   # what `build_model` converts to

    def __init__(self, spec: Tuple, num_class: int = 1, srm: str = "none",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if srm not in ("none", "concat30", "residual3"):
            raise ValueError(f"srm must be none|concat30|residual3, got {srm!r}")
        self.spec = tuple(spec)
        self.num_class = num_class
        self.srm = srm
        if srm != "none":
            # frozen, not part of the state dict (the JAX model has no leaf for it)
            self.register_buffer("srm_weight", srm_weight(full=srm == "concat30"),
                                 persistent=False)
        c = 30 if srm == "concat30" else 3
        layers = []
        for op in self.spec:
            kind = op[0]
            if kind == "sep":
                _, out, k, s, p, act, sbn = op
                layers.append(SepConv3d(c, out, k, s, p, act, spatial_bn=sbn, spatial_act=sbn))
                c = out
            elif kind == "basic":
                _, out, k, s, p, act = op
                layers.append(BasicConv3d(c, out, k, s, p, act))
                c = out
            elif kind == "pool":
                layers.append(nn.MaxPool3d(op[1], op[2], op[3]))
            elif kind == "mix":
                layers.append(InceptionMix(c, INCEPTION_PLANS[op[1]], op[2], op[3]))
                c = layers[-1].out_channels
            elif kind == "ctx":
                layers.append(ContextBlock3d(c, op[1], op[2]))
            elif kind == "mscan_half":
                layers.append(MSCANHalf(c, op[1]))
            elif kind == "iformer":
                layers.append(IFormerBlock(c, op[1], op[2], light=op[3]))
            else:
                raise ValueError(kind)
        self.base = nn.Sequential(*layers)
        self.fc = nn.Sequential(Conv3d(c, num_class, 1))

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        dt = self.dtype if self.dtype == torch.bfloat16 else self.fc[0].weight.dtype
        x = clips.to(dt)
        if self.srm != "none":
            xf = widen(x)
            hp = srm_filter(xf, self.srm_weight)
            x = (hp if self.srm == "concat30" else xf + hp).to(dt)
        x = self.base(x)
        # head: avg over (2, H, W) stride 1, 1×1×1 conv, temporal mean
        x = self.fc(avg_pool3d(x, (2, x.shape[3], x.shape[4])))
        return x.flatten(2).mean(2).float()


def _s3d_net(cfg, spec, srm: str = "concat30") -> S3DNet:
    return S3DNet(spec, num_class=cfg.num_class, srm=srm if cfg.srm_net else "none",
                  dtype=torch_dtype(cfg.dtype))


@register("model", "s3d")
def build_s3d(cfg):
    return _s3d_net(cfg, s3d_spec())


@register("model", "ca_s3d")
def build_ca_s3d(cfg):
    """CA_S3D_v3, the default ``--model_type 0`` (`S3D-train.py:169-171`)."""
    return _s3d_net(cfg, ca_s3d_spec())


@register("model", "msca_s3d")
def build_msca_s3d(cfg):
    return _s3d_net(cfg, msca_spec())


@register("model", "msca_s3d_srm")
def build_msca_s3d_srm(cfg):
    """v1 residual-SRM hybrid: y = x + HPF_3(x) (`msca_S3Dv1.py:61-63`)."""
    return _s3d_net(cfg, msca_spec(stem_mscan=True), srm="residual3")


@register("model", "msca_s3d_v2")
def build_msca_s3d_v2(cfg):
    """v2 re-plan: all-full iFormer blocks (`msca_S3Dv2.py:85-104`)."""
    return _s3d_net(cfg, msca_spec(all_full=True))


@register("model", "msca_s3d_srm_v2")
def build_msca_s3d_srm_v2(cfg):
    """v2 residual-SRM: the v1 structure without the stem MSCAN_half."""
    return _s3d_net(cfg, msca_spec(stem_mscan=False), srm="residual3")
