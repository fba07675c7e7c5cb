"""Model zoo. Importing this package registers every model builder."""
from __future__ import annotations

import math

import torch
from torch import nn

from fac_fake_torch.core.device import DeviceLike, resolve_device
from fac_fake_torch.core.registry import get

from . import cvit  # noqa: F401  (registers cvit, cvit_repbn8)
from . import resnet  # noqa: F401  (registers reskan, resvitkan, resvit)
from .blocks.deconv import DEConv
from .blocks.kan import KANLinear
from .layers import LINEAR_NORM_STEPS, LinearNorm, RepBN
from .s3d.layers import srm_weight
from .s3d import model as s3d_model  # noqa: F401  (registers the S3D family)


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter and buffer from one explicit `torch.Generator`
    on the model's device: 2D convs He-normal (a ResNet's LeCun-normal),
    3D convs and linears LeCun-normal, biases 0, norms identity (BatchNorm
    running mean 0, var 1; RepBN's ``alpha`` 1), LinearNorm's schedule at
    its start, the CViT's (and ResVitKan's) cls token and legacy
    pos-embedding N(0, 1) (patch mode N(0, 0.02)), 1-D convs as 2D ones,
    a GroupNorm as identity, the zoo's own parameters as their
    ``reset_own`` says (JAX's initializers: an ODConv's candidate kernels
    He-normal, scales at their start values, UFFC's location map U[0, 1),
    SLA's positional encoding 0), a `KANLinear` as JAX's
    (`KANLinear.reset_parameters`: kaiming-uniform base weight and scaler,
    the spline weight fitted to noise, the default grid), as the JAX
    package initialises them; an S3DNet's frozen SRM bank is written anew
    (``to_empty`` leaves buffers unset).

    A DEConv departs from the JAX package on purpose: its five branches are
    drawn N(0, 1), then all five are scaled by one factor, so that the
    kernel they compose into has the He-normal std √(2/fan_in) of a plain
    conv (composition is linear, so one factor does it). The JAX init draws
    each branch U(±1/√fan_in) with the 1-D hd/vd taps' fan_in taken as 3,
    whatever the width, and the flagship's twelve DEConvs multiply that
    scale: its logits are NaN at the JAX init."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    done = set()
    # a ResNet's convs are flax's default, LeCun-normal (He-normal through
    # ResNet-34's 16 residual adds grows its pooled features to ~10^2)
    lecun = {id(c.weight) for r in model.modules() if isinstance(r, resnet.ResNet)
             for c in r.modules() if isinstance(c, nn.Conv2d)}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DEConv):
                branches = [c for c in m.modules() if isinstance(c, (nn.Conv1d, nn.Conv2d))]
                for c in branches:
                    c.weight.normal_(0.0, 1.0, generator=gen)
                    c.bias.zero_()
                    done.update((id(c.weight), id(c.bias)))
                w = m.composed()[0]
                scale = math.sqrt(2.0 / w[0].numel()) / float(w.square().mean().sqrt())
                for c in branches:
                    c.weight.mul_(scale)
            elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)):
                if id(m.weight) in done:   # a DEConv branch
                    continue
                fan_in = m.weight[0].numel()
                gain = math.sqrt(2.0) if isinstance(m, (nn.Conv1d, nn.Conv2d)) \
                    and id(m.weight) not in lecun else 1.0
                m.weight.normal_(0.0, gain / math.sqrt(fan_in), generator=gen)
                done.add(id(m.weight))
                if m.bias is not None:
                    m.bias.zero_()
                    done.add(id(m.bias))
            elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d, nn.LayerNorm,
                                nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                done.update((id(m.weight), id(m.bias)))
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
                    m.num_batches_tracked.zero_()
            elif hasattr(m, "reset_own"):
                m.reset_own(gen)
                done.update(id(p) for p in m.parameters(recurse=False))
            elif isinstance(m, RepBN):
                m.alpha.fill_(1.0)
                done.add(id(m.alpha))
            elif isinstance(m, LinearNorm):
                m.warm.fill_(0)
                m.iter.fill_(LINEAR_NORM_STEPS)
            elif isinstance(m, KANLinear):
                m.reset_parameters(gen)
                done.update(id(p) for p in m.parameters(recurse=False))
            elif isinstance(m, (cvit.CViT, resnet.ResVitKan)):
                m.cls_token.normal_(0.0, 1.0, generator=gen)
                std = 1.0 if m.pos_mode == "legacy" else 0.02
                m.pos_embedding.normal_(0.0, std, generator=gen)
                done.update((id(m.cls_token), id(m.pos_embedding)))
            elif isinstance(m, s3d_model.S3DNet) and m.srm != "none":
                m.srm_weight.copy_(srm_weight(full=m.srm == "concat30"))
    missed = [n for n, p in model.named_parameters() if id(p) not in done]
    if missed:
        raise RuntimeError(f"init_weights left parameters unset: {missed}")
    return model


def build_model(cfg, device: DeviceLike = None, seed: int = 0) -> nn.Module:
    """Construct a model from a ModelConfig via the registry, on ``device``
    (the card unless the caller names the CPU), initialised from ``seed``,
    in eval mode and the model's ``memory_format`` (``channels_last``
    unless the class names another)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = get("model", cfg.name)(cfg)
    model = model.to_empty(device=dev)
    init_weights(model, seed)
    fmt = getattr(model, "memory_format", torch.channels_last)
    return model.to(memory_format=fmt).eval()
