"""Model zoo. Importing this package registers every model builder."""
from __future__ import annotations

import math

import torch
from torch import nn

from fac_fake_torch.core.device import DeviceLike, resolve_device
from fac_fake_torch.core.registry import get

from . import cvit  # noqa: F401  (registers cvit)
from .s3d.layers import srm_weight
from .s3d import model as s3d_model  # noqa: F401  (registers the S3D family)


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter and buffer from one explicit `torch.Generator`
    on the model's device: 2D convs He-normal, 3D convs and linears
    LeCun-normal, biases 0, norms identity (BatchNorm running mean 0, var
    1), the CViT's cls token and legacy pos-embedding N(0, 1) (patch mode
    N(0, 0.02)), as the JAX package initialises them; an S3DNet's frozen SRM
    bank is written anew (``to_empty`` leaves buffers unset)."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    done = set()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                fan_in = m.weight[0].numel()
                gain = math.sqrt(2.0) if isinstance(m, nn.Conv2d) else 1.0
                m.weight.normal_(0.0, gain / math.sqrt(fan_in), generator=gen)
                done.add(id(m.weight))
                if m.bias is not None:
                    m.bias.zero_()
                    done.add(id(m.bias))
            elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                done.update((id(m.weight), id(m.bias)))
                if not isinstance(m, nn.LayerNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
                    m.num_batches_tracked.zero_()
            elif isinstance(m, cvit.CViT):
                m.cls_token.normal_(0.0, 1.0, generator=gen)
                std = 1.0 if m.pos_mode == "legacy" else 0.02
                m.pos_embedding.normal_(0.0, std, generator=gen)
                done.update((id(m.cls_token), id(m.pos_embedding)))
            elif isinstance(m, s3d_model.S3DNet) and m.srm == "concat30":
                m.srm_weight.copy_(srm_weight(full=True))
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
