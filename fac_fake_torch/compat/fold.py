"""Inference-time BatchNorm folding — the port of `fac_fake_tpu/compat/fold.py`.

A conv followed by BatchNorm with running stats folds into the conv:
    k' = k · γ/√(σ²+ε),  b' = (b − μ)·γ/√(σ²+ε) + β
which removes the BN pass (the base stem has 17 pairs). A DEConv first
composes its five branches into one conv kernel (exact: the forward sums
them anyway, `models/blocks/deconv.py`), then folds the same way; a bare
DEConv (the flagship's 128-stage quirk) composes into a plain conv. The
folded spec holds ``("conv", ch)`` ops only where there were conv and
deconv ops, and drops the folded ``("bn", ch)``, so stem indices renumber
as in the JAX fold: the flagship's stems fold to plain conv/relu/pool
specs of 14 and 4 convs. The variant zoo's stem ops (scconv, wtconv, idw,
od) and a BN after one pass through with their parameters and stats,
renumbered (JAX `compat/fold.py:94`); the blocks' BNs (GGCA, MDFA, BFM,
ODConv's attention) keep theirs.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from fac_fake_torch.models.blocks.deconv import compose_deconv_state
from fac_fake_torch.models.layers import BN_EPS


def _scale_of(sd: Dict[str, torch.Tensor], i: int):
    g = sd[f"{i}.weight"].float() / torch.sqrt(sd[f"{i}.running_var"].float() + BN_EPS)
    return g, sd[f"{i}.bias"].float() - sd[f"{i}.running_mean"].float() * g


def fold_stem_bn(spec: Tuple, sd: Dict[str, torch.Tensor]
                 ) -> Tuple[Tuple, Dict[str, torch.Tensor]]:
    """Fold every conv or deconv immediately followed by bn, and compose
    every other deconv. ``sd`` is the stem's own state dict (``"{i}.weight"``,
    ``"{i}.running_mean"``, …). Returns (new_spec, new_sd); other ops pass
    through, renumbered."""
    spec = tuple(spec)
    new_spec = []
    new_sd: Dict[str, torch.Tensor] = {}
    i = 0
    while i < len(spec):
        op = spec[i]
        out_i = len(new_spec)
        nxt = spec[i + 1] if i + 1 < len(spec) else ("",)
        if op[0] in ("conv", "deconv"):
            if op[0] == "deconv":
                w, b = compose_deconv_state(sd, f"{i}.")
            else:
                w, b = sd[f"{i}.weight"], sd[f"{i}.bias"]
            if nxt[0] == "bn":
                g, shift = _scale_of(sd, i + 1)
                w, b = w * g[:, None, None, None], b * g + shift
            new_sd[f"{out_i}.weight"], new_sd[f"{out_i}.bias"] = w, b
            new_spec.append(("conv", op[1]))
            i += 2 if nxt[0] == "bn" else 1
            continue
        for k, v in sd.items():
            head, _, leaf = k.partition(".")
            if head == str(i):
                new_sd[f"{out_i}.{leaf}"] = v
        new_spec.append(op)
        i += 1
    return tuple(new_spec), new_sd


def fold_cvit(model):
    """A new CViT on the model's device with every stem's BNs folded and
    DEConvs composed, in eval mode; the blocks, the transformer and the
    head keep their weights and stats (copied)."""
    from fac_fake_torch.models.cvit import CViT

    sd = model.state_dict()
    config = dict(model.config)
    for field, name in model.stem_names.items():
        pre = f"{name}."
        own = {k[len(pre):]: sd.pop(k) for k in list(sd) if k.startswith(pre)}
        config[field], folded_sd = fold_stem_bn(config[field], own)
        sd.update({pre + k: v for k, v in folded_sd.items()})
    with torch.device("meta"):
        folded = CViT(**config)
    dev = next(model.parameters()).device
    folded = folded.to_empty(device=dev)
    folded.load_state_dict(sd, strict=True)
    return folded.to(memory_format=torch.channels_last).eval()
