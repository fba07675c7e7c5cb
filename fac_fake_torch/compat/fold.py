"""Inference-time BatchNorm folding — the port of `fac_fake_tpu/compat/fold.py`
for conv+bn pairs.

A conv followed by BatchNorm with running stats folds into the conv:
    k' = k · γ/√(σ²+ε),  b' = (b − μ)·γ/√(σ²+ε) + β
which removes the BN pass (the base stem has 17 pairs). The folded spec
drops the ``("bn", ch)`` ops, so stem indices renumber as in the JAX fold.
DEConv composition waits for the flagship slice (ROADMAP queue 1 item 4).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from fac_fake_torch.models.layers import BN_EPS


def _scale_of(sd: Dict[str, torch.Tensor], i: int):
    g = sd[f"{i}.weight"].float() / torch.sqrt(sd[f"{i}.running_var"].float() + BN_EPS)
    return g, sd[f"{i}.bias"].float() - sd[f"{i}.running_mean"].float() * g


def fold_stem_bn(spec: Tuple, sd: Dict[str, torch.Tensor]
                 ) -> Tuple[Tuple, Dict[str, torch.Tensor]]:
    """Fold every conv immediately followed by bn. ``sd`` is the stem's own
    state dict (``"{i}.weight"``, ``"{i}.running_mean"``, …). Returns
    (new_spec, new_sd); other ops pass through, renumbered."""
    spec = tuple(spec)
    new_spec = []
    new_sd: Dict[str, torch.Tensor] = {}
    i = 0
    while i < len(spec):
        op = spec[i]
        out_i = len(new_spec)
        nxt = spec[i + 1] if i + 1 < len(spec) else ("",)
        if op[0] == "deconv":
            raise NotImplementedError("DEConv folding is ROADMAP queue 1 item 4")
        if op[0] == "conv" and nxt[0] == "bn":
            g, b = _scale_of(sd, i + 1)
            new_sd[f"{out_i}.weight"] = sd[f"{i}.weight"] * g[:, None, None, None]
            new_sd[f"{out_i}.bias"] = sd[f"{i}.bias"] * g + b
            new_spec.append(op)
            i += 2
            continue
        for k, v in sd.items():
            head, _, leaf = k.partition(".")
            if head == str(i):
                new_sd[f"{out_i}.{leaf}"] = v
        new_spec.append(op)
        i += 1
    return tuple(new_spec), new_sd


def fold_cvit(model):
    """A new CViT on the model's device with its stem's BNs folded, in eval
    mode; transformer and head weights are shared values, copied."""
    from fac_fake_torch.models.cvit import CViT

    sd = model.state_dict()
    stem = {k[len("features."):]: v for k, v in sd.items() if k.startswith("features.")}
    new_spec, new_stem = fold_stem_bn(model.stem_spec, stem)
    rest = {k: v for k, v in sd.items() if not k.startswith("features.")}
    rest.update({f"features.{k}": v for k, v in new_stem.items()})
    with torch.device("meta"):
        folded = CViT(**{**model.config, "stem_spec": new_spec})
    dev = next(model.parameters()).device
    folded = folded.to_empty(device=dev)
    folded.load_state_dict(rest, strict=True)
    return folded.to(memory_format=torch.channels_last).eval()
