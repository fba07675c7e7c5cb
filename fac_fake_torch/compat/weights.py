"""Carry weights into the port: JAX variables and reference ``.pth`` files.

The port's counterpart of `fac_fake_tpu/compat/torch_weights.py` and
`torch_export.py`, with its own copy of the base-``cvit`` key map
(`torch_weights._cvit_torch_key`) and of the layout transforms: flax HWIO
convs → OIHW, flax (I, O) denses → (O, I). The port's module tree already
uses the reference torch names, so a reference ``.pth`` needs no map, only
`load_reference_pth`.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def t_conv(w: np.ndarray) -> np.ndarray:   # (kh, kw, I, O) -> (O, I, kh, kw)
    return np.transpose(w, (3, 2, 0, 1))


def t_dense(w: np.ndarray) -> np.ndarray:  # (I, O) -> (O, I)
    return np.transpose(w, (1, 0))


def t_id(w: np.ndarray) -> np.ndarray:
    return np.asarray(w)


_TFM_RE = re.compile(r"^(attn_norm|attn|ffn_norm|ffn)(\d+)$")


def cvit_torch_key(path, variant: str = "cvit") -> Optional[Tuple[str, Callable]]:
    """flax variable path (``("params", "stem", "l0", "kernel")``) →
    (torch key, flax→torch transform) for the base CViT."""
    if variant != "cvit":
        raise NotImplementedError(
            f"variant {variant!r}: multi-stem CViTs are ROADMAP queue 1 "
            "items 4 and 14")
    col, rest = path[0], list(path[1:])
    leaf = rest[-1]
    if rest[0] == "stem" and len(rest) == 3:
        base = f"features.{rest[1][1:]}"  # l{i} -> i
        if col == "batch_stats":
            return f"{base}.running_{'mean' if leaf == 'mean' else 'var'}", t_id
        if leaf == "kernel":
            return f"{base}.weight", t_conv
        return (f"{base}.weight", t_id) if leaf == "scale" else (f"{base}.bias", t_id)
    if rest in (["pos_embedding"], ["cls_token"]):
        return rest[0], t_id
    if rest[0] == "patch_to_embedding":
        return ("patch_to_embedding.weight", t_dense) if leaf == "kernel" \
            else ("patch_to_embedding.bias", t_id)
    if rest[0] == "mlp_head":
        idx = "0" if rest[1] == "fc1" else "2"
        return (f"mlp_head.{idx}.weight", t_dense) if leaf == "kernel" \
            else (f"mlp_head.{idx}.bias", t_id)
    if rest[0] == "transformer":
        m = _TFM_RE.match(rest[1])
        if m is None or (m.group(1) == "ffn_norm" and len(rest) != 3):
            raise NotImplementedError(f"{path}: LinearNorm is ROADMAP queue 1 item 4")
        kind, i = m.group(1), m.group(2)
        L = f"transformer.layers.{i}"
        if kind in ("attn_norm", "ffn_norm"):
            N = f"{L}.0.fn.norm" if kind == "attn_norm" else f"{L}.1.fn.norm"
            return (f"{N}.weight", t_id) if leaf == "scale" else (f"{N}.bias", t_id)
        if kind == "attn":
            return (f"{L}.0.fn.fn.{rest[2]}.weight", t_dense) if leaf == "kernel" \
                else (f"{L}.0.fn.fn.{rest[2]}.bias", t_id)
        idx = "0" if rest[2] == "fc1" else "2"
        return (f"{L}.1.fn.fn.net.{idx}.weight", t_dense) if leaf == "kernel" \
            else (f"{L}.1.fn.fn.net.{idx}.bias", t_id)
    raise KeyError(f"no torch mapping for flax path {path}")


def cvit_state_dict_from_flax(flat: Mapping[str, np.ndarray],
                              variant: str = "cvit") -> Dict[str, torch.Tensor]:
    """JAX CViT variables flattened to ``"params/stem/l0/kernel"``-style keys
    → the port's state_dict (float32)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in flat.items():
        key, tf = cvit_torch_key(k.split("/"), variant)
        out[key] = torch.from_numpy(np.array(tf(np.asarray(v, np.float32)), order="C"))
    return out


def blazeface_state_dict_from_flax(npz: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The packaged ``blazeface_flax.npz`` (``conv0/kernel``, ``b1_3/dw/bias``,
    …) → the port's BlazeFaceNet state_dict, whose names are the reference
    ``blazeface.pth`` names (`fac_fake_tpu/detect/blazeface.py
    convert_blazeface`, inverted)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in npz.items():
        parts = k.split("/")
        if parts[0] == "conv0":
            base = "backbone1.0"
        elif parts[0].startswith("b1_"):
            i = int(parts[0][3:])
            base = f"backbone1.{i + 2}.convs.{0 if parts[1] == 'dw' else 1}"
        elif parts[0].startswith("b2_"):
            i = int(parts[0][3:])
            base = f"backbone2.{i}.convs.{0 if parts[1] == 'dw' else 1}"
        else:
            base = parts[0]  # classifier_8/16, regressor_8/16
        arr = np.asarray(v, np.float32)
        if parts[-1] == "kernel":
            out[f"{base}.weight"] = torch.from_numpy(np.ascontiguousarray(t_conv(arr)))
        else:
            out[f"{base}.bias"] = torch.from_numpy(arr.copy())
    return out


def strip_ddp_prefix(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Remove a leading 'module.' from every key (a prefix strip, not the
    reference's character-set ``lstrip``)."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference or exported ``.pth`` → state_dict on the CPU: unwraps the
    ``{'state_dict': ...}`` training-checkpoint form and strips ``module.``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return strip_ddp_prefix(obj)
