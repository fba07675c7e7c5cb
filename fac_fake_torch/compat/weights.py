"""Carry weights into the port: JAX variables and reference ``.pth`` files.

The port's counterpart of `fac_fake_tpu/compat/torch_weights.py` and
`torch_export.py`, with its own copies of the ``cvit``/``cvit_repbn8`` and
S3D key maps (`torch_weights._cvit_torch_key`, ``_s3d_torch_key``) and of
the layout transforms: flax HWIO convs → OIHW, DHWIO → OIDHW, 1-D (k, I, O)
taps → (O, I, k), flax (I, O) denses → (O, I). The int8 leaves of a JAX
`quantize_cvit` output (``kernel_q``, ``w_scale``, ``x_scale``) map to the
port's `QuantConv3x3` / `QuantLinear` buffers of the same names, with the
same layout transforms; ``kernel_q`` stays int8. The port's module tree
already uses the reference torch names, so a reference ``.pth`` needs no
map, only `load_reference_pth` (and, for S3D, `load_s3d_state_dict`).

A JAX training state comes over whole: its ``params``, ``batch_stats`` and
``schedule`` collections by `cvit_state_dict_from_flax`, and optax's Adam
``mu``/``nu``/``count`` into the torch Adam's ``exp_avg``/``exp_avg_sq``/
``step`` by `load_flax_adam_state`, through the same key map and transforms
(the moments are elementwise, so they transpose as their parameters do).
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch


def t_conv(w: np.ndarray) -> np.ndarray:   # (kh, kw, I, O) -> (O, I, kh, kw)
    return np.transpose(w, (3, 2, 0, 1))


def t_conv3d(w: np.ndarray) -> np.ndarray:  # (kt, kh, kw, I, O) -> (O, I, kt, kh, kw)
    return np.transpose(w, (4, 3, 0, 1, 2))


def t_conv1d(w: np.ndarray) -> np.ndarray:  # (k, I, O) -> (O, I, k)
    return np.transpose(w, (2, 1, 0))


def t_dense(w: np.ndarray) -> np.ndarray:  # (I, O) -> (O, I)
    return np.transpose(w, (1, 0))


def t_id(w: np.ndarray) -> np.ndarray:
    return np.asarray(w)


_TFM_RE = re.compile(r"^(attn_norm|attn|ffn_norm|ffn)(\d+)$")


def _leaf(base: str, leaf: str, kernel_tf: Callable) -> Tuple[str, Callable]:
    """A layer's flax leaf → (torch key, transform): ``kernel`` → weight,
    ``kernel_q`` keeps its name (both take the layer's layout transform),
    ``w_scale``/``x_scale`` keep theirs, a norm's ``scale`` → weight, and
    ``bias`` → bias."""
    if leaf in ("kernel", "kernel_q"):
        return f"{base}.{'weight' if leaf == 'kernel' else leaf}", kernel_tf
    if leaf in ("w_scale", "x_scale"):
        return f"{base}.{leaf}", t_id
    return (f"{base}.weight", t_id) if leaf == "scale" else (f"{base}.bias", t_id)


_DECONV = {"cd": "conv1_1.conv", "hd": "conv1_2.conv", "vd": "conv1_3.conv",
           "ad": "conv1_4.conv", "std": "conv1_5"}
_GGCA = {"conv1": "0", "bn": "1", "conv2": "3"}
CVIT_VARIANTS = ("cvit", "cvit_repbn8")


def _norm_key(base: str, col: str, leaf: str) -> Tuple[str, Callable]:
    """A BatchNorm's or LayerNorm's leaf under ``base``."""
    if col == "batch_stats":
        return f"{base}.running_{'mean' if leaf == 'mean' else 'var'}", t_id
    return (f"{base}.weight", t_id) if leaf == "scale" else (f"{base}.bias", t_id)


def cvit_torch_key(path, variant: str = "cvit") -> Tuple[str, Callable]:
    """flax variable path (``("params", "stem", "l0", "kernel")``) →
    (torch key, flax→torch transform) for base ``cvit`` and the flagship
    ``cvit_repbn8`` — the port's copy of JAX `torch_weights._cvit_torch_key`
    (:69-157). The flagship's stems are ``features1``/``features2``; a
    DEConv's ``w_*``/``b_*`` leaves map to its branches (the hd/vd taps by
    `t_conv1d`); GGCA's ``conv1``/``bn``/``conv2`` to
    ``ggca.shared_conv.{0,1,3}``; a LinearNorm's ``norm1`` (LayerNorm),
    ``norm2`` (RepBN: ``alpha``, ``bn``) and its ``schedule`` counters
    ``warm``/``iter``."""
    if variant not in CVIT_VARIANTS:
        raise NotImplementedError(
            f"variant {variant!r}: the CViT variant zoo is ROADMAP queue 1 item 14")
    col, rest = path[0], list(path[1:])
    leaf = rest[-1]
    if rest[0] in ("stem", "stem2", "stem3"):
        name = "features" if variant == "cvit" else \
            {"stem": "features1", "stem2": "features2", "stem3": "features3"}[rest[0]]
        base = f"{name}.{rest[1][1:]}"  # l{i} -> i
        m = re.match(r"^([wb])_(cd|hd|vd|ad|std)$", leaf)
        if m:
            key = f"{base}.{_DECONV[m.group(2)]}"
            if m.group(1) == "b":
                return f"{key}.bias", t_id
            return f"{key}.weight", t_conv1d if m.group(2) in ("hd", "vd") else t_conv
        if len(rest) != 3:
            raise KeyError(f"no torch mapping for flax path {path}")
        if col == "batch_stats" or leaf == "scale":
            return _norm_key(base, col, leaf)
        return _leaf(base, leaf, t_conv)
    if rest[0] == "ggca":
        base = f"ggca.shared_conv.{_GGCA[rest[1]]}"
        return _norm_key(base, col, leaf) if rest[1] == "bn" else _leaf(base, leaf, t_conv)
    if rest in (["pos_embedding"], ["cls_token"]):
        return rest[0], t_id
    if rest[0] == "patch_to_embedding":
        return _leaf("patch_to_embedding", leaf, t_dense)
    if rest[0] == "mlp_head":
        return _leaf(f"mlp_head.{'0' if rest[1] == 'fc1' else '2'}", leaf, t_dense)
    if rest[0] == "transformer":
        kind, i = _TFM_RE.match(rest[1]).groups()
        L = f"transformer.layers.{i}"
        if kind == "attn_norm":
            return _norm_key(f"{L}.0.fn.norm", col, leaf)
        if kind == "attn":
            return _leaf(f"{L}.0.fn.fn.{rest[2]}", leaf, t_dense)
        if kind == "ffn":
            return _leaf(f"{L}.1.fn.fn.net.{'0' if rest[2] == 'fc1' else '2'}", leaf, t_dense)
        N = f"{L}.1.fn.norm"    # ffn_norm: a LayerNorm, or a LinearNorm
        if col == "schedule":
            return f"{N}.{leaf}", t_id          # warm, iter
        if len(rest) == 3:
            return _norm_key(N, col, leaf)
        if rest[2] == "norm1":
            return _norm_key(f"{N}.norm1", col, leaf)
        if leaf == "alpha":
            return f"{N}.norm2.alpha", t_id
        return _norm_key(f"{N}.norm2.bn", col, leaf)
    raise KeyError(f"no torch mapping for flax path {path}")


def cvit_state_dict_from_flax(flat: Mapping[str, np.ndarray],
                              variant: str = "cvit") -> Dict[str, torch.Tensor]:
    """JAX CViT variables flattened to ``"params/stem/l0/kernel"``-style keys
    → the port's state_dict: float leaves (and LinearNorm's int32 counters)
    as float32, the int8 ``kernel_q`` of quantized variables as int8."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in flat.items():
        key, tf = cvit_torch_key(k.split("/"), variant)
        arr = np.asarray(v)
        if arr.dtype != np.int8:
            arr = arr.astype(np.float32)
        out[key] = torch.from_numpy(np.array(tf(arr), order="C"))
    return out


def load_flax_adam_state(model, optimizer, flat_mu: Mapping[str, np.ndarray],
                         flat_nu: Mapping[str, np.ndarray], count: int,
                         variant: str = "cvit") -> None:
    """optax Adam's first and second moments (flattened as the variables,
    ``"params/stem/l0/kernel"``) and its step count → ``optimizer``'s state
    for ``model``'s parameters, every parameter covered. The step tensor
    lies on the parameter's device where the optimizer is fused or
    capturable, else on the CPU, as torch keeps it."""
    params = dict(model.named_parameters())
    mu = cvit_state_dict_from_flax(flat_mu, variant)
    nu = cvit_state_dict_from_flax(flat_nu, variant)
    if set(mu) != set(params) or set(nu) != set(params):
        raise KeyError(f"Adam state and model differ: {sorted(set(mu) ^ set(params))}")
    group = optimizer.param_groups[0]
    on_device = bool(group.get("fused") or group.get("capturable"))
    for name, p in params.items():
        if tuple(mu[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: moment shape {tuple(mu[name].shape)} != {tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32,
                                 device=p.device if on_device else "cpu"),
            # in the parameter's memory format, as torch makes its moments
            "exp_avg": torch.empty_like(p).copy_(mu[name]),
            "exp_avg_sq": torch.empty_like(p).copy_(nu[name])}


_MIX_BRANCH = {"b0": "branch0.0", "b1a": "branch1.0", "b1b": "branch1.1",
               "b2a": "branch2.0", "b2b": "branch2.1", "b3": "branch3.1"}
_CTX = {"ca1": "channel_add_conv.0", "ln": "channel_add_conv.1",
        "ca2": "channel_add_conv.3", "conv_mask": "conv_mask"}


def s3d_torch_key(path, spec) -> Tuple[str, Callable]:
    """flax S3DNet variable path (``("params", "l5", "b1b", "conv_s",
    "kernel")``) → (torch key, flax→torch transform), for the ``sep``,
    ``basic``, ``mix`` and ``ctx`` ops and the head — the port's copy of
    `fac_fake_tpu/compat/torch_weights.py` ``_s3d_torch_key``. ``base.{i}``
    lines up with spec index i. The ctx LayerNorm keeps its (planes,)
    weight, as the port's `ChannelLayerNorm` does."""
    col, rest = path[0], list(path[1:])
    leaf = rest[-1]

    def term(base):
        if col == "batch_stats":
            return f"{base}.running_{'mean' if leaf == 'mean' else 'var'}", t_id
        if leaf == "kernel":
            return f"{base}.weight", t_conv3d
        return (f"{base}.weight", t_id) if leaf == "scale" else (f"{base}.bias", t_id)

    if rest[0] == "fc":
        return term("fc.0")
    m = re.match(r"^l(\d+)$", rest[0])
    if m is None:
        raise KeyError(f"no S3D mapping for flax path {path}")
    i = int(m.group(1))
    base, op = f"base.{i}", spec[i][0]
    if op in ("sep", "basic"):
        return term(f"{base}.{rest[1]}")
    if op == "mix":
        return term(f"{base}.{_MIX_BRANCH[rest[1]]}.{rest[2]}")
    if op == "ctx":
        return term(f"{base}.{_CTX[rest[1]]}")
    raise NotImplementedError(f"{path}: spec op {op!r} belongs to the msca S3D family "
                              "(ROADMAP queue 1 item 13)")


def s3d_state_dict_from_flax(flat: Mapping[str, np.ndarray], spec) -> Dict[str, torch.Tensor]:
    """JAX S3DNet variables flattened to ``"params/l0/conv_s/kernel"``-style
    keys → the port's S3DNet state_dict (float32)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in flat.items():
        key, tf = s3d_torch_key(k.split("/"), spec)
        out[key] = torch.from_numpy(np.array(tf(np.asarray(v, np.float32)), order="C"))
    return out


def load_s3d_state_dict(model, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Fill an S3DNet from a reference or exported S3D state_dict, as
    `fac_fake_tpu/compat/torch_weights.py` ``convert_s3d`` fills the JAX
    model: every key the model has (but BatchNorm's ``num_batches_tracked``,
    which the JAX package does not keep) must be present with its shape,
    and keys the model has no module for are ignored. The reference ctx
    LayerNorm's (planes, 1, 1, 1) weight and bias load as (planes,)."""
    new = {}
    for key, target in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        if key not in state_dict:
            raise KeyError(f"S3D checkpoint missing '{key}'")
        v = state_dict[key]
        if key.endswith(("channel_add_conv.1.weight", "channel_add_conv.1.bias")):
            v = v.reshape(-1)
        if tuple(v.shape) != tuple(target.shape):
            raise ValueError(f"{key}: shape {tuple(v.shape)} != {tuple(target.shape)}")
        new[key] = v
    model.load_state_dict(new, strict=True)


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


# MTCNN: facenet_pytorch's layer names a net, and the JAX package's flax names
# (`fac_fake_tpu/detect/mtcnn.py` convert_mtcnn): the i-th PReLU is PReLU_i
MTCNN_LAYERS = {
    "pnet": (("conv1", "conv2", "conv3", "conv4_1", "conv4_2"), (),
             ("prelu1", "prelu2", "prelu3")),
    "rnet": (("conv1", "conv2", "conv3"), ("dense4", "dense5_1", "dense5_2"),
             ("prelu1", "prelu2", "prelu3", "prelu4")),
    "onet": (("conv1", "conv2", "conv3", "conv4"), ("dense5", "dense6_1", "dense6_2", "dense6_3"),
             ("prelu1", "prelu2", "prelu3", "prelu4", "prelu5")),
}


def mtcnn_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX MTCNN variables (``{net: {"params": {layer: {leaf: array}}}}``,
    numpy) → the port's MTCNN state_dict in facenet_pytorch's names
    (``pnet.conv1.weight``, …): HWIO convs → OIHW, (I, O) denses → (O, I),
    PReLU ``alpha`` → ``prelu{i}.weight``. The inverse of
    `fac_fake_tpu/detect/mtcnn.py` convert_mtcnn; the flatten before the
    first dense needs no permutation, as the nets flatten in facenet's
    order."""
    out: Dict[str, torch.Tensor] = {}

    def put(key, arr, tf):
        out[key] = torch.from_numpy(np.array(tf(np.asarray(arr, np.float32))))

    for net, (convs, denses, prelus) in MTCNN_LAYERS.items():
        params = variables[net]["params"]
        for name, tf in [(c, t_conv) for c in convs] + [(d, t_dense) for d in denses]:
            put(f"{net}.{name}.weight", params[name]["kernel"], tf)
            put(f"{net}.{name}.bias", params[name]["bias"], t_id)
        for i, name in enumerate(prelus):
            put(f"{net}.{name}.weight", params[f"PReLU_{i}"]["alpha"], t_id)
    return out


def mtcnn_flax_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's (facenet_pytorch-layout) MTCNN state_dict → the JAX
    package's variables tree of numpy arrays: the port's copy of
    `fac_fake_tpu/detect/mtcnn.py` convert_mtcnn."""
    sd = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
          for k, v in state_dict.items()}
    tree: Dict = {}
    for net, (convs, denses, prelus) in MTCNN_LAYERS.items():
        params = {}
        for name in convs:
            params[name] = {"kernel": np.transpose(sd[f"{net}.{name}.weight"], (2, 3, 1, 0)),
                            "bias": sd[f"{net}.{name}.bias"]}
        for name in denses:
            params[name] = {"kernel": np.transpose(sd[f"{net}.{name}.weight"]),
                            "bias": sd[f"{net}.{name}.bias"]}
        for i, name in enumerate(prelus):
            params[f"PReLU_{i}"] = {"alpha": sd[f"{net}.{name}.weight"].reshape(-1)}
        tree[net] = {"params": params}
    return tree
