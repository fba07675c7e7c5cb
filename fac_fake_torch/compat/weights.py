"""Carry weights into the port: JAX variables and reference ``.pth`` files.

The port's counterpart of `fac_fake_tpu/compat/torch_weights.py` and
`torch_export.py`, with its own copies of the CViT (every registry entry:
the variant zoo's blocks and stem ops too), S3D and ResNet/KAN key maps
(`torch_weights._cvit_torch_key`, ``_block_torch_key``, ``_stem_op_key``,
``_s3d_torch_key``, ``_resnet_key``, ``_kan_key``) and of the layout
transforms: flax HWIO convs → OIHW, DHWIO → OIDHW, 1-D (k, I, O) taps →
(O, I, k), flax (I, O) denses → (O, I), an ODConv's (kn, k, k, I, O)
candidates → (kn, O, I, k, k), a flat per-channel scale → (1, C, 1, 1). The int8 leaves of a JAX
`quantize_cvit` output (``kernel_q``, ``w_scale``, ``x_scale``) map to the
port's `QuantConv3x3` / `QuantLinear` buffers of the same names, with the
same layout transforms; ``kernel_q`` stays int8. The port's module tree
already uses the reference torch names, so a reference ``.pth`` needs no
map, only `load_reference_pth` (and, for S3D, `load_s3d_state_dict`), and
`export_state_dict` writes a model back out in that layout.

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


def t_od_weight(w: np.ndarray) -> np.ndarray:   # (kn, k, k, I, O) -> (kn, O, I, k, k)
    return np.transpose(w, (0, 4, 3, 1, 2))


def t_chan(w: np.ndarray) -> np.ndarray:        # (C,) -> (1, C, 1, 1)
    return np.asarray(w).reshape(1, -1, 1, 1)


_DECONV = {"cd": "conv1_1.conv", "hd": "conv1_2.conv", "vd": "conv1_3.conv",
           "ad": "conv1_4.conv", "std": "conv1_5"}
_GGCA = {"conv1": "0", "bn": "1", "conv2": "3"}
#: variants whose one stem is ``features`` (JAX's rule: every other name
#: means ``features1..3``; pass ``"single"`` for a one-stem zoo entry)
SINGLE_STEM = ("cvit", "single")
#: the flax module names of the zoo's blocks (``*_tok``: the token block)
BLOCKS = ("ggca", "bfm", "mdfa", "bfm_tok", "mdfa_tok", "odconv", "moga", "smfa", "uffc",
          "sla", "glu")
_PLAIN_LEAVES = ("kernel", "kernel_q", "w_scale", "x_scale", "scale", "bias", "mean", "var")


def _norm_key(base: str, col: str, leaf: str) -> Tuple[str, Callable]:
    """A BatchNorm's or LayerNorm's leaf under ``base``."""
    if col == "batch_stats":
        return f"{base}.running_{'mean' if leaf == 'mean' else 'var'}", t_id
    return (f"{base}.weight", t_id) if leaf == "scale" else (f"{base}.bias", t_id)


def _term(base: str, col: str, leaf: str, kernel_tf: Callable = t_conv) -> Tuple[str, Callable]:
    """A conv's or norm's leaf under ``base`` (JAX ``_term``)."""
    if col == "batch_stats" or leaf == "scale":
        return _norm_key(base, col, leaf)
    return _leaf(base, leaf, kernel_tf)


def cvit_torch_key(path, variant: str = "cvit") -> Tuple[str, Callable]:
    """flax variable path (``("params", "stem", "l0", "kernel")``) →
    (torch key, flax→torch transform), for every CViT registry entry — the
    port's copy of JAX `torch_weights._cvit_torch_key` (:69-157). A stem is
    ``features`` for a ``variant`` in `SINGLE_STEM`, else ``features1..3``;
    a DEConv's ``w_*``/``b_*`` leaves map to its branches (the hd/vd taps by
    `t_conv1d`); the zoo's stem ops and blocks as `_stem_op_key` and
    `_block_torch_key`; a LinearNorm's ``norm1`` (LayerNorm), ``norm2``
    (RepBN: ``alpha``, ``bn``) and its ``schedule`` counters
    ``warm``/``iter``."""
    col, rest = path[0], list(path[1:])
    leaf = rest[-1]
    if rest[0] in ("stem", "stem2", "stem3"):
        name = "features" if variant in SINGLE_STEM else \
            {"stem": "features1", "stem2": "features2", "stem3": "features3"}[rest[0]]
        base = f"{name}.{rest[1][1:]}"  # l{i} -> i
        m = re.match(r"^([wb])_(cd|hd|vd|ad|std)$", leaf)
        if m:
            key = f"{base}.{_DECONV[m.group(2)]}"
            if m.group(1) == "b":
                return f"{key}.bias", t_id
            return f"{key}.weight", t_conv1d if m.group(2) in ("hd", "vd") else t_conv
        if len(rest) == 3 and leaf in _PLAIN_LEAVES:   # a conv, qconv or bn
            return _term(base, col, leaf)
        return _stem_op_key(base, rest[2:], col, leaf)
    if rest[0] in BLOCKS:
        return _block_torch_key(rest[0], rest[1:], col, leaf)
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


_MDFA = {"b1_conv": "branch1.0", "b1_bn": "branch1.1", "b2_conv": "branch2.0",
         "b2_bn": "branch2.1", "b3_conv": "branch3.0", "b3_bn": "branch3.1",
         "b4_conv": "branch4.0", "b4_bn": "branch4.1", "b5_conv": "branch5_conv",
         "b5_bn": "branch5_bn", "cat_conv": "conv_cat.0", "cat_bn": "conv_cat.1"}
_HEBING = {"tongdao": "Hebing.tongdao.fc", "kongjian": "Hebing.kongjian.Conv1x1"}
_MOGA_VALUE = {"dw0": "DW_conv0", "dw1": "DW_conv1", "dw2": "DW_conv2", "pw": "PW_conv"}
_SMFA_LDE = {"conv0a": "conv_0.0", "conv0b": "conv_0.1", "conv1": "conv_1"}
_UFFC = {"conv_down": "conv_layer_down55", "conv_down_shift": "conv_layer_down55_shift"}
_OD_ATTENTION = ("fc", "bn", "channel_fc", "filter_fc", "spatial_fc", "kernel_fc")


def _block_torch_key(tname: str, rest, col: str, leaf: str) -> Tuple[str, Callable]:
    """A zoo block's flax sub-path → (torch key, transform) — JAX
    `torch_weights._block_torch_key` (:478-563). The torch module is the
    flax one's name without its ``_tok`` suffix."""
    kind, sub = tname.replace("_tok", ""), rest[0] if rest else None
    if kind == "ggca":
        return _term(f"ggca.shared_conv.{_GGCA[sub]}", col, leaf)
    if kind == "mdfa":
        if sub == "hebing":
            return _term(f"mdfa.{_HEBING[rest[1]]}", col, leaf)
        return _term(f"mdfa.{_MDFA[sub]}", col, leaf)
    if kind == "bfm":
        if sub.startswith("ms_conv"):
            i = {"3": "1", "5": "2", "7": "3"}[sub[-1]]
            return _term(f"bfm.multi_scale_extractor.conv{i}", col, leaf)
        inner = rest[1]                         # under tfam
        if inner.startswith("channel_conv"):
            return _term(f"bfm.tfam.channel_attention.{inner}", col, leaf, t_conv1d)
        return _term(f"bfm.tfam.spatial_attention.{inner}", col, leaf)
    if kind == "odconv":
        return _od_key("odconv", sub, col, leaf)
    if kind == "moga":
        if sub == "sigma":
            return "moga.sigma.scale", t_chan
        if sub == "value":
            return _term(f"moga.value.{_MOGA_VALUE[rest[1]]}", col, leaf)
        return _term(f"moga.{sub}", col, leaf)          # proj_1 / gate / proj_2
    if kind == "smfa":
        if sub in ("alpha", "belt"):
            return f"smfa.{sub}", t_chan
        if sub == "lde":
            return _term(f"smfa.lde.{_SMFA_LDE[rest[1]]}", col, leaf)
        return _term(f"smfa.{sub}", col, leaf)          # linear_0/1/2, dw_conv
    if kind == "uffc":
        if sub in ("locMap", "lambda_base"):
            return f"uffc.{sub}", t_id
        return _term(f"uffc.{_UFFC[sub]}", col, leaf)
    if kind == "sla":
        if sub == "positional_encoding":
            return "sla.positional_encoding", t_id
        return _term(f"sla.{sub}", col, leaf, t_conv if sub == "dwc" else t_dense)
    if kind == "glu":
        if sub == "dwconv":
            return _term("glu.dwconv.dwconv", col, leaf)
        return _leaf(f"glu.{sub}", leaf, t_dense)       # fc1 / fc2
    raise KeyError(f"no torch mapping for block {tname} / {rest}")


def _od_key(base: str, sub: str, col: str, leaf: str) -> Tuple[str, Callable]:
    """An ODConv2d's leaf: its candidate ``weight``, or its attention head."""
    if sub == "weight":
        return f"{base}.weight", t_od_weight
    if sub in _OD_ATTENTION:
        return _term(f"{base}.attention.{sub}", col, leaf)
    raise KeyError(f"no torch mapping for ODConv leaf {sub}")


def _stem_op_key(base: str, rest, col: str, leaf: str) -> Tuple[str, Callable]:
    """A zoo stem op's leaf under ``features*.{i}`` (scconv, wtconv, idw,
    od) — JAX `torch_weights._stem_op_key` (:566-596)."""
    sub = rest[0]
    if sub == "sru":
        return f"{base}.SRU.gn.{'weight' if leaf == 'gn_scale' else 'bias'}", t_id
    if sub == "cru":
        inner = {"gwc": "GWC", "pwc1": "PWC1", "pwc2": "PWC2"}.get(rest[1], rest[1])
        return _term(f"{base}.CRU.{inner}", col, leaf)
    if sub == "base_conv":
        return _term(f"{base}.base_conv", col, leaf)
    if sub == "base_scale":
        return f"{base}.base_scale.weight", t_chan
    if sub.startswith("wavelet_scale"):
        return f"{base}.wavelet_scale.{sub[len('wavelet_scale'):]}.weight", t_chan
    if sub.startswith("wavelet_conv"):
        return _term(f"{base}.wavelet_convs.{sub[len('wavelet_conv'):]}", col, leaf)
    if sub in ("dwconv_hw", "dwconv_w", "dwconv_h"):
        return _term(f"{base}.{sub}", col, leaf)
    return _od_key(base, sub, col, leaf)


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
    "kernel")``) → (torch key, flax→torch transform), for every op of the
    family and the head — the port's copy of
    `fac_fake_tpu/compat/torch_weights.py` ``_s3d_torch_key`` and its msca
    helpers (:234-336). ``base.{i}`` lines up with spec index i. The ctx
    LayerNorm keeps its (planes,) weight, as the port's `ChannelLayerNorm`
    does."""
    col, rest = path[0], list(path[1:])
    leaf = rest[-1]
    term = lambda base: _s3d_term(base, col, leaf)

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
    if op == "mscan_half":
        return _mscan_key(base, rest[1:], term)
    if op == "iformer":
        return _iformer_key(base, rest[1:], term)
    raise KeyError(f"no S3D mapping for flax path {path}")


def _s3d_term(base: str, col: str, leaf: str) -> Tuple[str, Callable]:
    """A conv, BatchNorm or LayerNorm leaf under ``base``."""
    if col == "batch_stats":
        return f"{base}.running_{'mean' if leaf == 'mean' else 'var'}", t_id
    if leaf == "kernel":
        return f"{base}.weight", t_conv3d
    return (f"{base}.weight", t_id) if leaf == "scale" else (f"{base}.bias", t_id)


# flax names → the reference's, in the msca blocks
_SPATIAL_ATTN = {"proj1": "proj_1", "proj2": "proj_2", "gate": "spatial_gating_unit"}
_IFORMER_MIXER = {"pool_fc": "maxpool_fc.1", "fc": "fc_dw.0", "bn": "fc_dw.2"}


def _dwsep_key(base: str, rest, term) -> Tuple[str, Callable]:
    """A DWSepConv3d's ``["sep", inner, leaf]``: its keys sit directly under
    the module (``conv_s``, ``conv_t``, ``bn_t``)."""
    return term(f"{base}.{rest[1]}")


def _spatial_attn_key(base: str, rest, term) -> Tuple[str, Callable]:
    """SpatialAttention3d: ``proj1``/``proj2`` 1×1 convs, and the gate's
    DWSepConv3d ``conv0``/``conv0_1``/``conv1_1`` and its 1×1 ``conv3``."""
    sub = f"{base}.{_SPATIAL_ATTN[rest[0]]}"
    if rest[0] != "gate":
        return term(sub)
    if rest[1] == "conv3":
        return term(f"{sub}.conv3")
    return _dwsep_key(f"{sub}.{rest[1]}", rest[2:], term)


def _mlp3d_key(base: str, rest, term) -> Tuple[str, Callable]:
    if rest[0] in ("fc1", "fc2"):
        return term(f"{base}.{rest[0]}")
    return _dwsep_key(f"{base}.dwconv.dwconv", rest[1:], term)      # rest[0] == "dw"


def _mscan_key(base: str, rest, term) -> Tuple[str, Callable]:
    if rest[0] in ("norm1", "norm2"):
        return term(f"{base}.{rest[0]}")
    if rest[0] == "attn":
        return _spatial_attn_key(f"{base}.attn", rest[1:], term)
    if rest[0] == "mlp":
        return _mlp3d_key(f"{base}.mlp", rest[1:], term)
    raise KeyError(f"no torch mapping for MSCAN path {rest}")


def _iformer_key(base: str, rest, term) -> Tuple[str, Callable]:
    if rest[0] in ("norm1", "norm2"):
        return term(f"{base}.{rest[0]}")
    if rest[0] == "mlp":
        return _mlp3d_key(f"{base}.mlp", rest[1:], term)
    if rest[0] != "mixer":
        raise KeyError(f"no torch mapping for iFormer path {rest}")
    mix, sub = f"{base}.inceptionmixer", rest[1]
    if sub in ("pool_fc", "fc"):                # BasicConv3d: .../{conv,bn}/leaf
        return term(f"{mix}.{_IFORMER_MIXER[sub]}.{rest[2]}")
    if sub == "bn":
        return term(f"{mix}.{_IFORMER_MIXER[sub]}")
    if sub == "dw":
        return _dwsep_key(f"{mix}.fc_dw.1", rest[2:], term)
    if sub == "attn":
        return _spatial_attn_key(f"{mix}.attn", rest[2:], term)
    raise KeyError(f"no torch mapping for iFormer path {rest}")


def _from_flax(flat: Mapping[str, np.ndarray], key_fn) -> Dict[str, torch.Tensor]:
    """Flat ``"col/…/leaf"`` flax variables → a float32 state_dict through
    ``key_fn(path) -> (torch key, transform)``."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in flat.items():
        key, tf = key_fn(k.split("/"))
        out[key] = torch.from_numpy(np.array(tf(np.asarray(v, np.float32)), order="C"))
    return out


def s3d_state_dict_from_flax(flat: Mapping[str, np.ndarray], spec) -> Dict[str, torch.Tensor]:
    """JAX S3DNet variables flattened to ``"params/l0/conv_s/kernel"``-style
    keys → the port's S3DNet state_dict (float32)."""
    return _from_flax(flat, lambda path: s3d_torch_key(path, spec))


_RESNET_BLOCK_RE = re.compile(r"^layer(\d+)_(\d+)$")


def resnet_torch_key(rest, col: str, prefix: str = "") -> Tuple[str, Callable]:
    """A flax ResNet path below the ResNet module (``["layer1_0", "conv1",
    "kernel"]``) → (torch key, transform): the port's copy of JAX
    `torch_weights._resnet_key` (:361-387). ``conv1``/``channel`` and every
    block conv → ``.weight`` (HWIO → OIHW), ``bn1``/``bn2`` and the block
    BNs as BatchNorms, ``ds_conv``/``ds_bn`` → ``downsample.{0,1}``."""
    sub, leaf = rest[0], rest[-1]

    def term(base: str, is_conv: bool) -> Tuple[str, Callable]:
        return (f"{base}.weight", t_conv) if is_conv else _norm_key(base, col, leaf)

    if sub in ("conv1", "channel"):
        return term(f"{prefix}{sub}", True)
    if sub in ("bn1", "bn2"):
        return term(f"{prefix}{sub}", False)
    m = _RESNET_BLOCK_RE.match(sub)
    if m is None:
        raise KeyError(f"no torch mapping for ResNet path {rest}")
    block = f"{prefix}layer{m.group(1)}.{m.group(2)}"
    inner = rest[1]
    if inner == "ds_conv":
        return term(f"{block}.downsample.0", True)
    if inner == "ds_bn":
        return term(f"{block}.downsample.1", False)
    return term(f"{block}.{inner}", inner.startswith("conv"))


def kan_torch_key(rest, col: str, prefix: str) -> Tuple[str, Callable]:
    """A flax KAN path below the KAN module (``["layer0", "base_weight"]``,
    or ``["layer0", "grid"]`` in the ``kan_grid`` collection) → (torch key,
    identity): JAX `torch_weights._kan_key` (:390-396); JAX keeps torch's
    (out, in, …) layouts."""
    m = re.match(r"^layer(\d+)$", rest[0])
    if m is None:
        raise KeyError(f"no torch mapping for KAN path {rest}")
    return f"{prefix}.layers.{m.group(1)}.{'grid' if col == 'kan_grid' else rest[-1]}", t_id


def reskan_state_dict_from_flax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX ``reskan`` variables flattened to ``"params/resnet/conv1/kernel"``-
    style keys (``params``, ``batch_stats``, ``kan_grid``) → the port's
    `ResKan` state_dict, the reference's ``kan_resnet.py`` keys: the inverse
    of JAX `convert_reskan`."""
    def key_fn(path):
        col, rest = path[0], path[1:]
        if rest[0] == "resnet":
            return resnet_torch_key(rest[1:], col)
        if rest[0] == "kan":
            return kan_torch_key(rest[1:], col, "kan")
        raise KeyError(f"no torch mapping for reskan path {path}")
    return _from_flax(flat, key_fn)


def resvitkan_state_dict_from_flax(flat: Mapping[str, np.ndarray],
                                   head: str = "kan") -> Dict[str, torch.Tensor]:
    """JAX ``resvitkan`` (``head="kan"``) or ``resvit`` (``head="mlp"``)
    variables, flattened as `reskan_state_dict_from_flax`'s → the port's
    `ResVitKan` state_dict, the reference's keys: the inverse of JAX
    `convert_resvitkan` (:426-451). ``features.`` the ResNet; the
    transformer through `cvit_torch_key`; ``{kan,mlp}_head.0`` the fc,
    ``mlp_head.3`` the output, ``kan_head.3.layers.{i}`` the KAN."""
    if head not in ("kan", "mlp"):
        raise ValueError(f"head {head!r}: expected kan or mlp")
    hname = f"{head}_head"

    def key_fn(path):
        col, rest = path[0], path[1:]
        leaf = rest[-1]
        if rest[0] == "features":
            return resnet_torch_key(rest[1:], col, "features.")
        if rest[0] == "transformer":
            return cvit_torch_key(path, "cvit")
        if rest in (["pos_embedding"], ["cls_token"]):
            return rest[0], t_id
        if rest[0] in ("patch_to_embedding", "head_fc", "head_out"):
            base = {"patch_to_embedding": "patch_to_embedding", "head_fc": f"{hname}.0",
                    "head_out": f"{hname}.3"}[rest[0]]
            return _leaf(base, leaf, t_dense)
        if rest[0] == "head_kan":
            return kan_torch_key(rest[1:], col, f"{hname}.3")
        raise KeyError(f"no torch mapping for resvitkan path {path}")
    return _from_flax(flat, key_fn)


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


def export_state_dict(model) -> Dict[str, torch.Tensor]:
    """The reference-layout ``state_dict`` of a CViT-family model, as CPU
    tensors: the port's modules carry the reference's keys, so it is the
    model's own ``state_dict`` without BatchNorm's ``num_batches_tracked``,
    which JAX's `export_cvit` does not write either (torch fills it in on a
    strict load). It loads into the reference's models and, ``strict=True``,
    into the port's (`load_reference_pth`)."""
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


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
