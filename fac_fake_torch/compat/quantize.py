"""Post-training int8 quantization of a folded CViT (inference only) — the
port of `fac_fake_tpu/compat/quantize.py`.

Scheme, as in the JAX package:
  * weights: symmetric per-output-channel int8,
    ``s_w = max(max|w| / 127, 1e-12)``, ``w_q = clip(round(w / s_w), ±127)``
    (round half to even);
  * activations: symmetric per-tensor int8, ``s_x = max(amax, 1e-8) / 127``
    from the calibration batch's absolute maximum at the layer's input;
  * compute: kernels K3 / K4 (`ops/quant.py`), int32 accumulation, dequant
    ``· s_x·s_w[o] + b`` in the epilogue.

Only the plain conv/relu/pool prefix of a folded stem quantizes: the first
other op ends it, because the calibration walk models only those ops and
advances the activations with the fp convs. With ``transformer=True`` the
patch embedding, every attention ``to_qkv``/``to_out``, every FFN
``net.0``/``net.2`` and the head's ``mlp_head.0`` quantize too; their input
ranges come from one fp forward, read by forward pre-hooks where JAX reads
its ``sow`` taps. LayerNorm, softmax and the 2-logit output stay fp.

    model = fold_cvit(model)
    qmodel = quantize_cvit(model, calib_x, transformer=True)
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

_SIMPLE = {"conv", "relu", "pool"}


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as an IEEE division on ``a``'s device (CUDA turns division
    by a Python scalar into a multiply by its reciprocal)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _act_scale(amax: torch.Tensor) -> torch.Tensor:
    return _div(torch.clamp_min(amax.float(), 1e-8), 127.0)


def _weight_q(w: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel (dim 0) scale and int8 weights."""
    w = w.float()
    s_w = torch.clamp_min(_div(w.abs().amax(dim=dims), 127.0), 1e-12)
    shape = (-1,) + (1,) * (w.dim() - 1)
    w_q = torch.clamp(torch.round(w / s_w.reshape(shape)), -127, 127).to(torch.int8)
    return w_q, s_w


def _plan_stem(spec: Tuple) -> Tuple[Tuple, List[int]]:
    """(new_spec, indices of quantized convs) — value-free."""
    new_spec = []
    q_idx: List[int] = []
    prefix = True
    for i, op in enumerate(spec):
        kind = op[0]
        if prefix and kind not in _SIMPLE:
            prefix = False
        if prefix and kind == "conv":
            new_spec.append(("qconv", op[1]))
            q_idx.append(i)
        else:
            new_spec.append(op)
    return tuple(new_spec), q_idx


def _rewrite_stem(spec: Tuple, sd: Dict[str, torch.Tensor], calib_x: torch.Tensor,
                  q_idx: List[int]) -> Dict[str, torch.Tensor]:
    """The stem's own state dict (``"{i}.weight"``, …) with int8 kernels and
    calibrated scales for the planned convs. ``calib_x`` is the stem's NCHW
    input; the activations advance with the fp weights."""
    new_sd = dict(sd)
    x = calib_x.float()
    for i, op in enumerate(spec):
        kind = op[0]
        if i in q_idx:
            w = sd[f"{i}.weight"].float()
            b = sd[f"{i}.bias"].float()
            w_q, s_w = _weight_q(w, (1, 2, 3))
            del new_sd[f"{i}.weight"]
            new_sd.update({f"{i}.kernel_q": w_q, f"{i}.w_scale": s_w,
                           f"{i}.x_scale": _act_scale(x.abs().amax()), f"{i}.bias": b})
            x = F.conv2d(x, w, b, padding=1)
        elif kind == "relu":
            x = torch.relu(x)
        elif kind == "pool":
            x = F.max_pool2d(x, 2, 2)
        else:
            break  # the first non-simple op ends the modeled prefix
    return new_sd


def quantize_stem(spec: Tuple, sd: Dict[str, torch.Tensor], calib_x: torch.Tensor):
    """Quantize the conv/relu/pool prefix of a folded stem. Returns
    (new_spec, new_sd, n_quantized)."""
    new_spec, q_idx = _plan_stem(spec)
    if not q_idx:
        return tuple(spec), dict(sd), 0
    return new_spec, _rewrite_stem(spec, sd, calib_x, q_idx), len(q_idx)


def _dense_names(model) -> List[str]:
    """The ``nn.Linear``s that ``transformer=True`` quantizes."""
    names = ["patch_to_embedding"]
    for i in range(len(model.transformer.layers)):
        names += [f"transformer.layers.{i}.0.fn.fn.to_qkv",
                  f"transformer.layers.{i}.0.fn.fn.to_out",
                  f"transformer.layers.{i}.1.fn.fn.net.0",
                  f"transformer.layers.{i}.1.fn.fn.net.2"]
    return names + ["mlp_head.0"]


@torch.no_grad()
def _capture_amax(model, calib_x: torch.Tensor, names: List[str]) -> Dict[str, torch.Tensor]:
    """One fp forward; the absolute maximum of each named module's input."""
    amax: Dict[str, torch.Tensor] = {}
    hooks = []
    for name in names:
        def hook(_mod, args, name=name):
            amax[name] = args[0].detach().abs().amax().float()
        hooks.append(model.get_submodule(name).register_forward_pre_hook(hook))
    kw = {}
    if model.pos_mode == "legacy":
        # the legacy (32, 1, dim) pos-embedding caps batch at 32; the capture
        # forward only needs activations, so any row assignment works
        kw["pos_indices"] = torch.arange(calib_x.shape[0], device=calib_x.device) % 32
    try:
        model(calib_x, **kw)
    finally:
        for h in hooks:
            h.remove()
    return amax


@torch.no_grad()
def quantize_cvit(model, calib_x: torch.Tensor, transformer: bool = False):
    """A new CViT (on the model's device, eval mode, ``channels_last``) with
    the stem's conv prefix as `QuantConv3x3` and, with ``transformer``, the
    big denses as `QuantLinear`. ``calib_x`` is a normalized NCHW batch,
    what the model's forward takes. The model must be BN-folded
    (`compat/fold.py`); the model itself is not changed."""
    from fac_fake_torch.models.cvit import CViT

    spec = getattr(model, "stem_spec", None)
    if spec is None:
        raise ValueError("model has no foldable stem to quantize")
    if any(op[0] == "bn" for op in spec):
        raise ValueError("quantize_cvit expects a folded stem (run fold_cvit first)")
    calib_x = calib_x.float()
    sd = dict(model.state_dict())
    stem = {k[len("features."):]: v for k, v in sd.items() if k.startswith("features.")}
    new_spec, stem, n_q = quantize_stem(spec, stem, calib_x)
    if n_q == 0 and not transformer:
        return model

    if transformer:
        names = _dense_names(model)
        amax = _capture_amax(model, calib_x, names)
        for name in names:
            w_q, s_w = _weight_q(sd.pop(f"{name}.weight"), (1,))
            sd.update({f"{name}.kernel_q": w_q, f"{name}.w_scale": s_w,
                       f"{name}.x_scale": _act_scale(amax[name])})
            if f"{name}.bias" in sd:
                sd[f"{name}.bias"] = sd[f"{name}.bias"].float()
    sd = {k: v for k, v in sd.items() if not k.startswith("features.")}
    sd.update({f"features.{k}": v for k, v in stem.items()})

    with torch.device("meta"):
        qmodel = CViT(**{**model.config, "stem_spec": new_spec,
                         "quant_dense": transformer or model.quant_dense})
    qmodel = qmodel.to_empty(device=model.cls_token.device)
    qmodel.load_state_dict(sd, strict=True)
    return qmodel.to(memory_format=torch.channels_last).eval()
