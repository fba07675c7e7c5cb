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
advances the activations with the fp convs. On the variant zoo's stems
that op is the first mixer (scconv, wtconv, idw, od): the stem's int8 walk
then ends in a conv that writes fp32 and the rest runs as modules
(`models/stems.py`). Folded, such a stem keeps the BN after each mixer
(nothing to fold it into). The JAX package's `quantize_cvit` refuses any
stem that holds a BN, so it cannot serve those four entries in int8; the
port refuses only a stem that is not folded (a BN right after a conv, or
a deconv left). Every stem quantizes (the
flagship's ``features1`` and ``features2``), each calibrated from its own
fp input: a later stem's comes from one fp forward of the folded model,
read by a forward pre-hook where JAX reads its ``stem2_input`` sow. With
``transformer=True`` the patch embedding, every attention
``to_qkv``/``to_out``, every FFN ``net.0``/``net.2`` and the head's
``mlp_head.0`` quantize too; their input ranges come from the same
forward. LayerNorm, LinearNorm, GGCA, softmax and the 2-logit output stay
fp.

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


def _folded(spec: Tuple) -> bool:
    """No deconv left and no BN right after a conv (`compat/fold.py` folds
    those; a BN after a zoo mixer stays)."""
    return not any(op[0] == "deconv" or (op[0] == "conv" and nxt[0] == "bn")
                   for op, nxt in zip(spec, tuple(spec[1:]) + (("",),)))


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
def _capture_inputs(model, calib_x: torch.Tensor, whole: List[str],
                    amax: List[str]) -> Dict[str, torch.Tensor]:
    """One fp forward; the input of each module named in ``whole`` and the
    absolute maximum of the input of each named in ``amax``."""
    seen: Dict[str, torch.Tensor] = {}
    hooks = []
    for name in whole + amax:
        def hook(_mod, args, name=name, keep=name in whole):
            x = args[0].detach()
            seen[name] = x if keep else x.abs().amax()
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
    return seen


@torch.no_grad()
def quantize_cvit(model, calib_x: torch.Tensor, transformer: bool = False):
    """A new CViT (on the model's device, eval mode, ``channels_last``) with
    each stem's conv prefix as `QuantConv3x3` and, with ``transformer``, the
    big denses as `QuantLinear`. ``calib_x`` is a normalized NCHW batch,
    what the model's forward takes. The model must be BN-folded
    (`compat/fold.py`); the model itself is not changed."""
    from fac_fake_torch.models.cvit import CViT

    if not isinstance(model, CViT):
        raise ValueError(f"{type(model).__name__} has no foldable stem to quantize")
    stems = model.stems()
    if not all(_folded(model.config[field]) for field, _, _ in stems):
        raise ValueError("quantize_cvit expects a folded stem (run fold_cvit first)")
    plans = {name: _plan_stem(model.config[field]) for field, name, _ in stems}
    if not any(q_idx for _, q_idx in plans.values()) and not transformer:
        return model
    calib_x = calib_x.float()
    dense = _dense_names(model) if transformer else []
    # the later stems' inputs, and the denses', from one fp forward
    later = [name for _, name, _ in stems[1:] if plans[name][1]]
    inputs = _capture_inputs(model, calib_x, later, dense) if later or dense else {}
    inputs[stems[0][1]] = calib_x

    sd = dict(model.state_dict())
    config = dict(model.config, quant_dense=transformer or model.quant_dense)
    for field, name, _ in stems:
        new_spec, q_idx = plans[name]
        if not q_idx:
            continue
        pre = f"{name}."
        own = {k[len(pre):]: sd.pop(k) for k in list(sd) if k.startswith(pre)}
        own = _rewrite_stem(model.config[field], own, inputs[name].float(), q_idx)
        sd.update({pre + k: v for k, v in own.items()})
        config[field] = new_spec
    for name in dense:
        w_q, s_w = _weight_q(sd.pop(f"{name}.weight"), (1,))
        sd.update({f"{name}.kernel_q": w_q, f"{name}.w_scale": s_w,
                   f"{name}.x_scale": _act_scale(inputs[name])})
        if f"{name}.bias" in sd:
            sd[f"{name}.bias"] = sd[f"{name}.bias"].float()

    with torch.device("meta"):
        qmodel = CViT(**config)
    qmodel = qmodel.to_empty(device=model.cls_token.device)
    qmodel.load_state_dict(sd, strict=True)
    return qmodel.to(memory_format=torch.channels_last).eval()
