"""Model building blocks of the CViT — the port of the parts of
`fac_fake_tpu/models/layers.py` that base ``cvit`` and the flagship
``cvit_repbn8`` use.

Module and attribute names mirror the reference torch CViT
(`CViT-main/model/cvit.py:5-78`), so a reference ``.pth`` and the JAX
package's `export_cvit` output both load with ``strict=True``:
``transformer.layers.{i}.0.fn.norm`` / ``.0.fn.fn.to_qkv`` /
``.1.fn.fn.net.{0,2}``. In eval, BatchNorm uses its running stats; in
training (`train/trainer.py`) it normalizes by the batch's statistics and
updates its running ones as the JAX package does (`BatchNorm2d`), and
`LinearNorm` runs its schedule's blend.

Precision follows JAX's ``dtype=bfloat16`` modules, with fp32 master
parameters: `Linear`, `Conv1d`, `Conv2d`, `Conv3d` compute in their input's dtype
(the weights cast to it, as flax's ``Dense``/``Conv`` cast theirs), so a
bf16 input keeps the model in bf16; `LayerNorm` normalizes in fp32 and
rounds once to its input's dtype (flax's ``LayerNorm(dtype=bf16)``); the
BatchNorms take JAX's bf16 fast path for a bf16 input (`_FlaxRunningStats`);
attention scores are fp32 (JAX's ``preferred_element_type``). An fp32 input
runs exactly the fp32 ops it ran before: every cast is then a no-op.

`QuantConv3x3` and `QuantLinear` are the int8 post-training-quantized
layers (`fac_fake_tpu/models/layers.py` `QuantConv3x3`, `QuantDense`):
buffers only, written by `compat/quantize.py`, run by kernels K3 and K4
(`ops/quant.py`). `quant_linear` swaps one in under the same attribute
name, so state-dict paths keep the reference names
(``transformer.layers.{i}.0.fn.fn.to_qkv.kernel_q``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fac_fake_torch.ops import preprocess, quant, quant3d

# torch BatchNorm defaults, as the JAX package's TorchBatchNorm
BN_EPS = 1e-5
LN_EPS = 1e-5
LINEAR_NORM_EPS = 1e-6   # the reference's partial(nn.LayerNorm, eps=1e-6)
LINEAR_NORM_STEPS = 300000   # LinearNorm's total_step, the blend's length


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in at least fp32: a bf16 tensor in fp32, fp32 and float64 as
    they are."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype (flax ``Dense(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` in its input's dtype (flax ``Conv(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype (flax ``Conv(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` in its input's dtype (flax ``Conv(dtype=...)``). A bf16
    input on the CPU, and a grouped (depthwise) conv's bf16 input on the
    card, convolve its values and the bf16 weights in fp32 and round once,
    which is what a bf16 conv computes: torch's CPU bf16 conv3d returns
    garbage weight gradients at some shapes (a (3, 1, 1) conv over 2 frames
    of 2×2 maps, not in ``channels_last_3d``: NaN or 1e33), and cuDNN's bf16
    grouped 3D convs made the msca family's bf16 train step 3.3× slower than
    its fp32 one on an H100 (PERF.md §6)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), _cast(self.bias, x.dtype)
        if x.dtype == torch.bfloat16 and (x.device.type == "cpu" or self.groups > 1):
            return self._conv_forward(x.float(), w.float(), _cast(b, torch.float32)).to(x.dtype)
        return self._conv_forward(x, w, b)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in fp32 and rounded once to its input's
    dtype (flax ``LayerNorm(dtype=...)``: its statistics and normalize
    promote to fp32)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(widen(x), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class MaxOver(nn.Module):
    """``x.amax(dims, keepdim=True)``. A module, as `nn.MaxPool2d` is, so
    that a check holding two devices' training steps together can make one
    take the other's argmax (`chip_smoke.py` `_route_pools`): two values
    within rounding of each other can win on one device and lose on the
    other, and the gradient then goes to another element."""

    def __init__(self, *dims: int):
        super().__init__()
        self.dims = dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(self.dims, keepdim=True)


class Clip(nn.Module):
    """``x.clamp(lo, hi)``, a module for the same reason as `MaxOver`: a
    value within rounding of a bound is clipped on one device and not on
    the other, and its gradient then goes to the bound."""

    def forward(self, x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, lo, hi)


def conv3x3(cin: int, cout: int) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=1, padding=1, bias=True)


class FlatLoad:
    """A module mixin: each parameter named in ``_flat`` also loads from a
    state-dict tensor of another shape with as many values, reshaped. The
    reference keeps a per-channel scale as (1, C, 1, 1) (as does the port);
    the JAX package's `export_cvit` writes it as flax holds it, (C,), since
    its inverse transforms know no reshape."""

    _flat: tuple = ()

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in self._flat:
            key, p = prefix + name, getattr(self, name)
            t = state_dict.get(key)
            if t is not None and t.shape != p.shape and t.numel() == p.numel():
                state_dict[key] = t.reshape(p.shape)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class _FlaxRunningStats:
    """A torch BatchNorm whose training forward updates the running stats
    with flax's rule (JAX `models/layers.py:78-84`, stock flax in fp32):
    ``ra ← 0.9·ra + 0.1·stat`` with the *biased* batch variance, where
    torch's own BatchNorm takes the unbiased one. At RepBN's 2·B values a
    channel the two differ by 2B/(2B−1). Flax's decay 0.9 is torch's
    momentum 0.1. The forward is torch's fused batch norm; the running
    variance it wrote is then brought back to the biased rule on the C
    channels, so no second pass reads the activations.

    A bf16 input takes JAX's bf16 fast path (`Bf16FastBatchNorm`,
    JAX `models/layers.py:45-88`, `_bf16`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            return self._bf16(x)
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]          # values a channel
        # batch_norm updates these copies in place and saves them for its
        # backward, so the buffers themselves are written after it
        mean, var = self.running_mean.clone(), self.running_var.clone()
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, self.momentum, self.eps)
        with torch.no_grad():
            # var = keep + m·v·n/(n−1) now, for the batch's biased variance v;
            # flax's is keep + m·v
            keep = (1.0 - self.momentum) * self.running_var
            self.running_var.copy_(keep + (var - keep) * ((n - 1) / n))
            self.running_mean.copy_(mean)
            self.num_batches_tracked.add_(1)
        return out

    def _bf16(self, x: torch.Tensor) -> torch.Tensor:
        """JAX's bf16 fast path: the batch's mean and biased variance from
        ``x.float()`` (one fp32 reduction; JAX forms ``max(E[x²] − mean², 0)``,
        which agrees but for its rounding), the running stats updated in
        fp32 by flax's rule; then ``w = scale·rsqrt(var + eps)`` and ``b =
        bias − mean·w`` in fp32, and the output ``x·bf16(w) + bf16(b)`` in
        bf16, the product and the sum each rounded, as JAX's: a small cvit's
        bf16 gradient is 4.9% from JAX's this way, 82% with one fused
        rounding (`tests/test_torch_bf16.py`). In eval, the running stats."""
        red = [0, *range(2, x.dim())]
        if self.training:
            var, mean = torch.var_mean(x.float(), red, correction=0)
            with torch.no_grad():
                keep = 1.0 - self.momentum          # flax's decay
                self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
                self.running_var.copy_(keep * self.running_var + self.momentum * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        w = self.weight * torch.rsqrt(var + self.eps)
        b = self.bias - mean * w
        view = (1, -1) + (1,) * (x.dim() - 2)
        return x * w.to(x.dtype).view(view) + b.to(x.dtype).view(view)


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    pass


class BatchNorm1d(_FlaxRunningStats, nn.BatchNorm1d):
    pass


def batch_norm(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=BN_EPS)


class QuantConv3x3(nn.Module):
    """int8 3×3 pad-1 conv (inference only): ``kernel_q`` int8 (O, I, 3, 3),
    per-output-channel ``w_scale``, per-tensor ``x_scale`` (0-d), fp32
    ``bias``. NCHW in, NCHW ``channels_last`` out, in the input's dtype.

    K3's derived tensors are non-persistent buffers made from those: ``w_k``
    (`quant.conv3x3_rows`) and ``s = x_scale · w_scale``, made again after
    every ``load_state_dict``. `quantize` (or, from uint8 crops,
    `quantize_crops`) and `walk` are the steps of the stem's int8 walk
    (`models/stems.py`)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.register_buffer("kernel_q", torch.zeros((cout, cin, 3, 3), dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(cout))
        self.register_buffer("x_scale", torch.ones(()))
        self.register_buffer("bias", torch.zeros(cout))
        self._derive()

    def _derive(self) -> None:
        self.register_buffer("w_k", quant.conv3x3_rows(self.kernel_q), persistent=False)
        self.register_buffer("s", self.x_scale * self.w_scale, persistent=False)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        with torch.no_grad():
            self._derive()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant.quant_conv3x3(x, self.kernel_q, self.w_scale, self.x_scale, self.bias,
                                   self.w_k, self.s)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW fp → this conv's int8 NHWC input (K3's quantize pass)."""
        return quant3d.quantize_pad(x.permute(0, 2, 3, 1).contiguous(), self.x_scale)

    def quantize_crops(self, crops_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """uint8 NHWC crops → this conv's int8 NHWC input, normalized in
        ``dtype`` and quantized in one pass (K2's int8 entry)."""
        return preprocess.quantize_crops(crops_u8, self.x_scale, dtype)

    def walk(self, xq: torch.Tensor, relu: bool, dtype: torch.dtype,
             q_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """int8 NHWC in → NHWC in ``dtype``, or with ``q_scale`` the next
        conv's int8 input (`quant.int8_conv3x3`)."""
        return quant.int8_conv3x3(xq, self.kernel_q, self.s, self.bias, relu, dtype, q_scale,
                                  self.w_k)


class QuantLinear(nn.Module):
    """int8 dense (inference only): ``kernel_q`` int8 (out, in), as
    ``nn.Linear.weight``; ``w_scale``, ``x_scale`` and the optional
    ``bias`` as in `QuantConv3x3`. (..., in) → (..., out)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.register_buffer("kernel_q", torch.zeros((out_features, in_features),
                                                     dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(out_features))
        self.register_buffer("x_scale", torch.ones(()))
        self.register_buffer("bias", torch.zeros(out_features) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant.quant_dense(x, self.kernel_q, self.w_scale, self.x_scale, self.bias)


def quant_linear(in_features: int, out_features: int, quant: bool,
                 bias: bool = True) -> nn.Module:
    """``nn.Linear``, or its int8 twin when ``quant`` (JAX `dense(quant=)`)."""
    if quant:
        return QuantLinear(in_features, out_features, bias)
    return Linear(in_features, out_features, bias=bias)


class MultiHeadSelfAttention(nn.Module):
    """Reference CViT attention (`model/cvit.py:34-62`). Quirk kept: the
    softmax scale is ``dim ** -0.5`` on the model dimension, not the head
    dimension; qkv unpacks as ``(b, n, 3, h, head_dim)``."""

    def __init__(self, dim: int, heads: int = 8, quant: bool = False):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.scale = dim ** -0.5
        self.to_qkv = quant_linear(dim, dim * 3, quant, bias=False)
        self.to_out = quant_linear(dim, dim, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h = self.heads
        qkv = self.to_qkv(x).reshape(b, n, 3, h, self.dim // h)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (b, h, n, hd)
        # fp32 scores, as JAX's einsum(preferred_element_type=float32)
        dots = torch.matmul(widen(q), widen(k).transpose(-1, -2)) * self.scale
        attn = torch.softmax(dots, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, self.dim)
        return self.to_out(out)


class FeedForward(nn.Module):
    """dim → hidden (exact GELU) → dim (`model/cvit.py:22-32`)."""

    def __init__(self, dim: int, hidden_dim: int, quant: bool = False):
        super().__init__()
        self.net = nn.Sequential(quant_linear(dim, hidden_dim, quant), nn.GELU(),
                                 quant_linear(hidden_dim, dim, quant))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fn(x)


class RepBN(nn.Module):
    """Re-parameterizable BatchNorm over the token sequence,
    ``BN1d(xᵀ)ᵀ + α·x`` (`cvit_GGCA_ADD_DEConv_RepBn8.py:9-19`): the model
    dim is the BN's channels, normalized over (batch, tokens)."""

    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(1))
        self.bn = BatchNorm1d(dim, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x.transpose(1, 2)).transpose(1, 2) + self.alpha * x


class LinearNorm(nn.Module):
    """The schedule-blended LayerNorm → RepBN of the RepBN variants
    (`cvit_GGCA_ADD_DEConv_RepBn8.py:22-46`, JAX `models/layers.py:266-305`).
    In eval it is ``norm1`` alone, a LayerNorm with eps 1e-6. In training,
    with ``λ = iter / LINEAR_NORM_STEPS``: ``norm1(x)`` while ``warm > 0``,
    else ``λ·norm1(x) + (1−λ)·norm2(x)``; ``norm2`` (RepBN) runs, and its
    stats move, either way. After each training forward the counters tick:
    ``warm`` down to 0, then ``iter`` down to 0. Both are read and written
    on the tensors' device, so a training step never waits on the host.
    They start at ``warm`` 0 and ``iter`` `LINEAR_NORM_STEPS` (λ = 1)."""

    def __init__(self, dim: int):
        super().__init__()
        self.register_buffer("warm", torch.tensor(0))
        self.register_buffer("iter", torch.tensor(LINEAR_NORM_STEPS))
        self.norm1 = LayerNorm(dim, eps=LINEAR_NORM_EPS)
        self.norm2 = RepBN(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.norm1(x)
        if not self.training:
            return x1
        x2 = self.norm2(x)
        in_warmup = self.warm > 0
        lam = self.iter.float() / float(LINEAR_NORM_STEPS)
        # JAX's promotions: the fp32 λ blends in fp32 (RepBN's α·x is fp32
        # too); its one reader, the FFN's first dense, casts to x's dtype
        out = torch.where(in_warmup, x1, lam * widen(x1) + (1.0 - lam) * x2)
        with torch.no_grad():
            self.warm.copy_(torch.where(in_warmup, self.warm - 1, self.warm))
            self.iter.copy_(torch.where(~in_warmup & (self.iter > 0), self.iter - 1, self.iter))
        return out.to(x.dtype)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module, norm: Optional[nn.Module] = None):
        super().__init__()
        self.norm = LayerNorm(dim, eps=LN_EPS) if norm is None else norm
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class TransformerEncoder(nn.Module):
    """depth × (PreNorm-Attention + PreNorm-FFN) with residuals
    (`model/cvit.py:64-78`). ``ffn_norm="linearnorm"`` (the RepBN variants,
    `cvit_GGCA_ADD_DEConv_RepBn8.py:126-134`) takes `LinearNorm` for the
    FFN's pre-norm; the attention keeps its LayerNorm."""

    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int,
                 ffn_norm: str = "ln", quant: bool = False):
        super().__init__()
        if ffn_norm not in ("ln", "linearnorm"):
            raise ValueError(f"unknown ffn_norm {ffn_norm!r}")
        ffn_pre = lambda: LinearNorm(dim) if ffn_norm == "linearnorm" else None
        self.layers = nn.ModuleList(
            nn.ModuleList([Residual(PreNorm(dim, MultiHeadSelfAttention(dim, heads, quant))),
                           Residual(PreNorm(dim, FeedForward(dim, mlp_dim, quant), ffn_pre()))])
            for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for attn, ffn in self.layers:
            x = ffn(attn(x))
        return x


def mlp_head(dim: int, mlp_dim: int, num_classes: int,
             quant: bool = False) -> nn.Sequential:
    """dim → mlp_dim (ReLU) → num_classes (`model/cvit.py:161-165`). Under
    ``quant`` only the first layer is int8; the 2-logit output stays fp."""
    return nn.Sequential(quant_linear(dim, mlp_dim, quant), nn.ReLU(),
                         Linear(mlp_dim, num_classes))
