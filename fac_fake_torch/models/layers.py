"""Model building blocks of the base CViT — the port of the parts of
`fac_fake_tpu/models/layers.py` that base ``cvit`` uses.

Module and attribute names mirror the reference torch CViT
(`CViT-main/model/cvit.py:5-78`), so a reference ``.pth`` and the JAX
package's `export_cvit` output both load with ``strict=True``:
``transformer.layers.{i}.0.fn.norm`` / ``.0.fn.fn.to_qkv`` /
``.1.fn.fn.net.{0,2}``. Eval-mode only: BatchNorm uses its running stats.

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
from torch import nn

from fac_fake_torch.ops import preprocess, quant, quant3d

# torch BatchNorm defaults, as the JAX package's TorchBatchNorm
BN_EPS = 1e-5
LN_EPS = 1e-5


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=1, padding=1, bias=True)


def batch_norm(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS)


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
    return nn.Linear(in_features, out_features, bias=bias)


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
        dots = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        attn = torch.softmax(dots.float(), dim=-1).to(v.dtype)
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


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class TransformerEncoder(nn.Module):
    """depth × (PreNorm-Attention + PreNorm-FFN) with residuals
    (`model/cvit.py:64-78`), the ``ffn_norm="ln"`` branch."""

    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int,
                 ffn_norm: str = "ln", quant: bool = False):
        super().__init__()
        if ffn_norm != "ln":
            raise NotImplementedError(
                f"ffn_norm={ffn_norm!r} (LinearNorm/RepBN) is ROADMAP queue 1 "
                "item 4, the flagship slice")
        self.layers = nn.ModuleList(
            nn.ModuleList([Residual(PreNorm(dim, MultiHeadSelfAttention(dim, heads, quant))),
                           Residual(PreNorm(dim, FeedForward(dim, mlp_dim, quant)))])
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
                         nn.Linear(mlp_dim, num_classes))
