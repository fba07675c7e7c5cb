"""int8 post-training-quantized conv and dense — kernels K3 and K4, the
port of `fac_fake_tpu/models/layers.py` `QuantConv3x3` and `QuantDense`.

Both compute, with per-tensor activation scale ``s_x`` (a 0-d fp32 tensor)
and per-output-channel weight scale ``s_w``:

    xq  = clip(round(x / s_x), -127, 127)            int8, half to even
    acc = xq ⊛ kernel_q                              exact int32
    y   = acc · (s_x · s_w[o]) + b[o]                fp32, then the out dtype

On the card both run on `wgmma` from `csrc/quant_wgmma.cuh`. K3 is K5's
persistent implicit-GEMM conv (`csrc/quant_conv3d.cu` `conv_wgmma`) at
T = 1, kernel (1, 3, 3), padding (0, 1, 1): `quantize_pad` makes the int8
NHWC input (4 channels from the stem's 3, else padded to 16), and the
epilogue ``acc · s + b`` takes ``s = s_x · s_w`` formed once, the product
JAX forms. `int8_conv3x3` is K3 on an int8 input, with the ReLU and the
next conv's quantize in its epilogue: the stem's int8 walk
(`models/stems.py`) runs on it. K4 (`csrc/quant_dense.cu`) quantizes its
rows in a pass of their own, then one GEMM applies the epilogue. On a CPU
tensor the wrappers take the plain versions below, which form the integer
product exactly as a float64 product of the int8 values: every sum is an
integer below 2^53 (at most 25088 · 127² ≈ 4.0e8), which float32 could not
hold exactly above 2^24.

Layouts: activations are NCHW-shaped ``channels_last`` (the conv) or
(..., K) (the dense); ``kernel_q`` is (O, I, 3, 3) for the conv, read in
O-HW-I memory (its ``channels_last`` form), and (O, I) for the dense. The
output has the input's dtype (fp32 or bf16), as JAX casts to the layer's
compute dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fac_fake_torch import kernels
from fac_fake_torch.ops import quant3d as q3
from fac_fake_torch.ops.quant3d import _out_dtype, _pad_last, pad16, quantize_plain


def dequant_plain(acc: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
                  bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """JAX's epilogue order: ``acc · (s_x · s_w) + b``, the scales' product
    first, over a last axis of output channels."""
    y = acc.float() * (x_scale * w_scale)
    if bias is not None:
        y = y + bias
    return y.to(dtype)


def int_conv3x3_plain(xq: torch.Tensor, kernel_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 3×3 stride-1 pad-1 conv: ``xq`` int8 NHWC, ``kernel_q``
    int8 (O, I, 3, 3) → int32 NHWO, as nine float64 tap products."""
    n, h, w, _ = xq.shape
    xp = F.pad(xq.double(), (0, 0, 1, 1, 1, 1))
    wd = kernel_q.double()
    acc = torch.zeros((n, h, w, kernel_q.shape[0]), dtype=torch.float64, device=xq.device)
    for dy in range(3):
        for dx in range(3):
            acc += torch.einsum("nhwc,oc->nhwo", xp[:, dy:dy + h, dx:dx + w], wd[:, :, dy, dx])
    return acc.to(torch.int32)


def int_matmul_plain(xq: torch.Tensor, kernel_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 (M, K) int8 × (N, K) int8ᵀ → (M, N), in float64."""
    return (xq.double() @ kernel_q.double().t()).to(torch.int32)


# ---- K3 -------------------------------------------------------------------

_K3 = ((1, 3, 3), (1, 1, 1), (0, 1, 1))   # K5's kernel, stride, padding for a 3×3 pad-1 conv


def _kernel5(kernel_q: torch.Tensor) -> torch.Tensor:
    """(O, I, 3, 3) → K5's (O, 1, 3, 3, Cp), the input channels zero-padded
    to what `quantize_pad` makes of I (4, or I rounded up to 16)."""
    cin = kernel_q.shape[1]
    w = kernel_q.permute(0, 2, 3, 1)
    return F.pad(w, (0, q3.quant_channels(cin) - cin))[:, None]


def conv3x3_rows(kernel_q: torch.Tensor) -> torch.Tensor:
    """K3's weights on the card, made once from ``kernel_q`` (O, I, 3, 3):
    the (O, K) K-major matrix `conv_wgmma` reads, K = 9·Cp in (dy, dx, c)
    order, or for I ≤ 4 the stem's rows (`quant3d.stem_rows`), K = 3·32. Two
    dimensions, so a model's ``channels_last`` conversion leaves it as it
    is."""
    w = _kernel5(kernel_q)
    if w.shape[-1] == 4:
        w = q3.stem_rows(w)
    return w.reshape(w.shape[0], -1).contiguous()


def int8_conv3x3_plain(xq, kernel_q, s, bias, relu: bool, dtype: torch.dtype,
                       q_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 on the int8 walk's input: ``xq`` int8 (B, H, W, Cp) ⊛ ``kernel_q``
    → ``acc · s + b`` in fp32, cast to ``dtype``, the ReLU if asked for:
    (B, H, W, O); with ``q_scale``, that quantized for the next conv, int8
    (B, H, W, pad16(O))."""
    y = q3.int8_conv3d_plain(xq[:, None], _kernel5(kernel_q), s, bias, *_K3[1:], relu, dtype,
                             q_scale=q_scale)
    return y[:, 0]


def int8_conv3x3(xq, kernel_q, s, bias, relu: bool, dtype: torch.dtype,
                 q_scale: Optional[torch.Tensor] = None,
                 w_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3's kernel wrapper: what `int8_conv3x3_plain` returns, in one launch.
    ``w_k``: ``conv3x3_rows(kernel_q)``, made once by the caller (made here
    when not given). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if not xq.is_cuda:
        return int8_conv3x3_plain(xq, kernel_q, s, bias, relu, dtype, q_scale)
    b, h, w, cp = xq.shape
    wk = conv3x3_rows(kernel_q) if w_k is None else w_k
    out = q3.conv_launch(xq.view(b, 1, h, w, cp), wk, s, bias, *_K3, relu, dtype,
                         q_scale=q_scale, what="int8_conv3x3")
    if out.numel():
        int8_conv3x3.launches += 1
    return out[:, 0]


int8_conv3x3.launches = 0


def quant_conv3x3_plain(x, kernel_q, w_scale, x_scale, bias):
    """(B, Cin, H, W) fp → (B, Cout, H, W) channels_last in ``x``'s dtype."""
    dtype = _out_dtype(x, "quant_conv3x3")
    acc = int_conv3x3_plain(quantize_plain(x.permute(0, 2, 3, 1), x_scale), kernel_q)
    return dequant_plain(acc, x_scale, w_scale, bias, dtype).permute(0, 3, 1, 2)


def quant_conv3x3(x, kernel_q, w_scale, x_scale, bias, w_k: Optional[torch.Tensor] = None,
                  s: Optional[torch.Tensor] = None):
    """JAX's `QuantConv3x3` on NCHW fp ``x``: K3's quantize pass, then
    `int8_conv3x3` (fp out, no ReLU), each of which takes its plain version
    on a CPU tensor and launches its kernel or raises on a CUDA one.
    ``w_k`` and ``s = x_scale · w_scale`` are K3's derived tensors, made
    once by the caller (here when not given)."""
    dtype = _out_dtype(x, "quant_conv3x3")
    xq = q3.quantize_pad(x.permute(0, 2, 3, 1).contiguous(), x_scale)   # no copy for channels_last
    s = x_scale * w_scale if s is None else s
    return int8_conv3x3(xq, kernel_q, s, bias, False, dtype, w_k=w_k).permute(0, 3, 1, 2)


def max_pool2x2_i8(xq: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 max-pool of int8 NHWC (floor: an odd last row or column
    is dropped, as `nn.MaxPool2d(2, 2)`), by one reduction. On the int8
    walk it takes the place of the fp pool before the next conv's
    quantize: max-pool commutes with the monotone quantizer, so the values
    are the same."""
    ho, wo = xq.shape[1] // 2, xq.shape[2] // 2
    return xq[:, :2 * ho, :2 * wo].unflatten(1, (ho, 2)).unflatten(3, (wo, 2)).amax((2, 4))


# ---- K4 -------------------------------------------------------------------

DENSE_CHANNELS, DENSE_BK = 128, 128   # K4's CTA: output channels, K bytes a stage
DENSE_ROWS = (16, 32, 64, 96, 128, 192, 256)   # wgmma N: activation rows a CTA
DENSE_MAX_SPLITS = 8                  # CTAs of one thread-block cluster
# CTAs of one launch at most: more clusters of 8 than that wait for free
# SMs on the H100 (the (192, 1024) x (1024, 2048) dense takes 0.0175 ms at
# split 8, 128 CTAs, and 0.0112 at split 4; PERF.md)
DENSE_MAX_CTAS = 96


def dense_rows_tile(m: int) -> int:
    """K4's row tile for ``m`` activation rows: the narrowest wgmma N that
    covers them all, or 256 rows a tile above that."""
    return next((r for r in DENSE_ROWS if m <= r), DENSE_ROWS[-1])


def dense_splits(m: int, n: int, k: int) -> int:
    """K4's split of the k-tiles of each output tile over the CTAs of one
    cluster: the largest of 1, 2, 4, 8 that keeps the launch within
    DENSE_MAX_CTAS CTAs and gives every split a k-tile. The CTAs add their
    int32 partial sums through distributed shared memory, exact in any
    order."""
    tiles = -(-n // DENSE_CHANNELS) * -(-m // dense_rows_tile(m))
    k_tiles = -(-pad16(k) // DENSE_BK)
    splits = 1
    while (2 * splits <= min(DENSE_MAX_SPLITS, k_tiles)
           and 2 * splits * tiles <= DENSE_MAX_CTAS):
        splits *= 2
    per = -(-k_tiles // splits)
    return -(-k_tiles // per)


def quant_dense_plain(x, kernel_q, w_scale, x_scale, bias=None):
    """(..., K) fp → (..., N) in ``x``'s dtype."""
    dtype = _out_dtype(x, "quant_dense")
    x2 = x.reshape(-1, x.shape[-1])
    acc = int_matmul_plain(quantize_plain(x2, x_scale), kernel_q)
    y = dequant_plain(acc, x_scale, w_scale, bias, dtype)
    return y.reshape(*x.shape[:-1], kernel_q.shape[0])


def quant_dense(x, kernel_q, w_scale, x_scale, bias=None):
    """K4's wrapper. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if not x.is_cuda:
        return quant_dense_plain(x, kernel_q, w_scale, x_scale, bias)
    dtype = _out_dtype(x, "quant_dense")
    k = x.shape[-1]
    n = kernel_q.shape[0]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    kernels.require_cuda(kernel_q, "quant_dense kernel_q", torch.int8, (n, k))
    kernels.require_cuda(w_scale, "quant_dense w_scale", torch.float32, (n,))
    kernels.require_cuda(x_scale, "quant_dense x_scale", torch.float32, ())
    if bias is not None:
        kernels.require_cuda(bias, "quant_dense bias", torch.float32, (n,))
    out = torch.empty((m, n), dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out.reshape(*x.shape[:-1], n)
    kp = pad16(k)
    wq = _pad_last(kernel_q, kp)
    xq = torch.empty((m, kp), dtype=torch.int8, device=x.device)
    err = kernels.lib("quant_dense").fac_quant_dense(
        kernels.ptr(x2), int(dtype == torch.bfloat16), kernels.ptr(wq),
        kernels.ptr(w_scale), kernels.ptr(x_scale),
        None if bias is None else kernels.ptr(bias), kernels.ptr(out),
        m, n, k, dense_splits(m, n, k), kernels.ptr(xq), kernels.stream_ptr(x.device))
    kernels.check(err, "quant_dense")
    quant_dense.launches += 1
    return out.reshape(*x.shape[:-1], n)


quant_dense.launches = 0
