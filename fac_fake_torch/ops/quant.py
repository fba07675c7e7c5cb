"""int8 post-training-quantized conv and dense — kernels K3 and K4, the
port of `fac_fake_tpu/models/layers.py` `QuantConv3x3` and `QuantDense`.

Both compute, with per-tensor activation scale ``s_x`` (a 0-d fp32 tensor)
and per-output-channel weight scale ``s_w``:

    xq  = clip(round(x / s_x), -127, 127)            int8, half to even
    acc = xq ⊛ kernel_q                              exact int32
    y   = acc · (s_x · s_w[o]) + b[o]                fp32, then the out dtype

On the card the wrappers launch K3 (`csrc/quant_conv.cu`, implicit GEMM over
NHWC, on `mma.sync` from `csrc/quant_mma.cuh`) and K4 (`csrc/quant_dense.cu`,
on `wgmma` with TMA from `csrc/quant_wgmma.cuh`): one pass quantizes the
activations into an int8 scratch with the channels padded to 16, then the
GEMM runs on the int8 tensor cores and applies the epilogue. On a CPU
tensor they take the plain versions below, which form the integer product exactly as a float64
product of the int8 values: every sum is an integer below 2^53 (at most
25088 · 127² ≈ 4.0e8), which float32 could not hold exactly above 2^24.

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

_DTYPES = (torch.float32, torch.bfloat16)
SM_COUNT = 132      # H100 SXM


def quantize_plain(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / s_x), ±127) as int8. ``x_scale`` is a tensor on
    ``x``'s device, so CUDA divides (a Python or CPU scalar would turn the
    division into a multiply by the reciprocal)."""
    return torch.clamp(torch.round(x.float() / x_scale), -127, 127).to(torch.int8)


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


def pad16(c: int) -> int:
    """Channels (or K) rounded up to 16, the kernels' int8 row unit."""
    return -(-c // 16) * 16


def _pad_last(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the last dim of a contiguous int8 tensor to ``n``."""
    return t if t.shape[-1] == n else F.pad(t, (0, n - t.shape[-1]))


def _out_dtype(x: torch.Tensor, what: str) -> torch.dtype:
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what}: no kernel for input dtype {x.dtype}")
    return x.dtype


# ---- K3 -------------------------------------------------------------------

def quant_conv3x3_plain(x, kernel_q, w_scale, x_scale, bias):
    """(B, Cin, H, W) fp → (B, Cout, H, W) channels_last in ``x``'s dtype."""
    dtype = _out_dtype(x, "quant_conv3x3")
    acc = int_conv3x3_plain(quantize_plain(x.permute(0, 2, 3, 1), x_scale), kernel_q)
    return dequant_plain(acc, x_scale, w_scale, bias, dtype).permute(0, 3, 1, 2)


def quant_conv3x3(x, kernel_q, w_scale, x_scale, bias):
    """K3's wrapper. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if not x.is_cuda:
        return quant_conv3x3_plain(x, kernel_q, w_scale, x_scale, bias)
    dtype = _out_dtype(x, "quant_conv3x3")
    b, cin, h, w = x.shape
    cout = kernel_q.shape[0]
    xh = x.permute(0, 2, 3, 1).contiguous()          # no copy for channels_last
    wq = kernel_q.permute(0, 2, 3, 1).contiguous()   # O-HW-I
    kernels.require_cuda(wq, "quant_conv3x3 kernel_q", torch.int8, (cout, 3, 3, cin))
    kernels.require_cuda(w_scale, "quant_conv3x3 w_scale", torch.float32, (cout,))
    kernels.require_cuda(x_scale, "quant_conv3x3 x_scale", torch.float32, ())
    kernels.require_cuda(bias, "quant_conv3x3 bias", torch.float32, (cout,))
    out = torch.empty((b, h, w, cout), dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out.permute(0, 3, 1, 2)
    cp = pad16(cin)
    wq = _pad_last(wq, cp)
    xq = torch.empty((b, h, w, cp), dtype=torch.int8, device=x.device)
    err = kernels.lib("quant_conv").fac_quant_conv3x3(
        kernels.ptr(xh), int(dtype == torch.bfloat16), kernels.ptr(wq),
        kernels.ptr(w_scale), kernels.ptr(x_scale), kernels.ptr(bias),
        kernels.ptr(out), b, h, w, cin, cout, kernels.ptr(xq), kernels.stream_ptr(x.device))
    kernels.check(err, "quant_conv3x3")
    quant_conv3x3.launches += 1
    return out.permute(0, 3, 1, 2)


quant_conv3x3.launches = 0


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
