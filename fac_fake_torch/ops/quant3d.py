"""int8 3D conv and int8 max-pool of the S3D int8 walk — kernels K5 and K6,
the port of `fac_fake_tpu/compat/quantize_s3d.py` ``_quantize_in`` (:93),
``_conv3d(int8=True)`` (:59) with the epilogue of ``conv_step``
(:147-149), and ``_max_pool3d_i8`` (:85).

The int8 activations between these calls are channel-padded NDHWC: an
int8 (B, T, H, W, Cp) tensor, Cp = C rounded up to 16 with zero channels,
the unit the kernels read in.

  * `quantize_pad` (K5's quantize pass): x (B, T, H, W, C) fp32 or bf16 →
    ``clip(round(x / s_x), ±127)`` int8, padded to Cp; ``s_x`` is a 0-d
    fp32 tensor on x's device;
  * `int8_conv3d` (K5): int8 (B, T, H, W, Cp) ⊛ int8 kernel (N, kt, kh, kw,
    Cp) → exact int32, then ``acc · s[o] + b[o]`` in fp32 (``s = s_x·s_w``
    formed once at calibration, as JAX forms it), the ReLU if asked for, in
    fp32 or bf16; into a new (B, To, Ho, Wo, N) tensor or into channels
    ``c0 … c0 + N`` of a given ``out`` (B, To, Ho, Wo, C_total);
  * `max_pool3d_i8` (K6): 3×3×3 stride-1 max-pool with padding 1 whose
    identity is −128, on int8 (B, T, H, W, Cp).

On a CUDA tensor each wrapper launches its kernel (`csrc/quant_conv3d.cu`,
`csrc/max_pool3d_i8.cu`) or raises; on a CPU tensor it takes the plain
version below. The plain conv forms the integer sums exactly as a float64
``F.conv3d`` of the int8 values (every sum is an integer below 2^53; the
largest, 7·7·30·127² ≈ 2.4e7, already exceeds float32's 2^24); the plain
pool max-pools a float32 copy, exact for int8.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fac_fake_torch import kernels
from fac_fake_torch.ops.quant import _DTYPES, _out_dtype, _pad_last, pad16, quantize_plain

Int3 = Tuple[int, int, int]


def conv3d_out_shape(shape: Sequence[int], kernel: Int3, stride: Int3, padding: Int3) -> tuple:
    """(B, T, H, W) → (B, To, Ho, Wo) of a conv without dilation."""
    b, *dims = shape
    return (b,) + tuple((d + 2 * p - k) // s + 1
                        for d, k, s, p in zip(dims, kernel, stride, padding))


# ---- plain versions ---------------------------------------------------------

def quantize_pad_plain(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    return _pad_last(quantize_plain(x, x_scale), pad16(x.shape[-1]))


def int_conv3d_plain(xq: torch.Tensor, w_q: torch.Tensor, stride: Int3,
                     padding: Int3) -> torch.Tensor:
    """Exact int32 3D conv: int8 (B, T, H, W, C) ⊛ int8 (N, kt, kh, kw, C) →
    int32 (B, To, Ho, Wo, N), as a float64 ``F.conv3d``."""
    acc = F.conv3d(xq.permute(0, 4, 1, 2, 3).double(), w_q.permute(0, 4, 1, 2, 3).double(),
                   stride=tuple(stride), padding=tuple(padding))
    return acc.permute(0, 2, 3, 4, 1).to(torch.int32)


def _write(y: torch.Tensor, out: Optional[torch.Tensor], c0: int) -> torch.Tensor:
    if out is None:
        return y.contiguous()
    out[..., c0:c0 + y.shape[-1]] = y
    return out


def int8_conv3d_plain(xq, w_q, s, bias, stride, padding, relu: bool, dtype: torch.dtype,
                      out: Optional[torch.Tensor] = None, c0: int = 0) -> torch.Tensor:
    """JAX's order: ``(acc · s + b)`` in fp32, cast to ``dtype``, then the
    ReLU (which commutes with the cast)."""
    y = (int_conv3d_plain(xq, w_q, stride, padding).float() * s + bias).to(dtype)
    return _write(torch.relu(y) if relu else y, out, c0)


def max_pool3d_i8_plain(xq: torch.Tensor) -> torch.Tensor:
    x = F.pad(xq.permute(0, 4, 1, 2, 3).float(), (1, 1, 1, 1, 1, 1), value=-128.0)
    return F.max_pool3d(x, 3, 1).to(torch.int8).permute(0, 2, 3, 4, 1).contiguous()


# ---- K5 -----------------------------------------------------------------------

def quantize_pad(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """K5's quantize pass. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if not x.is_cuda:
        return quantize_pad_plain(x, x_scale)
    _out_dtype(x, "quantize_pad")
    kernels.require_cuda(x, "quantize_pad x")
    kernels.require_cuda(x_scale, "quantize_pad x_scale", torch.float32, ())
    c = x.shape[-1]
    xq = torch.empty((*x.shape[:-1], pad16(c)), dtype=torch.int8, device=x.device)
    if xq.numel() == 0:
        return xq
    err = kernels.lib("quant_conv3d").fac_quantize_pad(
        kernels.ptr(x), int(x.dtype == torch.bfloat16), kernels.ptr(x_scale), kernels.ptr(xq),
        x.numel() // c, c, kernels.stream_ptr(x.device))
    kernels.check(err, "quantize_pad")
    quantize_pad.launches += 1
    return xq


quantize_pad.launches = 0


def int8_conv3d(xq, w_q, s, bias, stride: Int3, padding: Int3, relu: bool,
                dtype: torch.dtype, out: Optional[torch.Tensor] = None,
                c0: int = 0) -> torch.Tensor:
    """K5's wrapper: returns the new (B, To, Ho, Wo, N) output, or ``out``
    with channels ``c0 … c0 + N`` written. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if not xq.is_cuda:
        return int8_conv3d_plain(xq, w_q, s, bias, stride, padding, relu, dtype, out, c0)
    if dtype not in _DTYPES:
        raise ValueError(f"int8_conv3d: no kernel for output dtype {dtype}")
    b, t, h, w, cp = xq.shape
    n, kt, kh, kw = w_q.shape[:4]
    kernels.require_cuda(xq, "int8_conv3d xq", torch.int8)
    kernels.require_cuda(w_q, "int8_conv3d w_q", torch.int8, (n, kt, kh, kw, cp))
    kernels.require_cuda(s, "int8_conv3d s", torch.float32, (n,))
    kernels.require_cuda(bias, "int8_conv3d bias", torch.float32, (n,))
    if cp % 16:
        raise ValueError(f"int8_conv3d: channels {cp} are not padded to 16")
    oshape = conv3d_out_shape((b, t, h, w), (kt, kh, kw), stride, padding)
    if out is None:
        out = torch.empty((*oshape, n), dtype=dtype, device=xq.device)
        c0 = 0
    else:
        kernels.require_cuda(out, "int8_conv3d out", dtype, (*oshape, None))
        if not 0 <= c0 <= out.shape[-1] - n:
            raise ValueError(f"int8_conv3d: channels {c0}..{c0 + n} outside out's "
                             f"{out.shape[-1]}")
    if out.numel() == 0:
        return out
    geom = (ctypes.c_int * 18)(b, t, h, w, cp, *oshape[1:], n, kt, kh, kw, *stride, *padding)
    err = kernels.lib("quant_conv3d").fac_int8_conv3d(
        kernels.ptr(xq), kernels.ptr(w_q), kernels.ptr(s), kernels.ptr(bias), kernels.ptr(out),
        int(dtype == torch.bfloat16), int(relu), out.shape[-1], c0, geom,
        kernels.stream_ptr(xq.device))
    kernels.check(err, "int8_conv3d")
    int8_conv3d.launches += 1
    return out


int8_conv3d.launches = 0


# ---- K6 -----------------------------------------------------------------------

def max_pool3d_i8(xq: torch.Tensor) -> torch.Tensor:
    """K6's wrapper. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if not xq.is_cuda:
        return max_pool3d_i8_plain(xq)
    kernels.require_cuda(xq, "max_pool3d_i8 xq", torch.int8, (None,) * 5)
    b, t, h, w, c = xq.shape
    if c % 16:
        raise ValueError(f"max_pool3d_i8: channels {c} are not padded to 16")
    y = torch.empty_like(xq)
    if y.numel() == 0:
        return y
    err = kernels.lib("max_pool3d_i8").fac_max_pool3d_i8(
        kernels.ptr(xq), kernels.ptr(y), b, t, h, w, c, kernels.stream_ptr(xq.device))
    kernels.check(err, "max_pool3d_i8")
    max_pool3d_i8.launches += 1
    return y


max_pool3d_i8.launches = 0
