"""int8 3D conv and int8 max-pool of the S3D int8 walk — kernels K5 and K6,
the port of `fac_fake_tpu/compat/quantize_s3d.py` ``_quantize_in`` (:93),
``_conv3d(int8=True)`` (:59) with the epilogue of ``conv_step``
(:147-149), and ``_max_pool3d_i8`` (:85).

The int8 activations between these calls are channel-padded NDHWC: an
int8 (B, T, H, W, Cp) tensor, Cp = C rounded up to 16 with zero channels,
the unit the kernels read in; the 3-channel stem input is padded to 4.

  * `quantize_pad` (K5's quantize pass): x (B, T, H, W, C) fp32 or bf16 →
    ``clip(round(x / s_x), ±127)`` int8, padded to Cp; ``s_x`` is a 0-d
    fp32 tensor on x's device;
  * `int8_conv3d` (K5): int8 (B, T, H, W, Cp) ⊛ int8 kernel (N, kt, kh, kw,
    Cp) → exact int32, then ``acc · s[o] + b[o]`` in fp32 (``s = s_x·s_w``
    formed once at calibration, as JAX forms it), the activation ``act``
    (`ACT_NONE`, `ACT_RELU` or `ACT_RELU6`: ``clip(·, 0, 6)``, the msca
    family's; ``False``/``True`` read as none/ReLU), in fp32 or bf16; into
    a new (B, To, Ho, Wo, N) tensor or into channels ``c0 … c0 + N`` of a
    given ``out`` (B, To, Ho, Wo, C_total). With
    ``q_scale`` (the next conv's ``s_x``), that value is quantized again
    in the same launch: int8 (B, To, Ho, Wo, pad16(N)), exactly
    ``quantize_pad(int8_conv3d(...), q_scale)``. A 4-channel input (the
    stem's) takes a kernel whose channels are zero past 4 (the calibrated
    16-channel layout): K5 gathers each row of kw taps as kw·4 contiguous
    bytes;
  * `max_pool3d_i8` (K6): 3×3×3 stride-1 max-pool with padding 1 whose
    identity is −128, on int8 (B, T, H, W, Cp).

K3 (`ops/quant.py`, the CViT stem's 3×3 convs) is the T = 1 case of K5's
kernel: it takes `quantize_pad` and `conv_launch` from here, and K3 and
K4 the scheme's plain pieces (`quantize_plain`, `pad16`).

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

Int3 = Tuple[int, int, int]

_DTYPES = (torch.float32, torch.bfloat16)

# K5's epilogue activations (`csrc/quant_conv3d.cu` ``Act``), applied to
# ``acc·s + b`` after its rounding to the walk's dtype
ACT_NONE, ACT_RELU, ACT_RELU6 = 0, 1, 2
_ACT_NAMES = {None: ACT_NONE, "relu": ACT_RELU, "relu6": ACT_RELU6}


def act_mode(name: Optional[str]) -> int:
    """The epilogue mode of a spec activation: None, ``relu`` or ``relu6``."""
    if name not in _ACT_NAMES:
        raise ValueError(f"K5 epilogue: no activation {name!r} (None, relu or relu6)")
    return _ACT_NAMES[name]


def _check_act(act: int, what: str) -> int:
    if act not in (ACT_NONE, ACT_RELU, ACT_RELU6):
        raise ValueError(f"{what}: act {act!r} is not ACT_NONE, ACT_RELU or ACT_RELU6")
    return int(act)


def apply_act(y: torch.Tensor, act: int) -> torch.Tensor:
    """The epilogue's activation as JAX's `_act` applies it: ``relu``, or
    ``clip(y, 0, 6)`` (0 and 6 are exact in bf16, so it commutes with the
    cast before it)."""
    if act == ACT_RELU:
        return torch.relu(y)
    if act == ACT_RELU6:
        return torch.clamp(y, 0.0, 6.0)
    return y


def quantize_plain(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / s_x), ±127) as int8. ``x_scale`` is a tensor on
    ``x``'s device, so CUDA divides (a Python or CPU scalar would turn the
    division into a multiply by the reciprocal)."""
    return torch.clamp(torch.round(x.float() / x_scale), -127, 127).to(torch.int8)


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


def conv3d_out_shape(shape: Sequence[int], kernel: Int3, stride: Int3, padding: Int3) -> tuple:
    """(B, T, H, W) → (B, To, Ho, Wo) of a conv without dilation."""
    b, *dims = shape
    return (b,) + tuple((d + 2 * p - k) // s + 1
                        for d, k, s, p in zip(dims, kernel, stride, padding))


# ---- plain versions ---------------------------------------------------------

def quant_channels(c: int) -> int:
    """Channels of the int8 tensor `quantize_pad` makes from ``c``: 4 for
    the stem's 3 (RGB), else ``c`` rounded up to 16."""
    return 4 if c <= 4 else pad16(c)


def quantize_pad_plain(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    return _pad_last(quantize_plain(x, x_scale), quant_channels(x.shape[-1]))


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


def _kernel_for(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``w_q`` cut to ``xq``'s channels: a 4-channel input reads the first 4
    of the calibrated kernel's 16 (zero past the image's real channels)."""
    cp = xq.shape[-1]
    if w_q.shape[-1] == cp:
        return w_q
    if cp != 4 or w_q.shape[-1] < cp:
        raise ValueError(f"int8_conv3d: kernel channels {w_q.shape[-1]} for a {cp}-channel input")
    return w_q[..., :cp]


def int8_conv3d_plain(xq, w_q, s, bias, stride, padding, act: int, dtype: torch.dtype,
                      out: Optional[torch.Tensor] = None, c0: int = 0,
                      q_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's order: ``(acc · s + b)`` in fp32, cast to ``dtype``, then the
    activation (`apply_act`, which commutes with the cast); with
    ``q_scale``, that quantized for the next conv."""
    act = _check_act(act, "int8_conv3d")
    y = (int_conv3d_plain(xq, _kernel_for(xq, w_q), stride, padding).float() * s
         + bias).to(dtype)
    y = apply_act(y, act)
    if q_scale is not None:
        if out is not None:
            raise ValueError("int8_conv3d: q_scale writes a new int8 tensor, not into out")
        return quantize_pad_plain(y, q_scale)
    return _write(y, out, c0)


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
    cp = quant_channels(c)
    xq = torch.empty((*x.shape[:-1], cp), dtype=torch.int8, device=x.device)
    if xq.numel() == 0:
        return xq
    err = kernels.lib("quant_conv3d").fac_quantize_pad(
        kernels.ptr(x), int(x.dtype == torch.bfloat16), kernels.ptr(x_scale), kernels.ptr(xq),
        x.numel() // c, c, cp, kernels.stream_ptr(x.device))
    kernels.check(err, "quantize_pad")
    quantize_pad.launches += 1
    return xq


quantize_pad.launches = 0

STEM_ROW = 32   # K bytes of one (dt, dy) row of a 4-channel conv: kw <= 8 taps of 4


def stem_rows(w_q: torch.Tensor) -> torch.Tensor:
    """A 4-channel conv's kernel in K5's layout: (N, kt, kh, kw, ≥4) int8 →
    (N, kt, kh, 32), each row's kw·4 bytes of (dx, c) weights, then zeros."""
    n, kt, kh, kw = w_q.shape[:4]
    rows = w_q[..., :4].reshape(n, kt, kh, kw * 4)
    return F.pad(rows, (0, STEM_ROW - kw * 4)).contiguous()


def conv_launch(xq, wk, s, bias, kernel: Int3, stride: Int3, padding: Int3, act: int,
                dtype: torch.dtype, out: Optional[torch.Tensor] = None, c0: int = 0,
                q_scale: Optional[torch.Tensor] = None, what: str = "int8_conv3d"
                ) -> torch.Tensor:
    """One launch of `conv_wgmma` (`csrc/quant_conv3d.cu`), the kernel of K5
    and K3, whose wrappers check their own arguments, call this and count
    their launches. ``wk``: the conv's (N, K) K-major int8 weights, K =
    kt·kh·kw·Cp in (dt, dy, dx, c) order, or with a 4-channel input
    `stem_rows`' kt·kh·32; any shape that holds that matrix contiguously.
    Returns ``out`` as `int8_conv3d` does; nothing launches when it is
    empty."""
    if dtype not in _DTYPES:
        raise ValueError(f"{what}: no kernel for output dtype {dtype}")
    act = _check_act(act, what)
    b, t, h, w, cp = xq.shape
    n = s.shape[0]
    kt, kh, kw = kernel
    kernels.require_cuda(xq, f"{what} xq", torch.int8)
    kernels.require_cuda(s, f"{what} s", torch.float32, (n,))
    kernels.require_cuda(bias, f"{what} bias", torch.float32, (n,))
    if cp == 4:
        if kw * 4 > STEM_ROW:
            raise ValueError(f"{what}: a 4-channel input takes kw <= 8, not {kw}")
        k = kt * kh * STEM_ROW
    elif cp % 16:
        raise ValueError(f"{what}: channels {cp} are not padded to 16")
    else:
        k = kt * kh * kw * cp
    kernels.require_cuda(wk, f"{what} weights", torch.int8)
    if wk.shape[0] != n or wk.numel() != n * k:
        raise ValueError(f"{what}: weights {tuple(wk.shape)} are not ({n}, {k})")
    oshape = conv3d_out_shape((b, t, h, w), kernel, stride, padding)
    if q_scale is not None:
        if out is not None:
            raise ValueError(f"{what}: q_scale writes a new int8 tensor, not into out")
        kernels.require_cuda(q_scale, f"{what} q_scale", torch.float32, ())
        c0, ldo = 0, pad16(n)
        out = torch.empty((*oshape, ldo), dtype=torch.int8, device=xq.device)
    elif out is None:
        out = torch.empty((*oshape, n), dtype=dtype, device=xq.device)
        c0, ldo = 0, n
    else:
        kernels.require_cuda(out, f"{what} out", dtype, (*oshape, None))
        if not 0 <= c0 <= out.shape[-1] - n:
            raise ValueError(f"{what}: channels {c0}..{c0 + n} outside out's "
                             f"{out.shape[-1]}")
        ldo = out.shape[-1]
    if out.numel() == 0:
        return out
    geom = (ctypes.c_int * 18)(b, t, h, w, cp, *oshape[1:], n, kt, kh, kw, *stride, *padding)
    err = kernels.lib("quant_conv3d").fac_int8_conv3d(
        kernels.ptr(xq), kernels.ptr(wk), kernels.ptr(s), kernels.ptr(bias), kernels.ptr(out),
        int(dtype == torch.bfloat16), act, ldo, c0,
        None if q_scale is None else kernels.ptr(q_scale), geom, kernels.stream_ptr(xq.device))
    kernels.check(err, what)
    return out


def int8_conv3d(xq, w_q, s, bias, stride: Int3, padding: Int3, act: int,
                dtype: torch.dtype, out: Optional[torch.Tensor] = None,
                c0: int = 0, q_scale: Optional[torch.Tensor] = None,
                w_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5's wrapper: returns the new (B, To, Ho, Wo, N) output, or ``out``
    with channels ``c0 … c0 + N`` written, or with ``q_scale`` the new
    int8 (B, To, Ho, Wo, pad16(N)) input of the next conv. ``act``: the
    epilogue's activation (`ACT_NONE`, `ACT_RELU`, `ACT_RELU6`). ``w_rows``:
    for a 4-channel input, ``stem_rows(w_q)`` made once by the caller (made
    here when not given). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise. A launch adds one to ``launches``, and one
    with ReLU6 also to ``relu6_launches``."""
    if not xq.is_cuda:
        return int8_conv3d_plain(xq, w_q, s, bias, stride, padding, act, dtype, out, c0,
                                 q_scale)
    n, kt, kh, kw = w_q.shape[:4]
    kernels.require_cuda(w_q, "int8_conv3d w_q", torch.int8, (n, kt, kh, kw, None))
    wk = w_q
    if xq.shape[-1] == 4:
        wk = stem_rows(w_q) if w_rows is None else w_rows
    out = conv_launch(xq, wk, s, bias, (kt, kh, kw), stride, padding, act, dtype, out, c0,
                      q_scale)
    if out.numel():
        int8_conv3d.launches += 1
        int8_conv3d.relu6_launches += act == ACT_RELU6
    return out


int8_conv3d.launches = 0
int8_conv3d.relu6_launches = 0


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
