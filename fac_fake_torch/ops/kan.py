"""KAN's B-spline bases: kernel K9 and its plain version.

The port of `fac_fake_tpu/models/blocks/kan.py` `b_splines` (efficient-KAN's
`KANLinear.b_splines`): for ``x`` (B, in) over a per-feature ``grid`` (in,
L) of knots, the order-0 indicator bases ``g[j] <= x < g[j+1]``, then
``spline_order`` Cox–de Boor levels, each two divisions and a blend. The
result is (B, in, L − 1 − spline_order), contiguous, so that its (B, in·…)
view is the spline GEMM's A operand. fp32 or bf16: ``x`` and ``grid`` in
one dtype, as `KANLinear` casts the grid to its input's.

`kan_bases` launches K9 (`csrc/kan_bases.cu`, a thread per (row, feature))
for CUDA tensors or raises; `kan_bases_plain`, JAX's ops one by one in
PyTorch, is the CPU path and the oracle, bit-equal to the kernel (IEEE
divisions between tensors, each op rounded to the dtype as PyTorch rounds
it).
"""
from __future__ import annotations

import threading

import torch

from fac_fake_torch import kernels

DTYPES = (torch.float32, torch.bfloat16)
# K9's caps (`csrc/kan_bases.cu`): knots a feature, spline order
MAX_KNOTS = 16
MAX_ORDER = 5
# scoring runs forwards on a thread pool: the count is kept under a lock
_count_lock = threading.Lock()


def _check(x: torch.Tensor, grid: torch.Tensor, spline_order: int) -> None:
    if x.dim() != 2 or grid.dim() != 2 or grid.shape[0] != x.shape[1]:
        raise ValueError(f"kan_bases: expected x (B, in) and grid (in, L), got "
                         f"{tuple(x.shape)} and {tuple(grid.shape)}")
    if x.dtype != grid.dtype:
        raise ValueError(f"kan_bases: x is {x.dtype}, grid {grid.dtype}")
    if spline_order < 0 or grid.shape[1] < spline_order + 2:
        raise ValueError(f"kan_bases: {grid.shape[1]} knots give no bases of order "
                         f"{spline_order}")


def kan_bases_plain(x: torch.Tensor, grid: torch.Tensor, spline_order: int) -> torch.Tensor:
    """K9's plain version: JAX's `b_splines`, op for op (every divisor a
    tensor, so CUDA divides as the CPU does)."""
    _check(x, grid, spline_order)
    x = x[..., None]
    bases = ((x >= grid[:, :-1]) & (x < grid[:, 1:])).to(x.dtype)
    for k in range(1, spline_order + 1):
        left = (x - grid[:, :-(k + 1)]) / (grid[:, k:-1] - grid[:, :-(k + 1)])
        right = (grid[:, k + 1:] - x) / (grid[:, k + 1:] - grid[:, 1:-k])
        bases = left * bases[..., :-1] + right * bases[..., 1:]
    return bases.contiguous()


def kan_bases(x: torch.Tensor, grid: torch.Tensor, spline_order: int) -> torch.Tensor:
    """K9's wrapper: the plain version for CPU tensors; for CUDA tensors one
    kernel launch or an exception. x (B, in) and grid (in, L), contiguous,
    fp32 or bf16, L ≤ `MAX_KNOTS`, spline_order ≤ `MAX_ORDER`. K9 is
    forward-only: a CUDA ``x`` or ``grid`` that requires grad while grad
    mode is on raises, rather than return bases that autograd cannot see."""
    if not x.is_cuda:
        return kan_bases_plain(x, grid, spline_order)
    _check(x, grid, spline_order)
    if torch.is_grad_enabled() and (x.requires_grad or grid.requires_grad):
        raise RuntimeError("kan_bases: K9 has no backward, so its bases would carry no "
                           "gradient; call it under torch.no_grad() or "
                           "torch.inference_mode() (the KAN family is scored, not trained)")
    if x.dtype not in DTYPES:
        raise ValueError(f"kan_bases: no kernel for {x.dtype}")
    kernels.require_cuda(x, "kan_bases x", x.dtype)
    kernels.require_cuda(grid, "kan_bases grid", x.dtype)
    n_knots = grid.shape[1]
    if n_knots > MAX_KNOTS or spline_order > MAX_ORDER:
        raise ValueError(f"kan_bases: {n_knots} knots of order {spline_order} exceed K9's "
                         f"caps ({MAX_KNOTS} knots, order {MAX_ORDER})")
    b, n_in = x.shape
    out = torch.empty((b, n_in, n_knots - 1 - spline_order), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = kernels.lib("kan_bases").fac_kan_bases(
        kernels.ptr(x), kernels.ptr(grid), kernels.ptr(out), b, n_in, n_knots, spline_order,
        int(x.dtype == torch.bfloat16), kernels.stream_ptr(x.device))
    kernels.check(err, "kan_bases")
    with _count_lock:
        kan_bases.launches += 1
    return out


kan_bases.launches = 0
