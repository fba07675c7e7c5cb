"""KAN — Kolmogorov–Arnold Network layers (efficient-KAN), the port of
`fac_fake_tpu/models/blocks/kan.py`.

A `KANLinear` is a SiLU-base linear plus a B-spline linear: the spline
bases of each input feature over its own grid (kernel K9, `ops/kan.py`)
flattened into one GEMM against ``spline_weight · spline_scaler``. Names
and layouts are efficient-KAN's (``base_weight`` (out, in),
``spline_weight`` (out, in, grid + order), ``spline_scaler`` (out, in), the
persistent buffer ``grid`` (in, grid + 2·order + 1); a `KAN` stacks them
under ``layers.{i}``), so a reference ``state_dict`` loads ``strict=True``.

KAN's grid functions are pure, as JAX's: `regularization_loss` of a
spline weight, and `update_grid`, the data-adaptive refit of a layer's grid
and spline weight from a batch of its inputs (its bases through K9 on the
card, its solve `curve2coeff`'s on the CPU). Nothing trains the family:
K9 has no backward, and `Trainer` refuses a KAN model.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fac_fake_torch.ops import kan

# efficient-KAN's defaults, the only values the reference's heads use
SCALE_NOISE = 0.1
SCALE_BASE = 1.0
GRID_RANGE = (-1.0, 1.0)


def default_grid(in_features: int, grid_size: int = 5, spline_order: int = 3,
                 grid_range=(-1, 1)) -> np.ndarray:
    """(in, grid + 2·order + 1) fp32 knots, uniform over ``grid_range`` and
    extended by ``spline_order`` steps at each end (JAX :28-33)."""
    h = (grid_range[1] - grid_range[0]) / grid_size
    pts = np.arange(-spline_order, grid_size + spline_order + 1) * h + grid_range[0]
    return np.tile(pts[None, :], (in_features, 1)).astype(np.float32)


def b_splines(x: torch.Tensor, grid: torch.Tensor, spline_order: int) -> torch.Tensor:
    """(B, in) → (B, in, grid + order) B-spline bases: K9 on the card."""
    return kan.kan_bases(x.contiguous(), grid.contiguous(), spline_order)


def curve2coeff(x: torch.Tensor, y: torch.Tensor, grid: torch.Tensor,
                spline_order: int) -> torch.Tensor:
    """Least-squares spline coefficients of the curves ``y`` (B, in, out) at
    ``x`` (B, in) (JAX :47-55): one minimum-norm lstsq a feature, solved
    on the CPU by SVD (``gelsd``, as JAX's ``lstsq``; CUDA's solver takes no
    underdetermined system). Returns (out, in, coeff) on ``x``'s device."""
    a = b_splines(x.cpu(), grid.cpu(), spline_order).transpose(0, 1)   # (in, B, coeff)
    b = y.cpu().transpose(0, 1)                                        # (in, B, out)
    sol = torch.linalg.lstsq(a, b, driver="gelsd").solution            # (in, coeff, out)
    return sol.permute(2, 0, 1).contiguous().to(x.device)


def regularization_loss(spline_weight: torch.Tensor, regularize_activation: float = 1.0,
                        regularize_entropy: float = 1.0) -> torch.Tensor:
    """efficient-KAN's regularization (JAX :128-136): the sum of each edge's
    mean |w| (L1) plus the entropy of the edges' shares of it. A zero edge
    gives ``0 · log 0``, NaN, as in JAX."""
    l1 = spline_weight.abs().mean(-1)
    total = l1.sum()
    p = l1 / total
    entropy = -torch.sum(p * torch.log(p))
    return regularize_activation * total + regularize_entropy * entropy


@torch.no_grad()
def update_grid(x: torch.Tensor, grid: torch.Tensor, spline_weight: torch.Tensor,
                spline_scaler: Optional[torch.Tensor] = None, grid_size: int = 5,
                spline_order: int = 3, grid_eps: float = 0.02, margin: float = 0.01
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The data-adaptive grid refit (JAX :139-165, efficient-KAN's
    ``update_grid``): the layer's spline output on ``x`` (B, in) under the
    old grid (its bases through K9 on the card), a new grid blending the
    sorted inputs at ``grid_size + 1`` evenly spaced ranks with a uniform
    grid over their range (``grid_eps``), extended by ``spline_order``
    steps at each end, and the spline weight refitted to that output on the
    new grid (`curve2coeff`). Pure: returns (new grid (in, L), new spline
    weight (out, in, coeff)) on ``x``'s device. The ranks are truncated
    fp32 ``linspace`` values made on the host, and the grid's one division
    is by a tensor, so the card's grid equals the CPU's bit for bit. Quirk
    kept: the refit is against the *scaled* spline output but stored into
    the raw spline weight, so a layer with a scaler applies it twice after
    a refit (the reference's `kan.py:259-260`)."""
    batch = x.shape[0]
    scaled = spline_weight if spline_scaler is None \
        else spline_weight * spline_scaler[..., None]
    splines = b_splines(x, grid, spline_order).transpose(0, 1)        # (in, B, c)
    orig = scaled.permute(1, 2, 0)                                     # (in, c, out)
    unreduced = torch.bmm(splines, orig).transpose(0, 1)               # (B, in, out)

    x_sorted = torch.sort(x, dim=0).values
    idx = torch.linspace(0, batch - 1, grid_size + 1).to(torch.int64).to(x.device)
    grid_adaptive = x_sorted[idx]
    size = torch.tensor(float(grid_size), dtype=x.dtype, device=x.device)
    step = (x_sorted[-1] - x_sorted[0] + 2 * margin) / size
    ar = lambda *a: torch.arange(*a, dtype=x.dtype, device=x.device)[:, None]
    grid_uniform = ar(grid_size + 1) * step + x_sorted[0] - margin
    g = grid_eps * grid_uniform + (1 - grid_eps) * grid_adaptive
    lo = g[:1] - step * ar(spline_order, 0, -1)
    hi = g[-1:] + step * ar(1, spline_order + 1)
    new_grid = torch.cat([lo, g, hi], dim=0).T.contiguous()           # (in, L)
    return new_grid, curve2coeff(x, unreduced, new_grid, spline_order)


class KANLinear(nn.Module):
    """efficient-KAN's ``KANLinear`` with its standalone spline scaler, on
    `GRID_RANGE`."""

    def __init__(self, in_features: int, out_features: int, grid_size: int = 5,
                 spline_order: int = 3):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.grid_size, self.spline_order = grid_size, spline_order
        self.register_buffer("grid", torch.empty(in_features, grid_size + 2 * spline_order + 1))
        self.base_weight = nn.Parameter(torch.empty(out_features, in_features))
        self.spline_weight = nn.Parameter(torch.empty(out_features, in_features,
                                                      grid_size + spline_order))
        self.spline_scaler = nn.Parameter(torch.empty(out_features, in_features))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """JAX's init (:75-91) from ``gen``: the base weight and the scaler
        kaiming-uniform with ``a = √5·SCALE_BASE``; the spline weight fitted
        by `curve2coeff` to uniform noise at the grid's inner knots; the
        grid `default_grid`."""
        g0 = torch.from_numpy(default_grid(self.in_features, self.grid_size, self.spline_order,
                                           GRID_RANGE))
        self.grid.copy_(g0)
        a = math.sqrt(5) * SCALE_BASE
        bound = math.sqrt(2.0 / (1 + a * a)) * math.sqrt(3.0 / self.in_features)
        self.base_weight.uniform_(-bound, bound, generator=gen)
        self.spline_scaler.uniform_(-bound, bound, generator=gen)
        dev = self.spline_weight.device
        noise = (torch.rand((self.grid_size + 1, self.in_features, self.out_features),
                            generator=gen, device=dev) - 0.5) * SCALE_NOISE / self.grid_size
        k = self.spline_order
        self.spline_weight.copy_(curve2coeff(g0.T[k:-k].to(dev), noise, g0, k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """JAX :103-108 in order: ``silu(x) @ base_wᵀ + bases(x) @
        (spline_w · scaler)ᵀ``, with the grid and both weights in ``x``'s
        dtype (bf16 in a bf16 model)."""
        spline_w = self.spline_weight * self.spline_scaler[..., None]
        base = F.linear(F.silu(x), self.base_weight.to(x.dtype))
        bases = b_splines(x, self.grid.to(x.dtype), self.spline_order)
        spline = F.linear(bases.reshape(x.shape[0], -1),
                          spline_w.reshape(self.out_features, -1).to(x.dtype))
        return base + spline


class KAN(nn.Module):
    """A stack of `KANLinear` layers (efficient-KAN's ``KAN``), ``layers.{i}``."""

    def __init__(self, layers_hidden: Sequence[int], grid_size: int = 5, spline_order: int = 3):
        super().__init__()
        self.layers = nn.ModuleList(
            KANLinear(fin, fout, grid_size=grid_size, spline_order=spline_order)
            for fin, fout in zip(layers_hidden, layers_hidden[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
