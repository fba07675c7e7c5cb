"""KAN's grid functions in the port (`fac_fake_torch/models/blocks/kan.py`
`update_grid`, `regularization_loss`) against the JAX package's
(`fac_fake_tpu/models/blocks/kan.py:128-165`) on the CPU.

A seeded `KAN((16, 8, 2))` (the port's init) is refitted layer by layer on
a batch of 24, as efficient-KAN's ``update_grid=True`` forward does: each
layer's grid and spline weight refitted from its input, then its output
under the new grid is the next layer's input. The first layer's input is a
ReLU of seeded normals, some features all zero and some clustered in a
narrow band, so the old grid's intervals and the new one's between tied
ranks hold no sample and the solve is underdetermined there (JAX's and the
port's least squares both take the minimum-norm solution). Both sides get
the same arrays: the grid within 1e-6 of its largest value (sorted inputs
and affine arithmetic; XLA and torch may round the one division apart);
the weight within 1e-5 of its largest value on the features whose new
bases are well conditioned (WELL_CONDITIONED); everywhere, the refit's
spline output on the batch (the new bases times the new weight, what the
layer computes there) within 1e-4 of its largest value. Elsewhere the
minimum-norm weight moves by the condition number times the rounding of
its right side: up to 5.5e5 on this input, where JAX's SVD-based
``lstsq`` and LAPACK's ``gelsd`` part by 1e-5 of the largest weight, and
the spline output, a sum of such weights that cancels, by 2e-5 of its
largest value (torch 2.13 CPU, jax 0.9.0).
`regularization_loss` within 1e-6 relative, and NaN on a zero edge in
both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

LAYERS = (16, 8, 2)
BATCH = 24
GRID_ATOL = 1e-6      # of the grid's largest |knot|
WEIGHT_ATOL = 1e-5    # of the weight's largest |value|
FIT_ATOL = 1e-4       # of the refit spline output's largest |value|
LOSS_RTOL = 1e-6
WELL_CONDITIONED = 1e3  # largest over smallest kept singular value of a feature's bases


def _input(seed=0):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(0.0, 0.7, (BATCH, LAYERS[0])), 0.0)
    x[:, 0] = 0.0                                    # a dead unit: all ties
    x[:, 1] = 0.3 + 0.01 * rng.random(BATCH)         # a narrow band
    x[::3, 2] = x[0, 2]                              # repeated values
    return x.astype(np.float32)


def _seeded_kan():
    from fac_fake_torch.models.blocks.kan import KAN
    m = KAN(LAYERS)
    gen = torch.Generator().manual_seed(7)
    for layer in m.layers:
        layer.reset_parameters(gen)
    return m


def _jax_update(x, grid, weight, scaler=None, grid_size=5, spline_order=3):
    """JAX's `update_grid`, jitted (op by op it compiles each op: ~3x slower
    here)."""
    from fac_fake_tpu.models.blocks.kan import update_grid
    fn = jax.jit(update_grid, static_argnums=(4, 5))
    arrays = (None if a is None else jnp.asarray(np.asarray(a)) for a in (x, grid, weight, scaler))
    g, w = fn(*arrays, grid_size, spline_order)
    return np.asarray(g), np.asarray(w)


def _jax_layer_update(x, layer):
    return _jax_update(x, layer.grid.numpy(), layer.spline_weight.detach().numpy(),
                       layer.spline_scaler.detach().numpy())


def _check_weight(x, grid, w, ref_w, order=3):
    """The refit's spline output on ``x`` everywhere, and the weight on the
    well-conditioned features, against JAX's weight ``ref_w``."""
    from fac_fake_torch.models.blocks.kan import b_splines
    bases = b_splines(x, grid, order).double()                    # (B, in, c)
    fit = torch.einsum("bic,oic->bio", bases, w.double())
    ref_fit = torch.einsum("bic,oic->bio", bases, torch.from_numpy(ref_w.copy()).double())
    np.testing.assert_allclose(fit.numpy(), ref_fit.numpy(), rtol=0,
                               atol=FIT_ATOL * float(ref_fit.abs().max()))
    s = torch.linalg.svdvals(bases.transpose(0, 1))               # (in, c)
    kept = s > s[:, :1] * np.finfo(np.float32).eps * max(bases.shape[0], bases.shape[2])
    cond = s[:, 0] / torch.where(kept, s, torch.inf).min(dim=1).values
    well = (cond <= WELL_CONDITIONED).numpy()
    assert well.sum() >= len(well) // 2, cond
    np.testing.assert_allclose(w.numpy()[:, well], ref_w[:, well], rtol=0,
                               atol=WEIGHT_ATOL * float(np.abs(ref_w).max()))


def test_update_grid_matches_jax_layer_by_layer():
    """Each layer's refit against JAX's on the same input, weights and
    grid; the refit layer's output is finite and feeds the next layer."""
    from fac_fake_torch.models.blocks.kan import update_grid
    from fac_fake_torch.ops import kan as ops_kan

    m = _seeded_kan()
    x = torch.from_numpy(_input())
    calls = []
    plain = ops_kan.kan_bases

    def counted(*a, **k):
        calls.append(tuple(a[0].shape))
        return plain(*a, **k)

    for i, layer in enumerate(m.layers):
        ref_g, ref_w = _jax_layer_update(x.numpy(), layer)
        ops_kan.kan_bases = counted
        try:
            g, w = update_grid(x, layer.grid, layer.spline_weight, layer.spline_scaler)
        finally:
            ops_kan.kan_bases = plain
        # the old grid's bases of x, then curve2coeff's under the new grid
        assert calls == [tuple(x.shape)] * 2
        calls.clear()
        assert g.shape == ref_g.shape == layer.grid.shape and w.shape == ref_w.shape
        assert not w.requires_grad and bool((g[:, 1:] > g[:, :-1]).all())
        np.testing.assert_allclose(g.numpy(), ref_g, rtol=0,
                                   atol=GRID_ATOL * float(np.abs(ref_g).max()))
        _check_weight(x, g, w, ref_w)
        with torch.no_grad():
            layer.grid.copy_(g)
            layer.spline_weight.copy_(w)
            x = layer(x)
        assert torch.isfinite(x).all(), i
    assert x.shape == (BATCH, LAYERS[-1])


def test_update_grid_without_scaler_and_other_sizes_matches_jax():
    """No scaler (JAX's ``spline_scaler=None``), grid size 8, order 2, a
    batch whose ranks land between samples; the inputs unchanged."""
    from fac_fake_tpu.models.blocks.kan import default_grid as jax_grid
    from fac_fake_torch.models.blocks.kan import update_grid

    rng = np.random.default_rng(1)
    x = rng.normal(0.0, 0.5, (37, 6)).astype(np.float32)
    grid = jax_grid(6, 8, 2)
    w = rng.normal(0.0, 0.1, (3, 6, 10)).astype(np.float32)
    ref_g, ref_w = _jax_update(x, grid, w, None, 8, 2)
    xt, gt, wt = (torch.from_numpy(a.copy()) for a in (x, grid, w))
    g, nw = update_grid(xt, gt, wt, None, grid_size=8, spline_order=2)
    assert np.array_equal(xt.numpy(), x) and np.array_equal(gt.numpy(), grid)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=0, atol=GRID_ATOL * np.abs(ref_g).max())
    _check_weight(xt, g, nw, ref_w, order=2)


def test_grid_ranks_are_jax_linspace_truncated():
    """The refit's ranks: torch's CPU fp32 ``linspace`` truncated, equal to
    JAX's for the batches and grid sizes a KAN head sees."""
    for batch in (2, 24, 37, 96, 256, 599):
        for size in (3, 5, 8, 10):
            want = np.asarray(jnp.linspace(0, batch - 1, size + 1).astype(jnp.int32))
            got = torch.linspace(0, batch - 1, size + 1).to(torch.int64).numpy()
            assert np.array_equal(got, want), (batch, size)


def test_regularization_loss_matches_jax():
    """The seeded and the refitted spline weights, with and without the
    weights of its terms; a zero edge gives NaN in both."""
    from fac_fake_tpu.models.blocks.kan import regularization_loss as jax_loss
    from fac_fake_torch.models.blocks.kan import regularization_loss, update_grid

    m = _seeded_kan()
    layer = m.layers[0]
    _, refit = update_grid(torch.from_numpy(_input()), layer.grid, layer.spline_weight,
                           layer.spline_scaler)
    for w in (layer.spline_weight.detach(), refit, m.layers[1].spline_weight.detach()):
        for kw in ({}, {"regularize_activation": 0.5, "regularize_entropy": 2.0}):
            want = float(jax_loss(jnp.asarray(w.numpy()), **kw))
            got = float(regularization_loss(w, **kw))
            assert got == pytest.approx(want, rel=LOSS_RTOL, abs=0), kw
    zero = layer.spline_weight.detach().clone()
    zero[0, 0] = 0.0
    assert np.isnan(float(regularization_loss(zero)))
    assert np.isnan(float(jax_loss(jnp.asarray(zero.numpy()))))
