"""The port's KAN (`fac_fake_torch/models/blocks/kan.py`) and K9's plain
version (`fac_fake_torch/ops/kan.py kan_bases_plain`) against the JAX
package's `fac_fake_tpu/models/blocks/kan.py` on the CPU: the B-spline bases
on the default grid, a grid refitted by JAX's `update_grid`, planted knot
cases and a repeated knot, in fp32 and bf16; `curve2coeff`; `KANLinear` and
`KAN` with JAX's variables carried across; the seeded init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

torch.set_num_threads(2)

G, K = 5, 3                      # grid_size, spline_order of every KAN head
BF16_ATOL = 1.6e-2               # two bf16 ulps at 1


def _grid(case, n_in, seed=0):
    """(in, G + 2K + 1) fp32 knots: the default grid, JAX's `update_grid`
    refit to seeded inputs (non-uniform, per feature), or the default with
    one feature's knot repeated."""
    from fac_fake_tpu.models.blocks.kan import default_grid, update_grid

    g = default_grid(n_in, G, K)
    if case == "refit":
        rng = np.random.default_rng(seed)
        x = rng.normal(0.0, 0.6, (64, n_in)).astype(np.float32)
        w = rng.normal(0.0, 0.1, (4, n_in, G + K)).astype(np.float32)
        g = np.array(update_grid(jnp.asarray(x), jnp.asarray(g), jnp.asarray(w))[0])
    elif case == "repeated":
        g = g.copy()
        g[1, 5] = g[1, 4]
    return g


def _planted_x(grid, rows, seed=0):
    """Seeded x over and beyond the grid's span, with planted entries: every
    knot of each feature exactly, below the first knot, at the last and
    past it."""
    rng = np.random.default_rng(seed)
    n_in, n_knots = grid.shape
    lo, hi = grid[:, 0] - 0.3, grid[:, -1] + 0.3
    x = (lo + (hi - lo) * rng.random((rows, n_in))).astype(np.float32)
    for j in range(n_knots):
        x[j] = grid[:, j]
    x[n_knots] = grid[:, 0] - 0.5
    x[n_knots + 1] = grid[:, -1]
    x[n_knots + 2] = np.nextafter(grid[:, -1], np.float32(np.inf))
    return x


def _jax_bases(x, grid, dtype):
    from fac_fake_tpu.models.blocks.kan import b_splines
    fn = jax.jit(b_splines, static_argnums=2)
    return np.asarray(fn(jnp.asarray(x, dtype), jnp.asarray(grid, dtype), K).astype(jnp.float32))


@pytest.mark.parametrize("case", ["default", "refit", "repeated"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kan_bases_plain_matches_jax_b_splines(case, dtype):
    """fp32 atol 1e-6; bf16 (x and grid cast, every op rounded) atol 1.6e-2.
    A repeated knot gives 0/0 = NaN in the same entries in both."""
    from fac_fake_torch.ops.kan import kan_bases_plain

    grid = _grid(case, 48)
    x = _planted_x(grid, 40)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    got = kan_bases_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(grid).to(tdt), K)
    assert got.shape == (40, 48, G + K) and got.dtype == tdt and got.is_contiguous()
    got = got.float().numpy()
    ref = _jax_bases(x, grid, jdt)
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    assert nan.any() == (case == "repeated")
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=0,
                               atol=1e-6 if dtype == "float32" else BF16_ATOL)


def test_kan_bases_planted_knots_are_half_open():
    """x on knot j opens interval j (order 0); x at or past the last knot and
    below the first give all-zero bases; inside the grid's inner span the
    order-3 bases sum to 1."""
    from fac_fake_torch.ops.kan import kan_bases_plain
    from fac_fake_torch.models.blocks.kan import default_grid

    grid = torch.from_numpy(default_grid(6, G, K))
    n = grid.shape[1]
    x = torch.from_numpy(_planted_x(grid.numpy(), 32))
    b0 = kan_bases_plain(x, grid, 0)
    for j in range(n - 1):
        assert torch.equal(b0[j].argmax(-1), torch.full((6,), j))
    assert b0[n - 1:n + 3].sum() == 0                 # the last knot, below, past
    b3 = kan_bases_plain(x, grid, K)
    assert b3[n:n + 3].abs().sum() == 0
    inner = (x >= grid[:, K]) & (x < grid[:, -K - 1])
    np.testing.assert_allclose(b3.sum(-1)[inner].numpy(), 1.0, atol=1e-6)


def test_kan_bases_refuses_what_it_does_not_take():
    from fac_fake_torch.ops.kan import kan_bases

    x, grid = torch.zeros(4, 6), torch.zeros(6, 12)
    with pytest.raises(ValueError, match="expected x"):
        kan_bases(x, grid[:5], K)
    with pytest.raises(ValueError, match="bfloat16"):
        kan_bases(x, grid.bfloat16(), K)
    with pytest.raises(ValueError, match="no bases"):
        kan_bases(x, grid[:, :4], K)


def test_default_grid_and_curve2coeff_match_jax():
    """`default_grid` equal; `curve2coeff` (the port's lstsq by SVD on the
    CPU, minimum norm as JAX's) within 1e-5 on the init's underdetermined
    fit and on an overdetermined one."""
    from fac_fake_tpu.models.blocks import kan as jkan
    from fac_fake_torch.models.blocks import kan as tkan

    g = tkan.default_grid(10, G, K)
    assert np.array_equal(g, jkan.default_grid(10, G, K))
    rng = np.random.default_rng(3)
    for rows in (G + 1, 40):
        x = rng.uniform(-1, 1, (rows, 10)).astype(np.float32)
        if rows == G + 1:
            x = g.T[K:-K].copy()
        y = rng.normal(0, 0.05, (rows, 10, 4)).astype(np.float32)
        ref = np.asarray(jkan.curve2coeff(jnp.asarray(x), jnp.asarray(y), jnp.asarray(g), K))
        got = tkan.curve2coeff(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(g), K)
        assert got.shape == (4, 10, G + K)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def _carry(jlayer, tlayer, shape_in, seed, grid_case="default"):
    """Init the JAX layer, optionally refit its grids, and load its variables
    into the port's layer (efficient-KAN names, `strict=True`)."""
    from fac_fake_torch.compat.weights import kan_torch_key

    v = jlayer.init(jax.random.key(seed), jnp.zeros(shape_in))
    flat = traverse_util.flatten_dict(v)
    if grid_case == "refit":
        for k in flat:
            if k[0] == "kan_grid":
                flat[k] = jnp.asarray(_grid("refit", flat[k].shape[0], seed))
    v = traverse_util.unflatten_dict(flat)
    sd = {}
    for k, a in flat.items():
        if len(k) == 2:      # a bare KANLinear: ("params", leaf), ("kan_grid", "grid")
            sd[k[1]] = torch.from_numpy(np.array(a))
        else:
            key, tf = kan_torch_key(list(k[1:]), k[0], "x")
            sd[key[len("x."):]] = torch.from_numpy(np.array(tf(np.asarray(a))))
    tlayer.load_state_dict(sd, strict=True)
    return v


@pytest.mark.parametrize("grid_case", ["default", "refit"])
def test_kan_linear_matches_jax(grid_case):
    """A `KANLinear` (24 → 10) with JAX's variables: rtol/atol 1e-5."""
    from fac_fake_tpu.models.blocks.kan import KANLinear as JaxKANLinear
    from fac_fake_torch.models.blocks.kan import KANLinear

    jl, tl = JaxKANLinear(24, 10), KANLinear(24, 10)
    v = _carry(jl, tl, (1, 24), 0, grid_case)
    x = np.random.default_rng(0).normal(0, 0.8, (16, 24)).astype(np.float32)
    ref = np.asarray(jl.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_kan_stack_matches_jax():
    """`KAN((32, 12, 3))`, layers under ``layers.{i}``: rtol/atol 1e-5."""
    from fac_fake_tpu.models.blocks.kan import KAN as JaxKAN
    from fac_fake_torch.models.blocks.kan import KAN

    jm, tm = JaxKAN((32, 12, 3)), KAN((32, 12, 3))
    assert sorted(tm.state_dict()) == sorted(
        f"layers.{i}.{n}" for i in range(2)
        for n in ("base_weight", "spline_weight", "spline_scaler", "grid"))
    v = _carry(jm, tm, (1, 32), 1)
    x = np.random.default_rng(1).normal(0, 0.8, (20, 32)).astype(np.float32)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_seeded_kan_linear_init_follows_jax():
    """`reset_parameters`: the default grid; base weight and scaler inside
    kaiming-uniform's bound for a = √5; the spline weight interpolates noise
    of JAX's scale at the grid's inner knots (an exact fit: 6 points, 8
    coefficients); the same seed gives the same layer."""
    from fac_fake_torch.models.blocks.kan import KANLinear, b_splines, default_grid

    layers = []
    for _ in range(2):
        layer = KANLinear(16, 8)
        layer.reset_parameters(torch.Generator().manual_seed(4))
        layers.append(layer)
    a = layers[0]
    assert torch.equal(a.grid, torch.from_numpy(default_grid(16, G, K)))
    bound = np.sqrt(2.0 / 6.0) * np.sqrt(3.0 / 16)
    for w in (a.base_weight.detach(), a.spline_scaler.detach()):
        assert float(w.abs().max()) <= bound and float(w.std()) > bound / 3
    pts = a.grid.T[K:-K]                                        # (G + 1, in)
    fitted = torch.einsum("bic,oic->bio", b_splines(pts, a.grid, K), a.spline_weight.detach())
    assert float(fitted.abs().max()) <= 0.5 * 0.1 / G + 1e-6
    assert float(fitted.abs().max()) > 0.1 * 0.1 / G
    for n, p in a.state_dict().items():
        assert torch.equal(p, layers[1].state_dict()[n]), n
