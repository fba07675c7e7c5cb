"""The order in which K6 (`fac_fake_torch/csrc/max_pool3d_i8.cu`) takes its
3×3×3 int8 max, modelled in numpy and held against JAX's
``_max_pool3d_i8`` (a reduce_window with the identity −128) on the CPU.

The kernel cannot run here, so this pins the identity it relies on: per
tile of 7 output rows and ``BW`` output columns, three taps along W with
the column clamped to the image (a clamped tap repeats a value the window
already holds), then three along H over the band's rows inside the image,
then a rolling window of three planes along T (the first and last plane
clamped), with the same tile sizes the kernel picks. Shapes take T, H and W
from {1, 2, 3, 7}, values from the whole int8 range and all negative."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

BAND = 7            # K6's output rows a CTA (kBH)
MAX_THREADS = 256   # K6's BW * G


def chunk_groups(c16: int) -> int:
    """K6's 16-byte channel groups a CTA (`chunk_groups` in the source)."""
    if c16 % 8 == 0:
        return 8
    if c16 % 4 == 0:
        return 4
    return min(c16, 8)


def k6_model(x: np.ndarray) -> np.ndarray:
    """(B, T, H, W, C) int8 → the pool, in the kernel's order and tiles
    (all channels of a tile at once: a chunk of channels does not change a
    value)."""
    b, t_, h_, w_, c = x.shape
    bw = min(w_, MAX_THREADS // chunk_groups(c // 16))
    ident = np.full((b, bw, c), -128, np.int8)
    y = np.empty_like(x)
    for w0, h0 in itertools.product(range(0, w_, bw), range(0, h_, BAND)):
        cols = np.arange(w0, w0 + bw)                 # a thread's output column
        taps = [np.clip(cols + d, 0, w_ - 1) for d in (-1, 0, 1)]
        keep = cols < w_
        lo = mid = None
        for t in range(t_):
            wmax = []                                 # W maxima of the tile rows
            for r in range(BAND + 2):
                hr = h0 - 1 + r
                wmax.append(ident if not 0 <= hr < h_ else np.maximum(
                    np.maximum(x[:, t, hr, taps[0]], x[:, t, hr, taps[1]]),
                    x[:, t, hr, taps[2]]))
            s = [np.maximum(np.maximum(wmax[i], wmax[i + 1]), wmax[i + 2])
                 for i in range(BAND)]                # S_t on the band's rows
            if t == 0:
                lo = s
            else:
                for i in range(BAND):
                    if h0 + i < h_:
                        y[:, t - 1, h0 + i, cols[keep]] = np.maximum(lo[i], s[i])[:, keep]
                lo = [np.maximum(m, v) for m, v in zip(mid, s)]
            mid = s
        for i in range(BAND):
            if h0 + i < h_:
                y[:, t_ - 1, h0 + i, cols[keep]] = lo[i][:, keep]
    return y


def _jax_pool(x: np.ndarray) -> np.ndarray:
    from fac_fake_tpu.compat.quantize_s3d import _max_pool3d_i8
    return np.asarray(_max_pool3d_i8(jnp.asarray(x), (3, 3, 3), (1, 1, 1), (1, 1, 1)))


@pytest.mark.parametrize("t,h,w", list(itertools.product((1, 2, 3, 7), repeat=3)))
def test_k6_order_equals_jax(t, h, w):
    rng = np.random.default_rng(100 * t + 10 * h + w)
    x = rng.integers(-127, 128, (2, t, h, w, 16), dtype=np.int8)
    neg = rng.integers(-127, 0, (1, t, h, w, 32), dtype=np.int8)
    neg[:, :, 0] = neg[:, :, -1] = -127               # borders of minima
    for v in (x, neg):
        np.testing.assert_array_equal(k6_model(v), _jax_pool(v))


# tiles the shapes above do not reach: a ragged last band (H = 13), two
# column tiles (W = 70 at 64 channels, 4 groups of 16; W = 40 at 208
# channels, 8 groups a chunk), a chunk of 3 groups (48 channels)
@pytest.mark.parametrize("shape", [(1, 3, 13, 6, 48), (1, 2, 5, 70, 64), (1, 1, 9, 40, 208),
                                   (2, 10, 14, 14, 16)])
def test_k6_order_equals_jax_across_tiles(shape):
    x = np.random.default_rng(shape[3]).integers(-127, 128, shape, dtype=np.int8)
    np.testing.assert_array_equal(k6_model(x), _jax_pool(x))
