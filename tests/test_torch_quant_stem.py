"""The quantized stem's int8 walk (`models/stems.py`) on the CPU: the planner,
the walk against the module-by-module chain (`QuantConv3x3` → ReLU → pool)
bit for bit, the int8 pool, K3's fused plain op and its derived tensors.
Inputs are made from numpy seeds."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(2)

# all three edge kinds: qconv → relu → qconv, qconv → relu → pool → qconv, and
# the last qconv → relu → pool, which runs as fp modules
SPEC = (("qconv", 8), ("relu",), ("qconv", 16), ("relu",), ("pool",),
        ("qconv", 16), ("relu",), ("qconv", 24), ("relu",), ("pool",))


def _quantized_vgg():
    from fac_fake_torch.compat.quantize import _plan_stem
    from fac_fake_torch.models.stems import vgg_stem
    return _plan_stem(tuple(op for op in vgg_stem() if op[0] != "bn"))[0]


def _stem(spec, seed):
    """A `Stem` whose QuantConv3x3s hold seeded int8 kernels, power-of-two
    scales (so that bf16 outputs fall on exact .5 quantization steps of
    the next conv) and biases, loaded through ``load_state_dict``."""
    from fac_fake_torch.models.stems import Stem
    rng = np.random.default_rng(seed)
    stem = Stem(spec)
    sd, cin = stem.state_dict(), 3
    for i, op in enumerate(spec):
        if op[0] == "qconv":
            cout = op[1]
            sd[f"{i}.kernel_q"] = torch.from_numpy(rng.integers(-127, 128, (cout, cin, 3, 3),
                                                                dtype=np.int8))
            sd[f"{i}.w_scale"] = torch.full((cout,), 2.0 ** -int(rng.integers(8, 11)))
            sd[f"{i}.x_scale"] = torch.tensor(2.0 ** -int(rng.integers(2, 5)))
            sd[f"{i}.bias"] = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
        if op[0] in ("qconv", "bn"):
            cin = op[1]
    stem.load_state_dict(sd, strict=True)
    return stem.eval()


def _input(rng, shape, x_scale):
    """NCHW channels_last fp32, a quarter of it exact .5 steps of ``x_scale``
    and some of it past ±127 steps."""
    x = rng.standard_normal(shape).astype(np.float32) * 6.0
    ties = rng.random(shape) < 0.25
    x[ties] = (rng.integers(-200, 200, int(ties.sum())) + 0.5) * x_scale
    return torch.from_numpy(x).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("hw", [(9, 11), (8, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_walk_equals_the_module_chain(hw, dtype):
    """The walk (ReLU in K3's epilogue, the next conv's quantize there too,
    the 2×2 pool on the int8 tensor) gives the chain's values bit for bit;
    an odd H/W drops the last row and column in both."""
    from torch import nn

    stem = _stem(SPEC, sum(hw))
    assert len(stem.walk) == 4 and stem.walk_tail == 9
    x = _input(np.random.default_rng(hw[0]), (2, 3, *hw), float(stem[0].x_scale)).to(dtype)
    with torch.no_grad():
        got = stem(x)
        want = nn.Sequential.forward(stem, x)
    assert got.dtype == want.dtype == dtype and got.shape == (2, 24, hw[0] // 4, hw[1] // 4)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


def test_int8_walk_hits_quantization_ties_in_bf16():
    """The chain's bf16 activations fall on exact .5 steps of the next
    conv's power-of-two scale, so the equality above covers ties."""
    stem = _stem(SPEC, 20)
    x = _input(np.random.default_rng(3), (2, 3, 9, 11), float(stem[0].x_scale)).bfloat16()
    with torch.no_grad():
        y = torch.relu(stem[0](x)).float() / stem[2].x_scale
    frac = (y - y.floor())[y.abs() < 127]
    assert int((frac == 0.5).sum()) > 50


def test_walk_plan_of_the_quantized_vgg_stem():
    from fac_fake_torch.models.stems import plan_walk, walk_counts

    spec = _quantized_vgg()
    steps, tail = plan_walk(spec)
    assert walk_counts(spec) == {"convs": 17, "fused": 16, "no_relu_fused": 0, "quantize": 1,
                                 "int8_pools": 4, "fp_pools": 1, "fp_relus": 0}
    assert (tail, len(spec)) == (38, 39)
    assert all(st.relu for st in steps) and steps[-1].to is None
    assert sum(st.pool for st in steps) == 4 and sum(st.to is not None and not st.pool
                                                     for st in steps) == 12


@pytest.mark.parametrize("spec,counts,tail", [
    # unquantized: no walk
    ((("conv", 8), ("relu",), ("pool",)),
     {"convs": 0, "fused": 0, "no_relu_fused": 0, "quantize": 0, "int8_pools": 0, "fp_pools": 1,
      "fp_relus": 1}, 0),
    # no ReLU after the first qconv; two pools end the walk
    ((("qconv", 8), ("qconv", 8), ("relu",), ("pool",), ("pool",), ("qconv", 8)),
     {"convs": 3, "fused": 1, "no_relu_fused": 1, "quantize": 2, "int8_pools": 0, "fp_pools": 2,
      "fp_relus": 0}, 3),
    # an op the walk does not model ends it
    ((("qconv", 8), ("bn", 8), ("qconv", 8), ("relu",)),
     {"convs": 2, "fused": 0, "no_relu_fused": 0, "quantize": 2, "int8_pools": 0, "fp_pools": 0,
      "fp_relus": 1}, 1),
    # no walk unless op 0 is a qconv
    ((("relu",), ("qconv", 8), ("qconv", 8)),
     {"convs": 2, "fused": 0, "no_relu_fused": 0, "quantize": 2, "int8_pools": 0, "fp_pools": 0,
      "fp_relus": 1}, 0),
])
def test_walk_plan_edges(spec, counts, tail):
    """The counts are what one forward launches (on the CPU: the plain
    versions a forward would launch), so check them against a run."""
    from fac_fake_torch.models.stems import plan_walk, walk_counts
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3

    assert walk_counts(spec) == counts
    assert plan_walk(spec)[1] == tail
    stem = _stem(spec, 9)
    ran = {"convs": 0, "fused": 0, "no_relu_fused": 0, "quantize": 0}
    conv, quantize = q.int8_conv3x3, q3.quantize_pad

    def counted_conv(xq, kernel_q, s, bias, relu, dtype, q_scale=None, w_k=None):
        ran["convs"] += 1
        ran["fused"] += q_scale is not None
        ran["no_relu_fused"] += q_scale is not None and not relu
        return conv(xq, kernel_q, s, bias, relu, dtype, q_scale, w_k)

    def count(kind, fn):
        def run(*args, **kw):
            ran[kind] += 1
            return fn(*args, **kw)
        return run

    q.int8_conv3x3, q3.quantize_pad = counted_conv, count("quantize", quantize)
    try:
        with torch.no_grad():
            stem(_input(np.random.default_rng(9), (1, 3, 8, 8), 0.125))
    finally:
        q.int8_conv3x3, q3.quantize_pad = conv, quantize
    assert ran == {k: counts[k] for k in ran}


def test_walk_runs_modules_after_the_chain():
    """The ops after the walk's end, a qconv among them, run as modules."""
    from torch import nn

    spec = (("qconv", 8), ("qconv", 16), ("relu",), ("pool",), ("relu",), ("qconv", 8))
    stem = _stem(spec, 5)
    x = _input(np.random.default_rng(5), (2, 3, 7, 6), 0.125)
    with torch.no_grad():
        assert torch.equal(stem(x), nn.Sequential.forward(stem, x))


def test_int8_pool_equals_quantize_after_the_fp_pool():
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3

    rng = np.random.default_rng(7)
    s = torch.tensor(0.0625)
    y = _input(rng, (2, 20, 9, 7), float(s)).permute(0, 2, 3, 1).contiguous()
    got = q.max_pool2x2_i8(q3.quantize_pad_plain(y, s))
    pooled = F.max_pool2d(y.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    assert got.shape == (2, 4, 3, 32) and got.is_contiguous()
    assert torch.equal(got, q3.quantize_pad_plain(pooled, s))


@pytest.mark.parametrize("cin", [3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_plain_op_equals_quantize_of_relu_of_the_layer(cin, dtype):
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3

    rng = np.random.default_rng(cin)
    xs, qs = torch.tensor(0.0625), torch.tensor(0.25)
    x = _input(rng, (2, cin, 5, 6), float(xs)).to(dtype)
    kq = torch.from_numpy(rng.integers(-127, 128, (24, cin, 3, 3), dtype=np.int8))
    ws = torch.from_numpy(rng.uniform(1e-3, 1e-2, 24).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    xq = q3.quantize_pad_plain(x.permute(0, 2, 3, 1), xs)
    got = q.int8_conv3x3_plain(xq, kq, xs * ws, b, True, dtype, qs)
    layer = q.quant_conv3x3_plain(x, kq, ws, xs, b)
    want = q3.quantize_pad_plain(torch.relu(layer).permute(0, 2, 3, 1), qs)
    assert got.dtype == torch.int8 and got.shape == (2, 5, 6, 32)
    assert torch.equal(got, want)
    # fp out: the layer's values, ReLU'd, NHWC
    fp = q.int8_conv3x3_plain(xq, kq, xs * ws, b, True, dtype)
    assert torch.equal(fp, torch.relu(layer).permute(0, 2, 3, 1))


@pytest.mark.parametrize("cin,k", [(3, 3 * 32), (16, 9 * 16), (40, 9 * 48)])
def test_k3_derived_tensors_follow_load_state_dict(cin, k):
    """``w_k`` and ``s`` are made again by every ``load_state_dict``, stay
    out of the state dict, and hold the (dy, dx, c) rows K3 reads (the
    stem's 4-channel rows for Cin = 3)."""
    from fac_fake_torch.models.layers import QuantConv3x3
    from fac_fake_torch.ops import quant as q

    rng = np.random.default_rng(k)
    m = QuantConv3x3(cin, 8)
    kq = torch.from_numpy(rng.integers(-127, 128, (8, cin, 3, 3), dtype=np.int8))
    sd = {"kernel_q": kq, "w_scale": torch.rand(8), "x_scale": torch.tensor(0.5),
          "bias": torch.zeros(8)}
    m.load_state_dict(sd, strict=True)
    assert sorted(m.state_dict()) == sorted(sd)
    assert m.w_k.shape == (8, k) and torch.equal(m.w_k, q.conv3x3_rows(kq))
    assert torch.equal(m.s, sd["x_scale"] * sd["w_scale"])
    rows = m.w_k.reshape(8, 3, -1)
    if cin == 3:   # row dy: taps dx = 0, 1, 2 of 4 channels (the 4th zero), then zeros
        want = F.pad(kq.permute(0, 2, 3, 1), (0, 1)).reshape(8, 3, 12)
        assert torch.equal(rows[..., :12], want) and not rows[..., 12:].any()
    else:
        cp = k // 9
        want = F.pad(kq.permute(0, 2, 3, 1), (0, cp - cin)).reshape(8, 3, -1)
        assert torch.equal(rows, want)
    m.to(memory_format=torch.channels_last)
    assert m.w_k.is_contiguous()


# the flagship's edge kind: qconv → qconv with no ReLU between (its 56² conv →
# deconv), quantized for the next conv all the same
NO_RELU_SPEC = (("qconv", 8), ("relu",), ("qconv", 16), ("qconv", 16), ("relu",), ("pool",),
                ("qconv", 16), ("relu",), ("pool",))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_walk_equals_the_module_chain_over_a_no_relu_edge(dtype):
    from torch import nn

    stem = _stem(NO_RELU_SPEC, 31)
    assert [(st.relu, st.to) for st in stem.walk] == [(True, 2), (False, 3), (True, 6),
                                                      (True, None)]
    x = _input(np.random.default_rng(31), (2, 3, 9, 10), float(stem[0].x_scale)).to(dtype)
    with torch.no_grad():
        got = stem(x)
        want = nn.Sequential.forward(stem, x)
    assert got.dtype == want.dtype == dtype and got.shape == (2, 16, 2, 2)
    assert torch.equal(got, want)


def test_walk_plan_of_the_quantized_flagship_stems():
    """The folded flagship stems (DEConvs composed into convs, BNs folded),
    quantized: stem 1 from the crops, 14 convs, 13 quantizing for the next
    (one with no ReLU between: the 56² conv → deconv), 3 int8 pools and 1
    fp pool; stem 2 from stem 1's fp map, one quantize pass, 4 convs, 3
    fused, 1 fp pool."""
    from fac_fake_torch.compat.quantize import _plan_stem
    from fac_fake_torch.models.stems import plan_walk, repbn8_stem1, repbn8_stem2, walk_counts

    def quantized(spec):
        return _plan_stem(tuple(("conv", op[1]) if op[0] == "deconv" else op for op in spec
                                if op[0] != "bn"))[0]

    s1, s2 = quantized(repbn8_stem1()), quantized(repbn8_stem2())
    assert walk_counts(s1, crops=True) == {"convs": 14, "fused": 13, "no_relu_fused": 1,
                                           "quantize": 0, "k2_int8": 1, "k2_fp": 0,
                                           "int8_pools": 3, "fp_pools": 1, "fp_relus": 0}
    assert walk_counts(s2) == {"convs": 4, "fused": 3, "no_relu_fused": 0, "quantize": 1,
                               "int8_pools": 0, "fp_pools": 1, "fp_relus": 0}
    steps1, steps2 = plan_walk(s1)[0], plan_walk(s2)[0]
    no_relu = [st for st in steps1 if not st.relu]
    assert len(no_relu) == 1 and no_relu[0].to == no_relu[0].conv + 1
    assert s1[no_relu[0].conv] == s1[no_relu[0].to] == ("qconv", 128)
    assert all(st.relu for st in steps2)
