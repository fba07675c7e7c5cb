"""The port's S3D family against the JAX package on the CPU: JAX variables
(randomized BatchNorm statistics) → `export_s3d` → the port's
``load_state_dict(strict=True)``, then logits against ``S3DNet.apply(train=False)``
within 1e-4, for a small spec with every op kind, the full ``ca_s3d`` and
``s3d`` specs, and the 30-filter SRM input; and reference-layout ``.pth``
loading."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

torch.set_num_threads(2)

P133 = ("pool", (1, 3, 3), (1, 2, 2), (0, 1, 1))
P333 = ("pool", (3, 3, 3), (2, 2, 2), (1, 1, 1))
P222 = ("pool", (2, 2, 2), (2, 2, 2), (0, 0, 0))


def _small_spec(pooling):
    """Every op kind of s3d/ca_s3d at test widths: sep, pool, basic, mix,
    ctx (between two mixes and after the last)."""
    return (("sep", 16, 7, 2, 3, "relu", True), P133, ("basic", 16, 1, 1, 0, "relu"),
            ("sep", 24, 3, 1, 1, "relu", True), ("mix", "3b", "relu", True),
            ("ctx", 1.0 / 16.0, pooling), P333, ("mix", "3c", "relu", True),
            ("ctx", 1.0 / 16.0, pooling), P222)


def _clips(b, hw=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 255.0, (b, 20, hw, hw, 3)).astype(np.float32)


def _seeded_variables(jm, x, seed):
    """The JAX model's variable tree (its shapes from ``jax.eval_shape`` of
    ``init``), filled from a numpy seed: LeCun-normal kernels, non-trivial
    norm affines and BatchNorm statistics, so that nothing folds to the
    identity."""
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x[:1]))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in traverse_util.flatten_dict(shapes).items():
        shape, name = leaf.shape, path[-1]
        if name == "kernel":
            v = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 2.0, shape)
        else:                                   # bias, mean
            v = rng.normal(0.0, 0.3, shape)
        flat[path] = jnp.asarray(v, jnp.float32)
    return traverse_util.unflatten_dict(flat)


def _port(spec, variables, srm="none"):
    from fac_fake_tpu.compat.torch_export import export_s3d
    from fac_fake_torch.models.s3d.model import S3DNet

    m = S3DNet(spec, 1, srm=srm).eval()
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in export_s3d(variables, spec).items()}, strict=True)
    return m.to(memory_format=torch.channels_last_3d)


def _logits(m, clips):
    with torch.no_grad():
        return m(torch.from_numpy(clips).permute(0, 4, 1, 2, 3)).numpy()


def _check(spec, b=2, srm="none", seed=0):
    from fac_fake_tpu.models.s3d.model import S3DNet as JaxS3D

    clips = _clips(b, seed=seed)
    jm = JaxS3D(spec=spec, num_class=1, srm=srm)
    v = _seeded_variables(jm, clips, seed)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(clips)))
    m = _port(spec, v, srm)
    got = _logits(m, clips)
    assert got.shape == ref.shape == (b, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    return v, m, clips


@pytest.mark.parametrize("pooling", ["avg", "att"])
def test_small_spec_logits_match_jax_and_state_dicts_agree(pooling):
    from fac_fake_tpu.compat.torch_export import export_s3d
    from fac_fake_torch.compat.weights import s3d_state_dict_from_flax

    spec = _small_spec(pooling)
    v, m, _ = _check(spec, b=3, seed=1)
    flat = {"/".join(k): np.asarray(a) for k, a in traverse_util.flatten_dict(v).items()}
    ours, ref = s3d_state_dict_from_flax(flat, spec), export_s3d(v, spec)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k])
    keys = set(m.state_dict())
    assert {"base.4.branch3.1.conv.weight", "base.5.channel_add_conv.1.weight",
            "fc.0.bias"} <= keys
    assert ("base.5.conv_mask.weight" in keys) == (pooling == "att")
    assert m.state_dict()["base.5.channel_add_conv.1.weight"].shape == (16,)   # 256 / 16


@pytest.mark.parametrize("name", ["ca_s3d", "s3d"])
def test_full_spec_logits_match_jax(name):
    from fac_fake_torch.models.s3d import model as sm

    _check(sm.ca_s3d_spec() if name == "ca_s3d" else sm.s3d_spec(), b=2, seed=2)


def test_concat30_srm_logits_match_jax():
    spec = (("sep", 16, 7, 2, 3, "relu", True), P133, ("mix", "3b", "relu", True),
            P333, P222)
    _check(spec, b=2, srm="concat30", seed=3)


def test_srm_bank_is_the_jax_bank():
    from fac_fake_tpu.models.s3d.layers import _srm_kernel
    from fac_fake_torch.models.s3d.layers import srm_weight

    for full, name, scale in ((True, "srm_30.npy", 1.0 / 3.0), (False, "srm_msca3.npy", 1.0)):
        ref = np.transpose(_srm_kernel(name, scale), (4, 3, 0, 1, 2))
        np.testing.assert_array_equal(srm_weight(full).numpy(), ref)


def test_reference_pth_round_trip(tmp_path):
    """A reference-layout checkpoint: ``module.``-prefixed keys, the ctx
    LayerNorm at (planes, 1, 1, 1), BatchNorm counters and a key the port
    has no module for (the reference SRM module's weight)."""
    from fac_fake_tpu.models.s3d.model import S3DNet as JaxS3D
    from fac_fake_torch.compat.weights import load_reference_pth, load_s3d_state_dict
    from fac_fake_torch.models.s3d.model import S3DNet

    spec = _small_spec("att")
    clips = _clips(2, seed=4)
    v = _seeded_variables(JaxS3D(spec=spec, num_class=1), clips, 4)
    want = _port(spec, v)
    ref_sd = {}
    for k, t in want.state_dict().items():
        if k.endswith(("channel_add_conv.1.weight", "channel_add_conv.1.bias")):
            t = t.reshape(-1, 1, 1, 1)
        ref_sd["module." + k] = t.clone()
    ref_sd["module.hpf.weight"] = torch.zeros(30, 3, 1, 5, 5)
    path = tmp_path / "s3d.pth"
    torch.save({"state_dict": ref_sd}, path)

    got = S3DNet(spec, 1).eval().to(memory_format=torch.channels_last_3d)
    load_s3d_state_dict(got, load_reference_pth(str(path)))
    np.testing.assert_array_equal(_logits(got, clips), _logits(want, clips))

    sd = load_reference_pth(str(path))
    del sd["base.3.conv_t.weight"]
    with pytest.raises(KeyError, match="base.3.conv_t.weight"):
        load_s3d_state_dict(S3DNet(spec, 1), sd)
    sd = load_reference_pth(str(path))
    sd["fc.0.weight"] = torch.zeros(2, 480, 1, 1, 1)
    with pytest.raises(ValueError, match="fc.0.weight"):
        load_s3d_state_dict(S3DNet(spec, 1), sd)


def test_build_model_registry_and_refusals():
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model
    from fac_fake_torch.models.s3d.layers import SepConv3d, srm_weight
    from fac_fake_torch.models.s3d.model import S3DNet, msca_spec

    m = build_model(ModelConfig(name="ca_s3d", num_class=1), device="cpu", seed=0)
    assert isinstance(m, S3DNet) and not m.training
    w = m.base[0].conv_s.weight
    assert w.is_contiguous(memory_format=torch.channels_last_3d)
    fan_in = w[0].numel()
    assert abs(float(w.detach().std()) * np.sqrt(fan_in) - 1.0) < 0.1     # LeCun normal
    assert float(m.base[0].bn_s.running_var.min()) == 1.0 and m.base[0].bn_s.eps == 1e-3
    srm = build_model(ModelConfig(name="s3d", num_class=1, srm_net=True), device="cpu")
    assert srm.base[0].conv_s.weight.shape[1] == 30 and "srm_weight" not in srm.state_dict()
    np.testing.assert_array_equal(srm.srm_weight.numpy(),
                                  S3DNet(((P222),), 1, srm="concat30").srm_weight.numpy())
    for name in ("msca_s3d", "msca_s3d_srm", "msca_s3d_v2", "msca_s3d_srm_v2"):
        m = build_model(ModelConfig(name=name, num_class=1, srm_net=True), device="cpu")
        assert isinstance(m, S3DNet) and m.srm == ("residual3" if "srm" in name else "concat30")
        m16 = build_model(ModelConfig(name=name, num_class=1, dtype="bfloat16"), device="cpu")
        assert m16.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert all(p.dtype == torch.float32 for p in m16.parameters())
    assert len(S3DNet(msca_spec(), 1).base) == len(msca_spec())
    res = S3DNet((P222,), 1, srm="residual3")
    np.testing.assert_array_equal(res.srm_weight.numpy(), srm_weight(full=False).numpy())
    with pytest.raises(ValueError, match="srm must be"):
        S3DNet((P222,), 1, srm="residual30")
    dw = SepConv3d(8, 16, depthwise=True)
    assert dw.conv_s.groups == dw.conv_t.groups == 8 and dw.conv_t.out_channels == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(ModelConfig(name="s3d", num_class=1))
