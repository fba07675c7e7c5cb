"""The port's CViT against the JAX package on the CPU: weights carried over
key for key, logits at full width and at the tiny test width, BN folding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

torch.set_num_threads(2)


def _tiny_jax():
    from helpers import tiny_cvit
    return tiny_cvit()


def _tiny_spec():
    spec = ()
    for _ in range(5):
        spec += (("conv", 8), ("bn", 8), ("relu",), ("pool",))
    return spec


def _flat(variables):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(variables).items()}


def _randomize_bn(variables, seed):
    """Non-trivial BN statistics and affine, so folding has work to do."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(variables)
    for k in list(flat):
        if k[0] == "batch_stats":
            shape = np.shape(flat[k])
            flat[k] = jnp.asarray(rng.normal(0, 0.1, shape) if k[-1] == "mean"
                                  else rng.uniform(0.5, 2.0, shape), jnp.float32)
        elif k[0] == "params" and k[1] == "stem" and k[-1] in ("scale", "bias") \
                and len(np.shape(flat[k])) == 1 and "l" in k[2]:
            flat[k] = flat[k] + jnp.asarray(rng.normal(0, 0.1, np.shape(flat[k])), jnp.float32)
    return traverse_util.unflatten_dict(flat)


def _port_tiny(sd):
    from fac_fake_torch.models.cvit import CViT
    m = CViT(_tiny_spec(), dim=64, depth=1, heads=2, mlp_dim=64)
    m.load_state_dict(sd, strict=True)
    return m.eval()


def test_state_dict_from_flax_equals_export_cvit_and_loads_strict(tmp_path):
    from fac_fake_tpu.compat.torch_export import export_cvit
    from fac_fake_torch.compat.weights import (cvit_state_dict_from_flax,
                                               load_reference_pth)

    jm = _tiny_jax()
    v = _randomize_bn(jm.init(jax.random.key(0), jnp.zeros((1, 224, 224, 3))), 0)
    sd = cvit_state_dict_from_flax(_flat(v))
    ref = export_cvit(v)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        assert np.array_equal(sd[k].numpy(), ref[k]), k
    _port_tiny(sd)
    # a reference-style checkpoint: DDP prefix, training dict, BN counters
    wrapped = {"epoch": 3, "state_dict": {f"module.{k}": torch.from_numpy(v.copy())
                                          for k, v in ref.items()}}
    for k in ref:
        if k.endswith("running_var"):
            wrapped["state_dict"]["module." + k[:-len("running_var")]
                                  + "num_batches_tracked"] = torch.tensor(7)
    torch.save(wrapped, tmp_path / "ref.pth")
    loaded = load_reference_pth(str(tmp_path / "ref.pth"))
    _port_tiny(loaded)


def test_full_width_cvit_logits_match_jax():
    """Base cvit at its published widths, batch 2, legacy pos rows [0, 31]:
    rtol/atol 2e-4, the bar of tests/test_cvit_parity.py."""
    from fac_fake_tpu.core.config import ModelConfig as JaxModelConfig
    from fac_fake_tpu.models import build_model as jax_build
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model

    jm = jax_build(JaxModelConfig(name="cvit"))
    v = jm.init(jax.random.key(3), jnp.zeros((1, 224, 224, 3)))
    x = np.random.default_rng(3).standard_normal((2, 224, 224, 3)).astype(np.float32)
    pos = np.array([0, 31])
    ref = np.asarray(jm.apply(v, jnp.asarray(x), pos_indices=jnp.asarray(pos)))

    tm = build_model(ModelConfig(name="cvit"), device="cpu")
    tm.load_state_dict(cvit_state_dict_from_flax(_flat(v)), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_tiny_cvit_batch40_legacy_pos_rows_match_jax():
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax

    jm = _tiny_jax()
    v = _randomize_bn(jm.init(jax.random.key(1), jnp.zeros((1, 224, 224, 3))), 1)
    x = np.random.default_rng(1).standard_normal((40, 224, 224, 3)).astype(np.float32)
    pos = np.arange(40) % 32
    ref = np.asarray(jm.apply(v, jnp.asarray(x), pos_indices=jnp.asarray(pos)))
    tm = _port_tiny(cvit_state_dict_from_flax(_flat(v)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    # without pos_indices a legacy batch above 32 is refused, as in JAX
    with pytest.raises(ValueError):
        tm(torch.from_numpy(x).permute(0, 3, 1, 2))


def test_folded_equals_unfolded():
    from fac_fake_torch.compat.fold import fold_cvit, fold_stem_bn
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax

    jm = _tiny_jax()
    v = _randomize_bn(jm.init(jax.random.key(2), jnp.zeros((1, 224, 224, 3))), 2)
    tm = _port_tiny(cvit_state_dict_from_flax(_flat(v)))
    folded = fold_cvit(tm)
    assert not any(op[0] == "bn" for op in folded.stem_spec)
    assert len(folded.stem_spec) == len(tm.stem_spec) - 5
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 3, 224, 224)).astype(np.float32))
    with torch.no_grad():
        a, b = tm(x), folded(x)
    assert float((a - b).abs().max()) <= 1e-5
    # a bn that does not follow a conv passes through, renumbered
    spec = (("conv", 8), ("bn", 8), ("relu",), ("bn", 8))
    sd = {k: torch.rand(8) + 0.5 for k in ("1.weight", "1.bias", "1.running_var",
                                           "3.weight", "3.bias", "3.running_var")}
    sd.update({"0.weight": torch.rand(8, 3, 3, 3), "0.bias": torch.rand(8),
               "1.running_mean": torch.rand(8), "3.running_mean": torch.rand(8)})
    new_spec, new_sd = fold_stem_bn(spec, sd)
    assert new_spec == (("conv", 8), ("relu",), ("bn", 8))
    assert sorted(new_sd) == ["0.bias", "0.weight", "2.bias", "2.running_mean",
                              "2.running_var", "2.weight"]


def test_build_model_defaults_to_cuda_and_raises_without_it():
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(ModelConfig(name="cvit"))
    m = build_model(ModelConfig(name="cvit", dim=64, depth=1, heads=2, mlp_dim=64),
                    device="cpu", seed=4)
    m2 = build_model(ModelConfig(name="cvit", dim=64, depth=1, heads=2, mlp_dim=64),
                     device="cpu", seed=4)
    # explicit generator: the same seed gives the same weights
    for (k, a), (_, b) in zip(m.state_dict().items(), m2.state_dict().items()):
        assert torch.equal(a, b), k
