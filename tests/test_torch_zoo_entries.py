"""The variant zoo's registry entries against the JAX package on the CPU, a
third of them in this file (``ENTRIES[0::3]``; `test_torch_zoo_entries_b.py`
and `_c.py` hold the others): each entry's published stems with ``dim``,
``depth``, ``heads`` and ``mlp_dim`` cut down (``cvit_ggca_sla``,
``cvit_ggca_add_glu`` and the four token-block entries keep dim 1024 and
224² crops, which their embedding and token blocks need; ``cvit_ggca_smfa``
takes 128², so that SMFA's 8× pool has a map to pool). The JAX side's
weights are its init with ``train=True``, each DEConv at He scale and every
norm, bias and zoo parameter moved off its initial value
(`zoo_variables`).

* keys: the port's key map (`cvit_state_dict_from_flax`) against
  `export_cvit`, key for key, and both load with ``strict=True`` into the
  same state;
* logits: batch 1, the port's model and its BN-folded twin each within
  1e-3 of JAX's (the JAX package's logit bar), and of each other.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from test_torch_flagship import flagship_variables, flat

torch.set_num_threads(2)

LOGIT_TOL = 1e-3
# the JAX registry's 29 entries beyond cvit and cvit_repbn8, in its order
ENTRIES = (
    "cvit_ggca", "cvit_ggca_add", "cvit_ggca_add_repbn", "cvit_ggca4", "cvit_ggca_add3",
    "cvit_deconv", "cvit_ggca_add_deconv", "cvit_repbn", "cvit_repbn3", "cvit_repbn4",
    "cvit_repbn5", "cvit_ggca_add_dconv", "cvit_ggca_add_scconv", "cvit_ggca_add_wtconv",
    "cvit_ggca_add_odconv", "cvit_ggca_odconv", "cvit_ggca_add_moga", "cvit_ggca_smfa",
    "cvit_ggca_uffc", "cvit_ggca_sla", "cvit_ggca_add_glu", "cvit_ggca4_bfm5",
    "cvit_ggca4_mdfa5", "cvit_bfm_ggca_mdfa", "cvit_bfm_mdfa", "cvit_ggca_bfm_mdfa",
    "cvit_ggca_mdfa_bfm", "cvit_mdfa_bfm", "cvit_mdfa_ggca_bfm")
# dim 1024 at 224²: SLA's 32 × 32 window, GLU's 8 × 8 tokens at dim 1024,
# the token block's (B, 2, 32, 32) view
FULL = ("cvit_ggca_sla", "cvit_ggca_add_glu", "cvit_bfm_ggca_mdfa", "cvit_ggca_bfm_mdfa",
        "cvit_ggca_mdfa_bfm", "cvit_mdfa_ggca_bfm")
# one stem, ``features``: export_cvit's ``variant="single"``
SINGLE = ("cvit_ggca", "cvit_ggca_add", "cvit_ggca_add_repbn", "cvit_ggca_add_dconv",
          "cvit_ggca_add_wtconv", "cvit_ggca_add_glu")
# zoo leaves `randomize_norms` leaves at their initial values
_ZOO_LEAVES = ("lambda_base", "positional_encoding", "gn_scale", "gn_bias")


def variant(name):
    return "single" if name in SINGLE else "multi"


def entry_dims(name):
    """(crop side, the config's cut widths) of an entry's test model."""
    if name in FULL:
        return 224, dict(patch_size=7, dim=1024, depth=1, heads=2, mlp_dim=64)
    hw, p = (128, 4) if name == "cvit_ggca_smfa" else (64, 2)
    return hw, dict(patch_size=p, dim=64, depth=1, heads=2, mlp_dim=64)


def zoo_variables(jm, hw, seed):
    v = flagship_variables(jm, hw, seed)
    rng = np.random.default_rng(seed + 100)
    f = traverse_util.flatten_dict(v)
    for k in f:
        if k[-1] in _ZOO_LEAVES:
            f[k] = f[k] + jnp.asarray(rng.normal(0, 0.1, np.shape(f[k])), jnp.float32)
    return traverse_util.unflatten_dict(f)


@functools.lru_cache(maxsize=None)
def jax_entry(name):
    """(JAX model, its variables, crop side, the cut widths) of an entry."""
    from fac_fake_tpu.core.config import ModelConfig as JaxModelConfig
    from fac_fake_tpu.models import build_model as jax_build
    hw, dims = entry_dims(name)
    jm = jax_build(JaxModelConfig(name=name, **dims))
    return jm, zoo_variables(jm, hw, ENTRIES.index(name)), hw, dims


def port_entry(name, state_dict=None, **overrides):
    """The port's entry at the test widths on the CPU, eval mode, with
    ``state_dict`` loaded strictly."""
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model
    hw, dims = entry_dims(name)
    model = build_model(ModelConfig(name=name, image_size=hw, **dict(dims, **overrides)),
                        device="cpu")
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def check_keys(name):
    from fac_fake_tpu.compat.torch_export import export_cvit
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    _, v, _, _ = jax_entry(name)
    sd = cvit_state_dict_from_flax(flat(v), variant(name))
    ref = export_cvit(v, variant(name))
    assert sorted(sd) == sorted(ref)
    for k, want in ref.items():
        got = sd[k].numpy()
        if got.shape != want.shape:
            # export_cvit's inverse transforms know no reshape and no ODConv
            # layout: a flat per-channel scale, the flax (kn, k, k, I, O)
            assert got.size == want.size, k
            want = (want.transpose(0, 4, 3, 1, 2) if want.ndim == 5 else want.reshape(got.shape))
        assert np.array_equal(got, want), k
    a, b = port_entry(name, sd), port_entry(name, {k: torch.from_numpy(np.array(w))
                                                   for k, w in ref.items()})
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)


def check_logits(name):
    from fac_fake_torch.compat.fold import fold_cvit
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    jm, v, hw, _ = jax_entry(name)
    x = np.random.default_rng(ENTRIES.index(name)).standard_normal((1, hw, hw, 3))
    x = x.astype(np.float32)
    ref = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx))(v, jnp.asarray(x)))
    model = port_entry(name, cvit_state_dict_from_flax(flat(v), variant(name)))
    folded = fold_cvit(model)
    assert not any(op[0] in ("bn", "deconv") and prev[0] in ("conv", "deconv")
                   for op, prev in zip(folded.stem_ops()[1:], folded.stem_ops()))
    with torch.no_grad():
        got = model(nchw(x)).numpy()
        got_folded = folded(nchw(x)).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(got_folded, ref, rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(got_folded, got, rtol=0, atol=LOGIT_TOL)


PART = ENTRIES[0::3]


@pytest.mark.parametrize("name", PART)
def test_entry_state_dict_matches_export_cvit(name):
    check_keys(name)


@pytest.mark.parametrize("name", PART)
def test_entry_logits_match_jax_folded_and_unfolded(name):
    check_logits(name)


def test_every_registry_entry_builds_and_names_its_stems():
    """All 31 JAX CViT registry names build through the port's
    `build_model`, each with the JAX entry's stems, slots and blocks; a
    single-stem entry's stem is ``features``, the others ``features1..``."""
    from fac_fake_tpu.core import registry as jax_registry
    from fac_fake_tpu.core.config import ModelConfig as JaxModelConfig
    import fac_fake_tpu.models  # noqa: F401  (registers the JAX entries)
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.core.registry import get
    names = sorted(n for n in jax_registry._REGISTRIES["model"] if n.startswith("cvit"))
    assert len(names) == 31 and set(ENTRIES) | {"cvit", "cvit_repbn8"} == set(names)
    as_tuple = lambda a: tuple(a) if isinstance(a, (list, tuple)) else a
    defaults = {"use_ggca": False, "ffn_norm": "ln"}
    for name in names:
        jm = jax_registry.get("model", name)(JaxModelConfig(name=name))
        with torch.device("meta"):
            tm = get("model", name)(ModelConfig(name=name))
        for f in ("stem_spec", "stem2_spec", "stem3_spec", "slot1", "slot2", "slot3",
                  "embed_block", "token_block", "use_ggca", "ffn_norm"):
            assert as_tuple(tm.config.get(f, defaults.get(f))) == as_tuple(getattr(jm, f)), \
                (name, f)
        assert list(tm.stem_names.values()) == (
            ["features"] if jm.stem2_spec is None else
            ["features1", "features2", "features3"][:2 + (jm.stem3_spec is not None)])
    from fac_fake_torch.models import build_model
    small = build_model(ModelConfig(name="cvit_ggca_add_odconv", image_size=64, patch_size=2,
                                    dim=64, depth=1, heads=2, mlp_dim=64), device="cpu")
    assert small.features1[13].weight.shape == (4, 64, 64, 3, 3)
