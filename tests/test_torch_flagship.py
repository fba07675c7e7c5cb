"""The port's flagship ``cvit_repbn8`` against the JAX package on the CPU:
DEConv's weight composition and module, GGCA, RepBN and LinearNorm in eval,
the weights carried over key for key, BN folding and DEConv composition,
logits at full width, the seeded init and `cli/predict.py`.

The JAX side's weights are its own init with ``train=True`` (so that
LinearNorm's ``norm2`` and ``schedule`` exist), with each DEConv's five
branches then scaled by one factor to He scale (`flagship_variables`): the
JAX init draws them at a scale that makes its flagship's logits NaN. Both
sides get the same numbers; inputs are made with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

torch.set_num_threads(2)

# the flagship's stems at narrow widths: the same op kinds and order
_CH = {32: 8, 64: 8, 128: 16, 256: 16, 512: 16}
SMALL = dict(patch_size=1, dim=32, depth=1, heads=2, mlp_dim=32)
HW = 64      # five pools: a 2×2 map, four tokens


def small(spec):
    return tuple((op[0], _CH[op[1]]) if len(op) > 1 else op for op in spec)


def small_specs():
    from fac_fake_tpu.models.stems import repbn8_stem1, repbn8_stem2
    return small(repbn8_stem1()), small(repbn8_stem2())


def flat(variables):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(variables).items()}


def he_scale_deconvs(variables):
    """Each DEConv's five branches times one factor, so that the kernel they
    compose into has the He std √(2/fan_in) (its RMS)."""
    from fac_fake_tpu.models.blocks.deconv import compose_deconv_weight
    f = traverse_util.flatten_dict(variables)
    for k in [k for k in f if k[-1] == "w_cd"]:
        keys = [k[:-1] + (f"w_{b}",) for b in ("cd", "hd", "vd", "ad", "std")]
        w = np.asarray(compose_deconv_weight(*(f[kk] for kk in keys)))
        scale = np.sqrt(2.0 / (9 * w.shape[2])) / np.sqrt(np.mean(np.square(w, dtype=np.float64)))
        for kk in keys:
            f[kk] = jnp.asarray(np.asarray(f[kk]) * np.float32(scale))
    return traverse_util.unflatten_dict(f)


def randomize_norms(variables, seed):
    """Non-trivial BN statistics, norm affines, RepBN alphas and biases, so
    that folding and the norms have work to do."""
    rng = np.random.default_rng(seed)
    f = traverse_util.flatten_dict(variables)
    for k in list(f):
        shape = np.shape(f[k])
        if k[0] == "batch_stats":
            f[k] = jnp.asarray(rng.normal(0, 0.1, shape) if k[-1] == "mean"
                               else rng.uniform(0.5, 2.0, shape), jnp.float32)
        elif k[0] == "params" and (k[-1] in ("scale", "alpha") or k[-1].startswith("b")):
            f[k] = f[k] + jnp.asarray(rng.normal(0, 0.1, shape), jnp.float32)
    return traverse_util.unflatten_dict(f)


def flagship_variables(jm, hw, seed, randomize=True):
    v = jm.init(jax.random.key(seed), jnp.zeros((1, hw, hw, 3)), train=True)
    v = he_scale_deconvs(v)
    return randomize_norms(v, seed) if randomize else v


def jax_small(pos_mode="legacy"):
    from fac_fake_tpu.models.cvit import CViT
    s1, s2 = small_specs()
    return CViT(stem_spec=s1, stem2_spec=s2, use_ggca=True, ffn_norm="linearnorm",
                pos_mode=pos_mode, **SMALL)


def port_small(sd=None, pos_mode="legacy", **kw):
    from fac_fake_torch.models.cvit import CViT
    from fac_fake_torch.models.stems import repbn8_stem1, repbn8_stem2
    m = CViT(small(repbn8_stem1()), image_size=HW, stem2_spec=small(repbn8_stem2()),
             use_ggca=True, ffn_norm="linearnorm", pos_mode=pos_mode, **{**SMALL, **kw})
    if sd is not None:
        m.load_state_dict(sd, strict=True)
    return m.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


# ---- the modules ------------------------------------------------------------

@pytest.mark.parametrize("cin,cout", [(8, 8), (3, 16)])
def test_compose_deconv_weight_matches_jax(cin, cout):
    """The port composes at θ = 1, every model's; JAX's at θ = 1, within 1e-6."""
    from fac_fake_tpu.models.blocks.deconv import compose_deconv_weight as jax_compose
    from fac_fake_torch.compat.weights import t_conv, t_conv1d
    from fac_fake_torch.models.blocks.deconv import compose_deconv_weight

    rng = np.random.default_rng(cin)
    k33 = [rng.standard_normal((3, 3, cin, cout)).astype(np.float32) for _ in range(3)]
    k3 = [rng.standard_normal((3, cin, cout)).astype(np.float32) for _ in range(2)]
    ref = np.asarray(jax_compose(k33[0], k3[0], k3[1], k33[1], k33[2], 1.0))
    t = lambda a, tf: torch.from_numpy(np.ascontiguousarray(tf(a)))
    got = compose_deconv_weight(t(k33[0], t_conv), t(k3[0], t_conv1d), t(k3[1], t_conv1d),
                                t(k33[1], t_conv), t(k33[2], t_conv))
    assert got.shape == (cout, cin, 3, 3)
    np.testing.assert_allclose(got.permute(2, 3, 1, 0).numpy(), ref, rtol=0, atol=1e-6)


def _module_sd(jax_params, key_fn, batch_stats=None):
    out = {}
    for col, tree in (("params", jax_params), ("batch_stats", batch_stats or {})):
        for k, v in traverse_util.flatten_dict(tree).items():
            key, tf = key_fn([col, *k])
            out[key] = torch.from_numpy(np.array(tf(np.asarray(v, np.float32))))
    return out


def test_deconv_matches_jax():
    """Eval, within 1e-5."""
    from fac_fake_tpu.models.blocks.deconv import DEConv as JaxDEConv
    from fac_fake_torch.compat.weights import cvit_torch_key
    from fac_fake_torch.models.blocks.deconv import DEConv

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 7, 16)).astype(np.float32)
    jm = JaxDEConv(16)
    v = randomize_norms(he_scale_deconvs({"params": {"stem": {"l0": jm.init(
        jax.random.key(0), jnp.asarray(x))["params"]}}}), 0)
    ref = np.asarray(jm.apply({"params": v["params"]["stem"]["l0"]}, jnp.asarray(x)))
    sd = _module_sd(v["params"], lambda p: cvit_torch_key(p, "cvit_repbn8"))
    m = DEConv(16)
    m.load_state_dict({k[len("features1.0."):]: w for k, w in sd.items()}, strict=True)
    with torch.no_grad():
        got = m(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("channels,hw", [(16, (5, 7)), (512, (7, 7))])
def test_ggca_matches_jax(channels, hw):
    """Eval with random BN stats, within 1e-5; at 512 channels the
    flagship's (7×7×512, a 128→8→128 bottleneck)."""
    from fac_fake_tpu.models.blocks.ggca import GGCA as JaxGGCA
    from fac_fake_torch.compat.weights import cvit_torch_key
    from fac_fake_torch.models.blocks.ggca import GGCA

    rng = np.random.default_rng(channels)
    x = rng.standard_normal((2, *hw, channels)).astype(np.float32)
    jm = JaxGGCA(channels)
    v = {col: {"ggca": t} for col, t in jm.init(jax.random.key(1), jnp.asarray(x)).items()}
    v = randomize_norms(v, 1)
    ref = np.asarray(jm.apply({col: t["ggca"] for col, t in v.items()}, jnp.asarray(x)))
    sd = _module_sd(v["params"], cvit_torch_key, v["batch_stats"])
    m = GGCA(channels)
    m.load_state_dict({k[len("ggca."):]: w for k, w in sd.items()}, strict=True)
    with torch.no_grad():
        got = m.eval()(nchw(x).contiguous(memory_format=torch.channels_last))
    assert got.shape == (2, channels, *hw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-5)


def test_linear_norm_and_repbn_match_jax_in_eval():
    """LinearNorm in eval is its LayerNorm (eps 1e-6) alone; RepBN on its
    running stats; each within 1e-5. A training forward ticks the counters
    and leaves eval as it was."""
    from fac_fake_tpu.models.layers import LinearNorm as JaxLinearNorm
    from fac_fake_tpu.models.layers import RepBN as JaxRepBN
    from fac_fake_torch.compat.weights import cvit_torch_key
    from fac_fake_torch.models.layers import LinearNorm

    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 32)) * 3 + 1).astype(np.float32)
    jm = JaxLinearNorm(32)
    v = randomize_norms(jm.init(jax.random.key(2), jnp.asarray(x), train=True), 2)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    ref_bn = np.asarray(JaxRepBN(32).apply(
        {"params": v["params"]["norm2"], "batch_stats": v["batch_stats"]["norm2"]},
        jnp.asarray(x), train=False))
    tree = lambda col: {"transformer": {"ffn_norm0": v[col]}}
    sd = {}
    for col in ("params", "batch_stats", "schedule"):
        for k, a in traverse_util.flatten_dict(tree(col)).items():
            key, tf = cvit_torch_key([col, *k], "cvit_repbn8")
            sd[key[len("transformer.layers.0.1.fn.norm."):]] = torch.from_numpy(
                np.asarray(tf(np.asarray(a, np.float32))))
    m = LinearNorm(32)
    m.load_state_dict(sd, strict=True)
    assert int(m.iter) == 300000 and int(m.warm) == 0
    m.eval()
    with torch.no_grad():
        np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(), ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(m.norm2(torch.from_numpy(x)).numpy(), ref_bn,
                                   rtol=1e-5, atol=1e-5)
    # training runs the blend (held against JAX in test_torch_train.py) and
    # ticks the counters; eval is the LayerNorm alone all the same
    m.train()(torch.from_numpy(x))
    assert int(m.iter) == 299999 and int(m.warm) == 0
    with torch.no_grad():
        np.testing.assert_allclose(m.eval()(torch.from_numpy(x)).numpy(), ref,
                                   rtol=1e-5, atol=1e-5)


# ---- weights, folding ----------------------------------------------------------

def test_state_dict_from_flax_equals_export_cvit_and_loads_strict(tmp_path):
    from fac_fake_tpu.compat.torch_export import export_cvit
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax, load_reference_pth

    v = flagship_variables(jax_small(), HW, 0)
    sd = cvit_state_dict_from_flax(flat(v), variant="cvit_repbn8")
    ref = export_cvit(v, "cvit_repbn8")
    assert sorted(sd) == sorted(ref)
    for k in ref:
        assert np.array_equal(sd[k].numpy(), ref[k]), k
    assert {"features1.27.conv1_2.conv.weight", "features2.3.conv1_3.conv.bias",
            "ggca.shared_conv.3.bias",
            "transformer.layers.0.1.fn.norm.norm2.alpha",
            "transformer.layers.0.1.fn.norm.iter"} <= set(sd)
    port_small(sd)
    # a reference-style checkpoint: DDP prefix, training dict, BN counters
    wrapped = {"epoch": 3, "state_dict": {f"module.{k}": torch.from_numpy(a.copy())
                                          for k, a in ref.items()}}
    for k in ref:
        if k.endswith("running_var"):
            wrapped["state_dict"]["module." + k[:-len("running_var")]
                                  + "num_batches_tracked"] = torch.tensor(7)
    torch.save(wrapped, tmp_path / "ref.pth")
    port_small(load_reference_pth(str(tmp_path / "ref.pth")))


def test_folded_equals_unfolded_and_matches_jax_fold():
    """Folded ≡ unfolded in the port within 2e-4; the folded stems are plain
    conv/relu/pool specs (14 and 4 convs) whose weights equal JAX
    `fold_cvit`'s, carried over, within 1e-6."""
    from fac_fake_tpu.compat.fold import fold_cvit as jax_fold
    from fac_fake_torch.compat.fold import fold_cvit
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax

    jm = jax_small()
    v = flagship_variables(jm, HW, 3)
    tm = port_small(cvit_state_dict_from_flax(flat(v), variant="cvit_repbn8"))
    folded = fold_cvit(tm)
    for field, n_convs in (("stem_spec", 14), ("stem2_spec", 4)):
        spec = folded.config[field]
        assert {op[0] for op in spec} == {"conv", "relu", "pool"}
        assert sum(op[0] == "conv" for op in spec) == n_convs
    x = nchw(np.random.default_rng(3).standard_normal((4, HW, HW, 3)).astype(np.float32))
    pos = torch.tensor([0, 5, 31, 2])
    with torch.no_grad():
        a, b = tm(x, pos), folded(x, pos)
    assert torch.isfinite(a).all() and float((a - b).abs().max()) <= 2e-4

    fm, fv = jax_fold(jm, v)
    assert (fm.stem_spec, fm.stem2_spec) == (folded.config["stem_spec"],
                                             folded.config["stem2_spec"])
    want = cvit_state_dict_from_flax(flat(fv), variant="cvit_repbn8")
    got = folded.state_dict()
    assert sorted(k for k in got if not k.endswith("num_batches_tracked")) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_full_width_cvit_repbn8_logits_match_jax():
    """The flagship at its published widths, batch 2, legacy pos rows
    [0, 31]: rtol/atol 3e-4, the bar of tests/test_cvit_repbn8_parity.py;
    both finite. The stems' output (after x·GGCA(x)) too, at 3e-4 of its
    largest value."""
    from fac_fake_tpu.core.config import ModelConfig as JaxModelConfig
    from fac_fake_tpu.models import build_model as jax_build
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model

    jm = jax_build(JaxModelConfig(name="cvit_repbn8"))
    v = flagship_variables(jm, 224, 4, randomize=False)
    x = np.random.default_rng(4).standard_normal((2, 224, 224, 3)).astype(np.float32)
    pos = np.array([0, 31])
    ref, sows = jm.apply(v, jnp.asarray(x), pos_indices=jnp.asarray(pos), train=False,
                         mutable=["intermediates"])
    ref, ref_feat = np.asarray(ref), np.asarray(sows["intermediates"]["stem_features"][0])
    assert np.isfinite(ref).all()

    tm = build_model(ModelConfig(name="cvit_repbn8"), device="cpu")
    tm.load_state_dict(cvit_state_dict_from_flax(flat(v), variant="cvit_repbn8"), strict=True)
    xt = nchw(x).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = tm(xt, torch.from_numpy(pos)).numpy()
        feat = tm._after_first_stem(tm.features1(xt)).permute(0, 2, 3, 1).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(feat, ref_feat, rtol=0, atol=3e-4 * np.abs(ref_feat).max())


# ---- the seeded init, the CLI ---------------------------------------------------

def test_seeded_flagship_has_he_scale_deconvs_and_finite_logits():
    """`init_weights` scales each DEConv's branches so that the composed
    kernel has the He std √(2/fan_in); the seeded full-width flagship gives
    finite logits of order 1-10, as base cvit's."""
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model
    from fac_fake_torch.models.blocks.deconv import DEConv

    m = build_model(ModelConfig(name="cvit_repbn8"), device="cpu", seed=5)
    deconvs = [d for d in m.modules() if isinstance(d, DEConv)]
    assert len(deconvs) == 12
    for d in deconvs:
        w = d.composed()[0].detach()
        np.testing.assert_allclose(float(w.square().mean().sqrt()),
                                   np.sqrt(2.0 / w[0].numel()), rtol=1e-5)
    u8 = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 224, 224, 3),
                                                            dtype=np.uint8))
    with torch.no_grad():
        logits = m.forward_crops(u8, torch.float32, torch.arange(2))
    assert torch.isfinite(logits).all() and 0.1 < float(logits.abs().max()) < 50


def test_cli_predict_loads_reference_flagship_pth_strict(tmp_path):
    """`cli/predict.py --model cvit_repbn8 --device cpu` on a reference-keyed
    flagship .pth (DDP prefix, training dict) over a directory with one
    noise mp4 (no faces: score 0.5); a checkpoint that lacks a key is
    refused."""
    import cv2
    from fac_fake_torch.cli import predict
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model

    narrow = dict(dim=64, depth=1, heads=2, mlp_dim=64)
    src = build_model(ModelConfig(name="cvit_repbn8", **narrow), device="cpu", seed=6)
    sd = {f"module.{k}": w for k, w in src.state_dict().items()}
    torch.save({"epoch": 1, "state_dict": sd}, tmp_path / "flagship.pth")
    vdir = tmp_path / "videos"
    vdir.mkdir()
    wr = cv2.VideoWriter(str(vdir / "clip.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (96, 64))
    rng = np.random.default_rng(6)
    for _ in range(20):
        wr.write(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8))
    wr.release()
    args = ["--videos", str(vdir), "--model", "cvit_repbn8", "--save-csv",
            str(tmp_path / "pred.csv"), "--device", "cpu", "--workers", "1",
            "--set"] + [f"model.{k}={x}" for k, x in narrow.items()]
    rows = predict.main(args[:2] + ["--weights", str(tmp_path / "flagship.pth")] + args[2:])
    assert [r[0] for r in rows] == ["clip.mp4"] and rows[0][1] == 0.5
    del sd["module.ggca.shared_conv.1.running_var"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        predict.main(args[:2] + ["--weights", str(tmp_path / "short.pth")] + args[2:])
