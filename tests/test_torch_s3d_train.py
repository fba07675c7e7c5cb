"""S3D training in the port against the JAX package on the CPU: the `BN3D`
running-variance rule, `load_plan` on every plan in ``configs/``, each msca
block against JAX's module, the four msca variants' logits, one train step of
``ca_s3d`` and ``msca_s3d`` against JAX's `Trainer.train_step`, and
``python -m fac_fake_torch.cli.train --plan`` whose checkpoint scores through
``cli/evaluate.py s3d``. Inputs are made with numpy from a seed at 32² and
16 frames (the fewest the S3D head takes: its temporal strides leave 16 / 8 =
2 steps for its (2, H, W) average); JAX's weights come over by `export_s3d`;
each comparison states its tolerance."""
import copy
import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from test_torch_s3d import _logits, _port, _seeded_variables
from test_torch_train import flat, jax_cfg, one_device_mesh, port_cfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, HW = 16, 32


def _clips_u8(b=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, T, HW, HW, 3), dtype=np.uint8)


def _ncdhw(clips):
    return torch.from_numpy(np.ascontiguousarray(clips)).permute(0, 4, 1, 2, 3)


def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def _spec(name):
    from fac_fake_torch.models.s3d import model as sm
    return {"ca_s3d": sm.ca_s3d_spec(), "msca_s3d": sm.msca_spec()}[name]


# ---- 0. BN3D: flax's running-variance rule -------------------------------------------------

def test_bn3d_running_stats_follow_flax_biased_variance():
    """One training-mode forward of a small ``ca_s3d`` (its full spec at 32²,
    16 frames, seeded weights and BatchNorm stats): every ``running_mean`` and
    ``running_var`` against JAX's ``batch_stats``. Held per tensor, by the
    norm of the difference over the norm: within 1e-6 of flax's rule applied
    by hand to each BatchNorm's input in a float64 forward (the biased batch
    variance), and within 1e-6 plus JAX's own distance from that value of
    JAX's (JAX's fp32 variance, E[x²] − E[x]², is up to ~1e-5 from it).
    torch's own rule, the unbiased variance, is 3e-4 from it here."""
    from fac_fake_tpu.models.s3d.model import S3DNet as JaxS3D
    from fac_fake_torch.compat.weights import s3d_state_dict_from_flax

    spec = _spec("ca_s3d")
    clips = _clips_u8(seed=3).astype(np.float32)
    jm = JaxS3D(spec=spec, num_class=1)
    v = _seeded_variables(jm, clips, 3)
    _, mut = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(clips))
    ref = s3d_state_dict_from_flax(flat({"batch_stats": mut["batch_stats"]}), spec)
    m = _port(spec, v).train()
    m64 = copy.deepcopy(m).double()
    # flax's rule, by hand, on each BatchNorm's float64 input: ra ← 0.999·ra +
    # 0.001·stat with the biased batch variance (independent of BN3D's code)
    b64 = {}

    def rule(name, bn):
        def hook(mod, args):
            x = args[0]
            mean, var = x.mean(dim=(0, 2, 3, 4)), x.var(dim=(0, 2, 3, 4), unbiased=False)
            keep = 1.0 - bn.momentum
            b64[f"{name}.running_mean"] = keep * bn.running_mean + bn.momentum * mean
            b64[f"{name}.running_var"] = keep * bn.running_var + bn.momentum * var
        return hook

    for name, bn in m64.named_modules():
        if isinstance(bn, torch.nn.BatchNorm3d):
            bn.register_forward_pre_hook(rule(name, bn))
    with torch.no_grad():
        m(_ncdhw(clips))
        m64(_ncdhw(clips).double())
    b32 = dict(m.named_buffers())
    assert len(ref) == 2 * sum(isinstance(mod, torch.nn.BatchNorm3d) for mod in m.modules())
    worst = {}
    for k, want in ref.items():
        e = {"port_vs_f64": _rel(b32[k], b64[k]), "jax_vs_f64": _rel(want, b64[k]),
             "port_vs_jax": _rel(b32[k], want)}
        assert e["port_vs_f64"] <= 1e-6, (k, e)
        assert e["port_vs_jax"] <= 1e-6 + e["jax_vs_f64"], (k, e)
        worst = max(worst, e, key=lambda d: d["port_vs_jax"]) if worst else e
    print(f"BN3D running stats, the worst tensor: {worst}")


# ---- 1. load_plan on every plan -----------------------------------------------------------

@pytest.mark.parametrize("plan", sorted(os.path.basename(p)
                                        for p in glob.glob(os.path.join(REPO, "configs", "*.yaml"))))
def test_load_plan_matches_jax_for_every_plan(plan):
    """Every field JAX's `load_plan` sets, on every plan the repo carries."""
    import dataclasses
    from fac_fake_tpu.core.plans import load_plan as jax_load_plan
    from fac_fake_torch.core.plans import load_plan

    path = os.path.join(REPO, "configs", plan)
    assert dataclasses.asdict(load_plan(path)) == dataclasses.asdict(jax_load_plan(path))


# ---- 2. the msca blocks and variants ------------------------------------------------------

def _block_pair(kind, c):
    """(JAX module, port module, flax path → port key) for one msca block."""
    from fac_fake_tpu.models.s3d import blocks as jb
    from fac_fake_tpu.models.s3d import layers as jl
    from fac_fake_torch.compat import weights as cw
    from fac_fake_torch.models.s3d import blocks as tb
    from fac_fake_torch.models.s3d import layers as tl

    def via(fn, strip="b."):
        def key(path):
            k, tf = fn("b", path[1:], lambda base: cw._s3d_term(base, path[0], path[-1]))
            return k[len(strip):], tf
        return key

    return {
        "dwsep": (jl.DWSepConv3d((3, 5, 5), 1, (1, 2, 2)), tl.DWSepConv3d(c, (3, 5, 5), 1, (1, 2, 2)),
                  via(cw._dwsep_key)),
        "mlp": (jb.Mlp3d(2 * c, c), tb.Mlp3d(c, 2 * c, c), via(cw._mlp3d_key)),
        "attention": (jb.SpatialAttention3d(3), tb.SpatialAttention3d(c, 3),
                      via(cw._spatial_attn_key)),
        "mscan_half": (jb.MSCANHalf(1), tb.MSCANHalf(c, 1), via(cw._mscan_key)),
        "mscan": (jb.MSCAN(3), tb.MSCAN(c, 3), via(cw._mscan_key)),
        "mixer": (jb.InceptionMixer(1 / 3, 3), tb.InceptionMixer(c, 1 / 3, 3),
                  lambda p: via(cw._iformer_key, "b.inceptionmixer.")(
                      [p[0], "mixer", *p[1:]])),
        "iformer_light": (jb.IFormerBlock(0.25, 1, light=True),
                          tb.IFormerBlock(c, 0.25, 1, light=True), via(cw._iformer_key)),
        "iformer": (jb.IFormerBlock(0.5, 3), tb.IFormerBlock(c, 0.5, 3), via(cw._iformer_key)),
    }[kind]


@pytest.mark.parametrize("kind", ["dwsep", "mlp", "attention", "mscan_half", "mscan", "mixer",
                                  "iformer_light", "iformer"])
def test_msca_block_matches_jax(kind):
    """Each msca block with JAX's seeded variables (randomized BatchNorm
    stats): eval-mode outputs within 1e-4 of their scale, and a
    training-mode forward's outputs and running stats likewise, at 96
    channels (the mixer's split: 32 low, 64 high at ratio 1/3), 4 frames,
    6², batch 2."""
    c = 96
    jm, tm, key = _block_pair(kind, c)
    x = np.random.default_rng(5).standard_normal((2, 4, 6, 6, c)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(x)), jax.random.key(0))
    rng = np.random.default_rng(6)
    v = {}
    for path, leaf in traverse_util.flatten_dict(shapes).items():
        name = path[-1]
        if name == "kernel":
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(leaf.shape[:-1])), leaf.shape)
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 2.0, leaf.shape)
        else:
            a = rng.normal(0.0, 0.3, leaf.shape)
        v[path] = jnp.asarray(a, jnp.float32)
    sd = {}
    for path, a in v.items():
        k, tf = key([str(p) for p in path])
        sd[k] = torch.from_numpy(np.array(tf(np.asarray(a)), order="C"))
    v = traverse_util.unflatten_dict(v)
    for k, t in tm.state_dict().items():
        sd.setdefault(k, t)                 # num_batches_tracked: JAX has none
    tm.load_state_dict(sd, strict=True)
    xt = _ncdhw(x)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm.eval()(xt).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale)
    ref_t, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got_t = tm.train()(xt).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got_t, np.asarray(ref_t), rtol=0,
                               atol=1e-4 * float(np.abs(np.asarray(ref_t)).max()))
    bufs = dict(tm.named_buffers())
    for path, a in traverse_util.flatten_dict(mut["batch_stats"]).items():
        k, _ = key(["batch_stats", *path])
        np.testing.assert_allclose(bufs[k].numpy(), np.asarray(a), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["msca_s3d", "msca_s3d_srm", "msca_s3d_v2", "msca_s3d_srm_v2"])
def test_msca_variant_logits_match_jax(name):
    """The four msca variants as the registry builds them, SRM input on
    (``msca_s3d_srm`` and ``_srm_v2``: the residual 3-filter SRM,
    ``x + srm(x)``), with JAX's seeded variables carried by `export_s3d` and
    loaded ``strict=True`` by `load_s3d_state_dict`: logits within 1e-3."""
    from fac_fake_tpu.compat.torch_export import export_s3d
    from fac_fake_tpu.core.config import ModelConfig as JaxModelConfig
    from fac_fake_tpu.models import build_model as jax_build
    from fac_fake_torch.compat.weights import load_s3d_state_dict
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model

    srm = name.startswith("msca_s3d_srm")
    jm = jax_build(JaxModelConfig(name=name, num_class=1, srm_net=srm))
    clips = _clips_u8(seed=7).astype(np.float32)
    v = _seeded_variables(jm, clips, 7)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(clips)))
    m = build_model(ModelConfig(name=name, num_class=1, srm_net=srm), device="cpu")
    assert m.srm == ("residual3" if srm else "none") and m.spec == jm.spec
    load_s3d_state_dict(m, {k: torch.from_numpy(np.array(a))
                            for k, a in export_s3d(v, jm.spec).items()})
    got = _logits(m, clips)
    assert got.shape == ref.shape == (2, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


# ---- 3. one train step against JAX's ------------------------------------------------------

PW = 0.7      # pos_weight


def _float64_step(m, tr, batch):
    """One training forward of a float64 copy of ``m``: its gradient (plus
    the coupled decay wd·p, as Adam's moments carry it), loss and buffers."""
    mc = copy.deepcopy(m).double().train()
    x = tr.normalize(batch["image"].double() / torch.full((1,), 255.0, dtype=torch.float64))
    loss = tr.loss_fn(mc(x), batch["label"], batch["mask"].double())
    loss.backward()
    wd = tr.cfg.train.optim.weight_decay
    grads = {k: (p.grad + wd * p.detach()).double() for k, p in mc.named_parameters()}
    return grads, float(loss.detach()), dict(mc.named_buffers())


def _adam_mu(opt_state):
    return [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
            if hasattr(s, "mu")][0].mu


def _jax_float64_step(jm, v, jt, batch):
    """JAX's own step in float64, independent of the port: JAX's model at
    ``dtype=float64`` on the raw bytes (``raw255``, exact in float64), JAX's
    loss (``jt.loss_fn``) and the first moment of JAX's optimizer
    (``jt.tx``, coupled decay included) after one update. Returns the loss,
    Adam's first moment and the running stats, as numpy float64."""
    with jax.enable_x64(True):
        jm64 = jm.clone(dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), v)
        x = jnp.asarray(batch["image"], jnp.float64)
        label = jnp.asarray(batch["label"])
        mask = jnp.asarray(batch["mask"], jnp.float64)

        def step(params):
            def loss_of(p):
                logits, mut = jm64.apply({"params": p, "batch_stats": v64["batch_stats"]}, x,
                                         train=True, mutable=["batch_stats"])
                return jt.loss_fn(logits, label, mask), mut
            (loss, mut), g = jax.value_and_grad(loss_of, has_aux=True)(params)
            _, opt_state = jt.tx.update(g, jt.tx.init(params), params)
            return loss, _adam_mu(opt_state), mut["batch_stats"]

        loss, mu, stats = jax.jit(step)(v64["params"])
        return float(loss), jax.tree.map(np.asarray, mu), jax.tree.map(np.asarray, stats)


@pytest.mark.parametrize("name", ["ca_s3d", "msca_s3d"])
def test_s3d_train_step_matches_jax(name):
    """One train step (augmentation off, ``raw255``, ``bce_weighted`` with a
    pos_weight) of a small model (the full spec at 32², 16 frames, batch 2)
    from JAX's seeded variables and the same batch as JAX's
    `Trainer.train_step`, held to JAX's step in float64
    (`_jax_float64_step`): the loss, the gradient (Adam's first moment over
    1 − β1, by the norm of the difference over the norm) and each
    running-stat tensor of the port's fp32 step within 3 × the distance of
    JAX's fp32 step from it, plus 1e-5 of the loss, 1e-4 and 1e-6. Both fp32
    steps are far from float64 here: the first convs' weight gradients sum
    raw 0-255 inputs against BatchNorm's zero-mean backward, and cancel
    (JAX's gradient is 2-14% from the float64 one, the port's 0.3-12%; the
    losses 2e-4 to 1.4e-3). The port's own float64 step (`_float64_step`)
    is held to JAX's within 1e-6 in each of the three: JAX's S3D casts its
    logits to float32 (JAX ``models/s3d/model.py:157``), so the two agree to
    about 1e-7, not to float64's rounding."""
    from fac_fake_tpu.models.s3d.model import S3DNet as JaxS3D
    from fac_fake_tpu.train.state import TrainState
    from fac_fake_tpu.train.trainer import Trainer as JaxTrainer
    from fac_fake_torch.compat.weights import s3d_state_dict_from_flax
    from fac_fake_torch.train.trainer import Trainer

    spec = _spec(name)
    batch = {"image": _clips_u8(seed=11), "label": np.array([0, 1], np.int32),
             "mask": np.ones(2, np.float32)}
    jm = JaxS3D(spec=spec, num_class=1)
    v = _seeded_variables(jm, batch["image"].astype(np.float32), 11)
    jcfg = jax_cfg(loss="bce_weighted")
    jcfg.data.normalize = "raw255"
    jt = JaxTrainer(jm, jcfg, mesh=one_device_mesh(), loss_kwargs={"pos_weight": PW},
                    input_shape=(1, T, HW, HW, 3))
    m = _port(spec, v)                      # before JAX's step, which donates v
    jloss64, jmu64, jstats64 = _jax_float64_step(jm, v, jt, batch)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], schedule={},
                       opt_state=jt.tx.init(v["params"]))
    state, jmet = jt.train_step(state, jt.put_batch(batch), jax.random.key(0))

    cfg = port_cfg(loss="bce_weighted")
    cfg.data.normalize = "raw255"
    tr = Trainer(m, cfg, device="cpu", loss_kwargs={"pos_weight": PW})
    tb = {"image": torch.from_numpy(batch["image"]), "label": torch.from_numpy(batch["label"]).long(),
          "mask": torch.from_numpy(batch["mask"])}
    g64, loss64, b64 = _float64_step(m, tr, tb)
    met = tr.train_step(tb, torch.Generator().manual_seed(0))
    loss = {"port": float(met["loss"]), "jax": float(jmet["loss"]), "jax_f64": jloss64,
            "port_f64": loss64}
    assert abs(loss64 - jloss64) <= 1e-6 * abs(jloss64), loss
    assert abs(loss["port"] - jloss64) <= 3 * abs(loss["jax"] - jloss64) + 1e-5 * abs(jloss64), loss

    params = dict(m.named_parameters())
    mu = s3d_state_dict_from_flax(flat(_adam_mu(state.opt_state), ("params",)), spec)
    mu64 = s3d_state_dict_from_flax(flat(jmu64, ("params",)), spec)
    g_port = {k: tr.optimizer.state[p]["exp_avg"].double() / 0.1 for k, p in params.items()}
    g_jax = {k: mu[k].double() / 0.1 for k in params}
    g_jax64 = {k: mu64[k].double() / 0.1 for k in params}

    def rel(a, b):
        num = sum(float((a[k] - b[k]).square().sum()) for k in b)
        return (num / sum(float(b[k].square().sum()) for k in b)) ** 0.5

    errs = {"port_vs_f64": rel(g_port, g_jax64), "jax_vs_f64": rel(g_jax, g_jax64),
            "port_f64_vs_f64": rel(g64, g_jax64), "port_vs_jax": rel(g_port, g_jax)}
    assert errs["port_f64_vs_f64"] <= 1e-6, errs
    assert errs["port_vs_f64"] <= 3 * errs["jax_vs_f64"] + 1e-4, errs
    jb = s3d_state_dict_from_flax(flat({"batch_stats": state.batch_stats}), spec)
    jb64 = s3d_state_dict_from_flax(flat({"batch_stats": jstats64}), spec)
    bufs = dict(m.named_buffers())
    worst = {}
    for k, want in jb.items():
        e = {"port_vs_f64": _rel(bufs[k], jb64[k]), "jax_vs_f64": _rel(want, jb64[k]),
             "port_f64_vs_f64": _rel(b64[k], jb64[k]), "port_vs_jax": _rel(bufs[k], want)}
        assert e["port_f64_vs_f64"] <= 1e-6, (k, e)
        assert e["port_vs_f64"] <= 3 * e["jax_vs_f64"] + 1e-6, (k, e)
        worst = max(worst, e, key=lambda d: d["port_vs_f64"]) if worst else e
    print(f"{name}: loss {loss}; gradient errors {errs}; running stats, the worst tensor {worst}")


# ---- 4. the CLI: train from a plan, score the checkpoint ----------------------------------

def test_cli_train_plan_then_evaluate_scores_the_checkpoint(tmp_path):
    """``python -m fac_fake_torch.cli.train --plan configs/caplan9.yaml`` (black
    masking, 6 regions) on a cv2-written tree of 8 videos of 160 crops at
    32², 16 frames, batch 2, one epoch, on the CPU: one video in seven held
    out for validation, the landmark cache filled by the port's BlazeFace on
    the CPU, and its ``best.pth`` scores through ``cli/evaluate.py s3d``.
    Without ``--device`` and without CUDA, the CLI raises; ``--clips-root``
    with a CViT model is refused."""
    import cv2

    root = tmp_path / "clips"
    rng = np.random.default_rng(13)
    meta = {}
    for i in range(8):
        d = root / f"vid_{i}"
        d.mkdir(parents=True)
        meta[f"vid_{i}.mp4"] = {"label": "FAKE" if i % 2 else "REAL"}
        base = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        for j in range(10 * T):        # the evaluator's strided snippet takes every 10th
            img = np.clip(base.astype(int) + rng.integers(-20, 21, base.shape), 0, 255)
            cv2.imwrite(str(d / f"{j:04d}.png"), img.astype(np.uint8))
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    ck = str(tmp_path / "ck")
    sets = ["model.image_size=32", f"data.frames_per_video={T}", "data.num_workers=1",
            "train.log_every=0", "train.epochs=1", "data.batch_size=2"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    env["TMPDIR"] = str(tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "fac_fake_torch.cli.train", "--plan",
         os.path.join(REPO, "configs", "caplan9.yaml"), "--clips-root", str(root),
         "--metadata", str(tmp_path / "meta.json"), "--device", "cpu", "--checkpoint-dir", ck,
         "--set", *sets],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert "epoch 0:" in res.stdout and os.path.exists(os.path.join(ck, "best.pth"))
    assert glob.glob(str(tmp_path / "fac_landmarks" / "*.lmv2.npy"))   # the mask ran

    from fac_fake_torch.cli import evaluate
    plan = tmp_path / "caplan9.yaml"
    plan.write_text(f"training:\n  frames-per-video: {T}\nmodel:\n  image-size: 32\n")
    out = evaluate.main(["s3d", "--clips-root", str(root), "--metadata",
                         str(tmp_path / "meta.json"), "--plan", str(plan), "--checkpoint",
                         os.path.join(ck, "best.pth"), "--no-degrade", "--device", "cpu",
                         "--out-prefix", str(tmp_path / "ev")])
    assert out["count"] == 8 and np.isfinite(out["bce"])

    from fac_fake_torch.cli import train
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(["--plan", os.path.join(REPO, "configs", "caplan9.yaml"),
                        "--clips-root", str(root), "--set", *sets])
    with pytest.raises(SystemExit, match="S3D"):
        train.main(["--model", "cvit", "--clips-root", str(root), "--device", "cpu"])
