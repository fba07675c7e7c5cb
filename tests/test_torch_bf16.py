"""bf16 mixed precision in the port against the JAX package's bf16 modules on
the CPU: the BatchNorm fast path (2D and 3D), one bf16 train step of small
``cvit``, ``cvit_repbn8``, ``ca_s3d`` and ``msca_s3d`` against JAX's bf16
`Trainer.train_step` and against float64, and bf16 S3D logits in fp and
int8 (int8 stepped in lock-step with JAX's walk). A bf16 step is far from
exact on either side, so the port is held to float64 by JAX's own distance
from it: within a stated multiple of it plus a stated slack. Inputs are made
with numpy from a seed."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flagship import he_scale_deconvs, small
from test_torch_s3d import _port, _seeded_variables
from test_torch_s3d_train import PW, T, _clips_u8, _jax_float64_step, _spec
from test_torch_s3d_train import HW as S3D_HW
from test_torch_train import HW, SMALL, flat, jax_cfg, one_device_mesh, port_cfg
from test_torch_train_step import _adam, _grads, _jax_float64_loss

torch.set_num_threads(2)

BF16 = torch.bfloat16
# the port's bf16 distance to float64 within RATIO × JAX bf16's + the slack
# (of the gradient's norm, or of the loss)
RATIO = 1.5
GRAD_SLACK, LOSS_SLACK = 1e-2, 1e-2
# a CViT's bf16 gradient against JAX's bf16 gradient, of its norm (measured
# 4.9% for cvit and 4.0% for cvit_repbn8; BatchNorm's fast path with one
# fused rounding in place of JAX's two reads 82%, a zero gradient 100%)
CVIT_GRAD_VS_JAX = 0.1


def _bf16_ulps(ref, n=2):
    """``n`` bf16 ulps at the largest |value| of ``ref`` (at least at 1)."""
    return n * 2.0 ** (np.floor(np.log2(max(1.0, float(np.abs(ref).max())))) - 7)


def _rel(a, b):
    num = sum(float((a[k] - b[k]).double().square().sum()) for k in b)
    return (num / sum(float(b[k].double().square().sum()) for k in b)) ** 0.5


# ---- BatchNorm: JAX's bf16 fast path ---------------------------------------------------

@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_bn_bf16_fast_path_matches_jax(kind):
    """`BatchNorm2d` / `BN3D` on a bf16 input against JAX's `TorchBatchNorm`
    / `BN3D` with ``dtype=bfloat16`` (`Bf16FastBatchNorm`), the same fp32
    parameters and stats: the training output within one bf16 ulp of its
    magnitude (4e-2 at |y| < 8), the running stats fp32 and within 1e-6 (relative) of
    JAX's and of flax's rule applied in float64 to the same bf16 values
    (mean and E[x²] of ``x.float()``); the eval output from the running
    stats likewise; the gradient finite. The fp32 path is not touched: an
    fp32 input gives torch's fused batch norm."""
    from fac_fake_tpu.models.layers import TorchBatchNorm
    from fac_fake_tpu.models.s3d.layers import BN3D as JaxBN3D
    from fac_fake_torch.models.layers import BatchNorm2d
    from fac_fake_torch.models.s3d.layers import BN3D

    rng = np.random.default_rng(1)
    shape = (8, 6, 6, 32) if kind == "2d" else (2, 4, 6, 6, 32)
    x32 = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    xj = jnp.asarray(x32).astype(jnp.bfloat16)
    jbn = (TorchBatchNorm if kind == "2d" else JaxBN3D)(use_running_average=False,
                                                       dtype=jnp.bfloat16)
    v = jbn.init(jax.random.key(0), xj)
    scale = rng.uniform(0.5, 2.0, 32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    ra_mean = rng.standard_normal(32).astype(np.float32)
    ra_var = rng.uniform(0.5, 2.0, 32).astype(np.float32)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}}
    ref, mut = jbn.apply(v, xj, mutable=["batch_stats"])
    bn = BatchNorm2d(32, eps=1e-5) if kind == "2d" else BN3D(32)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(ra_mean))
        bn.running_var.copy_(torch.from_numpy(ra_var))
    perm = (0, 3, 1, 2) if kind == "2d" else (0, 4, 1, 2, 3)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(BF16).permute(*perm)
    xt.requires_grad_(True)
    bn.train()
    out = bn(xt)
    assert out.dtype == BF16
    back = tuple(np.argsort(perm))
    y, yr = out.detach().float().permute(*back).numpy(), np.asarray(ref.astype(jnp.float32))
    assert np.abs(y - yr).max() <= 4e-2 * max(1.0, np.abs(yr).max() / 8)
    # running stats: fp32, JAX's, and flax's rule in float64 on the same values
    xf = np.asarray(xj.astype(jnp.float32)).astype(np.float64).reshape(-1, 32)
    mean, var = xf.mean(0), np.maximum((xf ** 2).mean(0) - xf.mean(0) ** 2, 0)
    m = bn.momentum
    for got, jax_val, f64 in ((bn.running_mean, mut["batch_stats"]["mean"],
                               (1 - m) * ra_mean + m * mean),
                              (bn.running_var, mut["batch_stats"]["var"],
                               (1 - m) * ra_var + m * var)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_val), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got.numpy(), f64, rtol=1e-6, atol=1e-7)
    out.float().square().sum().backward()
    assert torch.isfinite(xt.grad).all() and torch.isfinite(bn.weight.grad).all()
    # eval: the running stats
    bn.eval()
    jev = (TorchBatchNorm if kind == "2d" else JaxBN3D)(use_running_average=True,
                                                       dtype=jnp.bfloat16)
    ev_ref = np.asarray(jev.apply({"params": v["params"], "batch_stats": mut["batch_stats"]},
                                  xj).astype(jnp.float32))
    with torch.no_grad():
        ev = bn(xt.detach()).float().permute(*back).numpy()
    assert np.abs(ev - ev_ref).max() <= 4e-2 * max(1.0, np.abs(ev_ref).max() / 8)
    # the fp32 path: torch's own batch norm
    bn.train()
    x64 = xt.detach().float()
    torch.testing.assert_close(bn(x64), torch.nn.functional.batch_norm(
        x64, bn.running_mean.clone(), bn.running_var.clone(), bn.weight, bn.bias, True,
        bn.momentum, bn.eps), rtol=0, atol=0)


# ---- one bf16 train step: CViT -------------------------------------------------------------

def _jax_cvit(name, dtype):
    from fac_fake_tpu.models.cvit import CViT
    from fac_fake_tpu.models.stems import repbn8_stem1, repbn8_stem2, vgg_stem
    if name == "cvit":
        return CViT(stem_spec=small(vgg_stem()), dtype=dtype, **SMALL)
    return CViT(stem_spec=small(repbn8_stem1()), stem2_spec=small(repbn8_stem2()),
                use_ggca=True, ffn_norm="linearnorm", dtype=dtype, **SMALL)


def _port_cvit(name, state, dtype):
    """A port model and trainer at ``model.dtype`` from JAX's state."""
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    from fac_fake_torch.train.trainer import Trainer
    from test_torch_train_step import _port_model
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    if state.schedule:
        variables["schedule"] = state.schedule
    m = _port_model(name)
    sd = cvit_state_dict_from_flax(flat(variables), name)
    for k, t in m.state_dict().items():
        sd.setdefault(k, t)
    m.load_state_dict(sd, strict=True)
    cfg = port_cfg()
    cfg.model.dtype = dtype
    return m, Trainer(m, cfg, device="cpu")


@pytest.mark.parametrize("name", ["cvit", "cvit_repbn8"])
def test_cvit_bf16_train_step_matches_jax(name):
    """One bf16 train step of a small model (augmentation off) from the same
    weights and batch as JAX's bf16 `Trainer.train_step` (``dtype=bfloat16``
    model, "auto" chain): the parameters and Adam's moments stay fp32, the
    running stats fp32; the port's gradient (Adam's first moment over
    1 − β1) within CVIT_GRAD_VS_JAX of its norm from JAX's bf16 gradient;
    the port's loss and gradient also within RATIO × JAX bf16's distance
    from the float64 step plus LOSS_SLACK of the loss and GRAD_SLACK of the
    gradient's norm (a check that the two bf16 steps are equally far from
    float64, not one that a wrong gradient fails: a zero gradient is 1.0
    from float64, under that bound). The
    float64 step is the port's (`_grads`; held to JAX's float64 step within
    1e-6 in `tests/test_torch_train_step.py`), its loss also JAX's own
    (`_jax_float64_loss`). Measured (torch 2.13 CPU, jax 0.9.0): gradient
    port 0.852 / JAX 0.855 (cvit), 1.030 / 1.033 (flagship) of the norm
    from float64, the two 4.9% and 4.0% apart; loss 2.5e-2 / 2.2e-2 and
    2.1e-2 / 1.9e-2 of it: bf16's own rounding through BatchNorm's backward
    at 64², the same on both sides. The running
    stats (all of them, relative L2) within RATIO × JAX's distance from the
    float64 step's + 1e-4; LinearNorm's counters equal."""
    from fac_fake_tpu.train.trainer import Trainer as JaxTrainer
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax

    jm = _jax_cvit(name, jnp.bfloat16)
    jt = JaxTrainer(jm, jax_cfg(), mesh=one_device_mesh(), input_shape=(1, HW, HW, 3))
    state = jt.init_state(seed=0)
    v = {"params": state.params, "batch_stats": state.batch_stats}
    if name == "cvit_repbn8":
        v = he_scale_deconvs(v)
        sched = jax.tree.map(lambda a: jnp.asarray(150000, jnp.int32) if a.ndim == 0 and int(a) > 0
                             else a, state.schedule)
        state = state.replace(schedule=sched)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"],
                          opt_state=jt.tx.init(v["params"]))
    rng = np.random.default_rng(7)
    batch = {"image": rng.integers(0, 256, (4, HW, HW, 3), dtype=np.uint8),
             "label": np.array([0, 1, 1, 0], np.int32), "mask": np.ones(4, np.float32)}
    tb = {"image": torch.from_numpy(batch["image"]), "label": torch.from_numpy(batch["label"]).long(),
          "mask": torch.from_numpy(batch["mask"])}

    m32, tr32 = _port_cvit(name, state, "float32")
    losses64 = []
    g64 = _grads(m32, tr32, tb, torch.float64, losses=losses64)
    jax64 = _jax_float64_loss(_jax_cvit(name, jnp.float32), jt, state, batch)
    assert abs(losses64[0] - jax64) <= 1e-6 * abs(jax64)
    m, tr = _port_cvit(name, state, "bfloat16")
    state, jmet = jt.train_step(state, jt.put_batch(batch), jax.random.key(0))
    met = tr.train_step(tb, torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in m.parameters())
    params = dict(m.named_parameters())
    assert all(tr.optimizer.state[p]["exp_avg"].dtype == torch.float32 for p in params.values())
    mu = cvit_state_dict_from_flax(flat(_adam(state.opt_state).mu, ("params",)), name)
    g_port = {k: tr.optimizer.state[p]["exp_avg"].double() / 0.1 for k, p in params.items()}
    g_jax = {k: mu[k].double() / 0.1 for k in params}
    wd = tr.cfg.train.optim.weight_decay
    g64 = {k: g64[k] for k in params}
    errs = {"port_vs_f64": _rel(g_port, g64), "jax_vs_f64": _rel(g_jax, g64),
            "port_vs_jax": _rel(g_port, g_jax)}
    loss = {"port": float(met["loss"]), "jax": float(jmet["loss"]), "f64": jax64}
    print(f"{name} bf16 step: loss {loss}; gradient {errs} (weight decay {wd})")
    assert errs["port_vs_jax"] <= CVIT_GRAD_VS_JAX, errs
    assert errs["port_vs_f64"] <= RATIO * errs["jax_vs_f64"] + GRAD_SLACK, errs
    assert abs(loss["port"] - jax64) <= RATIO * abs(loss["jax"] - jax64) + LOSS_SLACK * abs(jax64), \
        loss
    # the running stats (and LinearNorm's counters) after the step
    m64 = copy.deepcopy(m32).double().train()
    with torch.no_grad():
        m64(tr32.normalize(tb["image"].double() / 255.0))
    b64 = dict(m64.named_buffers())
    jb = cvit_state_dict_from_flax(flat({"batch_stats": state.batch_stats, **(
        {"schedule": state.schedule} if state.schedule else {})}), name)
    bufs = dict(m.named_buffers())
    stats = [k for k in jb if k.endswith(("running_mean", "running_var"))]
    for k in set(jb) - set(stats):                  # LinearNorm's counters
        assert torch.equal(bufs[k], jb[k].to(bufs[k].dtype)), k
    assert all(bufs[k].dtype == torch.float32 for k in stats)
    e = {"port": _rel({k: bufs[k] for k in stats}, {k: b64[k] for k in stats}),
         "jax": _rel({k: jb[k] for k in stats}, {k: b64[k] for k in stats})}
    print(f"{name} bf16 running stats from float64's: {e}")
    assert e["port"] <= RATIO * e["jax"] + 1e-4, e


# ---- one bf16 train step: S3D --------------------------------------------------------------

def _short_spec(name):
    """The spec's first eight ops, up to ``ca_s3d``'s mix 3c (a context block
    between the two mixes) or the msca family's 320-channel conv (its two
    light iFormer blocks before it), ending at 4² × 8 frames at 32²: each
    BatchNorm there normalizes 256 values a channel. The full spec ends at
    1² × 2 frames, 4 values a channel, where bf16's rounding decides the
    normalized values: over three seeds either side's full-spec bf16
    gradient was 1.1-4.1× its norm from float64, so it is held layer by
    layer instead (`test_s3d_bf16_logits_match_jax`)."""
    return _spec(name)[:8]


@pytest.mark.parametrize("name", ["ca_s3d", "msca_s3d"])
def test_s3d_bf16_train_step_matches_jax(name):
    """One bf16 train step (augmentation off, ``raw255``: ``bf16(u8)/255 ·
    255`` in bf16, ``bce_weighted``) of a small model (the full spec at 32²,
    16 frames, batch 2) from JAX's seeded variables, against JAX's bf16
    `Trainer.train_step` (``S3DNet(dtype=bfloat16)``) and JAX's own float64
    step (`_jax_float64_step`): the port's loss, gradient and each
    running-stat tensor within RATIO × JAX bf16's distance from float64 plus
    LOSS_SLACK of the loss, GRAD_SLACK of the gradient's norm and 1e-4, on
    the spec's first eight ops (`_short_spec`). Measured over seeds 11-13:
    gradient port 0.338-0.354 / JAX 0.351-0.353 (ca_s3d), 0.335-0.350 /
    0.339-0.342 (msca_s3d) of the float64 norm; losses within 0.6% of
    float64 on both sides."""
    from fac_fake_tpu.models.s3d.model import S3DNet as JaxS3D
    from fac_fake_tpu.train.state import TrainState
    from fac_fake_tpu.train.trainer import Trainer as JaxTrainer
    from fac_fake_torch.compat.weights import s3d_state_dict_from_flax
    from fac_fake_torch.train.trainer import Trainer
    from test_torch_s3d_train import _adam_mu

    spec = _short_spec(name)
    batch = {"image": _clips_u8(seed=11), "label": np.array([0, 1], np.int32),
             "mask": np.ones(2, np.float32)}
    jm = JaxS3D(spec=spec, num_class=1, dtype=jnp.bfloat16)
    v = _seeded_variables(jm, batch["image"].astype(np.float32), 11)
    jcfg = jax_cfg(loss="bce_weighted")
    jcfg.data.normalize = "raw255"
    jt = JaxTrainer(jm, jcfg, mesh=one_device_mesh(), loss_kwargs={"pos_weight": PW},
                    input_shape=(1, T, S3D_HW, S3D_HW, 3))
    m = _port(spec, v)
    m.dtype = BF16
    jloss64, jmu64, jstats64 = _jax_float64_step(jm, v, jt, batch)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], schedule={},
                       opt_state=jt.tx.init(v["params"]))
    state, jmet = jt.train_step(state, jt.put_batch(batch), jax.random.key(0))

    cfg = port_cfg(loss="bce_weighted")
    cfg.data.normalize = "raw255"
    cfg.model.dtype = "bfloat16"
    tr = Trainer(m, cfg, device="cpu", loss_kwargs={"pos_weight": PW})
    tb = {"image": torch.from_numpy(batch["image"]), "label": torch.from_numpy(batch["label"]).long(),
          "mask": torch.from_numpy(batch["mask"])}
    met = tr.train_step(tb, torch.Generator().manual_seed(0))
    loss = {"port": float(met["loss"]), "jax": float(jmet["loss"]), "f64": jloss64}
    assert abs(loss["port"] - jloss64) <= RATIO * abs(loss["jax"] - jloss64) \
        + LOSS_SLACK * abs(jloss64), loss
    params = dict(m.named_parameters())
    assert all(p.dtype == torch.float32 for p in params.values())
    mu = s3d_state_dict_from_flax(flat(_adam_mu(state.opt_state), ("params",)), spec)
    mu64 = s3d_state_dict_from_flax(flat(jmu64, ("params",)), spec)
    g_port = {k: tr.optimizer.state[p]["exp_avg"].double() / 0.1 for k, p in params.items()}
    g_jax = {k: mu[k].double() / 0.1 for k in params}
    g64 = {k: mu64[k].double() / 0.1 for k in params}
    errs = {"port_vs_f64": _rel(g_port, g64), "jax_vs_f64": _rel(g_jax, g64),
            "port_vs_jax": _rel(g_port, g_jax)}
    print(f"{name} bf16 step: loss {loss}; gradient {errs}")
    assert errs["port_vs_f64"] <= RATIO * errs["jax_vs_f64"] + GRAD_SLACK, errs
    jb = s3d_state_dict_from_flax(flat({"batch_stats": state.batch_stats}), spec)
    jb64 = s3d_state_dict_from_flax(flat({"batch_stats": jstats64}), spec)
    bufs = dict(m.named_buffers())
    for k, want in jb.items():
        ref = jb64[k].double()
        e_port = float((bufs[k].double() - ref).norm() / ref.norm())
        e_jax = float((want.double() - ref).norm() / ref.norm())
        assert bufs[k].dtype == torch.float32 and e_port <= RATIO * e_jax + 1e-4, (k, e_port, e_jax)


# ---- bf16 S3D scoring, fp and int8 -------------------------------------------------------------

# a bf16 layer's output, port vs JAX on the same bf16 input: within this
# share of its largest value (measured: at most 1.13%, one or two bf16 ulps
# of the largest value, at every layer of ca_s3d and msca_s3d), and beyond
# 1% of it on at most 0.1% of the values
LAYER_REL = 2e-2


@pytest.mark.parametrize("name", ["ca_s3d", "msca_s3d"])
def test_s3d_bf16_logits_match_jax(name):
    """bf16 S3D scoring (``model.dtype=bfloat16``: the clips cast to bf16,
    every layer in bf16, BatchNorm's fast path in eval) against JAX's
    ``S3DNet(dtype=bfloat16)`` from the same variables, batch 2 at 32², layer
    by layer: each spec op of the port on JAX's bf16 output of the op before
    it, within LAYER_REL of its largest value; the head on JAX's last
    features within two bf16 ulps of JAX's logits. Free-running, the two bf16 forwards
    drift apart as bf16 rounding compounds through the spec (the deep layers
    see 1² maps at 32²): their logits are printed beside the fp32 ones (they
    differed from fp32 by up to 0.24 on the port's side and 0.43 on JAX's),
    not held. Also `S3DEvaluator` and `build_model` in bf16."""
    from fac_fake_tpu.models.s3d.layers import max_pool3d as jax_pool
    from fac_fake_tpu.models.s3d.model import S3DNet as JaxS3D
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.evaluate.s3d_eval import S3DEvaluator
    from fac_fake_torch.models import build_model
    from fac_fake_torch.models.s3d.layers import avg_pool3d

    spec = _spec(name)
    clips = _clips_u8(seed=3)
    jm = JaxS3D(spec=spec, num_class=1, dtype=jnp.bfloat16)
    v = _seeded_variables(jm, clips.astype(np.float32), 3)
    xj = jnp.asarray(clips, jnp.float32)
    ref, st = jm.apply(v, xj, capture_intermediates=True, mutable=["intermediates"])
    inter = st["intermediates"]
    m = _port(spec, v)
    m.dtype = BF16
    to_port = lambda a: torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(BF16) \
        .permute(0, 4, 1, 2, 3)
    prev = xj.astype(jnp.bfloat16)
    worst = 0.0
    for i, op in enumerate(spec):
        if op[0] == "pool":
            prev = jax_pool(prev, op[1], op[2], op[3])
            continue
        want = np.asarray(inter[f"l{i}"]["__call__"][0].astype(jnp.float32))
        with torch.no_grad():
            got = m.base[i](to_port(prev))
        assert got.dtype == BF16
        d = np.abs(got.float().permute(0, 2, 3, 4, 1).numpy() - want)
        top = np.abs(want).max()
        worst = max(worst, d.max() / top)
        assert d.max() <= LAYER_REL * top and (d > 0.01 * top).mean() <= 1e-3, (i, op[0], d.max() / top)
        prev = inter[f"l{i}"]["__call__"][0]
    with torch.no_grad():
        f = to_port(prev)
        head = m.fc(avg_pool3d(f, (2, f.shape[3], f.shape[4]))).flatten(2).mean(2).float().numpy()
    np.testing.assert_allclose(head, np.asarray(ref), rtol=0, atol=_bf16_ulps(ref))
    ref32 = np.asarray(jax.jit(jm.clone(dtype=jnp.float32).apply)(v, xj))
    x = torch.from_numpy(clips).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        got = m(x.float()).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    print(f"{name} bf16: layers within {worst:.3g} of their largest value; free-running logits "
          f"port {got.ravel()}, JAX {np.asarray(ref).ravel()}, fp32 {ref32.ravel()}")
    ev = S3DEvaluator(m, degrade=False, device="cpu")
    np.testing.assert_allclose(ev.predict_batch(clips),
                               1 / (1 + np.exp(-got.reshape(2, -1).mean(-1))), rtol=0, atol=1e-6)
    b = build_model(ModelConfig(name=name, num_class=1, dtype="bfloat16"), device="cpu")
    assert b.dtype == BF16 and all(p.dtype == torch.float32 for p in b.parameters())


@pytest.mark.parametrize("name", ["ca_s3d", "msca_s3d"])
def test_s3d_bf16_int8_engine_follows_the_model(name, monkeypatch):
    """The S3D int8 engine of a bf16 model (JAX `compat/quantize_s3d.py:110,
    :138`): its walk in bf16 (K5's bf16 out mode, the fp blocks and head in
    bf16), calibrated in fp32 (its qparams those of the fp32 model's
    engine, bit for bit); with JAX's bf16 engine's qparams carried over it
    steps in lock-step with JAX's walk (`lockstep_logits` of
    `tests/test_torch_quantize_s3d.py`, its tolerances in bf16 terms: each
    quantize's x/s_x within two bf16 ulps (2^17 fp32 ulps) of the point's
    largest value, a flipped code only that near a .5 tie, each fp block
    within 2e-2 of its largest value, JAX's codes and blocks carried on), and
    its logits within two bf16 ulps of JAX's bf16 int8 logits (measured: one,
    0.031 at |logit| 5.4, and 0)."""
    import test_torch_quantize_s3d as tq
    from fac_fake_tpu.compat.quantize_s3d import quantize_s3d as jax_quantize
    from fac_fake_tpu.models.s3d.model import S3DNet as JaxS3D
    from fac_fake_torch.compat.quantize_s3d import quantize_s3d

    spec = _spec(name)
    clips = _clips_u8(b=2, seed=4).astype(np.float32)
    jm = JaxS3D(spec=spec, num_class=1, dtype=jnp.bfloat16)
    v = _seeded_variables(jm, clips, 4)
    m = _port(spec, v)
    m.dtype = BF16
    x = torch.from_numpy(clips).permute(0, 4, 1, 2, 3)
    eng = quantize_s3d(m, x)
    m32 = copy.deepcopy(m)
    m32.dtype = torch.float32
    eng32 = quantize_s3d(m32, x)
    assert eng.dtype == BF16 and eng32.dtype == torch.float32
    for k, q in eng.qparams.items():
        for f, t in q.items():
            assert torch.equal(t, eng32.qparams[k][f]), (k, f)
    je = jax_quantize(jm, v, jnp.asarray(clips))
    ref = np.asarray(je(jnp.asarray(clips))).ravel()
    rec, points, blocks = tq.jax_quantize_points(je, v, clips)
    np.testing.assert_array_equal(rec, ref)
    monkeypatch.setattr(tq, "VALUE_ULPS", 2 ** 17)
    monkeypatch.setattr(tq, "TIE_ULPS", 2 ** 17)
    monkeypatch.setattr(tq, "FP_BLOCK_REL", 2e-2)
    carried = copy.deepcopy(eng)
    tq._carry_qparams(carried, je.qparams)
    got, flips = tq.lockstep_logits(carried, x, points, blocks)
    with torch.no_grad():
        free = eng(x).numpy().ravel()
    print(f"{name} bf16 int8: lock-step logits {np.abs(got - ref).max():.3g} from JAX's "
          f"({len(flips)} codes flipped at ties); free-running {np.abs(free - ref).max():.3g}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=_bf16_ulps(ref))


# ---- the CLI -----------------------------------------------------------------------------------

def test_cli_trains_in_bf16_and_records_the_dtype(tmp_path):
    """``cli/train.py --set model.dtype=bfloat16`` at tiny widths on the CPU
    (the strong_aug chain on, "auto": bf16): one epoch; ``best.pth`` and the
    epoch checkpoint hold fp32 master weights and record ``dtype``
    bfloat16, and the weights load strict into a fresh model."""
    import os
    from fac_fake_torch.cli import train
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model
    from test_torch_checkpoint import _crop_tree

    root = _crop_tree(str(tmp_path / "crops"), n=(4, 4))
    ck = str(tmp_path / "ck")
    out = train.main(["--model", "cvit", "--data-root", root, "--epochs", "1", "--batch-size",
                      "4", "--device", "cpu", "--checkpoint-dir", ck, "--set",
                      "model.image_size=32", "model.patch_size=1", "model.dim=32",
                      "model.depth=1", "model.heads=2", "model.mlp_dim=32",
                      "data.num_workers=1", "train.log_every=0", "train.checkpoint_every=1",
                      "model.dtype='bfloat16'"])
    assert np.isfinite(out["history"]["train_loss"]).all()
    for f in ("best.pth", "epoch_000000.pt"):
        saved = torch.load(os.path.join(ck, f), map_location="cpu", weights_only=True)
        assert saved["dtype"] == "bfloat16", f
        assert all(t.dtype == torch.float32 for t in saved["state_dict"].values()
                   if t.is_floating_point())
    m = build_model(ModelConfig(name="cvit", image_size=32, patch_size=1, dim=32, depth=1,
                                heads=2, mlp_dim=32), device="cpu")
    m.load_state_dict(torch.load(os.path.join(ck, "best.pth"), map_location="cpu",
                                 weights_only=True)["state_dict"], strict=True)
