"""The port's training engine (`fac_fake_torch/train/`) against the JAX
package on the CPU: losses, LR controllers, the optimizer, the train-mode
norms (BatchNorm's running stats, RepBN, LinearNorm's blend and counters),
gradient accumulation against JAX's, and the trainer's own invariants
(remat, padded rows, cached eval, learning, the options it refuses). One
train step against JAX's is `tests/test_torch_train_step.py`. Inputs are
made with numpy from a seed; each comparison states its tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from test_torch_flagship import he_scale_deconvs, small

torch.set_num_threads(2)

HW = 64
SMALL = dict(patch_size=1, dim=32, depth=1, heads=2, mlp_dim=32)


def flat(tree, prefix=()):
    return {"/".join(prefix + k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree).items()}


def port_cfg(**train):
    from fac_fake_torch.core.config import Config
    cfg = Config()
    cfg.data.image_size = HW
    cfg.data.augment.enabled = False
    cfg.train.log_every = 0
    cfg.train.checkpoint_every = 0
    cfg.train.checkpoint_dir = ""
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def jax_cfg(**train):
    from fac_fake_tpu.core.config import Config
    cfg = Config()
    cfg.data.image_size = HW
    cfg.data.augment.enabled = False
    cfg.train.log_every = 0
    cfg.train.checkpoint_every = 0
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def one_device_mesh():
    from fac_fake_tpu.core.config import MeshConfig
    from fac_fake_tpu.parallel.mesh import build_mesh
    return build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])


# ---- losses, schedules, optimizer ---------------------------------------------

@pytest.mark.parametrize("name,masked", [("cross_entropy", False), ("cross_entropy", True),
                                         ("bce_weighted", False), ("bce_weighted", True)])
def test_losses_match_jax(name, masked):
    """Masked (two padded rows) and plain means, 1e-6 relative."""
    from fac_fake_tpu.train.losses import make_loss as jax_loss
    from fac_fake_torch.train.losses import make_loss

    rng = np.random.default_rng(0)
    n = 8
    logits = rng.standard_normal((n, 2 if name == "cross_entropy" else 1)).astype(np.float32) * 3
    labels = rng.integers(0, 2, n).astype(np.int32)
    mask = np.array([1] * 6 + [0] * 2, np.float32) if masked else None
    kw = {"pos_weight": 2.5} if name == "bce_weighted" else {}
    ref = float(jax_loss(name, **kw)(jnp.asarray(logits), jnp.asarray(labels),
                                     None if mask is None else jnp.asarray(mask)))
    got = float(make_loss(name, **kw)(torch.from_numpy(logits), torch.from_numpy(labels),
                                      None if mask is None else torch.from_numpy(mask)))
    assert abs(got - ref) <= 1e-6 * abs(ref), (got, ref)


@pytest.mark.parametrize("schedule", ["plateau", "step", "cosine", "const"])
def test_lr_controllers_match_jax(schedule):
    """The four controllers over one validation-loss sequence: equal."""
    from fac_fake_tpu.core.config import OptimConfig as JaxOptim
    from fac_fake_tpu.train.schedules import build_controller as jax_build
    from fac_fake_torch.core.config import OptimConfig
    from fac_fake_torch.train.schedules import build_controller

    kw = dict(lr=1e-3, schedule=schedule, step_size=3, plateau_patience=1)
    a, b = jax_build(JaxOptim(**kw), epochs=10), build_controller(OptimConfig(**kw), epochs=10)
    losses = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.61, 0.62, 0.63]
    assert [a.epoch_end(e, v) for e, v in enumerate(losses)] == \
        [b.epoch_end(e, v) for e, v in enumerate(losses)]


def test_optimizer_matches_optax():
    """Adam with coupled L2 against `make_optimizer` on the same gradients,
    three steps with an LR change before the third: 1e-6 relative."""
    from fac_fake_tpu.train.state import make_optimizer as jax_opt
    from fac_fake_torch.train.state import make_optimizer, set_learning_rate

    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) for _ in range(3)]
    tx = jax_opt(1e-2, 1e-3)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    model = torch.nn.Linear(7, 5, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(p0))
    opt = make_optimizer(model, 1e-2, 1e-3)
    for i, g in enumerate(grads):
        if i == 2:
            st.hyperparams["learning_rate"] = jnp.asarray(3e-3, jnp.float32)
            set_learning_rate(opt, 3e-3)
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = jp + upd
        model.weight.grad = torch.from_numpy(g.copy())
        opt.step()
        ref = np.asarray(jp)
        got = model.weight.detach().numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


# ---- train-mode norms ------------------------------------------------------------------

def _bn_sd(v):
    return {"weight": torch.from_numpy(np.asarray(v["params"]["scale"])),
            "bias": torch.from_numpy(np.asarray(v["params"]["bias"])),
            "running_mean": torch.from_numpy(np.asarray(v["batch_stats"]["mean"])),
            "running_var": torch.from_numpy(np.asarray(v["batch_stats"]["var"])),
            "num_batches_tracked": torch.tensor(0)}


def _random_bn(v, seed):
    rng = np.random.default_rng(seed)
    f = traverse_util.flatten_dict(v)
    for k in f:
        f[k] = jnp.asarray(rng.uniform(0.5, 1.5, np.shape(f[k])) if k[-1] in ("scale", "var")
                           else rng.normal(0, 0.2, np.shape(f[k])), jnp.float32)
    return traverse_util.unflatten_dict(f)


def test_batchnorm_train_matches_flax_biased_variance():
    """JAX's TorchBatchNorm in training against the port's at 2×3 values a
    channel, where the unbiased running variance would be 6/5 of JAX's:
    output and running stats within 1e-5, two steps."""
    from fac_fake_tpu.models.layers import TorchBatchNorm
    from fac_fake_torch.models.layers import BatchNorm2d

    rng = np.random.default_rng(3)
    xs = [(rng.standard_normal((2, 1, 3, 16)) * 2 + 0.5).astype(np.float32) for _ in range(2)]
    jm = TorchBatchNorm(use_running_average=False)
    v = _random_bn(jm.init(jax.random.key(0), jnp.asarray(xs[0])), 3)
    m = BatchNorm2d(16, eps=1e-5)
    m.load_state_dict(_bn_sd(v))
    m.train()
    for x in xs:
        ref, mut = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(v["batch_stats"]["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(m.running_var.numpy(), np.asarray(v["batch_stats"]["var"]),
                                   rtol=1e-5, atol=1e-6)
    # torch's own rule would have missed by the factor n/(n-1)
    torch_bn = torch.nn.BatchNorm2d(16).train()
    torch_bn.load_state_dict(_bn_sd(_random_bn(jm.init(jax.random.key(0), jnp.asarray(xs[0])), 3)))
    torch_bn(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))
    ours = BatchNorm2d(16).train()
    ours.load_state_dict(_bn_sd(_random_bn(jm.init(jax.random.key(0), jnp.asarray(xs[0])), 3)))
    ours(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))
    assert not torch.allclose(torch_bn.running_var, ours.running_var, rtol=1e-3)


@pytest.mark.parametrize("warm,it", [(2, 150000), (0, 150000), (0, 300000)])
def test_linear_norm_train_matches_jax(warm, it):
    """LinearNorm's training forward against JAX's over three steps, from
    ``warm`` > 0 (LayerNorm alone while it counts down) and mid-schedule
    (the blend): output 1e-5, RepBN's running stats (biased variance over
    2·5 values a channel) 1e-5, the counters equal."""
    from fac_fake_tpu.models.layers import LinearNorm as JaxLinearNorm
    from fac_fake_torch.compat.weights import cvit_torch_key
    from fac_fake_torch.models.layers import LinearNorm

    rng = np.random.default_rng(4)
    xs = [(rng.standard_normal((2, 5, 32)) * 2 + 1).astype(np.float32) for _ in range(3)]
    jm = JaxLinearNorm(32)
    v = jm.init(jax.random.key(4), jnp.asarray(xs[0]), train=True)
    v = {"params": v["params"], "batch_stats": _random_bn(v["batch_stats"], 4),
         "schedule": {"warm": jnp.asarray(warm, jnp.int32), "iter": jnp.asarray(it, jnp.int32)}}
    sd = {}
    for col in ("params", "batch_stats", "schedule"):
        for k, a in traverse_util.flatten_dict({"transformer": {"ffn_norm0": v[col]}}).items():
            key, tf = cvit_torch_key([col, *k], "cvit_repbn8")
            sd[key[len("transformer.layers.0.1.fn.norm."):]] = torch.from_numpy(
                np.array(tf(np.asarray(a, np.float32))))
    m = LinearNorm(32)
    m.load_state_dict({**sd, "norm2.bn.num_batches_tracked": torch.tensor(0)}, strict=True)
    m.train()
    for x in xs:
        ref, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats", "schedule"])
        v = {"params": v["params"], **mut}
        got = m(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        bs = v["batch_stats"]["norm2"]["bn"]
        np.testing.assert_allclose(m.norm2.bn.running_mean.numpy(), np.asarray(bs["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(m.norm2.bn.running_var.numpy(), np.asarray(bs["var"]),
                                   rtol=1e-5, atol=1e-6)
        assert (int(m.warm), int(m.iter)) == (int(v["schedule"]["warm"]),
                                              int(v["schedule"]["iter"]))
    assert int(m.warm) == max(warm - 3, 0)


def test_repbn_train_matches_jax():
    """RepBN alone in training: output and running stats within 1e-5."""
    from fac_fake_tpu.models.layers import RepBN as JaxRepBN
    from fac_fake_torch.models.layers import RepBN

    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 3, 16)) * 3).astype(np.float32)
    jm = JaxRepBN(16)
    v = jm.init(jax.random.key(5), jnp.asarray(x), train=True)
    v = {"params": {"alpha": jnp.asarray([0.7], jnp.float32), "bn": v["params"]["bn"]},
         "batch_stats": _random_bn(v["batch_stats"], 5)}
    ref, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    m = RepBN(16)
    m.load_state_dict({"alpha": torch.tensor([0.7]),
                       **{f"bn.{k}": t for k, t in _bn_sd(
                           {"params": v["params"]["bn"],
                            "batch_stats": v["batch_stats"]["bn"]}).items()}})
    got = m.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["bn"]["var"]), rtol=1e-5, atol=1e-6)


def _port_model(name):
    from fac_fake_torch.models.cvit import CViT
    from fac_fake_torch.models.stems import repbn8_stem1, repbn8_stem2, vgg_stem
    if name == "cvit":
        m = CViT(small(vgg_stem()), image_size=HW, **SMALL)
    else:
        m = CViT(small(repbn8_stem1()), image_size=HW, stem2_spec=small(repbn8_stem2()),
                 use_ggca=True, ffn_norm="linearnorm", **SMALL)
    return m.to(memory_format=torch.channels_last)



def test_grad_accumulation_matches_jax():
    """grad_accum_steps=4 on the BN-free model of `tests/test_train.py`
    against JAX's with the same setting, from the same weights: loss 1e-5,
    parameters after the one Adam update within 2e-7 where |g| > 1e-6, and
    the port's accumulated step against its own big-batch step."""
    from fac_fake_tpu.models.cvit import CViT as JaxCViT
    from fac_fake_tpu.train.trainer import Trainer as JaxTrainer
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    from fac_fake_torch.models.cvit import CViT
    from fac_fake_torch.train.trainer import Trainer

    spec = ()
    for _ in range(5):
        spec += (("conv", 8), ("relu",), ("pool",))
    kw = dict(patch_size=1, dim=32, depth=1, heads=2, mlp_dim=32, pos_mode="patch")
    rng = np.random.default_rng(0)
    b = {"image": rng.integers(0, 255, (16, 32, 32, 3), dtype=np.uint8),
         "label": np.arange(16, dtype=np.int32) % 2, "mask": np.ones((16,), np.float32)}
    tb = {"image": torch.from_numpy(b["image"]), "label": torch.from_numpy(b["label"]).long(),
          "mask": torch.from_numpy(b["mask"])}
    params = {}
    for accum in (4, 1):
        cfg = jax_cfg(grad_accum_steps=accum)
        cfg.data.image_size = 32
        jt = JaxTrainer(JaxCViT(stem_spec=spec, **kw), cfg, mesh=one_device_mesh(),
                        input_shape=(1, 32, 32, 3))
        st = jt.init_state(seed=0)
        m = CViT(spec, image_size=32, **kw)
        m.load_state_dict(cvit_state_dict_from_flax(flat({"params": st.params})), strict=True)
        pcfg = port_cfg(grad_accum_steps=accum)
        pcfg.data.image_size = 32
        tr = Trainer(m, pcfg, device="cpu")
        st, jmet = jt.train_step(st, jt.put_batch(b), jax.random.key(7))
        met = tr.train_step(tb, torch.Generator().manual_seed(0))
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-5
        assert float(met["count"]) == float(jmet["count"]) == 16.0
        assert float(met["correct"]) == float(jmet["correct"])
        jp = cvit_state_dict_from_flax(flat({"params": st.params}))
        for k, p in m.named_parameters():
            g = tr.optimizer.state[p]["exp_avg"].numpy()
            clear = np.abs(g) > 1e-7
            np.testing.assert_allclose(p.detach().numpy()[clear], jp[k].numpy()[clear],
                                       rtol=0, atol=2e-7, err_msg=k)
        params[accum] = {k: p.detach().clone() for k, p in m.named_parameters()}
    for k in params[1]:
        torch.testing.assert_close(params[4][k], params[1][k], rtol=0, atol=2e-5)


# ---- the trainer's own invariants ------------------------------------------------------------

def _tiny_flagship():
    from fac_fake_torch.models import init_weights
    m = _port_model("cvit_repbn8")
    init_weights(m, 0)
    for mod in m.modules():                  # mid-schedule, and one warm-up step left
        if type(mod).__name__ == "LinearNorm":
            mod.warm.fill_(1)
            mod.iter.fill_(150000)
    return m


def _batch(n=8, hw=HW, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)),
            "label": torch.from_numpy(rng.integers(0, 2, n)).long(), "mask": torch.ones(n)}


@pytest.mark.parametrize("remat", ["nothing", "dots"])
def test_remat_keeps_grads_and_buffers(remat):
    """The flagship with the strong_aug chain on, two steps: with remat the
    loss, the gradients (Adam's moments), the parameters and every buffer
    (BN stats, LinearNorm's counters, through its warm-up step and into the
    blend) equal the plain step's: the recompute sees the buffers the
    forward saw and moves them once."""
    from fac_fake_torch.train.trainer import Trainer

    out = {}
    for mode in ("none", remat):
        cfg = port_cfg(remat=mode)
        cfg.data.augment.enabled = True
        m = _tiny_flagship()
        tr = Trainer(m, cfg, device="cpu")
        losses = [float(tr.train_step(_batch(seed=i), torch.Generator().manual_seed(i))["loss"])
                  for i in range(2)]
        out[mode] = (losses, {k: v.clone() for k, v in m.state_dict().items()},
                     {k: tr.optimizer.state[p]["exp_avg"].clone()
                      for k, p in m.named_parameters()})
    (l0, s0, g0), (l1, s1, g1) = out["none"], out[remat]
    assert l0 == pytest.approx(l1, rel=1e-6)
    norm = lambda d: float(sum((t.double() ** 2).sum() for t in d.values())) ** 0.5
    assert norm({k: g0[k] - g1[k] for k in g0}) <= 1e-5 * norm(g0)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-5, atol=1e-6, msg=k)
    assert int(s0["transformer.layers.0.1.fn.norm.warm"]) == 0
    assert int(s0["transformer.layers.0.1.fn.norm.iter"]) == 149999


def test_padded_rows_do_not_leak_into_the_loss():
    """Rows masked out (a padded tail) change neither the loss nor the
    gradients, whatever their pixels; BatchNorm, as in JAX, still sees them,
    so the model here has none."""
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.models.cvit import CViT
    from fac_fake_torch.train.trainer import Trainer

    spec = ()
    for _ in range(5):
        spec += (("conv", 8), ("relu",), ("pool",))
    grads = []
    for fill in (0, 255):
        m = init_weights(CViT(spec, image_size=32, pos_mode="patch", **SMALL), 0)
        cfg = port_cfg()
        cfg.data.image_size = 32
        tr = Trainer(m, cfg, device="cpu")
        b = _batch(8, 32)
        b["image"][6:] = fill
        b["mask"][6:] = 0.0
        met = tr.train_step(b, torch.Generator().manual_seed(0))
        assert float(met["count"]) == 6.0
        grads.append((float(met["loss"]), {k: tr.optimizer.state[p]["exp_avg"].clone()
                                           for k, p in m.named_parameters()}))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=1e-6)
    for k in grads[0][1]:
        torch.testing.assert_close(grads[0][1][k], grads[1][1][k], rtol=1e-5, atol=1e-9)


def test_cached_and_streamed_eval_agree():
    """`evaluate` over a `DeviceCache` and over host batches of the same
    data: the same loss and accuracy."""
    from fac_fake_torch.train.trainer import Trainer
    tr = Trainer(_tiny_flagship(), port_cfg(), device="cpu")
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (16, HW, HW, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, 16).astype(np.int32)
    cache = tr.cache_data(imgs, labels, 8)
    host = [{"image": imgs[i:i + 8], "label": labels[i:i + 8], "mask": np.ones(8, np.float32)}
            for i in (0, 8)]
    a, b = tr.evaluate(cache), tr.evaluate(host)
    assert a["loss"] == pytest.approx(b["loss"], rel=1e-6) and a["acc"] == b["acc"]


def test_tiny_fit_learns_from_a_device_cache():
    """`fit` on cached separable data (class k has brightness level k):
    the training loss falls, the history has every column."""
    from helpers import synthetic_batches
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.models.cvit import CViT
    from fac_fake_torch.train.trainer import Trainer

    spec = ()
    for _ in range(5):
        spec += (("conv", 8), ("bn", 8), ("relu",), ("pool",))
    m = init_weights(CViT(spec, image_size=32, pos_mode="patch", **SMALL), 0)
    cfg = port_cfg()
    cfg.data.image_size = 32
    cfg.train.epochs = 4
    cfg.train.optim.lr = 3e-3
    tr = Trainer(m, cfg, device="cpu")
    data = synthetic_batches(4, 16, image_size=32)
    cache = tr.cache_data(np.concatenate([b["image"] for b in data]),
                          np.concatenate([b["label"] for b in data]), 16)
    out = tr.fit(cache, cache)
    h = out["history"]
    assert h["train_loss"][-1] < h["train_loss"][0]
    assert len(h["lr"]) == 4 and out["best"]["acc"] == max(h["val_acc"])
    assert tr.step == 16


def test_trainer_runs_on_the_card_by_default_and_refuses_unported_options():
    from fac_fake_torch.train.trainer import Trainer
    m = _tiny_flagship()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(m, port_cfg())
    from fac_fake_torch.core.config import apply_dotted
    cfg = port_cfg()
    cfg.data.augment.enabled = True
    apply_dotted(cfg, ["mesh.data=2"])
    with pytest.raises(NotImplementedError, match="item 12"):
        Trainer(m, cfg, device="cpu")
    # TensorBoard is ported: the option is taken (the writer opens in `fit`,
    # tests/test_torch_profiling.py)
    cfg = port_cfg()
    cfg.data.augment.enabled = True
    apply_dotted(cfg, ["train.tensorboard_dir='tb'"])
    assert Trainer(m, cfg, device="cpu").cfg.train.tensorboard_dir == "tb"
    # bf16 training is ported: the model's dtype and a bf16 chain are taken on
    # the CPU; "auto" follows the model; the parameters stay fp32
    for sets, chain in ((["model.dtype='bfloat16'"], "bfloat16"),
                        (["data.augment.compute_dtype='bfloat16'"], "bfloat16"),
                        (["model.dtype='bfloat16'", "data.augment.compute_dtype='float32'"],
                         "float32")):
        cfg = port_cfg()
        cfg.data.augment.enabled = True
        apply_dotted(cfg, sets)
        tr = Trainer(m, cfg, device="cpu")
        assert tr.augment.compute_dtype == chain
        assert tr.dtype == (torch.bfloat16 if "model" in sets[0] else torch.float32)
        assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    for path, value in (("model.dtype", "float16"), ("data.augment.compute_dtype", "float16")):
        cfg = port_cfg()
        cfg.data.augment.enabled = True
        apply_dotted(cfg, [f"{path}={value!r}"])
        with pytest.raises(ValueError, match="float16"):
            Trainer(m, cfg, device="cpu")
    cfg = port_cfg()
    cfg.data.normalize = "raw"
    with pytest.raises(ValueError, match="imagenet or raw255"):
        Trainer(m, cfg, device="cpu")
