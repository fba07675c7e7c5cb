"""One train step of the port (`fac_fake_torch/train/trainer.py`) against
JAX's `Trainer.train_step` on the CPU: a small ``cvit`` and ``cvit_repbn8``
from the same weights and batch, step 2 from JAX's carried-over training
state. Inputs are made with numpy from a seed;
each comparison states its tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_flagship import he_scale_deconvs, small
from test_torch_train import HW, SMALL, flat, jax_cfg, one_device_mesh, port_cfg

torch.set_num_threads(2)


# ---- one train step against JAX's Trainer.train_step ----------------------------------------

# Step 2's loss against float64 (`test_train_step_matches_jax`): the port's
# fp32 loss was 1.2e-7 to 2.7e-6 of the loss from JAX's float64 one at
# either step of either model (torch 2.13 CPU, jax 0.9.0), so 5e-6 of it.
LOSS_ATOL = 5e-6

def _jax_model(name):
    from fac_fake_tpu.models.cvit import CViT
    from fac_fake_tpu.models.stems import repbn8_stem1, repbn8_stem2, vgg_stem
    if name == "cvit":
        return CViT(stem_spec=small(vgg_stem()), **SMALL)
    return CViT(stem_spec=small(repbn8_stem1()), stem2_spec=small(repbn8_stem2()),
                use_ggca=True, ffn_norm="linearnorm", **SMALL)


def _port_model(name):
    from fac_fake_torch.models.cvit import CViT
    from fac_fake_torch.models.stems import repbn8_stem1, repbn8_stem2, vgg_stem
    if name == "cvit":
        m = CViT(small(vgg_stem()), image_size=HW, **SMALL)
    else:
        m = CViT(small(repbn8_stem1()), image_size=HW, stem2_spec=small(repbn8_stem2()),
                 use_ggca=True, ffn_norm="linearnorm", **SMALL)
    return m.to(memory_format=torch.channels_last)


def _adam(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state,
                                       is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
    (adam,) = [s for s in leaves if isinstance(s, optax.ScaleByAdamState)]
    return adam


def _port_from_jax_state(name, state):
    """A port model and trainer carrying JAX's whole training state."""
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax, load_flax_adam_state
    from fac_fake_torch.train.trainer import Trainer
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    if state.schedule:
        variables["schedule"] = state.schedule
    m = _port_model(name)
    sd = cvit_state_dict_from_flax(flat(variables), name)
    for k, t in m.state_dict().items():
        sd.setdefault(k, t)                 # num_batches_tracked: JAX has none
    m.load_state_dict(sd, strict=True)
    tr = Trainer(m, port_cfg(), device="cpu")
    adam = _adam(state.opt_state)
    load_flax_adam_state(m, tr.optimizer, flat(adam.mu, ("params",)), flat(adam.nu, ("params",)),
                         int(adam.count), name)
    return m, tr


def _gradient_errors(g_port, g_jax, g64, jax64=None):
    """The gradient within 1e-4 of its norm: the port's against the float64
    gradient of the same model routed as the port's fp32 forward
    (``g64["routed"]``), and against JAX's wherever neither fp32 gradient
    strays from the float64 one (``g64["plain"]``) by more than that. A
    max-pool window at a near-tie can pick another element in fp32 than in
    float64, on either side; then the two are printed, not held. With
    ``jax64``, JAX's own float64 gradient from the same state (by the
    port's keys): the port's float64 gradient within 1e-6 of it, and JAX's
    fp32 distance measured from it; where that distance is over 1e-4 (a
    step that JAX's fp32 does not resolve), the port's fp32 gradient is
    held to it in place of 1e-4; the two fp32 gradients, each within that
    of float64, within twice it of each other (their distances add)."""
    errs = {"port_vs_f64_routed": _rel(g_port, g64["routed"]),
            "port_vs_f64": _rel(g_port, g64["plain"]), "jax_vs_f64": _rel(g_jax, g64["plain"]),
            "port_vs_jax": _rel(g_port, g_jax)}
    bound = pair = 1e-4
    if jax64 is not None:
        errs["port_f64_vs_jax_f64"] = _rel(g64["plain"], jax64)
        errs["jax_vs_f64"] = _rel(g_jax, jax64)
        assert errs["port_f64_vs_jax_f64"] <= 1e-6, errs
        bound = max(1e-4, errs["jax_vs_f64"])
        pair = 2 * bound
    assert errs["port_vs_f64_routed"] <= bound, errs
    if errs["port_vs_f64"] <= bound and errs["jax_vs_f64"] <= bound:
        assert errs["port_vs_jax"] <= pair, errs
    return errs


def _compare_state(m, tr, state, name, g64, jax64=None, bufs64=None):
    """After a first step: the gradient (Adam's first moment over 1 − β1)
    against JAX's and against the float64 gradient ``g64`` of the same
    model, the second moment's root likewise, the parameters where |g| is
    clear of ε, the running stats and counters. Returns how many parameter
    entries were left out, and the gradient errors. ``jax64`` as in
    `_gradient_errors`, ``bufs64`` as in `_compare_buffers`."""
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    adam = _adam(state.opt_state)
    mu = cvit_state_dict_from_flax(flat(adam.mu, ("params",)), name)
    nu = cvit_state_dict_from_flax(flat(adam.nu, ("params",)), name)
    jp = cvit_state_dict_from_flax(flat({"params": state.params}), name)
    params = dict(m.named_parameters())
    g_port = {k: tr.optimizer.state[p]["exp_avg"].double() / 0.1 for k, p in params.items()}
    g_jax = {k: mu[k].double() / 0.1 for k in params}
    r_port = {k: tr.optimizer.state[p]["exp_avg_sq"].double().sqrt() for k, p in params.items()}
    r_jax = {k: nu[k].double().sqrt() for k in params}
    errs = _gradient_errors(g_port, g_jax, g64, jax64)
    errs["sqrt_nu_port_vs_jax"] = _rel(r_port, r_jax)
    if errs["port_vs_jax"] <= 1e-4:
        assert errs["sqrt_nu_port_vs_jax"] <= 1e-4, errs
    total = np.sqrt(sum(float(np.square(t.numpy()).sum()) for t in g_jax.values()))
    left_out = 0
    for k, p in params.items():
        g = g_jax[k].numpy()
        # a tensor whose gradient is zero but for rounding (a conv bias
        # before a BatchNorm) is that on both sides; its update is ±lr at
        # random, so its entries are left out below
        noise = np.linalg.norm(g) < 1e-5 * total
        if noise:
            assert np.linalg.norm(g_port[k].numpy()) < 1e-5 * total, k
        # Adam's first update is lr·g/(|g| + ε): compared where |g| > 1e-5
        # (clear of ε) and the two gradients agree within 10% (a single
        # small entry's gradient is far noisier than its tensor's norm,
        # which is held above)
        clear = (np.abs(g) > 1e-5) & (np.abs(g_port[k].numpy() - g) < 0.1 * np.abs(g)) \
            & (not noise)
        left_out += int((~clear).sum())
        np.testing.assert_allclose(p.detach().numpy()[clear], jp[k].numpy()[clear],
                                   rtol=0, atol=2e-7, err_msg=k)
    _compare_buffers(m, state, name, bufs64)
    return left_out, errs


def _compare_buffers(m, state, name, bufs64=None):
    """Running stats (biased variance) and LinearNorm's counters: JAX's.
    With ``bufs64``, the running stats of JAX's own float64 step from the
    same state (torch keys), the port's running stats held to those
    instead: each variance within 1e-4 of it (relative) + 1e-6, each mean
    within 1e-4 of its |mean| + √variance + 1e-6. A batch mean near 0 is a
    cancelling fp32 sum of values on the scale of the channel's spread,
    which each side's fp32 BatchNorm rounds its own way
    (``cvit_ggca_add_dconv``: the port 3.4e-6 from float64, JAX 3.7e-7, on
    means of 0.04-0.31; ``cvit_ggca_add_odconv``'s GGCA BN: the port 9e-6,
    JAX 2e-4); the counters equal JAX's."""
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    bufs = dict(m.named_buffers())
    jb = cvit_state_dict_from_flax(flat({"batch_stats": state.batch_stats, **(
        {"schedule": state.schedule} if state.schedule else {})}), name)
    for k, ref in jb.items():
        if bufs64 is None:
            np.testing.assert_allclose(bufs[k].float().numpy(), ref.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        elif k.endswith(("running_mean", "running_var")):
            want = bufs64[k].double().numpy()
            scale = np.abs(want)
            if k.endswith("running_mean"):
                scale = scale + np.sqrt(bufs64[k[:-4] + "var"].double().numpy())
            err = np.abs(bufs[k].double().numpy() - want)
            assert (err <= 1e-4 * scale + 1e-6).all(), (k, float(err.max()))
        else:
            assert torch.equal(bufs[k], ref.to(bufs[k].dtype)), k


def _grads(m, tr, batch, dtype, routes=None, losses=None):
    """The gradient (plus the coupled decay wd·p, as Adam's moments carry
    it) of one training forward of a copy of ``m`` in ``dtype``; its loss
    is appended to ``losses`` when given. With
    ``routes`` (the max-pools' argmax indices of a forward, `_routes`), each
    max-pool takes its value from there: the float64 gradient then follows
    the fp32 forward's choice at a near-tie, where the two precisions can
    pick different elements of a window."""
    import copy
    import torch.nn.functional as F
    mc = copy.deepcopy(m).to(dtype).train()
    pools = [mod for mod in mc.modules() if isinstance(mod, torch.nn.MaxPool2d)]
    if routes is not None:
        for mod, idx in zip(pools, routes):
            mod.forward = lambda x, idx=idx: x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
    x = tr.normalize(batch["image"].to(torch.float32) / torch.full((1,), 255.0)).to(dtype)
    loss = tr.loss_fn(mc(x), batch["label"], batch["mask"].to(dtype))
    loss.backward()
    if losses is not None:
        losses.append(float(loss.detach()))
    wd = tr.cfg.train.optim.weight_decay
    return {k: (p.grad + wd * p.detach()).double() for k, p in mc.named_parameters()}


def _jax_float64_loss(jm, jt, state, batch):
    """JAX's own training-forward loss in float64 from ``state`` (its
    parameters, running stats and LinearNorm counters), independent of the
    port: the model at ``dtype=float64``, the ImageNet normalize of the
    bytes in float64, JAX's loss (which casts the logits to float32)."""
    from fac_fake_tpu.infer.predictor import IMAGENET_MEAN, IMAGENET_STD
    with jax.enable_x64(True):
        to64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64) \
            if np.asarray(a).dtype.kind == "f" else jnp.asarray(np.asarray(a))
        variables = {"params": jax.tree.map(to64, state.params),
                     "batch_stats": jax.tree.map(to64, state.batch_stats)}
        mutable = ["batch_stats"]
        if state.schedule:
            variables["schedule"] = jax.tree.map(to64, state.schedule)
            mutable.append("schedule")
        x = ((jnp.asarray(batch["image"], jnp.float64) / 255.0
              - jnp.asarray(IMAGENET_MEAN, jnp.float64)) / jnp.asarray(IMAGENET_STD, jnp.float64))
        logits, _ = jax.jit(lambda v, x: jm.clone(dtype=jnp.float64).apply(
            v, x, train=True, mutable=mutable))(variables, x)
        return float(jt.loss_fn(logits, jnp.asarray(batch["label"]),
                                jnp.asarray(batch["mask"], jnp.float64)))


def _routes(m, tr, batch):
    """The argmax indices of every 2×2 max-pool of an fp32 training forward
    of a copy of ``m``."""
    import copy
    import torch.nn.functional as F
    mc = copy.deepcopy(m).train()
    routes = []
    hooks = [mod.register_forward_hook(lambda mod, i, o: routes.append(
        F.max_pool2d(i[0], 2, 2, return_indices=True)[1]))
        for mod in mc.modules() if isinstance(mod, torch.nn.MaxPool2d)]
    with torch.no_grad():
        mc(tr.normalize(batch["image"].float() / torch.full((1,), 255.0)))
    return routes


def _rel(a, b):
    num = sum(float(np.square((a[k] - b[k]).numpy()).sum()) for k in b)
    return np.sqrt(num / sum(float(np.square(b[k].numpy()).sum()) for k in b))


@pytest.mark.parametrize("name", ["cvit", "cvit_repbn8"])
def test_train_step_matches_jax(name):
    """One train step of a small model (augmentation off) from the same
    weights and batch as JAX's `Trainer.train_step`: loss within 1e-5,
    gradients (Adam's moments) within 1e-4 of their norm
    (`_gradient_errors`), running stats (biased variance) and LinearNorm's
    counters (mid-schedule, so the blend shows) after the step, and the
    parameters where |g| is clear of ε.

    Step 2 on both, the port starting from JAX's state after step 1,
    carried over whole (Adam's moments and count included): the loss held
    to JAX's own float64 loss from that state (`_jax_float64_loss`) as the
    gradients are held, within 3 × JAX's fp32 distance from it plus
    LOSS_ATOL of it, and the port's float64 loss within 1e-6 of JAX's
    (JAX's fp32 step-2 loss of the flagship is 1.7e-5 from float64, its
    jitted fp32 logits 4.6e-5 from float64's, where the port's are 3.6e-7
    and 5.5e-6: step 1's 1e-5 between the two fp32 losses held JAX's
    rounding); the gradients as at step 1, the running stats and
    counters, and the parameters exactly one Adam step (count 2) from JAX's
    carried moments with the port's gradient."""
    from fac_fake_tpu.train.trainer import Trainer as JaxTrainer
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax

    jm = _jax_model(name)
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
    batches = [{"image": rng.integers(0, 256, (4, HW, HW, 3), dtype=np.uint8),
                "label": np.array([0, 1, 1, 0], np.int32), "mask": np.ones(4, np.float32)}
               for _ in range(2)]
    tbs = [{"image": torch.from_numpy(b["image"]), "label": torch.from_numpy(b["label"]).long(),
            "mask": torch.from_numpy(b["mask"])} for b in batches]

    # step 1
    m, tr = _port_from_jax_state(name, state)
    g64 = {"plain": _grads(m, tr, tbs[0], torch.float64),
           "routed": _grads(m, tr, tbs[0], torch.float64, _routes(m, tr, tbs[0]))}
    state, jmet = jt.train_step(state, jt.put_batch(batches[0]), jax.random.key(0))
    met = tr.train_step(tbs[0], torch.Generator().manual_seed(0))
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-5 * abs(float(jmet["loss"]))
    left_out, errs = _compare_state(m, tr, state, name, g64)
    n = sum(p.numel() for p in m.parameters())
    assert left_out < 0.1 * n, (left_out, n)
    print(f"{name} step 1: loss {float(met['loss']):.7f} / JAX {float(jmet['loss']):.7f}; "
          f"gradient errors {errs}; {left_out} of {n} parameter entries left out "
          f"(|g| ≤ 1e-5, the gradients 10% apart, or rounding noise)")

    # step 2 from JAX's state after step 1
    m, tr = _port_from_jax_state(name, state)
    p1 = {k: p.detach().clone().double() for k, p in m.named_parameters()}
    mu1 = {k: tr.optimizer.state[p]["exp_avg"].clone().double() for k, p in m.named_parameters()}
    nu1 = {k: tr.optimizer.state[p]["exp_avg_sq"].clone().double()
           for k, p in m.named_parameters()}
    port64 = []
    g64 = {"plain": _grads(m, tr, tbs[1], torch.float64, losses=port64),
           "routed": _grads(m, tr, tbs[1], torch.float64, _routes(m, tr, tbs[1]))}
    g32 = _grads(m, tr, tbs[1], torch.float32)
    jax64 = _jax_float64_loss(jm, jt, state, batches[1])
    state, jmet = jt.train_step(state, jt.put_batch(batches[1]), jax.random.key(0))
    met = tr.train_step(tbs[1], torch.Generator().manual_seed(0))
    loss = {"port": float(met["loss"]), "jax": float(jmet["loss"]), "jax_f64": jax64,
            "port_f64": port64[0]}
    assert abs(loss["port_f64"] - jax64) <= 1e-6 * abs(jax64), loss
    assert abs(loss["port"] - jax64) <= 3 * abs(loss["jax"] - jax64) + LOSS_ATOL * abs(jax64), \
        loss
    adam = _adam(state.opt_state)
    jmu = cvit_state_dict_from_flax(flat(adam.mu, ("params",)), name)
    g_jax = {k: (jmu[k].double() - 0.9 * mu1[k]) / 0.1 for k in mu1}
    errs = _gradient_errors(g32, g_jax, g64)
    print(f"{name} step 2: losses {loss}; gradient errors {errs}")
    lr, b1, b2, eps = tr.cfg.train.optim.lr, 0.9, 0.999, 1e-8
    for k, p in m.named_parameters():
        st = tr.optimizer.state[p]
        assert int(st["step"]) == 2
        mu2 = b1 * mu1[k] + (1 - b1) * g32[k]
        nu2 = b2 * nu1[k] + (1 - b2) * g32[k] ** 2
        want = p1[k] - lr * (mu2 / (1 - b1 ** 2)) / ((nu2 / (1 - b2 ** 2)).sqrt() + eps)
        np.testing.assert_allclose(st["exp_avg"].double().numpy(), mu2.numpy(), rtol=0,
                                   atol=1e-5 * float(mu2.abs().max()) + 1e-30, err_msg=k)
        np.testing.assert_allclose(p.detach().double().numpy(), want.numpy(), rtol=0,
                                   atol=2e-7, err_msg=k)
    _compare_buffers(m, state, name)
    if name == "cvit_repbn8":
        assert int(m.transformer.layers[0][1].fn.norm.iter) == 149998
