"""One train step of the variant zoo in the port (`fac_fake_torch/train/
trainer.py`) against JAX's `Trainer.train_step` on the CPU: one registry
entry of each block kind, a third of them in this file
(``TRAIN_ENTRIES[0::3]``; `test_torch_zoo_train_b.py` and `_c.py` hold the
others, `test_torch_zoo_train_bf16.py` the bf16 steps).

Each entry's small twin (`small_fields`) keeps the entry's stems, slots,
embedding and token blocks, ``use_ggca`` and ``ffn_norm``, with the stems
at the narrow widths of `test_torch_flagship.small`, one transformer layer
and ``dim`` 32 (64 for ``cvit_ggca_sla``, whose tokens are the embedding's
channels on an 8 × 8 map; 1024 for the token-block entries, which view the
(B, 2, dim) tokens as a 2-channel 32 × 32 map); crops 64² (128² for
``cvit_ggca_smfa``, whose 8× pool needs an 8 × 8 map). The weights are
the port's seeded init (JAX's initializers, each DEConv at He scale) laid
out as JAX's variables (`flax_variables`), every norm affine, bias and
BatchNorm statistic moved off its initial value, and the zoo's leaves that
start at a constant (SLA's positional encoding, UFFC's lambda, ScConv's
GroupNorm) moved by N(0, 0.1) (`zoo_state`). The
port carries JAX's whole state over (`port_from_jax_state`). Inputs are
made with numpy from a seed.

One step, augmentation off, batch 4, from the same state as JAX's, held
to JAX's own float64 step from that state (`jax_float64_step`: the model,
the normalize and the loss in float64): the port's float64 loss within
1e-6 of its loss and the port's float64 gradient (`float64_grads`) within
1e-6 of its gradient; the port's fp32 loss within 3 × JAX's fp32 distance
from it + LOSS_ATOL; the fp32 gradient (Adam's first moment over 1 − β1)
within 1e-4 of its norm of the float64 gradient routed as the fp32
forward's max-pools and ReLUs, or within JAX's fp32 distance from its own
float64 gradient where that is larger, and of JAX's where neither strays
further from float64 (`_gradient_errors`); fewer than 10% of the entries
clear of ε more than 10% from JAX's float64 gradient, and from JAX's fp32
one (but where that is JAX_FP32_OFF); the running stats by flax's rule
(biased variance) against JAX's float64 step's (`_compare_buffers`) and
LinearNorm's counters equal to JAX's; every parameter one Adam step on.
Then `load_flax_adam_state` carries JAX's Adam state after the step into a
fresh port model and trainer: every moment equal to JAX's through the key
map (ODConv's 5-D candidates and the flat per-channel scales included)
and the step count 1.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from test_torch_flagship import _CH, randomize_norms, small
from test_torch_train import HW, flat, jax_cfg, one_device_mesh, port_cfg
from test_torch_train_step import LOSS_ATOL, _adam, _compare_state
from test_torch_zoo_entries import _ZOO_LEAVES, variant

torch.set_num_threads(2)

# one registry entry of each block kind: the stem mixers (ScConv, WTConv,
# InceptionDW, ODConv), the slot blocks (ODConv, MOGA, SMFA, UFFC), the
# embedding blocks (SLA, GLU), BFM and MDFA in a slot and on the tokens,
# and the DEConv family without the flagship's stems
TRAIN_ENTRIES = (
    "cvit_ggca_add_scconv", "cvit_ggca_add_wtconv", "cvit_ggca_add_dconv",
    "cvit_ggca_add_odconv", "cvit_ggca_odconv", "cvit_ggca_add_moga", "cvit_ggca_smfa",
    "cvit_ggca_uffc", "cvit_ggca_sla", "cvit_ggca_add_glu", "cvit_bfm_ggca_mdfa",
    "cvit_ggca_mdfa_bfm", "cvit_deconv")
BATCH = 4
# where JAX's fp32 gradient does not resolve the step: cvit_ggca_add_odconv's
# is 9.1% of the norm from JAX's own float64 gradient (the port's 1.0e-4),
# spread over every stem layer, and 36% of the entries clear of ε part from
# the port's by more than 10% (every other entry: at most 0.3%; torch 2.13
# CPU, jax 0.9.0). There the port's entries are held to JAX's float64
# gradient alone.
JAX_FP32_OFF = ("cvit_ggca_add_odconv",)
_STEMS = ("stem_spec", "stem2_spec", "stem3_spec")
_SLOTS = ("slot1", "slot2", "slot3")


@functools.lru_cache(maxsize=None)
def small_fields(name):
    """(crop side, the CViT constructor fields of ``name``'s small twin),
    the fields read off the JAX registry's entry."""
    import fac_fake_tpu.models  # noqa: F401  (registers the JAX entries)
    from fac_fake_tpu.core import registry as jax_registry
    from fac_fake_tpu.core.config import ModelConfig as JaxModelConfig
    jm = jax_registry.get("model", name)(JaxModelConfig(name=name))
    hw = 128 if name == "cvit_ggca_smfa" else HW
    fields, pools = {}, 0
    for f in _STEMS:
        spec = getattr(jm, f)
        if spec is not None:
            fields[f] = small(spec)
            pools += sum(op[0] == "pool" for op in spec)
    for f in _SLOTS:
        slot = getattr(jm, f)
        if slot is not None:
            fields[f] = (slot[0], slot[1], _CH[slot[2]])
    side, dim = hw >> pools, 32
    embed, token = jm.embed_block, jm.token_block
    if token is not None:              # one patch: the (B, 2, 1024) tokens
        patch, dim = side, 1024
        fields["token_block"] = tuple(token)
    elif embed is not None and embed[0] == "sla":
        patch, dim = side // 4, 64     # the registry's 16 patches, 64 = 8² tokens
        fields["embed_block"] = tuple(embed)
    elif embed is not None:            # GLU on the registry's 8 × 8 tokens
        patch = side // embed[2]
        fields["embed_block"] = ("glu", dim, embed[2], embed[3])
    else:
        patch = side // 2
    fields.update(use_ggca=jm.use_ggca, ffn_norm=jm.ffn_norm, patch_size=patch, dim=dim,
                  depth=1, heads=2, mlp_dim=32)
    return hw, fields


def jax_model(name, dtype=jnp.float32):
    from fac_fake_tpu.models.cvit import CViT
    return CViT(**small_fields(name)[1], dtype=dtype)


def port_model(name):
    from fac_fake_torch.models.cvit import CViT
    hw, fields = small_fields(name)
    fields = dict(fields)
    return CViT(fields.pop("stem_spec"), image_size=hw, **fields).to(
        memory_format=torch.channels_last)


def flax_variables(jm, m, hw, name, var=None):
    """JAX variables of ``jm`` holding the port model ``m``'s weights, laid
    out by the port's key map (`cvit_torch_key`, for ``var`` or the entry
    ``name``'s variant): each leaf the inverse of
    its flax → torch transform. The tree's shapes come from
    `jax.eval_shape` of JAX's ``init(train=True)``, which compiles nothing
    (a jitted JAX init of one small twin takes ~10 s here)."""
    from fac_fake_torch.compat.weights import cvit_torch_key
    with jax_wavelets_in_input_dtype():
        shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, hw, hw, 3)), train=True),
                                jax.random.key(0))
    sd = m.state_dict()
    out = {}
    for path, leaf in traverse_util.flatten_dict(shapes).items():
        key, tf = cvit_torch_key(list(path), var or variant(name))
        where = np.asarray(tf(np.arange(int(np.prod(leaf.shape))).reshape(leaf.shape)))
        vals = np.empty(where.size, np.float64)
        vals[where.ravel()] = sd[key].double().contiguous().numpy().ravel()
        out[path] = jnp.asarray(vals.reshape(leaf.shape), leaf.dtype)
    return traverse_util.unflatten_dict(out)


def moved(variables, seed):
    """JAX variables with the norms, biases and statistics moved
    (`randomize_norms`), and the zoo's constant-started leaves moved by
    N(0, 0.1)."""
    v = randomize_norms(variables, seed)
    rng = np.random.default_rng(seed + 100)
    f = traverse_util.flatten_dict(v)
    for k in f:
        if k[-1] in _ZOO_LEAVES:
            f[k] = f[k] + jnp.asarray(rng.normal(0, 0.1, np.shape(f[k])), jnp.float32)
    return traverse_util.unflatten_dict(f)


def zoo_state(name, dtype=jnp.float32):
    """(JAX model, its Trainer, the training state to start from, crop
    side): the port's seeded init (`init_weights`, each DEConv at He
    scale) moved off its initial values, fresh Adam, LinearNorm
    mid-schedule."""
    from fac_fake_tpu.train.state import TrainState
    from fac_fake_tpu.train.trainer import Trainer as JaxTrainer
    from fac_fake_torch.models import init_weights
    hw, _ = small_fields(name)
    jm = jax_model(name, dtype)
    cfg = jax_cfg()
    cfg.data.image_size = hw
    jt = JaxTrainer(jm, cfg, mesh=one_device_mesh(), input_shape=(1, hw, hw, 3))
    seed = TRAIN_ENTRIES.index(name) if name in TRAIN_ENTRIES else 0
    v = flax_variables(jm, init_weights(port_model(name), seed), hw, name)
    schedule = jax.tree.map(lambda a: jnp.asarray(150000, jnp.int32) if int(a) > 0 else a,
                            v.pop("schedule", {}))
    v = moved(v, seed)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=v["params"],
                       batch_stats=v.get("batch_stats", {}), schedule=schedule,
                       opt_state=jt.tx.init(v["params"]))
    return jm, jt, state, hw


def port_from_jax_state(name, state, dtype="float32"):
    """The port's small twin and its CPU trainer at ``model.dtype``,
    carrying JAX's whole training state (Adam's moments and count too)."""
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax, load_flax_adam_state
    from fac_fake_torch.train.trainer import Trainer
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    if state.schedule:
        variables["schedule"] = state.schedule
    m = port_model(name)
    sd = cvit_state_dict_from_flax(flat(variables), variant(name))
    for k, t in m.state_dict().items():
        sd.setdefault(k, t)                 # num_batches_tracked: JAX has none
    m.load_state_dict(sd, strict=True)
    cfg = port_cfg()
    cfg.data.image_size = small_fields(name)[0]
    cfg.model.dtype = dtype
    tr = Trainer(m, cfg, device="cpu")
    adam = _adam(state.opt_state)
    load_flax_adam_state(m, tr.optimizer, flat(adam.mu, ("params",)), flat(adam.nu, ("params",)),
                         int(adam.count), variant(name))
    return m, tr


def zoo_batch(hw, seed=7):
    """A seeded uint8 batch, as JAX's and as the port's trainer take it."""
    rng = np.random.default_rng(seed)
    batch = {"image": rng.integers(0, 256, (BATCH, hw, hw, 3), dtype=np.uint8),
             "label": np.array([0, 1, 1, 0], np.int32), "mask": np.ones(BATCH, np.float32)}
    return batch, {"image": torch.from_numpy(batch["image"]),
                   "label": torch.from_numpy(batch["label"]).long(),
                   "mask": torch.from_numpy(batch["mask"])}


def float64_grads(m, tr, tb, routed=True, losses=None):
    """The float64 gradient of one training forward of ``m`` from the bytes
    (the normalize, the model and the loss in float64, `cross_entropy64`),
    plus the coupled decay wd·p, as Adam's moments carry it; the loss is
    appended to ``losses`` when given. With ``routed``, routed as ``m``'s
    fp32 training forward: each 2×2 max-pool takes the element the fp32
    forward took and each `nn.ReLU` call (the stems', MDFA's, GGCA's four,
    the head's) keeps the fp32 forward's positives. A BatchNorm output
    within rounding of 0 can take the other side of a ReLU in float64, and
    that element's gradient then moves every layer before it
    (``cvit_ggca_smfa``'s stem: both fp32 gradients 0.5% of the norm from
    float64's unrouted)."""
    import copy
    import torch.nn.functional as F
    m64 = copy.deepcopy(m).to(torch.float64).train()
    if routed:
        mc = copy.deepcopy(m).train()
        pools = {i: [] for i, mod in enumerate(mc.modules()) if type(mod) is torch.nn.MaxPool2d}
        relus = {i: [] for i, mod in enumerate(mc.modules()) if type(mod) is torch.nn.ReLU}
        for i, mod in enumerate(mc.modules()):
            if i in pools:
                mod.register_forward_hook(lambda mod, i_, o, rec=pools[i]: rec.append(
                    F.max_pool2d(i_[0], 2, 2, return_indices=True)[1]))
            elif i in relus:
                mod.register_forward_hook(lambda mod, i_, o, rec=relus[i]: rec.append(i_[0] > 0))
        with torch.no_grad():
            mc(tr.normalize(tb["image"].to(torch.float32) / torch.full((1,), 255.0)))
        for i, mod in enumerate(m64.modules()):
            # one forward: each call takes its recorded route in turn
            if i in pools:
                mod.forward = lambda y, idx=iter(pools[i]): (lambda ix: y.flatten(2).gather(
                    2, ix.flatten(2)).view(ix.shape))(next(idx))
            elif i in relus:
                mod.forward = lambda y, keep=iter(relus[i]): y * next(keep)
    x = tr.normalize(tb["image"].to(torch.float64) / 255.0)
    loss = cross_entropy64(m64(x), tb["label"], tb["mask"].to(torch.float64))
    loss.backward()
    if losses is not None:
        losses.append(float(loss.detach()))
    wd = tr.cfg.train.optim.weight_decay
    return {k: (p.grad + wd * p.detach()).double() for k, p in m64.named_parameters()}


def cross_entropy64(logits, labels, mask):
    """The trainers' masked cross-entropy (`fac_fake_torch/train/losses.py`,
    JAX's `train/losses.py`) without their cast of the logits to fp32: a
    float64 reference step stays float64 to its end. (Through the cast,
    each side's softmax rounds ``p - y`` its own way, and the two float64
    gradients part by 1e-6 to 7e-6 of their norm.)"""
    import torch.nn.functional as F
    losses = F.cross_entropy(logits, labels.long(), reduction="none")
    return (losses * mask).sum() / mask.sum().clamp(min=1.0)


@contextlib.contextmanager
def jax_wavelets_in_input_dtype():
    """JAX's WTConv with its Haar filters in the dtype of the map they
    transform, as the port's are: JAX's own builds them fp32, and its bf16
    and float64 WTConv raise (``lax.conv_general_dilated`` takes one dtype).
    An fp32 map is transformed exactly as before. Applies where the model
    is traced."""
    import fac_fake_tpu.models.blocks.wtconv as jw
    filters, dtype = jw._wavelet_filters, []

    def traced_in(fn):
        def run(x):
            dtype.append(x.dtype)
            try:
                return fn(x)
            finally:
                dtype.pop()
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jw, "_wavelet_filters",
                   lambda: tuple(f.astype(dtype[-1]) for f in filters()))
        for fn in ("wavelet_transform", "inverse_wavelet_transform"):
            mp.setattr(jw, fn, traced_in(getattr(jw, fn)))
        yield


def jax_float64_step(jm, jt, state, batch, name):
    """JAX's own training forward and backward in float64 from ``state``
    (the model at ``dtype=float64``, the ImageNet normalize in float64,
    `jax.value_and_grad` of the loss of `cross_entropy64`): its
    loss, its gradient plus the coupled decay (optax's
    ``add_decayed_weights``, which Adam's moments carry) and its running
    stats after it, by the port's keys."""
    from fac_fake_tpu.infer.predictor import IMAGENET_MEAN, IMAGENET_STD
    from fac_fake_torch.compat.weights import cvit_torch_key
    with jax.enable_x64(True), jax_wavelets_in_input_dtype():
        to64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64) \
            if np.asarray(a).dtype.kind == "f" else jnp.asarray(np.asarray(a))
        params = jax.tree.map(to64, state.params)
        variables = {"batch_stats": jax.tree.map(to64, state.batch_stats)}
        mutable = ["batch_stats"]
        if state.schedule:
            variables["schedule"] = jax.tree.map(to64, state.schedule)
            mutable.append("schedule")
        x = ((jnp.asarray(batch["image"], jnp.float64) / 255.0
              - jnp.asarray(IMAGENET_MEAN, jnp.float64)) / jnp.asarray(IMAGENET_STD, jnp.float64))

        def loss_of(params, x):
            logits, mut = jm.clone(dtype=jnp.float64).apply(
                {"params": params, **variables}, x, train=True, mutable=mutable)
            mask = jnp.asarray(batch["mask"], jnp.float64)
            losses = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(batch["label"]))
            return jnp.sum(losses * mask) / jnp.maximum(jnp.sum(mask), 1.0), mut

        def step(params, x):
            (loss, mut), grads = jax.value_and_grad(loss_of, has_aux=True)(params, x)
            wd = jt.cfg.train.optim.weight_decay
            return loss, mut, jax.tree.map(lambda g, p: g + wd * p, grads, params)

        loss, mut, grads = jax.jit(step)(params, x)
        key = lambda k: cvit_torch_key(k, variant(name))
        g64 = {}
        for k, g in traverse_util.flatten_dict(grads).items():
            tk, tf = key(("params",) + k)
            g64[tk] = torch.from_numpy(np.array(tf(np.asarray(g, np.float64)), order="C"))
        stats = {key(("batch_stats",) + k)[0]: torch.from_numpy(np.array(v, np.float64))
                 for k, v in traverse_util.flatten_dict(mut["batch_stats"]).items()}
    return float(loss), g64, stats


def check_train_step(name):
    """One train step of ``name``'s small twin against JAX's (module
    docstring); then JAX's Adam state after it through
    `load_flax_adam_state`."""
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax

    jm, jt, state, hw = zoo_state(name)
    batch, tb = zoo_batch(hw)
    m, tr = port_from_jax_state(name, state)
    port64 = []
    g64 = {"plain": float64_grads(m, tr, tb, routed=False, losses=port64),
           "routed": float64_grads(m, tr, tb)}
    # before JAX's step, which donates ``state``
    jax64, jgrads64, stats64 = jax_float64_step(jm, jt, state, batch, name)
    state, jmet = jt.train_step(state, jt.put_batch(batch), jax.random.key(0))
    p0 = {k: p.detach().double().clone() for k, p in m.named_parameters()}
    met = tr.train_step(tb, torch.Generator().manual_seed(0))
    loss = {"port": float(met["loss"]), "jax": float(jmet["loss"]), "jax_f64": jax64,
            "port_f64": port64[0]}
    assert abs(loss["port_f64"] - jax64) <= 1e-6 * abs(jax64), loss
    assert abs(loss["port"] - jax64) <= 3 * abs(loss["jax"] - jax64) + LOSS_ATOL * abs(jax64), \
        loss
    left_out, errs = _compare_state(m, tr, state, variant(name), g64, jax64=jgrads64,
                                    bufs64=stats64)
    # the share of the entries with a gradient clear of ε (SLA's positional
    # encoding past the 64 tokens has the weight decay's alone) whose two
    # gradients part by more than 10%: against JAX's fp32 gradient (but
    # where it is JAX_FP32_OFF) and against JAX's float64 gradient
    mu = cvit_state_dict_from_flax(flat(_adam(state.opt_state).mu, ("params",)), variant(name))
    small = sum(int((mu[k].abs() <= 1e-6).sum()) for k, _ in m.named_parameters())
    n = sum(p.numel() for p in m.parameters()) - small
    if name in JAX_FP32_OFF:
        assert errs["jax_vs_f64"] > 1e-2, errs
    else:
        assert left_out - small < 0.1 * n, (left_out, small, n)
    clear = apart = 0
    for k, p in m.named_parameters():
        g, want = tr.optimizer.state[p]["exp_avg"].double() / 0.1, jgrads64[k]
        big = want.abs() > 1e-5
        clear += int(big.sum())
        apart += int((big & ((g - want).abs() >= 0.1 * want.abs())).sum())
    assert apart < 0.1 * clear, (apart, clear)
    # every parameter one Adam step (count 1) on with the port's moments
    lr, eps = tr.cfg.train.optim.lr, 1e-8
    for k, p in m.named_parameters():
        st = tr.optimizer.state[p]
        want = p0[k] - lr * (st["exp_avg"].double() / 0.1) / (
            (st["exp_avg_sq"].double() / 0.001).sqrt() + eps)
        np.testing.assert_allclose(p.detach().double().numpy(), want.numpy(), rtol=0,
                                   atol=2e-7, err_msg=k)
    print(f"{name}: losses {loss}; gradient errors {errs}; "
          f"{left_out} of {n} parameter entries left out; {apart} of {clear} apart from "
          "float64")

    m2, tr2 = port_from_jax_state(name, state)
    nu = cvit_state_dict_from_flax(flat(_adam(state.opt_state).nu, ("params",)), variant(name))
    shapes = set()
    for k, p in m2.named_parameters():
        st = tr2.optimizer.state[p]
        assert int(st["step"]) == 1 and st["exp_avg"].shape == p.shape, k
        assert torch.equal(st["exp_avg"], mu[k]) and torch.equal(st["exp_avg_sq"], nu[k]), k
        assert st["exp_avg"].abs().sum() > 0 or mu[k].abs().sum() == 0, k
        shapes.add(p.dim())
    if name in ("cvit_ggca_add_odconv", "cvit_ggca_odconv"):
        assert 5 in shapes                  # ODConv's (kn, O, I, k, k) candidates


@pytest.mark.parametrize("name", TRAIN_ENTRIES[0::3])
def test_zoo_train_step_matches_jax(name):
    check_train_step(name)
