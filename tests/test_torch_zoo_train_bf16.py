"""One bf16 train step of four of the variant zoo's entries (the embedding
blocks SLA and GLU, the ODConv block, BFM in a slot with MDFA on the
tokens) against JAX's bf16 `Trainer.train_step` on the CPU, their small
twins and weights as in `test_torch_zoo_train.py`, held as
`tests/test_torch_bf16.py` holds ``cvit``'s bf16 step: a bf16 step is far
from exact on either side, so the port is held to float64 by JAX's own
distance from it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16 import GRAD_SLACK, RATIO, _rel
from test_torch_train import flat
from test_torch_train_step import _adam
from test_torch_zoo_entries import variant
from test_torch_zoo_train import (float64_grads, jax_float64_step, port_from_jax_state,
                                  zoo_batch, zoo_state)

torch.set_num_threads(2)

BF16_TRAIN_ENTRIES = ("cvit_ggca_sla", "cvit_ggca_add_glu", "cvit_ggca_odconv",
                      "cvit_bfm_ggca_mdfa")
# the port's bf16 gradient points at float64's as closely as JAX's does:
# its cosine with it no less than JAX's less this
COS_SLACK = 0.1
# a bf16 loss's distance from float64 is a draw, not a device's: over five
# seeded batches of cvit_ggca_sla's twin (torch 2.13 CPU, jax 0.9.0) the
# port's was 0.7-7.0% of the loss (mean 2.3%), JAX's 0.2-4.9% (mean 2.7%),
# either side the further on some; so the slack is 5% of the loss, a bf16
# forward's own scale (chip_smoke.py's TRAIN_BF16_LOSS_F64_SLACK)
LOSS_SLACK = 5e-2


def _cos(a, b):
    dot = sum(float((a[k] * b[k]).sum()) for k in b)
    return dot / (sum(float(a[k].square().sum()) for k in b) ** 0.5
                  * sum(float(b[k].square().sum()) for k in b) ** 0.5)


@pytest.mark.parametrize("name", BF16_TRAIN_ENTRIES)
def test_zoo_bf16_train_step_matches_jax(name):
    """One bf16 train step (augmentation off, batch 4) from the same weights
    and batch as JAX's bf16 `Trainer.train_step` (``dtype=bfloat16`` model):
    the parameters, Adam's moments and the running stats stay fp32; the
    port's loss and gradient (Adam's first moment over 1 − β1) within RATIO
    × JAX bf16's distance from the float64 step plus LOSS_SLACK of the loss
    and GRAD_SLACK of the gradient's norm, and the gradient's cosine with
    float64's no less than JAX's − COS_SLACK (a zero or unrelated gradient
    has a cosine near 0; the distances alone let it by where JAX bf16's own
    is near 1) (the float64 loss, gradient and running stats JAX's own,
    `jax_float64_step`; the port's float64 loss within 1e-6 of its loss
    and the port's float64 gradient, `float64_grads`, within 1e-6 of its
    gradient); the running stats (relative L2 over all of them) within
    RATIO × JAX's distance from float64's + 1e-4; LinearNorm's counters
    equal."""
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax

    jm, jt, state, hw = zoo_state(name, jnp.bfloat16)
    batch, tb = zoo_batch(hw)
    m32, tr32 = port_from_jax_state(name, state)
    port64 = []
    port_g64 = float64_grads(m32, tr32, tb, routed=False, losses=port64)
    # before JAX's step, which donates ``state``
    jax64, g64, stats64 = jax_float64_step(jm, jt, state, batch, name)
    assert abs(port64[0] - jax64) <= 1e-6 * abs(jax64), (port64, jax64)
    assert _rel(port_g64, g64) <= 1e-6, _rel(port_g64, g64)
    m, tr = port_from_jax_state(name, state, "bfloat16")
    state, jmet = jt.train_step(state, jt.put_batch(batch), jax.random.key(0))
    met = tr.train_step(tb, torch.Generator().manual_seed(0))
    params = dict(m.named_parameters())
    assert all(p.dtype == torch.float32 for p in params.values())
    assert all(tr.optimizer.state[p]["exp_avg"].dtype == torch.float32 for p in params.values())
    mu = cvit_state_dict_from_flax(flat(_adam(state.opt_state).mu, ("params",)), variant(name))
    g_port = {k: tr.optimizer.state[p]["exp_avg"].double() / 0.1 for k, p in params.items()}
    g_jax = {k: mu[k].double() / 0.1 for k in params}
    g64 = {k: g64[k] for k in params}
    errs = {"port_vs_f64": _rel(g_port, g64), "jax_vs_f64": _rel(g_jax, g64),
            "port_vs_jax": _rel(g_port, g_jax), "cos_port": _cos(g_port, g64),
            "cos_jax": _cos(g_jax, g64)}
    loss = {"port": float(met["loss"]), "jax": float(jmet["loss"]), "f64": jax64}
    print(f"{name} bf16 step: loss {loss}; gradient {errs}")
    assert np.isfinite(loss["port"]), loss
    assert errs["cos_port"] >= errs["cos_jax"] - COS_SLACK, errs
    assert errs["port_vs_f64"] <= RATIO * errs["jax_vs_f64"] + GRAD_SLACK, errs
    assert abs(loss["port"] - jax64) <= RATIO * abs(loss["jax"] - jax64) \
        + LOSS_SLACK * abs(jax64), loss
    # the running stats (and LinearNorm's counters) after the step
    jb = cvit_state_dict_from_flax(flat({"batch_stats": state.batch_stats, **(
        {"schedule": state.schedule} if state.schedule else {})}), variant(name))
    bufs = dict(m.named_buffers())
    stats = [k for k in jb if k.endswith(("running_mean", "running_var"))]
    for k in set(jb) - set(stats):
        assert torch.equal(bufs[k], jb[k].to(bufs[k].dtype)), k
    assert stats and all(bufs[k].dtype == torch.float32 for k in stats)
    e = {"port": _rel({k: bufs[k] for k in stats}, {k: stats64[k] for k in stats}),
         "jax": _rel({k: jb[k] for k in stats}, {k: stats64[k] for k in stats})}
    print(f"{name} bf16 running stats from float64's: {e}")
    assert e["port"] <= RATIO * e["jax"] + 1e-4, e
