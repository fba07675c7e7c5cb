"""The variant zoo in bf16 against the JAX package's ``dtype=bfloat16``
models on the CPU: every one of the 29 entries' small twins
(`test_torch_zoo_train.small_fields`, the weights of
`test_torch_zoo_train.zoo_state`, BatchNorm statistics drawn) scored in
eval mode at batch 2, unfolded and BN-folded, and one entry through
`VideoScorer` at ``model.dtype=bfloat16``. A bf16 forward is far from exact
on either side, so the port's logits are held to the float64 logits (the
port's model in float64) by JAX bf16's own distance from them: within
LOGIT_RATIO × that distance plus LOGIT_SLACK of the float64 logits' largest
magnitude. JAX's bf16 WTConv raises (its fp32 Haar filters meet a bf16
map); it runs here with its filters in the map's dtype
(`jax_wavelets_in_input_dtype`), as the port's are. Inputs are made with
numpy from a seed."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import flat
from test_torch_zoo_entries import ENTRIES, variant
from test_torch_zoo_train import (jax_wavelets_in_input_dtype, port_model, small_fields,
                                  zoo_state)

torch.set_num_threads(2)

LOGIT_RATIO = 3.0
LOGIT_SLACK = 2e-2


@functools.lru_cache(maxsize=None)
def bf16_pair(name):
    """(JAX bf16 model, its variables, the port's fp32 model carrying them,
    crop side)."""
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    jm, _, state, hw = zoo_state(name, jnp.bfloat16)
    v = {"params": state.params, "batch_stats": state.batch_stats}
    m = port_model(name)
    sd = cvit_state_dict_from_flax(flat(v), variant(name))
    for k, t in m.state_dict().items():
        sd.setdefault(k, t)             # LinearNorm's counters, num_batches_tracked
    m.load_state_dict(sd, strict=True)
    return jm, v, m.eval(), hw


def check_bf16_logits(name):
    """Batch 2 of seeded N(0, 1) crops: the port's bf16 logits, unfolded and
    folded, within LOGIT_RATIO × JAX bf16's distance from the float64
    logits + LOGIT_SLACK of their largest |value|; both finite; the model's
    weights fp32 and its activations bf16 (its logits come back fp32), as
    `VideoScorer` runs it at ``model.dtype=bfloat16``."""
    from fac_fake_torch.compat.fold import fold_cvit
    jm, v, m, hw = bf16_pair(name)
    x = np.random.default_rng(ENTRIES.index(name)).standard_normal((2, hw, hw, 3))
    x = x.astype(np.float32)
    with jax_wavelets_in_input_dtype():
        ref = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx))(v, jnp.asarray(x)),
                         np.float64)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        f64 = m.double()(xt.double()).numpy()
        m.float()
        seen = []
        hook = m.patch_to_embedding.register_forward_hook(lambda mod, i, o: seen.append(o.dtype))
        got = m(xt.to(torch.bfloat16))          # fp32 weights, bf16 activations
        hook.remove()
        folded = fold_cvit(m)(xt.to(torch.bfloat16))
    assert seen == [torch.bfloat16] and got.dtype == torch.float32
    jax_err = float(np.abs(ref - f64).max())
    bound = LOGIT_RATIO * jax_err + LOGIT_SLACK * float(np.abs(f64).max())
    errs = {"jax": jax_err, "port": float(np.abs(got.double().numpy() - f64).max()),
            "port_folded": float(np.abs(folded.double().numpy() - f64).max()), "bound": bound}
    print(f"{name} bf16 logits from float64's: {errs}")
    assert np.isfinite(ref).all() and torch.isfinite(got).all() and torch.isfinite(folded).all()
    assert errs["port"] <= bound and errs["port_folded"] <= bound, errs


@pytest.mark.parametrize("name", ENTRIES[0::2])
def test_zoo_bf16_logits_match_jax(name):
    check_bf16_logits(name)
