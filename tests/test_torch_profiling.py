"""The port's profiling helpers (`fac_fake_torch/utils/profiling.py`) and
the trainer's TensorBoard output (`train.tensorboard_dir`) on the CPU:
`time_fn`, `flops_estimate` (exactly 2n³ for an n × n product, the
convs', linears' and attention products' 2 × MACs of a tiny CViT),
`param_count` against JAX's, the Chrome trace of `trace`, and a tiny
`fit` that writes JAX's five scalar tags and ``model_graph.txt``."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_train import SMALL, port_cfg

torch.set_num_threads(2)


def _tiny_cvit(pos_mode="patch"):
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.models.cvit import CViT
    spec = ()
    for _ in range(5):
        spec += (("conv", 8), ("bn", 8), ("relu",), ("pool",))
    return init_weights(CViT(spec, image_size=32, pos_mode=pos_mode, **SMALL), 0).eval(), spec


def test_time_fn_waits_for_each_call():
    from fac_fake_torch.utils.profiling import time_fn
    calls = []
    x = torch.ones(8)
    dt, rate = time_fn(lambda a: calls.append(1) or {"out": (a * 2, 1)}, x, iters=5, warmup=3)
    assert len(calls) == 8 and dt > 0 and abs(rate * dt - 1.0) < 1e-9


def test_flops_estimate_counts_2_macs():
    from fac_fake_torch.utils.profiling import flops_estimate
    for n in (7, 64):
        a = torch.ones(n, n)
        assert flops_estimate(torch.matmul, a, a) == 2 * n ** 3
    m, spec = _tiny_cvit()
    x = torch.zeros(2, 3, 32, 32)
    with torch.no_grad():
        got = flops_estimate(m, x)
    # the stem's 3x3 convs (bias adds not counted), the patch embedding, one
    # layer's qkv, scores, weighted sum, out projection and FFN, the head
    side, ch, want = 32, 3, 0
    for op in spec:
        if op[0] == "conv":
            want += 2 * 2 * side * side * ch * op[1] * 9
            ch = op[1]
        elif op[0] == "pool":
            side //= 2
    d, h, n = SMALL["dim"], SMALL["mlp_dim"], side * side + 1
    want += 2 * 2 * (side * side) * (ch * SMALL["patch_size"] ** 2) * d
    want += 2 * 2 * n * (d * 3 * d + d * d + d * h + h * d) + 2 * 2 * (n * n * d) * 2
    want += 2 * 2 * (d * h + h * 2)
    assert got == want


def test_param_count_equals_jax():
    from fac_fake_tpu.models.cvit import CViT as JaxCViT
    from fac_fake_tpu.utils.profiling import param_count as jax_param_count
    from fac_fake_torch.utils.profiling import param_count
    m, spec = _tiny_cvit()
    jm = JaxCViT(stem_spec=spec, pos_mode="patch", **SMALL)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 32, 32, 3))), jax.random.key(0))
    params = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes["params"])
    assert param_count(m) == jax_param_count(params)


def test_trace_writes_a_chrome_trace(tmp_path):
    from fac_fake_torch.utils.profiling import TRACE_FILE, trace
    m, _ = _tiny_cvit()
    with trace(str(tmp_path / "tr")), torch.no_grad():
        m(torch.zeros(1, 3, 32, 32))
    with open(tmp_path / "tr" / TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names and "aten::addmm" in names


def _events(logdir):
    """{"scalars": {tag: [(step, value)]}, "tensors": {tag}} of the event
    files under ``logdir``, read record by record (length, its CRC, the
    event, its CRC) with tensorboardX's protobuf: TensorBoard's own reader
    imports TensorFlow, some 10 s here."""
    import struct
    from tensorboardX.proto import event_pb2
    out = {"scalars": {}, "tensors": set()}
    for fn in sorted(f for f in os.listdir(logdir) if "tfevents" in f):
        with open(os.path.join(logdir, fn), "rb") as f:
            data = f.read()
        at = 0
        while at < len(data):
            (n,) = struct.unpack("<Q", data[at:at + 8])
            ev = event_pb2.Event.FromString(data[at + 12:at + 12 + n])
            at += 12 + n + 4
            for v in ev.summary.value:
                if v.HasField("simple_value"):
                    out["scalars"].setdefault(v.tag, []).append((ev.step, v.simple_value))
                elif v.HasField("tensor"):
                    out["tensors"].add(v.tag)
    return out


def test_fit_writes_tensorboard_scalars_and_graph(tmp_path):
    from helpers import synthetic_batches
    from fac_fake_torch.train.trainer import Trainer
    m, _ = _tiny_cvit()
    cfg = port_cfg()
    cfg.data.image_size = 32
    cfg.train.epochs = 2
    cfg.train.tensorboard_dir = str(tmp_path / "tb")
    tr = Trainer(m, cfg, device="cpu")
    data = synthetic_batches(2, 8, image_size=32)
    cache = tr.cache_data(np.concatenate([b["image"] for b in data]),
                          np.concatenate([b["label"] for b in data]), 8)
    out = tr.fit(cache, cache)
    tags = _events(cfg.train.tensorboard_dir)
    assert set(tags["scalars"]) == {"train/loss", "train/acc", "val/loss", "val/acc", "lr"}
    for tag, key in (("train/loss", "train_loss"), ("val/acc", "val_acc"), ("lr", "lr")):
        ev = tags["scalars"][tag]
        assert [step for step, _ in ev] == [0, 1]
        assert np.allclose([value for _, value in ev], out["history"][key], rtol=1e-6)
    assert "model/graph/text_summary" in tags["tensors"]
    with open(os.path.join(cfg.train.tensorboard_dir, "model_graph.txt")) as f:
        graph = f.read()
    assert "aten.conv2d" in graph and "aten.linear" in graph
