"""The port's export (`fac_fake_torch/compat/onnx_proto.py`,
`compat/onnx_export.py`, `compat/export.py`, `compat/weights.py
export_state_dict`, `cli/export.py`) against the JAX package's
(`fac_fake_tpu/compat/onnx_export.py`, `compat/torch_export.py`,
`cli/export.py`) on the CPU.

* ONNX: base ``cvit`` at image 224 (the graph's fixed input), dim 64,
  depth 1, heads 2, mlp 64, its norms and statistics moved off their
  initial values, the same weights on both sides (the port's seeded init
  laid out as JAX's variables through `jax.eval_shape`, no jitted JAX
  init): the port's graph node for node JAX's (op types, attributes,
  tensor and initializer names and shapes, in order), each initializer
  within 1e-6 of its largest value (each side folds its BNs in its own
  fp32); the port's `run_onnx` on JAX's graph and JAX's `run_onnx` on the
  port's, each within 1e-4 of JAX's `apply` (JAX's bar,
  `tests/test_onnx_export.py`); the refusals.
* Program: `export_program` of the ONNX case's ``cvit`` and of a small
  ``cvit_repbn8`` twin against their eager forward (1e-5) and JAX's `apply`
  (1e-3, the JAX package's logit bar), and of each of the 13 zoo entries
  trained on the card (one of each block kind) at the widths of
  `tests/test_torch_zoo_entries.py` against its eager forward; saved and
  loaded back (`load_program`) through the CLI. The traces record no
  Python stack traces (debug metadata of the graph's nodes, a third of a
  trace's time here).
* ``.pth``: `export_state_dict` key for key and bit for bit JAX's
  `export_cvit` of the same weights (ODConv's candidates and flat scales
  through the port's layout transform), reloaded ``strict=True``.
* The CLI's three formats with ``--device cpu``, a ``.pth`` carried back in
  through ``--weights``, and its refusal of orbax.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_zoo_entries import entry_dims, port_entry, variant
from test_torch_zoo_train import TRAIN_ENTRIES, flax_variables, jax_model, moved, port_model

torch.set_num_threads(2)

ONNX_TOL = 1e-4          # the graph's logits against JAX's apply
INIT_TOL = 1e-6          # an initializer, of its largest value
PROGRAM_TOL = 1e-5       # the program against the eager forward
LOGIT_TOL = 1e-3         # against JAX's apply (PARITY.md)
DIMS = dict(dim=64, depth=1, heads=2, mlp_dim=64)
SMALL = ("--set", "model.dim=64", "model.depth=1", "model.heads=2", "model.mlp_dim=64")


def _load(m, v, var):
    """Load JAX variables ``v`` into the port model ``m`` through JAX's
    `export_cvit` (``strict=True``)."""
    from fac_fake_tpu.compat.torch_export import export_cvit
    m.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in export_cvit(v, var).items()},
                      strict=True)
    return m.eval()


_BASE = {}
_GRAPHS = {}
_JAX_LOGITS = {}


@pytest.fixture(scope="module", autouse=True)
def _no_stack_traces():
    import torch.fx.config
    was = torch.fx.config.do_not_emit_stack_traces
    torch.fx.config.do_not_emit_stack_traces = True
    yield
    torch.fx.config.do_not_emit_stack_traces = was


def base_pair():
    """(JAX cvit, its variables, the port's cvit holding them) at 224,
    ``DIMS``, the norms moved."""
    if not _BASE:
        from fac_fake_tpu.core.config import ModelConfig as JaxModelConfig
        from fac_fake_tpu.models import build_model as jax_build
        from fac_fake_torch.core.config import ModelConfig
        from fac_fake_torch.models import build_model
        jm = jax_build(JaxModelConfig(name="cvit", **DIMS))
        m = build_model(ModelConfig(name="cvit", **DIMS), device="cpu", seed=0)
        v = moved(flax_variables(jm, m, 224, "cvit", "cvit"), 0)
        v = {k: v[k] for k in ("params", "batch_stats")}
        _BASE.update(jm=jm, v=v, m=_load(m, v, "cvit"))
    return _BASE["jm"], _BASE["v"], _BASE["m"]


def graphs():
    """(JAX's parsed graph, the port's parsed graph, the port's bytes) of
    `base_pair`."""
    if not _GRAPHS:
        import tempfile
        from fac_fake_tpu.compat.onnx_export import export_onnx_cvit as jax_export
        from fac_fake_torch.compat.onnx_export import export_onnx_cvit
        from fac_fake_torch.compat.onnx_proto import parse_model
        jm, v, m = base_pair()
        with tempfile.TemporaryDirectory() as d:
            jpath, ppath = os.path.join(d, "jax.onnx"), os.path.join(d, "port.onnx")
            jax_export(jm, v, jpath)
            blob = export_onnx_cvit(m, ppath)
            assert os.path.getsize(ppath) == len(blob) > 1_000_000
            _GRAPHS.update(jax=parse_model(jpath), port=parse_model(ppath), blob=blob)
    return _GRAPHS["jax"], _GRAPHS["port"], _GRAPHS["blob"]


def _nchw_input(seed=0, batch=1, hw=224):
    x = np.random.default_rng(seed).standard_normal((batch, 3, hw, hw)).astype(np.float32)
    return x


def _jax_logits(jm, v, x):
    return np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
        v, jnp.asarray(x.transpose(0, 2, 3, 1))))


def base_logits():
    """(the input, JAX's logits) of `base_pair` at batch 1, computed once."""
    if not _JAX_LOGITS:
        jm, v, _ = base_pair()
        x = _nchw_input()
        _JAX_LOGITS.update(x=x, want=_jax_logits(jm, v, x))
    return _JAX_LOGITS["x"], _JAX_LOGITS["want"]


def test_onnx_graph_matches_jax_node_for_node():
    want, got, _ = graphs()
    assert got["opset"] == want["opset"] == 12 and got["ir_version"] == want["ir_version"] == 7
    gw, gg = want["graph"], got["graph"]
    assert gg["inputs"] == gw["inputs"] == [{"name": "input", "shape": [1, 3, 224, 224]}]
    assert gg["outputs"] == gw["outputs"] == [{"name": "logits", "shape": [1, 2]}]
    assert len(gg["nodes"]) == len(gw["nodes"]) > 50
    for a, b in zip(gg["nodes"], gw["nodes"]):
        assert a == b, (a, b)
    assert list(gg["initializers"]) == list(gw["initializers"])
    for k, b in gw["initializers"].items():
        a = gg["initializers"][k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_allclose(a, b, rtol=0, atol=INIT_TOL * float(np.abs(b).max()),
                                   err_msg=k)


def test_onnx_graphs_run_crosswise_within_jax_bar():
    """The port's evaluator on JAX's graph, JAX's evaluator on the port's,
    and the port's on its own, against JAX's apply."""
    from fac_fake_tpu.compat.onnx_export import run_onnx as jax_run
    from fac_fake_torch.compat.onnx_export import run_onnx
    jax_graph, port_graph, _ = graphs()
    x, want = base_logits()
    runs = {"port on JAX's": run_onnx(jax_graph, {"input": x}, "cpu")["logits"].numpy(),
            "JAX on the port's": np.asarray(jax_run(port_graph, {"input": x})["logits"]),
            "port on its own": run_onnx(port_graph, {"input": torch.from_numpy(x)},
                                        "cpu")["logits"].numpy()}
    for what, got in runs.items():
        assert got.shape == (1, 2), what
        np.testing.assert_allclose(got, want, rtol=0, atol=ONNX_TOL, err_msg=what)


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the default where no card is")
def test_run_onnx_runs_on_the_card_unless_told_otherwise():
    """`run_onnx` is an entry point: with no ``device`` it runs on the card,
    so where there is none it raises instead of computing on the CPU."""
    import inspect
    from fac_fake_torch.compat.onnx_export import run_onnx
    assert inspect.signature(run_onnx).parameters["device"].default == "cuda"
    _, port_graph, _ = graphs()
    with pytest.raises((RuntimeError, AssertionError)):
        run_onnx(port_graph, {"input": _nchw_input()})


def test_onnx_export_refuses_what_jax_refuses(tmp_path):
    from fac_fake_torch.compat.onnx_export import export_onnx_cvit
    for name in ("cvit_repbn8", "cvit_ggca_add_glu"):
        with pytest.raises(NotImplementedError, match="base CViT"):
            export_onnx_cvit(port_model(name), str(tmp_path / "never.onnx"))
    assert not os.path.exists(tmp_path / "never.onnx")


@pytest.mark.parametrize("name", ["cvit", "cvit_repbn8"])
def test_program_matches_eager_and_jax(name):
    """The norms moved: ``cvit`` the ONNX case's model and input, the
    flagship a small twin (`small_fields`) at batch 2; the program against
    the eager forward and JAX's apply."""
    from fac_fake_torch.compat.export import export_program
    from fac_fake_torch.models import init_weights
    if name == "cvit":
        _, _, m = base_pair()
        x, want = base_logits()
    else:
        jm, m = jax_model(name), port_model(name)
        hw, var = m.config["image_size"], variant(name)
        v = moved(flax_variables(jm, init_weights(m, 0), hw, name, var), 0)
        v = {k: v[k] for k in ("params", "batch_stats", "schedule") if k in v}
        m = _load(m, v, var)
        x = _nchw_input(1, 2, hw)
        want = _jax_logits(jm, v, x)
    program = export_program(m, x.shape)
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got, eager = program.module()(xt), m(xt)
    np.testing.assert_allclose(got.numpy(), eager.numpy(), rtol=0, atol=PROGRAM_TOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    assert not m.training


@pytest.mark.parametrize("name", TRAIN_ENTRIES)
def test_zoo_program_matches_eager(name):
    """One entry of each block kind at `entry_dims`, batch 1, seeded; the
    program in memory (saved and loaded in the CLI's case)."""
    from fac_fake_torch.compat.export import export_program
    hw, _ = entry_dims(name)
    m = port_entry(name)
    xt = torch.from_numpy(_nchw_input(2, 1, hw)).contiguous(memory_format=torch.channels_last)
    program = export_program(m, tuple(xt.shape))
    with torch.no_grad():
        got, eager = program.module()(xt), m(xt)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), eager.numpy(), rtol=0, atol=PROGRAM_TOL)


def _check_state_dict(sd, ref):
    """``sd`` (the port's export) against JAX's `export_cvit` output: the same
    keys, each value bit-equal, ODConv's candidates ((kn, O, I, k, k) against
    flax's (kn, k, k, I, O)) and the zoo's flat scales through the port's
    layout."""
    assert sorted(sd) == sorted(ref)
    for k, want in ref.items():
        got = sd[k].numpy()
        assert sd[k].device.type == "cpu"
        if got.shape != want.shape:
            assert got.size == want.size, k
            want = want.transpose(0, 4, 3, 1, 2) if want.ndim == 5 else want.reshape(got.shape)
        assert np.array_equal(got, want), k


@pytest.mark.parametrize("name", ["cvit", "cvit_ggca_add_odconv", "cvit_ggca_odconv"])
def test_export_state_dict_matches_export_cvit_and_reloads(name, tmp_path):
    from fac_fake_tpu.compat.torch_export import export_cvit
    from fac_fake_tpu.core.config import ModelConfig as JaxModelConfig
    from fac_fake_tpu.models import build_model as jax_build
    from fac_fake_torch.compat.weights import export_state_dict, load_reference_pth
    if name == "cvit":
        jm, v, m = base_pair()
        hw, var, fresh = 224, "cvit", lambda sd: _fresh_cvit(sd)
    else:
        hw, dims = entry_dims(name)
        m, var = port_entry(name), variant(name)
        v = flax_variables(jax_build(JaxModelConfig(name=name, **dims)), m, hw, name)
        fresh = lambda sd: port_entry(name, sd)
    sd = export_state_dict(m)
    _check_state_dict(sd, export_cvit(v, var))
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    path = str(tmp_path / "w.pth")
    torch.save(sd, path)
    again = fresh(load_reference_pth(path))
    x = torch.from_numpy(_nchw_input(3, 1, hw)).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        assert torch.equal(again(x), m(x))


def _fresh_cvit(sd):
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model
    m = build_model(ModelConfig(name="cvit", **DIMS), device="cpu", seed=5)
    m.load_state_dict(sd, strict=True)
    return m


def test_cli_writes_each_format_and_refuses_orbax(tmp_path, capsys):
    from fac_fake_torch.cli import export as cli
    from fac_fake_torch.compat.export import load_program
    from fac_fake_torch.compat.weights import export_state_dict, load_reference_pth
    _, _, m = base_pair()
    pth = str(tmp_path / "w.pth")
    torch.save(export_state_dict(m), pth)
    common = ("--device", "cpu", "--weights", pth) + SMALL
    outs = {f: str(tmp_path / f"out.{f}") for f in ("onnx", "program", "torch")}
    for fmt, out in outs.items():
        extra = ("--batch", "2") if fmt == "program" else ()
        assert cli.main([fmt, out, *common, *extra]) == out
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [f"wrote {outs['onnx']} ({os.path.getsize(outs['onnx'])} bytes, opset 12)",
                     f"wrote {outs['program']} ({os.path.getsize(outs['program'])} bytes, "
                     "torch.export)",
                     f"wrote {outs['torch']} ({len(export_state_dict(m))} tensors, reference "
                     "layout)"]
    # the .pth came back whole; the graph is the model's; the program its forward
    back = load_reference_pth(outs["torch"])
    want = export_state_dict(m)
    assert sorted(back) == sorted(want) and all(torch.equal(back[k], want[k]) for k in want)
    with open(outs["onnx"], "rb") as fh:
        assert fh.read() == graphs()[2]
    x = torch.from_numpy(_nchw_input(4, 2)).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        np.testing.assert_allclose(load_program(outs["program"])(x).numpy(), m(x).numpy(),
                                   rtol=0, atol=PROGRAM_TOL)
    # no orbax: not a format, and no checkpoint directory as --weights
    assert "orbax" in cli.__doc__
    with pytest.raises(SystemExit):
        cli.main(["orbax", str(tmp_path / "ckpt")])
    with pytest.raises(SystemExit, match="orbax"):
        cli.main(["torch", str(tmp_path / "x.pth"), "--weights", str(tmp_path), "--device", "cpu"])
