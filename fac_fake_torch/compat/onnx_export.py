"""ONNX export of the base CViT (opset 12) and a torch evaluator — the port
of `fac_fake_tpu/compat/onnx_export.py`.

The reference exports its base CViT with `torch.onnx.export` at opset 12,
input (1, 3, 224, 224) (`model/pt_to_onnx.py:34-51`). torch's exporter needs
the `onnx` package, which neither of the port's machines has, so the graph
is emitted here from the port's BN-folded model (`compat/fold.py`) and
serialized by the dependency-free writer `onnx_proto.py`. It is the graph
JAX's `export_onnx_cvit` emits, node for node: the same op types,
attributes, tensor names and initializer names and shapes (convs OIHW,
dense kernels (in, out) for `MatMul`, so the port's (out, in) ``Linear``
weights go over transposed). JAX's quirks stay in the graph: the softmax
scale ``dim ** -0.5``, the legacy position row 0 at batch 1, the fixed
input (1, 3, 224, 224) and the 7·7·512 flatten through a `Transpose` to
NHWC (the ``(p1 p2 c)`` token order).

Ops stay inside opset 12: Conv/Relu/MaxPool stems, MatMul/Add embeddings,
LayerNorm as ReduceMean/Sub/Mul/Sqrt/Div, exact GELU through Erf, attention
as Reshape/Transpose/Gather/MatMul/Softmax.

`run_onnx` runs a parsed graph with torch ops on the device the caller
names, so the same artifact is checked on the card and on the CPU.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fac_fake_torch.compat import onnx_proto as op
from fac_fake_torch.core.device import DeviceLike

# the graph's fixed input and flatten, as the reference's export fixes them
INPUT_SHAPE = (1, 3, 224, 224)
FLAT = 7 * 7 * 512


class _Graph:
    def __init__(self):
        self.nodes = []
        self.inits = []
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init(self, name: str, arr: np.ndarray) -> str:
        self.inits.append(op.tensor_proto(name, arr))
        return name

    def add(self, op_type: str, inputs, output: Optional[str] = None, **attrs) -> str:
        out = output or self.fresh(op_type.lower())
        self.nodes.append(op.node_proto(op_type, inputs, [out], **attrs))
        return out

    def scalar(self, value: float) -> str:
        return self.init(self.fresh("c"), np.asarray(value, np.float32))

    def shape_of(self, dims) -> str:
        return self.init(self.fresh("shape"), np.asarray(dims, np.int64))

    def index(self, i: int) -> str:
        return self.init(self.fresh("idx"), np.asarray(i, np.int64))


def _layer_norm(g: _Graph, x: str, scale: np.ndarray, bias: np.ndarray, eps: float,
                prefix: str) -> str:
    mean = g.add("ReduceMean", [x], axes=[2], keepdims=1)   # x is (1, n, dim)
    d = g.add("Sub", [x, mean])
    var = g.add("ReduceMean", [g.add("Mul", [d, d])], axes=[2], keepdims=1)
    std = g.add("Sqrt", [g.add("Add", [var, g.scalar(eps)])])
    norm = g.add("Div", [d, std])
    sc = g.init(f"{prefix}.scale", scale)
    bi = g.init(f"{prefix}.bias", bias)
    return g.add("Add", [g.add("Mul", [norm, sc]), bi])


def _gelu(g: _Graph, x: str) -> str:
    """Exact GELU, 0.5 · x · (1 + erf(x / √2)): opset 12 has Erf, not Gelu."""
    e = g.add("Erf", [g.add("Div", [x, g.scalar(np.sqrt(2.0))])])
    return g.add("Mul", [g.add("Mul", [x, g.add("Add", [e, g.scalar(1.0)])]), g.scalar(0.5)])


def _dense(g: _Graph, x: str, sd: Mapping[str, np.ndarray], key: str, name: str,
           bias: bool = True) -> str:
    """``x @ W + b`` of the port's ``Linear`` ``key`` ((out, in) weight, as
    the (in, out) kernel ``name.kernel``)."""
    w = g.init(f"{name}.kernel", np.ascontiguousarray(sd[f"{key}.weight"].T))
    y = g.add("MatMul", [x, w])
    if bias:
        y = g.add("Add", [y, g.init(f"{name}.bias", sd[f"{key}.bias"])])
    return y


def _check_exportable(model) -> None:
    """JAX's refusals: the graph covers the base CViT, as the reference's
    export does; and no int8 model (its denses hold no fp weight)."""
    cfg = model.config
    if cfg.get("stem2_spec") is not None or model.use_ggca or cfg.get("slot1") is not None \
            or cfg.get("embed_block") is not None or cfg.get("token_block") is not None \
            or cfg["ffn_norm"] != "ln":
        raise NotImplementedError(
            "ONNX export covers the base CViT (the reference exports only it, "
            "model/pt_to_onnx.py:34-51)")
    if model.quant_dense or any(o[0] == "qconv" for o in model.stem_spec):
        raise NotImplementedError("ONNX export of an int8 model: export its fp32 original")


def export_onnx_cvit(model, path: str, opset: int = 12) -> bytes:
    """Serialize the base CViT ``model`` (the port's `CViT`) as ONNX: input
    'input' (1, 3, 224, 224) NCHW, output 'logits' (1, num_classes). BN is
    folded first (`compat/fold.py fold_cvit`, an exact reparameterization).
    Writes ``path`` and returns its bytes."""
    from fac_fake_torch.compat.fold import fold_cvit

    _check_exportable(model)
    folded = fold_cvit(model)
    sd = {k: v.detach().float().cpu().numpy() for k, v in folded.state_dict().items()}
    cfg = folded.config
    g = _Graph()

    x = "input"                         # (1, 3, 224, 224) NCHW, ONNX's conv layout
    for li, spec_op in enumerate(folded.stem_spec):
        kind = spec_op[0]
        if kind == "conv":              # the port's conv weight is OIHW already
            w = g.init(f"stem.l{li}.kernel", sd[f"features.{li}.weight"])
            b = g.init(f"stem.l{li}.bias", sd[f"features.{li}.bias"])
            x = g.add("Conv", [x, w, b], kernel_shape=[3, 3], pads=[1, 1, 1, 1],
                      strides=[1, 1])
        elif kind == "relu":
            x = g.add("Relu", [x])
        elif kind == "pool":
            x = g.add("MaxPool", [x], kernel_shape=[2, 2], strides=[2, 2])
        else:
            raise NotImplementedError(f"stem op {kind} in ONNX export")
    # NCHW (1, 512, 7, 7) → NHWC → one 25088-wide token (h = w = 1, p = 7:
    # the '(p1 p2 c)' order is the NHWC flatten)
    x = g.add("Transpose", [x], perm=[0, 2, 3, 1])
    x = g.add("Reshape", [x, g.shape_of([1, 1, FLAT])])
    x = _dense(g, x, sd, "patch_to_embedding", "patch_to_embedding")

    dim, heads, depth = cfg["dim"], cfg["heads"], cfg["depth"]
    cls = g.init("cls_token", sd["cls_token"].reshape(1, 1, dim))
    x = g.add("Concat", [cls, x], axis=1)          # (1, 2, dim)
    # the legacy (32, 1, dim) batch-indexed pos embedding: batch 1 → row 0
    x = g.add("Add", [x, g.init("pos_embedding", sd["pos_embedding"][0:1])])

    hd = dim // heads
    n_tok = 2
    for i in range(depth):
        L = f"transformer.layers.{i}"
        h = _layer_norm(g, x, sd[f"{L}.0.fn.norm.weight"], sd[f"{L}.0.fn.norm.bias"], 1e-5,
                        f"attn_norm{i}")
        qkv = _dense(g, h, sd, f"{L}.0.fn.fn.to_qkv", f"attn{i}.to_qkv", bias=False)
        qkv = g.add("Reshape", [qkv, g.shape_of([1, n_tok, 3, heads, hd])])
        qkv = g.add("Transpose", [qkv], perm=[2, 0, 3, 1, 4])   # (3, 1, h, n, hd)
        q = g.add("Gather", [qkv, g.index(0)], axis=0)
        k = g.add("Gather", [qkv, g.index(1)], axis=0)
        v = g.add("Gather", [qkv, g.index(2)], axis=0)
        kt = g.add("Transpose", [k], perm=[0, 1, 3, 2])
        # quirk kept: the softmax scale is dim ** -0.5, not head_dim ** -0.5
        dots = g.add("Mul", [g.add("MatMul", [q, kt]), g.scalar(dim ** -0.5)])
        attn = g.add("Softmax", [dots], axis=3)
        ctx = g.add("MatMul", [attn, v])
        ctx = g.add("Transpose", [ctx], perm=[0, 2, 1, 3])
        ctx = g.add("Reshape", [ctx, g.shape_of([1, n_tok, dim])])
        x = g.add("Add", [x, _dense(g, ctx, sd, f"{L}.0.fn.fn.to_out", f"attn{i}.to_out")])

        h = _layer_norm(g, x, sd[f"{L}.1.fn.norm.weight"], sd[f"{L}.1.fn.norm.bias"], 1e-5,
                        f"ffn_norm{i}")
        h = _dense(g, h, sd, f"{L}.1.fn.fn.net.0", f"ffn{i}.fc1")
        h = _gelu(g, h)
        h = _dense(g, h, sd, f"{L}.1.fn.fn.net.2", f"ffn{i}.fc2")
        x = g.add("Add", [x, h])

    x = g.add("Gather", [x, g.index(0)], axis=1)   # the cls token (1, dim)
    x = _dense(g, x, sd, "mlp_head.0", "mlp_head.fc1")
    x = g.add("Relu", [x])
    w = g.init("mlp_head.fc2.kernel", np.ascontiguousarray(sd["mlp_head.2.weight"].T))
    g.nodes.append(op.node_proto("MatMul", [x, w], ["pre_logits"]))
    g.nodes.append(op.node_proto(
        "Add", ["pre_logits", g.init("mlp_head.fc2.bias", sd["mlp_head.2.bias"])], ["logits"]))

    graph = op.graph_proto(g.nodes, "cvit", g.inits,
                           inputs=[op.value_info("input", INPUT_SHAPE)],
                           outputs=[op.value_info("logits", (1, cfg["num_classes"]))])
    blob = op.model_proto(graph, opset=opset)
    with open(path, "wb") as f:
        f.write(blob)
    return blob


# --- the torch evaluator -----------------------------------------------------

def _conv(x, w, b, attrs):
    pt, pl, pb, pr = attrs.get("pads", [0, 0, 0, 0])
    if (pt, pl) != (pb, pr):
        x, pt, pl = F.pad(x, (pl, pr, pt, pb)), 0, 0
    return F.conv2d(x, w, b, stride=tuple(attrs.get("strides", [1, 1])), padding=(pt, pl))


def _gather(x, idx, axis):
    """ONNX Gather (numpy's ``take``): the indices' shape replaces ``axis``."""
    axis %= x.dim()
    flat = torch.index_select(x, axis, idx.reshape(-1).to(x.device))
    return flat.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def _softmax(x, axis):
    """Opset 12's Softmax: over the dims from ``axis`` on, flattened."""
    axis %= x.dim()
    return torch.softmax(x.reshape(*x.shape[:axis], -1), dim=-1).reshape(x.shape)


def run_onnx(model: Dict, feeds: Mapping[str, object],
             device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Run a parsed model (`onnx_proto.parse_model`) with torch ops on
    ``device`` (the card unless the caller names the CPU); ``feeds`` maps
    input names to arrays or tensors. Returns
    {output name: tensor on ``device``}. int64 initializers (shapes,
    indices) stay on the CPU."""
    dev = torch.device(device)
    g = model["graph"]
    env: Dict[str, torch.Tensor] = {
        k: torch.from_numpy(v) if v.dtype == np.int64 else torch.from_numpy(v).to(dev)
        for k, v in g["initializers"].items()}
    env.update({k: torch.as_tensor(v).to(dev) for k, v in feeds.items()})
    ops = {
        "Relu": lambda i, a: torch.relu(i[0]),
        "Add": lambda i, a: i[0] + i[1],
        "Sub": lambda i, a: i[0] - i[1],
        "Mul": lambda i, a: i[0] * i[1],
        "Div": lambda i, a: i[0] / i[1],
        "Sqrt": lambda i, a: torch.sqrt(i[0]),
        "Erf": lambda i, a: torch.erf(i[0]),
        "MatMul": lambda i, a: torch.matmul(i[0], i[1]),
        "Conv": lambda i, a: _conv(i[0], i[1], i[2], a),
        "MaxPool": lambda i, a: F.max_pool2d(i[0], tuple(a["kernel_shape"]),
                                             tuple(a["strides"])),
        "ReduceMean": lambda i, a: i[0].mean(dim=tuple(a["axes"]),
                                             keepdim=bool(a.get("keepdims", 1))),
        "Softmax": lambda i, a: _softmax(i[0], a.get("axis", 1)),
        "Transpose": lambda i, a: i[0].permute(*a["perm"]),
        "Reshape": lambda i, a: i[0].reshape([int(d) for d in i[1].tolist()]),
        "Concat": lambda i, a: torch.cat(i, dim=a["axis"]),
        "Gather": lambda i, a: _gather(i[0], i[1], a.get("axis", 0)),
    }
    with torch.inference_mode():
        for node in g["nodes"]:
            fn = ops.get(node["op"])
            if fn is None:
                raise NotImplementedError(f"evaluator op {node['op']}")
            env[node["outputs"][0]] = fn([env[n] for n in node["inputs"]], node["attrs"])
    return {o["name"]: env[o["name"]] for o in g["outputs"]}
