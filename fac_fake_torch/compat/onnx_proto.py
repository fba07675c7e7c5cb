"""Minimal ONNX protobuf writer and reader, numpy only — the port's own copy
of `fac_fake_tpu/compat/onnx_proto.py`.

Neither the port's machines nor its tests have the `onnx` package or
`onnxruntime` (and torch's ONNX exporter needs `onnx`), so the ONNX
artifact (the reference's `model/pt_to_onnx.py:34-51` writes one at opset
12) is serialized here directly against the public `onnx.proto` schema:
protobuf wire format is tag-length-value with varints, and the
ModelProto/GraphProto/NodeProto/TensorProto field numbers below are the
published schema's, as in the JAX package's writer (opset 12, IR version 7).

The reader parses the same subset back: serialize → `parse_model` → run
with `onnx_export.run_onnx` → compare against the model's own forward.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np

# TensorProto.DataType
FLOAT = 1
INT64 = 7

# AttributeProto.AttributeType
AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR = 1, 2, 3, 4
AT_FLOATS, AT_INTS = 6, 7


# --- wire-format primitives --------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_varint(field: int, value: int) -> bytes:
    return _varint(field << 3) + _varint(value)


def _field_bytes(field: int, data: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(data)) + data


def _field_str(field: int, s: str) -> bytes:
    return _field_bytes(field, s.encode())


def _field_f32(field: int, v: float) -> bytes:
    return _varint((field << 3) | 5) + struct.pack("<f", v)


def _packed_varints(field: int, values: Sequence[int]) -> bytes:
    payload = b"".join(_varint(v) for v in values)
    return _field_bytes(field, payload)


# --- ONNX message writers ----------------------------------------------------

def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    shape = np.asarray(arr).shape
    arr = np.ascontiguousarray(arr).reshape(shape)  # keep 0-d tensors 0-d
    if arr.dtype == np.float32:
        dt = FLOAT
    elif arr.dtype == np.int64:
        dt = INT64
    else:
        raise TypeError(f"unsupported tensor dtype {arr.dtype}")
    out = _packed_varints(1, list(arr.shape))
    out += _field_varint(2, dt)
    out += _field_str(8, name)
    out += _field_bytes(9, arr.tobytes())  # little-endian host
    return out


def _attribute(name: str, value: Any) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20."""
    out = _field_str(1, name)
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, float):
        out += _field_f32(2, value) + _field_varint(20, AT_FLOAT)
    elif isinstance(value, int):
        out += _field_varint(3, value) + _field_varint(20, AT_INT)
    elif isinstance(value, str):
        out += _field_bytes(4, value.encode()) + _field_varint(20, AT_STRING)
    elif isinstance(value, np.ndarray):
        out += _field_bytes(5, tensor_proto("", value)) + _field_varint(20, AT_TENSOR)
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        for v in value:
            out += _field_f32(7, v)
        out += _field_varint(20, AT_FLOATS)
    elif isinstance(value, (list, tuple)):
        for v in value:
            out += _field_varint(8, int(v))
        out += _field_varint(20, AT_INTS)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return out


def node_proto(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
               name: str = "", **attrs) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    out = b""
    for i in inputs:
        out += _field_str(1, i)
    for o in outputs:
        out += _field_str(2, o)
    out += _field_str(3, name or outputs[0])
    out += _field_str(4, op_type)
    for k, v in attrs.items():
        out += _field_bytes(5, _attribute(k, v))
    return out


def value_info(name: str, shape: Sequence[int], elem_type: int = FLOAT) -> bytes:
    """ValueInfoProto: name=1, type=2{tensor_type=1{elem_type=1, shape=2}}."""
    dims = b"".join(_field_bytes(1, _field_varint(1, d)) for d in shape)
    tensor_ty = _field_varint(1, elem_type) + _field_bytes(2, dims)
    ty = _field_bytes(1, tensor_ty)
    return _field_str(1, name) + _field_bytes(2, ty)


def graph_proto(nodes: Sequence[bytes], name: str,
                initializers: Sequence[bytes],
                inputs: Sequence[bytes], outputs: Sequence[bytes]) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    out = b"".join(_field_bytes(1, n) for n in nodes)
    out += _field_str(2, name)
    out += b"".join(_field_bytes(5, t) for t in initializers)
    out += b"".join(_field_bytes(11, v) for v in inputs)
    out += b"".join(_field_bytes(12, v) for v in outputs)
    return out


def model_proto(graph: bytes, opset: int = 12,
                producer: str = "fac_fake_torch") -> bytes:
    """ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8;
    OperatorSetIdProto: domain=1, version=2. ir_version 7 pairs with opset 12."""
    opset_id = _field_str(1, "") + _field_varint(2, opset)
    out = _field_varint(1, 7)
    out += _field_str(2, producer)
    out += _field_bytes(7, graph)
    out += _field_bytes(8, opset_id)
    return out


# --- reader ------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif wire == 1:
            val = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dt, name, raw = FLOAT, "", b""
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            if wire == 0:
                dims.append(val)
            else:  # packed
                p = 0
                while p < len(val):
                    d, p = _read_varint(val, p)
                    dims.append(d)
        elif field == 2:
            dt = val
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
    dtype = np.float32 if dt == FLOAT else np.int64
    return name, np.frombuffer(raw, dtype).reshape(dims).copy()


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_attr(buf: bytes) -> Tuple[str, Any]:
    name, ints, floats, out = "", [], [], None
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:
            out = val
        elif field == 3:
            out = _signed(val)
        elif field == 4:
            out = val.decode()
        elif field == 5:
            out = _parse_tensor(val)[1]
        elif field == 7:
            floats.append(val)
        elif field == 8:
            ints.append(_signed(val))
    if ints:
        out = ints
    if floats:
        out = floats
    return name, out


def _parse_node(buf: bytes) -> Dict[str, Any]:
    node: Dict[str, Any] = {"inputs": [], "outputs": [], "attrs": {},
                            "op": "", "name": ""}
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            node["inputs"].append(val.decode())
        elif field == 2:
            node["outputs"].append(val.decode())
        elif field == 3:
            node["name"] = val.decode()
        elif field == 4:
            node["op"] = val.decode()
        elif field == 5:
            k, v = _parse_attr(val)
            node["attrs"][k] = v
    return node


def parse_model(buf: Union[bytes, str]) -> Dict[str, Any]:
    """Parse a ModelProto (bytes or file path) into
    {ir_version, opset, graph: {nodes, initializers, inputs, outputs}}."""
    if isinstance(buf, str):
        with open(buf, "rb") as f:
            buf = f.read()
    model: Dict[str, Any] = {"ir_version": None, "opset": None, "graph": None}
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            model["ir_version"] = val
        elif field == 8:
            for f2, _, v2 in _iter_fields(val):
                if f2 == 2:
                    model["opset"] = v2
        elif field == 7:
            g: Dict[str, Any] = {"nodes": [], "initializers": {},
                                 "inputs": [], "outputs": []}
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    g["nodes"].append(_parse_node(v2))
                elif f2 == 5:
                    n, t = _parse_tensor(v2)
                    g["initializers"][n] = t
                elif f2 == 11:
                    g["inputs"].append(_parse_value_info(v2))
                elif f2 == 12:
                    g["outputs"].append(_parse_value_info(v2))
            model["graph"] = g
    return model


def _parse_value_info(buf: bytes) -> Dict[str, Any]:
    name, shape = "", []
    for field, _, val in _iter_fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:
            for f2, _, v2 in _iter_fields(val):       # TypeProto.tensor_type
                if f2 == 1:
                    for f3, _, v3 in _iter_fields(v2):  # Tensor.shape
                        if f3 == 2:
                            for f4, _, v4 in _iter_fields(v3):  # dim
                                if f4 == 1:
                                    for f5, _, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            shape.append(v5)
    return {"name": name, "shape": shape}
