"""ONNX model IR: schema-aware decoding of ModelProto into plain dataclasses.
The port's own copy of onnxocr_tpu/onnx/ir.py (numpy only).

Field numbers follow the public onnx.proto3 schema (onnx/onnx.proto). Only the
subset needed to run inference graphs is decoded: graph topology, node
attributes, initializers (weights), and input/output value infos.

This replaces the reference's dependency on the `onnxruntime` C++ session
(reference: onnxocr/predict_base.py:7-17) with an in-repo reader that feeds
the PyTorch executor (executor.py) and the weight lift (models/lift.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from . import wire

# TensorProto.DataType
DTYPE_MAP = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_GRAPH = 5
ATTR_FLOATS = 6
ATTR_INTS = 7
ATTR_STRINGS = 8


@dataclasses.dataclass
class Node:
    op_type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]


@dataclasses.dataclass
class ValueInfo:
    name: str
    elem_type: Optional[int] = None
    # Each dim is an int (static), a str (symbolic dim_param), or None.
    shape: Optional[List[Any]] = None


@dataclasses.dataclass
class Graph:
    name: str
    nodes: List[Node]
    initializers: Dict[str, np.ndarray]
    inputs: List[ValueInfo]   # graph inputs *excluding* initializers
    outputs: List[ValueInfo]


@dataclasses.dataclass
class Model:
    ir_version: int
    opset: int
    producer: str
    graph: Graph


def _decode_tensor(raw) -> tuple:
    """Decode a TensorProto; returns (name, ndarray)."""
    dims: List[int] = []
    data_type = 1
    name = ""
    raw_data = None
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    double_data: List[float] = []
    uint64_data: List[int] = []
    for fno, wt, val in wire.iter_fields(raw):
        if fno == 1:  # dims (int64, possibly packed)
            if wt == wire.VARINT:
                dims.append(val)
            else:
                dims.extend(wire.unpack_packed_varints(val))
        elif fno == 2 and wt == wire.VARINT:
            data_type = val
        elif fno == 4:  # float_data
            if wt == wire.FIXED32:
                float_data.append(wire.as_float(val))
            else:
                float_data.extend(wire.unpack_packed_floats(val))
        elif fno == 5:  # int32_data
            if wt == wire.VARINT:
                int32_data.append(wire.signed(val, 32))
            else:
                int32_data.extend(wire.signed(v, 32)
                                  for v in wire.unpack_packed_varints(val))
        elif fno == 7:  # int64_data
            if wt == wire.VARINT:
                int64_data.append(wire.signed(val))
            else:
                int64_data.extend(wire.signed(v)
                                  for v in wire.unpack_packed_varints(val))
        elif fno == 8 and wt == wire.LENGTH:
            name = bytes(val).decode("utf-8")
        elif fno == 9 and wt == wire.LENGTH:
            raw_data = bytes(val)
        elif fno == 10:  # double_data
            if wt == wire.FIXED64:
                double_data.append(wire.as_double(val))
            else:
                double_data.extend(wire.unpack_packed_doubles(val))
        elif fno == 11:  # uint64_data
            if wt == wire.VARINT:
                uint64_data.append(val)
            else:
                uint64_data.extend(wire.unpack_packed_varints(val))

    np_dtype = DTYPE_MAP.get(data_type)
    if np_dtype is None:
        raise ValueError(f"unsupported tensor dtype {data_type} for {name!r}")
    if raw_data is not None:
        arr = np.frombuffer(raw_data, dtype=np_dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=np_dtype)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=np_dtype)
    elif int32_data:
        # int32_data also carries int16/int8/uint8/bool/float16 payloads
        arr = np.asarray(int32_data, dtype=np.int32)
        if np_dtype == np.float16:
            arr = arr.astype(np.uint16).view(np.float16)
        else:
            arr = arr.astype(np_dtype)
    elif double_data:
        arr = np.asarray(double_data, dtype=np_dtype)
    elif uint64_data:
        arr = np.asarray(uint64_data, dtype=np_dtype)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _decode_attribute(raw) -> tuple:
    name = ""
    atype = None
    f = i = s = t = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for fno, wt, val in wire.iter_fields(raw):
        if fno == 1 and wt == wire.LENGTH:
            name = bytes(val).decode("utf-8")
        elif fno == 2 and wt == wire.FIXED32:
            f = wire.as_float(val)
        elif fno == 3 and wt == wire.VARINT:
            i = wire.signed(val)
        elif fno == 4 and wt == wire.LENGTH:
            s = bytes(val)
        elif fno == 5 and wt == wire.LENGTH:
            t = _decode_tensor(val)[1]
        elif fno == 7:  # floats
            if wt == wire.FIXED32:
                floats.append(wire.as_float(val))
            else:
                floats.extend(wire.unpack_packed_floats(val))
        elif fno == 8:  # ints
            if wt == wire.VARINT:
                ints.append(wire.signed(val))
            else:
                ints.extend(wire.signed(v)
                            for v in wire.unpack_packed_varints(val))
        elif fno == 9 and wt == wire.LENGTH:
            strings.append(bytes(val))
        elif fno == 20 and wt == wire.VARINT:
            atype = val

    if atype == ATTR_FLOAT:
        value: Any = f
    elif atype == ATTR_INT:
        value = i
    elif atype == ATTR_STRING:
        value = s.decode("utf-8", "replace") if s is not None else ""
    elif atype == ATTR_TENSOR:
        value = t
    elif atype == ATTR_FLOATS:
        value = floats
    elif atype == ATTR_INTS:
        value = ints
    elif atype == ATTR_STRINGS:
        value = [b.decode("utf-8", "replace") for b in strings]
    else:
        # Fall back to whichever field was populated (pre-typed protos).
        value = next((v for v in (i, f, s, t) if v is not None),
                     ints or floats or strings or None)
    return name, value


def _decode_value_info(raw) -> ValueInfo:
    vi = ValueInfo(name="")
    for fno, wt, val in wire.iter_fields(raw):
        if fno == 1 and wt == wire.LENGTH:
            vi.name = bytes(val).decode("utf-8")
        elif fno == 2 and wt == wire.LENGTH:  # TypeProto
            for f2, w2, v2 in wire.iter_fields(val):
                if f2 == 1 and w2 == wire.LENGTH:  # tensor_type
                    for f3, w3, v3 in wire.iter_fields(v2):
                        if f3 == 1 and w3 == wire.VARINT:
                            vi.elem_type = v3
                        elif f3 == 2 and w3 == wire.LENGTH:  # shape
                            dims: List[Any] = []
                            for f4, w4, v4 in wire.iter_fields(v3):
                                if f4 == 1 and w4 == wire.LENGTH:  # dim
                                    dim: Any = None
                                    for f5, w5, v5 in wire.iter_fields(v4):
                                        if f5 == 1 and w5 == wire.VARINT:
                                            dim = v5
                                        elif f5 == 2 and w5 == wire.LENGTH:
                                            dim = bytes(v5).decode("utf-8")
                                    dims.append(dim)
                            vi.shape = dims
    return vi


def _decode_node(raw) -> Node:
    inputs: List[str] = []
    outputs: List[str] = []
    name = ""
    op_type = ""
    attrs: Dict[str, Any] = {}
    for fno, wt, val in wire.iter_fields(raw):
        if fno == 1 and wt == wire.LENGTH:
            inputs.append(bytes(val).decode("utf-8"))
        elif fno == 2 and wt == wire.LENGTH:
            outputs.append(bytes(val).decode("utf-8"))
        elif fno == 3 and wt == wire.LENGTH:
            name = bytes(val).decode("utf-8")
        elif fno == 4 and wt == wire.LENGTH:
            op_type = bytes(val).decode("utf-8")
        elif fno == 5 and wt == wire.LENGTH:
            aname, avalue = _decode_attribute(val)
            attrs[aname] = avalue
    return Node(op_type=op_type, name=name, inputs=inputs,
                outputs=outputs, attrs=attrs)


def _decode_graph(raw) -> Graph:
    nodes: List[Node] = []
    initializers: Dict[str, np.ndarray] = {}
    inputs: List[ValueInfo] = []
    outputs: List[ValueInfo] = []
    name = ""
    for fno, wt, val in wire.iter_fields(raw):
        if fno == 1 and wt == wire.LENGTH:
            nodes.append(_decode_node(val))
        elif fno == 2 and wt == wire.LENGTH:
            name = bytes(val).decode("utf-8")
        elif fno == 5 and wt == wire.LENGTH:
            tname, arr = _decode_tensor(val)
            initializers[tname] = arr
        elif fno == 11 and wt == wire.LENGTH:
            inputs.append(_decode_value_info(val))
        elif fno == 12 and wt == wire.LENGTH:
            outputs.append(_decode_value_info(val))
    # Per ONNX convention initializers may also appear as graph inputs;
    # the real runtime-fed inputs are those without an initializer.
    inputs = [vi for vi in inputs if vi.name not in initializers]
    return Graph(name=name, nodes=nodes, initializers=initializers,
                 inputs=inputs, outputs=outputs)


def load_model(path: str) -> Model:
    with open(path, "rb") as f:
        buf = f.read()
    return parse_model(buf)


def parse_model(buf: bytes) -> Model:
    ir_version = 0
    opset = 0
    producer = ""
    graph: Optional[Graph] = None
    for fno, wt, val in wire.iter_fields(buf):
        if fno == 1 and wt == wire.VARINT:
            ir_version = val
        elif fno == 2 and wt == wire.LENGTH:
            producer = bytes(val).decode("utf-8", "replace")
        elif fno == 7 and wt == wire.LENGTH:
            graph = _decode_graph(val)
        elif fno == 8 and wt == wire.LENGTH:  # opset_import
            domain, version = "", 0
            for f2, w2, v2 in wire.iter_fields(val):
                if f2 == 1 and w2 == wire.LENGTH:
                    domain = bytes(v2).decode("utf-8")
                elif f2 == 2 and w2 == wire.VARINT:
                    version = v2
            if domain in ("", "ai.onnx"):
                opset = max(opset, version)
    if graph is None:
        raise ValueError("no graph in model")
    return Model(ir_version=ir_version, opset=opset,
                 producer=producer, graph=graph)
