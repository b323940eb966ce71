"""ONNX import, a copy of ``unetseg_tpu/models/import_onnx.py`` for the port.

A user holding only the ``.onnx`` of the reference's chain (PyTorch ->
ONNX -> TensorRT) imports it here, without the ``onnx`` package: the
protobuf wire format is walked directly (protobuf encoding + onnx.proto
field numbers):

    ModelProto.graph        = field 7  (message)
    GraphProto.node         = field 1  (repeated NodeProto)
    GraphProto.initializer  = field 5  (repeated TensorProto)
    NodeProto.input/output  = fields 1/2 (repeated string)
    NodeProto.op_type       = field 4  (string)
    NodeProto.attribute     = field 5  (repeated AttributeProto)
    AttributeProto.name/i/t/ints = fields 1/3/5/8
    TensorProto.dims        = field 1  (repeated int64)
    TensorProto.data_type   = field 2  (enum; FLOAT=1, DOUBLE=11, INT64=7)
    TensorProto.float_data  = field 4  (packed floats)
    TensorProto.name        = field 8  (string)
    TensorProto.raw_data    = field 9  (bytes, little-endian)

Two entry points, both returning the JAX-layout tree as float32 numpy:

* :func:`load_onnx`, by topology: walks the graph's Conv / Relu / MaxPool /
  ConvTranspose / Concat / BatchNormalization nodes in order, rebuilds the
  UNet's stages from the op pattern (encoder pairs split by MaxPools,
  ConvTranspose + Concat decoder stages, a trailing 1x1 head), infers the
  ModelConfig (depth, base_channels, in_channels, num_classes) from the
  weight shapes and folds inference-mode BatchNorm.  Exporter-mangled
  tensor names (``onnx::Conv_123``) and Constant-node weights are handled;
  graphs outside the family are refused.
* :func:`params_from_onnx`, by initializer name, for exporters that keep
  the state-dict names.

:func:`write_onnx_initializers` and :func:`write_onnx_graph` write the
subset the readers take (tests, tooling, and files on a machine without
``onnx``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field as dc_field
from typing import Dict, Iterator, List, Tuple

import numpy as np

from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models import import_torch as it

_FLOAT, _INT64, _DOUBLE = 1, 7, 11
_DTYPES = {_FLOAT: np.float32, _INT64: np.int64, _DOUBLE: np.float64}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _parse_tensor(buf: bytes):
    dims = []
    dtype = _FLOAT
    name = ""
    raw = None
    vals: List = []
    for field, wire, val in _fields(buf):
        if field == 1:                   # dims (packed OR unpacked varints)
            if wire == 0:
                dims.append(val)
            elif wire == 2:
                pos = 0
                while pos < len(val):
                    d, pos = _read_varint(val, pos)
                    dims.append(d)
        elif field == 2 and wire == 0:
            dtype = val
        elif field == 4:                 # float_data
            if wire == 2:  # packed floats
                vals.extend(struct.unpack(f"<{len(val)//4}f", val))
            elif wire == 5:
                vals.append(struct.unpack("<f", val)[0])
        elif field == 7:                 # int64_data (packed or unpacked)
            if wire == 0:
                vals.append(val)
            elif wire == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    vals.append(v)
        elif field == 8 and wire == 2:
            name = val.decode("utf-8")
        elif field == 9 and wire == 2:
            raw = val
        elif field == 10:                # double_data
            if wire == 2:
                vals.extend(struct.unpack(f"<{len(val)//8}d", val))
            elif wire == 1:
                vals.append(struct.unpack("<d", val)[0])
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        return name, None  # unsupported dtype: skip
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np.dtype(np_dtype).newbyteorder("<"))
    else:
        arr = np.asarray(vals, np_dtype)
    return name, arr.reshape(dims).astype(np_dtype)


def read_initializers(path: str) -> Dict[str, np.ndarray]:
    """Extract all named initializer tensors from an .onnx file."""
    with open(path, "rb") as f:
        model = f.read()
    out: Dict[str, np.ndarray] = {}
    for field, wire, graph in _fields(model):
        if field == 7 and wire == 2:  # ModelProto.graph
            for gfield, gwire, tensor in _fields(graph):
                if gfield == 5 and gwire == 2:  # GraphProto.initializer
                    name, arr = _parse_tensor(tensor)
                    if arr is not None and name:
                        out[name] = arr
    return out


def params_from_onnx(path: str, cfg: ModelConfig = ModelConfig()) -> dict:
    """.onnx -> parameter tree (via the canonical state-dict naming)."""
    return it.convert_state_dict(read_initializers(path), cfg)


# --------------------------------------------------------------------------
# Topology-based import
# --------------------------------------------------------------------------

@dataclass
class _Node:
    op: str
    inputs: List[str] = dc_field(default_factory=list)
    outputs: List[str] = dc_field(default_factory=list)
    attrs: Dict[str, object] = dc_field(default_factory=dict)


def _parse_attribute(buf: bytes):
    name = ""
    value = None
    ints: List[int] = []
    for f, wire, val in _fields(buf):
        if f == 1 and wire == 2:
            name = val.decode("utf-8")
        elif f == 2 and wire == 5:       # f (float) — e.g. BN epsilon
            value = struct.unpack("<f", val)[0]
        elif f == 3 and wire == 0:       # i
            value = val
        elif f == 4 and wire == 2:       # s (bytes) — e.g. auto_pad
            value = val.decode("utf-8", "replace")
        elif f == 5 and wire == 2:       # t (TensorProto)
            value = _parse_tensor(val)[1]
        elif f == 8:                     # ints (packed or unpacked)
            if wire == 0:
                ints.append(val)
            elif wire == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(v)
    if ints:
        value = ints
    return name, value


def _parse_node(buf: bytes) -> _Node:
    node = _Node(op="")
    for f, wire, val in _fields(buf):
        if f == 1 and wire == 2:
            node.inputs.append(val.decode("utf-8"))
        elif f == 2 and wire == 2:
            node.outputs.append(val.decode("utf-8"))
        elif f == 4 and wire == 2:
            node.op = val.decode("utf-8")
        elif f == 5 and wire == 2:
            k, v = _parse_attribute(val)
            if k:
                node.attrs[k] = v
    return node


def read_graph(path: str) -> Tuple[List[_Node], Dict[str, np.ndarray]]:
    """(nodes in graph order, tensors) — tensors covers initializers AND
    Constant-node outputs (some exporters emit weights as Constants)."""
    with open(path, "rb") as f:
        model = f.read()
    nodes: List[_Node] = []
    tensors: Dict[str, np.ndarray] = {}
    for f_, wire, graph in _fields(model):
        if f_ == 7 and wire == 2:  # ModelProto.graph
            for gf, gw, payload in _fields(graph):
                if gf == 1 and gw == 2:
                    nodes.append(_parse_node(payload))
                elif gf == 5 and gw == 2:
                    name, arr = _parse_tensor(payload)
                    if arr is not None and name:
                        tensors[name] = arr
    for n in nodes:
        if n.op == "Constant" and n.outputs:
            v = n.attrs.get("value")
            if isinstance(v, np.ndarray):
                tensors[n.outputs[0]] = v
    return nodes, tensors


_SUPPORTED = {"Conv", "ConvTranspose", "Relu", "MaxPool", "Concat",
              "BatchNormalization", "Constant", "Identity", "Cast",
              "Dropout", "Shape", "Gather", "Unsqueeze", "Slice"}


def load_onnx(path: str) -> Tuple[dict, ModelConfig]:
    """Topology-based .onnx -> (params pytree, inferred ModelConfig).

    Reconstructs the canonical UNet stage structure from the op sequence
    (exporter-independent): Conv pairs separated by MaxPools form the
    encoder, the pair after the last MaxPool is the bottleneck, each
    ConvTranspose (+Concat) introduces a decoder stage, and the final Conv
    is the 1x1 head.  Inference-mode BatchNormalization nodes fold into the
    preceding conv.  Raises ValueError on graphs outside this family.
    """
    nodes, tensors = read_graph(path)

    unsupported = sorted({n.op for n in nodes} - _SUPPORTED)
    if unsupported:
        raise ValueError(
            f"unsupported ONNX ops for the UNet family: {unsupported}")

    # Walk convs in graph (topological) order, folding BN consumers.
    def _weight(name):
        if name not in tensors:
            raise ValueError(f"weight tensor {name!r} not found in "
                             "initializers/Constants")
        return tensors[name]

    # map: tensor name -> consumer nodes
    consumers: Dict[str, List[_Node]] = {}
    for n in nodes:
        for i in n.inputs:
            consumers.setdefault(i, []).append(n)

    def fold_bn_chain(node: _Node, conv: dict, out_axis: int) -> dict:
        """Follow node's output through Relu-free BN and fold it.

        ``out_axis`` is the OUTPUT-channel axis of the RAW weight layout at
        this point in the walk: 0 for Conv (OIHW), 1 for ConvTranspose
        (IOHW).  ``import_torch.fold_batchnorm`` scales the last axis, the
        HWIO layout's, and is wrong on these raw layouts.
        """
        out = node.outputs[0]
        for c in consumers.get(out, []):
            if c.op == "BatchNormalization":
                gamma, beta, mean, var = (_weight(c.inputs[k])
                                          for k in range(1, 5))
                eps_attr = c.attrs.get("epsilon")
                eps = 1e-5 if eps_attr is None else float(eps_attr)
                scale = gamma / np.sqrt(var + eps)
                shape = [1] * conv["w"].ndim
                shape[out_axis] = -1
                return {"w": conv["w"] * scale.reshape(shape),
                        "b": (conv["b"] - mean) * scale + beta}
        return conv

    def _ints(v):
        return list(v) if isinstance(v, (list, tuple)) else None

    def _check_attrs(n: _Node) -> None:
        """Reject graphs whose node semantics differ from the canonical
        UNet family (3x3-SAME / 1x1 convs, 2x2/2 pools and up-convs);
        otherwise weights would graft silently into a model with other
        semantics."""
        a = n.attrs
        if a.get("group") not in (None, 1):
            raise ValueError(f"{n.op}: group={a['group']} unsupported")
        dil = _ints(a.get("dilations"))
        if dil and any(d != 1 for d in dil):
            raise ValueError(f"{n.op}: dilations {dil} unsupported")
        ks = _ints(a.get("kernel_shape"))
        strides = _ints(a.get("strides"))
        pads = _ints(a.get("pads"))
        auto = a.get("auto_pad")
        if n.op == "Conv":
            if strides and any(s != 1 for s in strides):
                raise ValueError(f"Conv: strides {strides} unsupported")
            k = ks[0] if ks else _weight(n.inputs[1]).shape[2]
            if ks and (len(ks) != 2 or ks[0] != ks[1] or k not in (1, 3)):
                raise ValueError(f"Conv: kernel_shape {ks} unsupported "
                                 "(UNet family is 3x3 / 1x1)")
            same = (pads is None and auto in (None, "", "NOTSET")) or \
                   (pads is not None and all(p == k // 2 for p in pads)) or \
                   (auto in ("SAME_UPPER", "SAME_LOWER") and k % 2 == 1)
            if not same:
                raise ValueError(
                    f"Conv: pads {pads} / auto_pad {auto!r} differ from the "
                    f"family's SAME padding for k={k}")
        elif n.op == "ConvTranspose":
            if ks and ks != [2, 2]:
                raise ValueError(f"ConvTranspose: kernel_shape {ks} != [2,2]")
            if strides and strides != [2, 2]:
                raise ValueError(f"ConvTranspose: strides {strides} != [2,2]")
            if pads and any(p != 0 for p in pads):
                raise ValueError(f"ConvTranspose: pads {pads} != 0")
        elif n.op == "MaxPool":
            if ks and ks != [2, 2]:
                raise ValueError(f"MaxPool: kernel_shape {ks} != [2,2]")
            if strides and strides != [2, 2]:
                raise ValueError(f"MaxPool: strides {strides} != [2,2]")
            if pads and any(p != 0 for p in pads):
                raise ValueError(f"MaxPool: pads {pads} != 0")

    encoder: List[dict] = []   # list of {"conv1","conv2"} (raw OIHW dicts)
    decoder: List[dict] = []
    pending: List[dict] = []   # conv pair accumulator for the current stage
    bottleneck = None
    head = None
    phase = "down"             # -> "up" at the first ConvTranspose

    def raw_conv(n: _Node) -> dict:
        w = _weight(n.inputs[1])
        b = (_weight(n.inputs[2]) if len(n.inputs) > 2
             else np.zeros(w.shape[0], np.float32))
        return fold_bn_chain(n, {"w": w, "b": b}, out_axis=0)  # OIHW

    for n in nodes:
        if n.op in ("Conv", "ConvTranspose", "MaxPool"):
            _check_attrs(n)
        if n.op == "Conv":
            pending.append(raw_conv(n))
        elif n.op == "MaxPool":
            if phase != "down" or len(pending) != 2:
                raise ValueError("unexpected MaxPool placement")
            encoder.append({"conv1": pending[0], "conv2": pending[1]})
            pending = []
        elif n.op == "ConvTranspose":
            if phase == "down":
                if len(pending) != 2:
                    raise ValueError("expected bottleneck conv pair before "
                                     "the first ConvTranspose")
                bottleneck = {"conv1": pending[0], "conv2": pending[1]}
                pending = []
                phase = "up"
            else:
                if len(pending) != 2:
                    raise ValueError("expected 2 convs per decoder stage")
                decoder.append({"up": decoder_up, "conv1": pending[0],
                                "conv2": pending[1]})
                pending = []
            w = _weight(n.inputs[1])
            b = (_weight(n.inputs[2]) if len(n.inputs) > 2
                 else np.zeros(w.shape[1], np.float32))
            decoder_up = fold_bn_chain(n, {"w": w, "b": b},
                                       out_axis=1)  # IOHW

    if phase != "up" or bottleneck is None:
        raise ValueError("no ConvTranspose found — not a UNet-family graph")
    if len(pending) != 3:      # last decoder pair + 1x1 head
        raise ValueError(
            f"expected decoder pair + head after the last ConvTranspose, "
            f"got {len(pending)} convs")
    decoder.append({"up": decoder_up, "conv1": pending[0],
                    "conv2": pending[1]})
    head = pending[2]

    depth = len(encoder)
    if len(decoder) != depth:
        raise ValueError(f"encoder depth {depth} != decoder depth "
                         f"{len(decoder)}")

    # Infer the config from weight shapes (OIHW).
    w0 = encoder[0]["conv1"]["w"]
    cfg = ModelConfig(
        depth=depth,
        base_channels=int(w0.shape[0]),
        in_channels=int(w0.shape[1]),
        num_classes=int(head["w"].shape[0]),
    )

    # Re-express as the canonical state_dict and reuse the torch converter
    # (OIHW->HWIO, ConvTranspose flip) — one layout-transposition codepath.
    sd: Dict[str, np.ndarray] = {}

    def put(prefix, conv):
        sd[prefix + ".weight"] = conv["w"]
        sd[prefix + ".bias"] = conv["b"]

    for i, st in enumerate(encoder):
        put(f"encoder.{i}.conv1", st["conv1"])
        put(f"encoder.{i}.conv2", st["conv2"])
    put("bottleneck.conv1", bottleneck["conv1"])
    put("bottleneck.conv2", bottleneck["conv2"])
    for i, st in enumerate(decoder):
        put(f"decoder.{i}.up", st["up"])
        put(f"decoder.{i}.conv1", st["conv1"])
        put(f"decoder.{i}.conv2", st["conv2"])
    put("head", head)

    return it.convert_state_dict(sd, cfg), cfg


# --------------------------------------------------------------------------
# Minimal writer (tests / tooling): emits exactly the subset we read.
# --------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _tensor_bytes(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr, np.float32)
    t = bytearray()
    for d in arr.shape:
        t += _varint(8) + _varint(d)          # dims (field 1, varint)
    t += _varint(16) + _varint(_FLOAT)        # data_type (field 2)
    t += _ld(8, name.encode())                # name
    t += _ld(9, arr.astype("<f4").tobytes())  # raw_data
    return bytes(t)


def write_onnx_initializers(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write a minimal ModelProto holding only graph initializers."""
    graph = bytearray()
    for name, arr in tensors.items():
        graph += _ld(5, _tensor_bytes(name, arr))
    with open(path, "wb") as f:
        f.write(_ld(7, bytes(graph)))             # ModelProto.graph


def write_onnx_graph(path: str, nodes, tensors: Dict[str, np.ndarray]) -> None:
    """Write a ModelProto with nodes AND initializers (tests / tooling).

    ``nodes`` is a sequence of ``(op_type, inputs, outputs, attrs)``; attr
    values may be int, float, str, or a list of ints — exactly the subset
    :func:`_parse_attribute` reads.  It writes graphs the torch exporter
    will not, such as one with a live BatchNormalization node (the exporter
    fuses Conv + BN first), and ``.onnx`` files on a machine without the
    ``onnx`` package."""
    graph = bytearray()
    for op, inputs, outputs, attrs in nodes:
        nb = bytearray()
        for i in inputs:
            nb += _ld(1, i.encode())
        for o in outputs:
            nb += _ld(2, o.encode())
        nb += _ld(4, op.encode())
        for aname, aval in (attrs or {}).items():
            ab = bytearray()
            ab += _ld(1, aname.encode())
            if isinstance(aval, float):
                ab += _varint((2 << 3) | 5) + struct.pack("<f", aval)
            elif isinstance(aval, bool) or isinstance(aval, int):
                ab += _varint((3 << 3) | 0) + _varint(int(aval))
            elif isinstance(aval, str):
                ab += _ld(4, aval.encode())
            elif isinstance(aval, (list, tuple)):
                for v in aval:
                    ab += _varint((8 << 3) | 0) + _varint(int(v))
            else:
                raise TypeError(f"unsupported attr type for {aname!r}")
            nb += _ld(5, bytes(ab))
        graph += _ld(1, bytes(nb))                # GraphProto.node
    for name, arr in tensors.items():
        graph += _ld(5, _tensor_bytes(name, arr))
    with open(path, "wb") as f:
        f.write(_ld(7, bytes(graph)))             # ModelProto.graph
