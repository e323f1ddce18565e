"""Minimal ONNX weight extraction, with no onnx/onnxruntime dependency.

Copy of ``whisper_timestamped_tpu/models/onnx_weights.py``. An ``.onnx``
file is a protobuf: the weights (graph *initializers*) are lifted straight
out of the wire format and fed to the port's silero module
(``silero.py``). Only the handful of proto fields needed for ``TensorProto``
floats are decoded; everything else is skipped by wire type.

Relevant schema subset (onnx.proto):

  ModelProto:  graph = 7
  GraphProto:  node = 1, initializer = 5
  NodeProto:   attribute = 5
  AttributeProto: t = 5 (tensor), g = 6 (graph), tensors = 10, graphs = 11
  TensorProto: dims = 1, data_type = 2, float_data = 4, name = 8, raw_data = 9

Initializers inside ``If``-branch subgraphs (silero wraps its 8 kHz/16 kHz
paths in ``If`` nodes) are collected by recursing through node attributes.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np

_ONNX_FLOAT = 1  # TensorProto.DataType.FLOAT


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    val = shift = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf: bytes, i: int, end: int) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, payload) for one message region.

    Payload is the int value for varints, or a (start, end) byte span for
    length-delimited / fixed-width fields."""
    while i < end:
        tag, i = _varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v, i = _varint(buf, i)
        elif wt == 2:  # length-delimited
            ln, i = _varint(buf, i)
            v = (i, i + ln)
            i += ln
        elif wt == 5:  # fixed32
            v = (i, i + 4)
            i += 4
        elif wt == 1:  # fixed64
            v = (i, i + 8)
            i += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, v


def _parse_tensor(buf: bytes, s: int, e: int):
    """TensorProto region -> (name, float32 ndarray) or (name, None)."""
    dims, dtype, name, raw = [], None, None, None
    floats: list = []
    for field, wt, v in _fields(buf, s, e):
        if field == 1:  # dims: packed or unpacked varints
            if wt == 0:
                dims.append(v)
            else:
                j, jend = v
                while j < jend:
                    d, j = _varint(buf, j)
                    dims.append(d)
        elif field == 2 and wt == 0:
            dtype = v
        elif field == 4:  # float_data
            if wt == 5:
                floats.append(struct.unpack("<f", buf[v[0] : v[1]])[0])
            else:
                floats.extend(np.frombuffer(buf[v[0] : v[1]], "<f4").tolist())
        elif field == 8 and wt == 2:
            name = buf[v[0] : v[1]].decode("utf-8", "replace")
        elif field == 9 and wt == 2:
            raw = buf[v[0] : v[1]]
    if dtype != _ONNX_FLOAT:
        return name, None  # int64 shape constants etc. — not weights
    if raw is not None:
        arr = np.frombuffer(raw, "<f4")
    else:
        arr = np.asarray(floats, np.float32)
    return name, arr.reshape(dims) if dims else arr


def _collect_graph(buf: bytes, s: int, e: int, out: Dict[str, np.ndarray]) -> None:
    for field, wt, v in _fields(buf, s, e):
        if wt != 2:
            continue
        if field == 5:  # initializer
            name, arr = _parse_tensor(buf, *v)
            if name and arr is not None:
                out.setdefault(name, arr)
        elif field == 1:  # node -> recurse into attribute subgraphs/tensors
            _collect_node(buf, *v, out)


def _collect_node(buf: bytes, s: int, e: int, out: Dict[str, np.ndarray]) -> None:
    for field, wt, v in _fields(buf, s, e):
        if field == 5 and wt == 2:  # attribute
            for afield, awt, av in _fields(buf, *v):
                if awt != 2:
                    continue
                if afield in (5, 10):  # t / tensors
                    name, arr = _parse_tensor(buf, *av)
                    if name and arr is not None:
                        out.setdefault(name, arr)
                elif afield in (6, 11):  # g / graphs
                    _collect_graph(buf, *av, out)


def parse_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """All named float32 initializers in an .onnx file (incl. subgraphs)."""
    with open(path, "rb") as f:
        buf = f.read()
    out: Dict[str, np.ndarray] = {}
    for field, wt, v in _fields(buf, 0, len(buf)):
        if field == 7 and wt == 2:  # ModelProto.graph
            _collect_graph(buf, *v, out)
    return out
