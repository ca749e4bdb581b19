"""Caffe .caffemodel -> numpy weight extraction, without caffe/protobuf deps.

The port's copy of real_time_video_deepfake_detection_tpu/utils/
caffe_convert.py (load_caffemodel); the port keeps Caffe's OIHW layout.

The reference's primary face detector loads a Caffe binary protobuf
(face_detection.py:19-24: res10_300x300_ssd_iter_140000_fp16.caffemodel).
This module walks the protobuf wire format directly and extracts each
layer's learnable blobs by name — enough to convert any conv/BN/scale layer
net without a caffe.proto compile step.

Wire-format facts used (NetParameter message):
  field 1  (name)            : string
  field 100/23 (layer/layers): repeated LayerParameter
LayerParameter:
  field 1 (name): string, field 2 (type): string, field 7 (blobs): repeated
BlobProto:
  field 5 (data): repeated float (packed), field 7 (shape): BlobShape
  field 1-4 (num, channels, height, width): legacy dims
  field 8 (half-precision raw data in some exports): bytes
BlobShape: field 1 (dim): repeated int64 (packed)
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview):
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:       # varint
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 1:     # 64-bit
            yield field, wire, bytes(buf[pos:pos + 8])
            pos += 8
        elif wire == 2:     # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 5:     # 32-bit
            yield field, wire, bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _parse_blob(buf: memoryview) -> np.ndarray:
    data: List[float] = []
    raw_half = None
    shape: List[int] = []
    legacy = {}
    for field, wire, val in _iter_fields(buf):
        if field == 5:
            if wire == 2:   # packed floats
                data.extend(struct.unpack(f"<{len(val)//4}f", bytes(val)))
            elif wire == 5:
                data.append(struct.unpack("<f", val)[0])
        elif field == 7 and wire == 2:
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    if w2 == 2:  # packed int64
                        p = 0
                        while p < len(v2):
                            d, p = _read_varint(v2, p)
                            shape.append(d)
                    elif w2 == 0:
                        shape.append(v2)
        elif field in (1, 2, 3, 4) and wire == 0:
            legacy[field] = val
        elif field == 8 and wire == 2:
            raw_half = bytes(val)
        elif field == 9 and wire == 2:
            # double_data (rare)
            data.extend(struct.unpack(f"<{len(val)//8}d", bytes(val)))
    if raw_half is not None and not data:
        arr = np.frombuffer(raw_half, dtype=np.float16).astype(np.float32)
    else:
        arr = np.asarray(data, np.float32)
    if not shape and legacy:
        shape = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if shape and int(np.prod(shape)) == arr.size:
        arr = arr.reshape(shape)
    return arr


def load_caffemodel(path: str) -> Dict[str, List[np.ndarray]]:
    """Returns {layer_name: [blob0 (weights), blob1 (bias), ...]}."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    layers: Dict[str, List[np.ndarray]] = {}
    for field, wire, val in _iter_fields(buf):
        if field in (100, 23) and wire == 2:   # layer (new) / layers (legacy)
            name = ""
            blobs: List[np.ndarray] = []
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    name = bytes(v2).decode("utf-8", "replace")
                elif f2 == 7 and w2 == 2:
                    blobs.append(_parse_blob(v2))
                elif f2 == 6 and w2 == 2 and field == 23:
                    blobs.append(_parse_blob(v2))
            if name and blobs:
                layers[name] = blobs
    return layers

