"""Synthesize a res10-class SSD face detector (deploy.prototxt + caffemodel).

The port's copy of real_time_video_deepfake_detection_tpu/utils/ssd_synth.py:
the same seed writes the same files.

The reference's primary detector is `res10_300x300_ssd_iter_140000_fp16
.caffemodel` (face_detection.py:19-34), a ResNet-10 SSD — but neither the
caffemodel nor deploy.prototxt ships in the snapshot (weights are
user-supplied downloads there too). This module generates a detector of the
same FAMILY — ResNet-style 300x300 trunk with residual blocks and SSD heads
at three feature-map scales — with random weights, so that:

  * the batched in-tick detection path (serving/batcher.make_device_step_
    detect) can be BENCHED at representative FLOPs without shipping weights,
  * parity tests can drill the full device detect path against the
    per-frame SSDRes10.detect host path at real spatial scales.

Detections from random weights are meaningless (and usually empty — the
bench counts the compute, not the boxes); with a real caffemodel the same
code path loads it instead (utils/caffe_convert.py).

The caffemodel bytes are written with a minimal protobuf writer (the wire
format is length-delimited fields; NetParameter.layer = field 100,
LayerParameter.name = 1, .blobs = 7; BlobProto.shape = 7, .data = 5).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

# ------------------------- minimal protobuf writer --------------------------


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _blob(arr: np.ndarray) -> bytes:
    shape_payload = b"".join(_varint(int(d)) for d in arr.shape)
    shape_msg = _len_delim(1, shape_payload)  # packed dims
    data = struct.pack(f"<{arr.size}f", *arr.astype(np.float32).reshape(-1))
    return _len_delim(7, shape_msg) + _len_delim(5, data)


def _layer_weights(name: str, blobs: List[np.ndarray]) -> bytes:
    payload = _len_delim(1, name.encode())
    for b in blobs:
        payload += _len_delim(7, _blob(b))
    return _len_delim(100, payload)


# ------------------------------ architecture --------------------------------


def _conv_txt(name, bottom, top, cout, k, s=1, pad=None):
    pad = (k // 2) if pad is None else pad
    return (f'layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}" '
            f'top: "{top}" convolution_param {{ num_output: {cout} '
            f'kernel_size: {k} pad: {pad} stride: {s} }} }}\n')


def _relu_txt(name, blob):
    return (f'layer {{ name: "{name}" type: "ReLU" bottom: "{blob}" '
            f'top: "{blob}" }}\n')


def _head_txt(src, idx, n_priors, min_size, max_size, ars):
    ar = "".join(f" aspect_ratio: {a}" for a in ars)
    loc, conf = f"loc{idx}", f"conf{idx}"
    t = _conv_txt(loc, src, loc, n_priors * 4, 3)
    t += _conv_txt(conf, src, conf, n_priors * 2, 3)
    for b in (loc, conf):
        t += (f'layer {{ name: "{b}_perm" type: "Permute" bottom: "{b}" '
              f'top: "{b}_perm" permute_param {{ order: 0 order: 2 order: 3 '
              f'order: 1 }} }}\n'
              f'layer {{ name: "{b}_flat" type: "Flatten" '
              f'bottom: "{b}_perm" top: "{b}_flat" }}\n')
    t += (f'layer {{ name: "prior{idx}" type: "PriorBox" bottom: "{src}" '
          f'bottom: "data" top: "prior{idx}" prior_box_param {{ '
          f'min_size: {min_size} max_size: {max_size}{ar} flip: true '
          f'clip: false variance: 0.1 variance: 0.1 variance: 0.2 '
          f'variance: 0.2 offset: 0.5 }} }}\n')
    return t


def res10_class_ssd(out_dir: str, seed: int = 0,
                    channels: Tuple[int, ...] = (32, 64, 128, 256),
                    decisive: bool = False) -> Tuple[str, str]:
    """Write deploy.prototxt + model.caffemodel into out_dir; returns their
    paths. Trunk: 7x7/2 stem + maxpool + 4 residual basic blocks (strides
    1,2,2,2 -> 75/38/19/10 px maps) + one extra 3x3/2 SSD layer (5 px); SSD
    heads on the 19/10/5 maps.

    decisive=False (default) keeps conf logits near the softmax tie so
    parity drills stress threshold/tie handling — the hardest case.
    decisive=True scales the conf head so softmax saturates (confidences
    near 0 or 1, like a trained detector's): used by the bench, where
    near-tie confs would make bf16-vs-f32 box equality a coin flip that no
    real checkpoint exhibits."""
    rng = np.random.default_rng(seed)
    c1, c2, c3, c4 = channels

    txt = ['name: "res10_class_ssd"\ninput: "data"\n'
           "input_dim: 1\ninput_dim: 3\ninput_dim: 300\ninput_dim: 300\n"]
    weights: List[Tuple[str, List[np.ndarray]]] = []

    def conv(name, bottom, top, cin, cout, k, s=1, pad=None):
        txt.append(_conv_txt(name, bottom, top, cout, k, s, pad))
        w = (rng.standard_normal((cout, cin, k, k)).astype(np.float32)
             * np.sqrt(2.0 / (cin * k * k)))
        b = np.zeros((cout,), np.float32)
        weights.append((name, [w, b]))

    def relu(blob):
        txt.append(_relu_txt(f"{blob}_relu", blob))

    # stem
    conv("conv1", "data", "conv1", 3, c1, 7, 2)
    relu("conv1")
    txt.append('layer { name: "pool1" type: "Pooling" bottom: "conv1" '
               'top: "pool1" pooling_param { pool: MAX kernel_size: 3 '
               'stride: 2 } }\n')

    def basic_block(idx, bottom, cin, cout, stride):
        a, b_, out = f"res{idx}a", f"res{idx}b", f"res{idx}"
        conv(a, bottom, a, cin, cout, 3, stride)
        relu(a)
        conv(b_, a, b_, cout, cout, 3, 1)
        if stride != 1 or cin != cout:
            sc = f"res{idx}sc"
            conv(sc, bottom, sc, cin, cout, 1, stride, pad=0)
            skip = sc
        else:
            skip = bottom
        txt.append(f'layer {{ name: "{out}" type: "Eltwise" '
                   f'bottom: "{b_}" bottom: "{skip}" top: "{out}" '
                   'eltwise_param { operation: SUM } }\n')
        relu(out)
        return out

    b1 = basic_block(1, "pool1", c1, c1, 1)   # 75
    b2 = basic_block(2, b1, c1, c2, 2)        # 38
    b3 = basic_block(3, b2, c2, c3, 2)        # 19
    b4 = basic_block(4, b3, c3, c4, 2)        # 10
    conv("extra1", b4, "extra1", c4, c3, 3, 2)  # 5
    relu("extra1")

    # SSD heads: 19 px (4 priors), 10 px (6), 5 px (6)
    head_srcs = [(b3, 1, 4, 30.0, 60.0, (2.0,)),
                 (b4, 2, 6, 60.0, 111.0, (2.0, 3.0)),
                 ("extra1", 3, 6, 111.0, 162.0, (2.0, 3.0))]
    for src, idx, np_, mn, mx, ars in head_srcs:
        txt.append(_head_txt(src, idx, np_, mn, mx, ars))
        cin = {1: c3, 2: c4, 3: c3}[idx]
        for nm, cout in ((f"loc{idx}", np_ * 4), (f"conf{idx}", np_ * 2)):
            # small head scales keep decoded boxes near their priors and
            # (non-decisive) conf logits near 0.5 — so synthetic detections
            # stay finite and occasionally valid (useful for parity drills)
            if nm.startswith("loc"):
                scale = 0.02
            else:
                scale = 4.0 if decisive else 0.3
            w = (rng.standard_normal((cout, cin, 3, 3)).astype(np.float32)
                 * np.sqrt(2.0 / (cin * 9)) * scale)
            b = rng.standard_normal((cout,)).astype(np.float32) * 0.1
            weights.append((nm, [w, b]))

    txt.append('layer { name: "loc_cat" type: "Concat" '
               + "".join(f'bottom: "loc{i}_flat" ' for i in (1, 2, 3))
               + 'top: "loc_cat" concat_param { axis: 1 } }\n')
    txt.append('layer { name: "conf_cat" type: "Concat" '
               + "".join(f'bottom: "conf{i}_flat" ' for i in (1, 2, 3))
               + 'top: "conf_cat" concat_param { axis: 1 } }\n')
    txt.append('layer { name: "prior_cat" type: "Concat" '
               + "".join(f'bottom: "prior{i}" ' for i in (1, 2, 3))
               + 'top: "prior_cat" concat_param { axis: 2 } }\n')
    txt.append('layer { name: "conf_resh" type: "Reshape" '
               'bottom: "conf_cat" top: "conf_resh" reshape_param { shape { '
               'dim: 0 dim: -1 dim: 2 } } }\n')
    txt.append('layer { name: "conf_soft" type: "Softmax" '
               'bottom: "conf_resh" top: "conf_soft" '
               'softmax_param { axis: 2 } }\n')
    txt.append('layer { name: "conf_out" type: "Flatten" '
               'bottom: "conf_soft" top: "conf_out" }\n')
    txt.append('layer { name: "detection_out" type: "DetectionOutput" '
               'bottom: "loc_cat" bottom: "conf_out" bottom: "prior_cat" '
               'top: "detection_out" detection_output_param { '
               'num_classes: 2 share_location: true background_label_id: 0 '
               'keep_top_k: 200 confidence_threshold: 0.01 '
               'code_type: CENTER_SIZE nms_param { nms_threshold: 0.3 '
               'top_k: 400 } } }\n')

    os.makedirs(out_dir, exist_ok=True)
    proto = os.path.join(out_dir, "deploy.prototxt")
    with open(proto, "w") as f:
        f.write("".join(txt))
    cm = os.path.join(out_dir, "res10_class.caffemodel")
    with open(cm, "wb") as f:
        for name, blobs in weights:
            f.write(_layer_weights(name, blobs))
    return proto, cm
