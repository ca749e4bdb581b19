"""Face classification: preprocessing + backbone + sigmoid.

Port of real_time_video_deepfake_detection_tpu/pipeline/classify.py: the
reference's `_single_prediction` tensor chain (deepfake_detection.py:
372-398), aligned 160x160 RGB (raw 0-255) -> bilinear resize 224
(half-pixel, as F.interpolate) -> /255 -> ImageNet normalize -> model ->
sigmoid, batched over faces."""

from __future__ import annotations

import copy
import weakref

import torch

from ..ops.resize import resize_bilinear_f32

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess_aligned(faces_rgb_raw: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) float or uint8 RGB with raw 0-255 values -> (B, size,
    size, 3) normalized f32. uint8 input takes the same float path (the
    JAX u8 fast path is bit-identical to it)."""
    x = resize_bilinear_f32(faces_rgb_raw, size, size, axes=(1, 2))
    x = x / 255.0
    mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(_IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


_bf16_models: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _bf16_model(model):
    """A bfloat16 copy of `model` (every float parameter and statistic cast,
    as the JAX package casts the parameter tree), made once per model."""
    m = _bf16_models.get(model)
    if m is None:
        m = copy.deepcopy(model).to(torch.bfloat16)
        _bf16_models[model] = m
    return m


@torch.no_grad()
def classify_features(model, faces_rgb_raw: torch.Tensor, size: int = 224,
                      bf16: bool = False, pallas_preproc: bool = False):
    """(B, H, W, 3) raw-RGB aligned faces -> ((B,) fake probabilities,
    (B, feature_dim) float32 pooled features). `model` is the backbone
    module (models/backbones.build_model: EfficientNet, ViT or Xception).
    bf16=True runs the backbone in bfloat16; the sigmoid and the features
    handed back are float32. pallas_preproc=True takes the resize +
    normalize from the preprocess kernel (kernels/preproc.py,
    csrc/preproc.cu on a CUDA tensor)."""
    if pallas_preproc:
        from ..kernels.preproc import preprocess_faces
        x = preprocess_faces(faces_rgb_raw, size)
    else:
        x = preprocess_aligned(faces_rgb_raw, size)
    if bf16:
        model = _bf16_model(model)
        x = x.to(torch.bfloat16)
    feats = model.extract_features(x)
    logits = model.apply_head(feats)
    return (torch.sigmoid(logits[:, 0].to(torch.float32)), feats.to(torch.float32))


def classify_batch(model, faces_rgb_raw: torch.Tensor, size: int = 224,
                   bf16: bool = False, pallas_preproc: bool = False) -> torch.Tensor:
    """(B, H, W, 3) raw-RGB aligned faces -> (B,) fake probabilities
    (classify_features without the features)."""
    return classify_features(model, faces_rgb_raw, size, bf16, pallas_preproc)[0]


def apply_small_face_heuristic(prob, face_h: int, face_w: int,
                               small_px: int = 80, boost: float = 0.10) -> float:
    """+0.10 when the detected crop is small, clipped to [0, 1]
    (deepfake_detection.py:489-502); host scalar math on the host-known box."""
    if face_h < small_px or face_w < small_px:
        prob = prob + boost
    return float(min(max(prob, 0.0), 1.0))
