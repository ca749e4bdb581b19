"""Backbone dispatch. Port of real_time_video_deepfake_detection_tpu/
models/backbones.py: every consumer (the serving tick, the single-stream
classifier) builds its classifier through this module, by name:

    b0..b7            EfficientNet (models/efficientnet.py)
    vit_s16/b16/l16   Vision Transformer (models/vit.py)
    xception          Xception (models/xception.py)

Each module has the same interface: extract_features (B, H, W, 3) ->
(B, feature_dim) and apply_head -> (B, 1) logits."""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from .efficientnet import EfficientNet, EfficientNetSpec
from .vit import ViT, ViTSpec
from .xception import Xception, XceptionSpec

_EFF_NAMES = tuple(f"b{i}" for i in range(8))
_VIT_NAMES = ("vit_s16", "vit_b16", "vit_l16")


def backbone_names() -> List[str]:
    """The server's --backbone choices."""
    return list(_EFF_NAMES) + list(_VIT_NAMES) + ["xception"]


def make(name: str):
    """Backbone name -> frozen spec (the ViTs at 224x224)."""
    if name in _EFF_NAMES:
        return EfficientNetSpec.make(name)
    if name in _VIT_NAMES:
        return ViTSpec.make(name.split("_", 1)[1])
    if name == "xception":
        return XceptionSpec()
    raise ValueError(f"unknown backbone {name!r} (choices: {backbone_names()})")


def feature_dim(spec) -> int:
    """Pooled-feature width, what the clip-attention head consumes
    (DetectorConfig.clip_feature_dim follows it)."""
    if isinstance(spec, EfficientNetSpec):
        return spec.head_filters
    if isinstance(spec, ViTSpec):
        return spec.dim
    if isinstance(spec, XceptionSpec):
        return spec.feature_dim
    raise TypeError(f"not a backbone spec: {type(spec)}")


def build_model(spec, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Backbone module with parameters drawn from `generator`."""
    if isinstance(spec, EfficientNetSpec):
        return EfficientNet(spec, generator=generator)
    if isinstance(spec, ViTSpec):
        return ViT(spec, generator=generator)
    if isinstance(spec, XceptionSpec):
        return Xception(spec, generator=generator)
    raise TypeError(f"not a backbone spec: {type(spec)}")
