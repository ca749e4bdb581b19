"""Backbone dispatch. Port of real_time_video_deepfake_detection_tpu/
models/backbones.py; this package serves the EfficientNet family (b0..b7).
ViT and Xception come with a later slice of the port."""

from __future__ import annotations

from typing import List, Optional

import torch

from .efficientnet import EfficientNet, EfficientNetSpec

_EFF_NAMES = tuple(f"b{i}" for i in range(8))


def backbone_names() -> List[str]:
    return list(_EFF_NAMES)


def make(name: str) -> EfficientNetSpec:
    """Backbone name -> frozen spec."""
    if name in _EFF_NAMES:
        return EfficientNetSpec.make(name)
    if name in ("vit_s16", "vit_b16", "vit_l16", "xception"):
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet (the ViT/Xception slice)")
    raise ValueError(f"unknown backbone {name!r} (choices: {backbone_names()})")


def build_model(spec, generator: Optional[torch.Generator] = None) -> EfficientNet:
    """Backbone module with parameters drawn from `generator`."""
    if isinstance(spec, EfficientNetSpec):
        return EfficientNet(spec, generator=generator)
    raise TypeError(f"not a backbone spec: {type(spec)}")
