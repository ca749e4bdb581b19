"""Backbone dispatch. Port of real_time_video_deepfake_detection_tpu/
models/backbones.py: every consumer (the serving tick, the single-stream
classifier) builds its classifier through this module, by name:

    b0..b7            EfficientNet (models/efficientnet.py)
    vit_s16/b16/l16   Vision Transformer (models/vit.py)
    xception          Xception (models/xception.py)

Each module has the same interface: extract_features (B, H, W, 3) ->
(B, feature_dim) and apply_head -> (B, 1) logits.

Training (train/steps.py): forward_train runs the module with batch-
statistic batch norm and returns the new running statistics, which
update_bn_stats writes after the optimizer step; lr_group labels each
parameter by name with its optimizer group. partition_specs gives the
tensor-parallel spec table of a backbone that has one (the ViT)."""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
from torch import nn

from .efficientnet import BatchNorm, BNStats, EfficientNet, EfficientNetSpec
from .vit import ViT, ViTSpec, vit_partition_specs
from .xception import Xception, XceptionSpec

_EFF_NAMES = tuple(f"b{i}" for i in range(8))
_VIT_NAMES = ("vit_s16", "vit_b16", "vit_l16")


def backbone_names() -> List[str]:
    """The server's --backbone choices."""
    return list(_EFF_NAMES) + list(_VIT_NAMES) + ["xception"]


def make(name: str, image_size: int = 224):
    """Backbone name -> frozen spec (the ViTs at image_size)."""
    if name in _EFF_NAMES:
        return EfficientNetSpec.make(name)
    if name in _VIT_NAMES:
        return ViTSpec.make(name.split("_", 1)[1], image_size=image_size)
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


@contextlib.contextmanager
def collect_bn_stats(model: nn.Module, momentum: Optional[float] = None):
    """While active, every batch norm of `model` normalises with its batch
    statistics and appends its new running statistics to the yielded
    BNStats (momentum None keeps each site's own: 0.01 in the backbones,
    0.1 in EfficientNet's head)."""
    stats = BNStats(momentum)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.stats = stats
    try:
        yield stats
    finally:
        for m in bns:
            m.stats = None


def draw_masks(model: nn.Module, n: int, generator: torch.Generator, dropout: float):
    """The training dropout masks of a batch (EfficientNet's drop-connect
    and head dropouts); None for the ViT and Xception, which have none."""
    if isinstance(model, EfficientNet):
        return model.draw_masks(n, generator, dropout)
    return None


def forward_train(model: nn.Module, x: torch.Tensor, masks=None,
                  bn_momentum: Optional[float] = None, params=None):
    """Training forward: (logits, BNStats) — empty for the ViT, which has
    no batch norm. `masks` from draw_masks; `params`, when given, replace
    the module's parameters and buffers by name (torch.func.functional_call;
    the bf16 step passes bf16 copies)."""
    kwargs = {"masks": masks} if isinstance(model, EfficientNet) else {}
    with collect_bn_stats(model, bn_momentum) as stats:
        if params is None:
            logits = model(x, **kwargs)
        else:
            logits = torch.func.functional_call(model, params, (x,), kwargs)
    return logits, stats


@torch.no_grad()
def update_bn_stats(stats: BNStats) -> None:
    """Write forward_train's new running statistics into the buffers (cast
    to their dtype)."""
    for bn, mean, var in stats:
        bn.mean.copy_(mean)
        bn.var.copy_(var)


def n_blocks(spec) -> int:
    """Depth unit of the freeze fraction (reference train.py:863-876)."""
    if isinstance(spec, EfficientNetSpec):
        return len(spec.blocks)
    if isinstance(spec, ViTSpec):
        return spec.depth
    if isinstance(spec, XceptionSpec):
        return spec.middle_blocks
    raise TypeError(f"not a backbone spec: {type(spec)}")


# per backbone: (head names, frozen names, the block list frozen by index)
_GROUPS = ((EfficientNetSpec, ("fc",), ("stem",), "blocks"),
           (ViTSpec, ("head",), ("patch", "pos", "cls"), "blocks"),
           (XceptionSpec, ("head",), ("conv1", "conv2", "entry"), "middle"))


def lr_group(spec, name: str, n_frozen: int) -> str:
    """Optimizer group of the parameter `name` (a state-dict key): "head"
    (full LR), "frozen" (no updates: the stem analogue and the first
    n_frozen blocks) or "backbone" (backbone_lr_mult x LR). The JAX
    package labels tree paths the same way."""
    parts = name.split(".")
    for cls, head, frozen, blocks in _GROUPS:
        if isinstance(spec, cls):
            if parts[0] in head:
                return "head"
            if parts[0] in frozen:
                return "frozen"
            if parts[0] == blocks and int(parts[1]) < n_frozen:
                return "frozen"
            return "backbone"
    raise TypeError(f"not a backbone spec: {type(spec)}")


def partition_specs(model: nn.Module, spec):
    """The PartitionSpec table for a ("data", "model") mesh
    (models/vit.vit_partition_specs), or None when the backbone has no
    tensor-parallel sharding (its parameters then replicate), as JAX's
    partition_specs(params, spec)."""
    if isinstance(spec, ViTSpec):
        return vit_partition_specs(spec)
    return None
