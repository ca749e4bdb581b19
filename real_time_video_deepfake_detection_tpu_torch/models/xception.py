"""Xception backbone (BASELINE config 5), as an nn.Module.

Port of real_time_video_deepfake_detection_tpu/models/xception.py (Chollet
2017, keras layer layout; the FaceForensics++ deepfake baseline):

  entry : conv 32 s2 VALID -> conv 64 VALID -> blocks (128, 256, 728) each
          [relu?] sep -> bn -> relu -> sep -> bn -> maxpool 3x3 s2, with a
          1x1 s2 conv + bn residual (the first block has no leading relu)
  middle: 8 x identity-residual [relu sep728 bn] x 3
  exit  : block (728 -> 1024, maxpool, conv residual) -> sep1536 bn relu
          -> sep2048 bn relu -> global mean -> (2048,) features
  head  : Linear(2048 -> 1) fake logit

A separable conv is a depthwise 3x3 (groups = cin, SAME) then a pointwise
1x1, both without bias, then batch norm (inference, eps 1e-3). The max
pools are "SAME" with -inf padding as XLA pads it: on an even input 0
before and 1 after, so nn.MaxPool2d(3, 2, padding=1) would shift every
window by one pixel. The public boundary is NHWC; inside, NCHW.

Parameter names follow the JAX parameter tree (conv1.w, entry.0.sep1.dw,
middle.7.sep3.bn.var, exit.res.w, head.w, ...): utils/convert.
params_from_jax maps HWIO kernels to (out, in, kh, kw) and the depthwise
(3, 3, 1, C) to (C, 1, 3, 3). Trainable parameters: 20,806,952 (keras
Xception include_top=False) plus the head's 2,049.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .efficientnet import BatchNorm
from .layers import Linear

_BN_EPS = 1e-3   # keras BatchNormalization default epsilon


@dataclasses.dataclass(frozen=True)
class XceptionSpec:
    middle_blocks: int = 8
    feature_dim: int = 2048


def _he(shape, fan_in: int, generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in))


class _ConvBN(nn.Module):
    """A convolution weight (out, in, k, k) and its batch norm."""

    def __init__(self, k: int, cin: int, cout: int, generator):
        super().__init__()
        self.w = _he((cout, cin, k, k), k * k * cin, generator)
        self.bn = BatchNorm(cout, _BN_EPS)


class _Sep(nn.Module):
    def __init__(self, cin: int, cout: int, generator):
        super().__init__()
        self.dw = _he((cin, 1, 3, 3), 9, generator)
        self.pw = _he((cout, cin, 1, 1), cin, generator)
        self.bn = BatchNorm(cout, _BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x, self.dw, padding=1, groups=x.shape[1])
        return self.bn(F.conv2d(x, self.pw))


class _Entry(nn.Module):
    def __init__(self, cin: int, cout: int, generator):
        super().__init__()
        self.sep1 = _Sep(cin, cout, generator)
        self.sep2 = _Sep(cout, cout, generator)
        self.res = _ConvBN(1, cin, cout, generator)


class _Middle(nn.Module):
    def __init__(self, generator):
        super().__init__()
        self.sep1 = _Sep(728, 728, generator)
        self.sep2 = _Sep(728, 728, generator)
        self.sep3 = _Sep(728, 728, generator)


class _Exit(nn.Module):
    def __init__(self, feature_dim: int, generator):
        super().__init__()
        self.sep1 = _Sep(728, 728, generator)
        self.sep2 = _Sep(728, 1024, generator)
        self.res = _ConvBN(1, 728, 1024, generator)
        self.sep3 = _Sep(1024, 1536, generator)
        self.sep4 = _Sep(1536, feature_dim, generator)


def maxpool3s2_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool with XLA's "SAME" padding (-inf; the odd pixel
    of padding goes after) on NCHW."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, 2)


class Xception(nn.Module):
    """Xception backbone + linear head, inference. Parameters are drawn
    from `generator` with the JAX init laws (He-normal over fan_in, the
    depthwise kernels over 9, unit BN); they are not JAX's numbers."""

    def __init__(self, spec: XceptionSpec = XceptionSpec(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        self.conv1 = _ConvBN(3, 3, 32, generator)
        self.conv2 = _ConvBN(3, 32, 64, generator)
        self.entry = nn.ModuleList(_Entry(cin, cout, generator) for cin, cout in
                                   ((64, 128), (128, 256), (256, 728)))
        self.middle = nn.ModuleList(_Middle(generator) for _ in range(spec.middle_blocks))
        self.exit = _Exit(spec.feature_dim, generator)
        self.head = Linear(spec.feature_dim, 1, generator)

    def extract_features(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized RGB -> (B, feature_dim) pooled features."""
        h = x_nhwc.permute(0, 3, 1, 2)
        h = torch.relu(self.conv1.bn(F.conv2d(h, self.conv1.w, stride=2)))
        h = torch.relu(self.conv2.bn(F.conv2d(h, self.conv2.w)))
        for i, blk in enumerate(self.entry):
            # a 1x1 stride-2 "SAME" conv needs no padding
            res = blk.res.bn(F.conv2d(h, blk.res.w, stride=2))
            if i > 0:
                h = torch.relu(h)
            h = blk.sep2(torch.relu(blk.sep1(h)))
            h = maxpool3s2_same(h) + res
        for blk in self.middle:
            res = h
            for sep in (blk.sep1, blk.sep2, blk.sep3):
                h = sep(torch.relu(h))
            h = h + res
        ex = self.exit
        res = ex.res.bn(F.conv2d(h, ex.res.w, stride=2))
        h = ex.sep2(torch.relu(ex.sep1(torch.relu(h))))
        h = maxpool3s2_same(h) + res
        h = torch.relu(ex.sep3(h))
        h = torch.relu(ex.sep4(h))
        return h.mean(dim=(2, 3))

    def apply_head(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, feature_dim) -> (B, 1) logits."""
        return self.head(feats)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        return self.apply_head(self.extract_features(x_nhwc))


def n_trainable_params(model: nn.Module) -> int:
    """Trainable values: every parameter, the BN running statistics (buffers)
    excluded; 20,806,952 + 2,049 for the full spec."""
    return sum(p.numel() for p in model.parameters())
