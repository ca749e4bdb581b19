"""EfficientNet (B0..B7) with the reference's custom head, as an nn.Module.

Port of real_time_video_deepfake_detection_tpu/models/efficientnet.py
(reference model.py:21-102: EfficientNet-B0 + 1280->512->256->1 head):

  stem conv3x3 s2 -> 16 MBConv blocks in 7 stages (expand 1/6, k3/k5,
  SE ratio 0.25, swish, BN eps 1e-3) -> head conv1x1 -> 1280 -> global avg
  pool -> head: Linear(1280,512) BN1d(eps 1e-5) ReLU Linear(512,256) BN1d
  ReLU Linear(256,1)

Inference by default. Training (models/backbones.forward_train): batch
norms normalise with the batch statistics while `collect_bn_stats` is
active and hand back their new running statistics, which
backbones.update_bn_stats writes into the buffers after the optimizer
step (the JAX package's order); drop-connect in the skip blocks and the
head's three dropouts apply masks drawn by `draw_masks` from an explicit
generator. Inside a torch.distributed group of more than one rank (data-
parallel training, train/steps.make_sharded_train_step) the batch
statistics are those of the global batch, as under JAX's sharded jit. The
public boundary is NHWC, as in the JAX package: `extract_features` takes
(B, H, W, 3) normalized RGB. Inside, convolutions run NCHW through
F.conv2d with TF-style SAME padding applied explicitly (asymmetric on
stride-2 convs: the extra row/column goes after, as XLA's "SAME" does).
Parameter names follow the JAX parameter tree (stem.conv, blocks.3.bn1.var,
fc.fc1.w, ...) so utils/convert.params_from_jax maps leaf to leaf; linear
weights keep the JAX (in, out) layout and are applied as x @ w + b.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import world_size

# (num_repeat, kernel, stride, expand_ratio, in_filters, out_filters)
_B0_BLOCKS = [
    (1, 3, 1, 1, 32, 16),
    (2, 3, 2, 6, 16, 24),
    (2, 5, 2, 6, 24, 40),
    (3, 3, 2, 6, 40, 80),
    (3, 5, 1, 6, 80, 112),
    (4, 5, 2, 6, 112, 192),
    (1, 3, 1, 6, 192, 320),
]

# (width_coefficient, depth_coefficient, resolution, dropout_rate)
_SCALING = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
}

_BN_EPS = 1e-3          # backbone BN (efficientnet convention)
_HEAD_BN_EPS = 1e-5     # torch BatchNorm1d default (reference head)
_BN_MOMENTUM = 0.01     # efficientnet_pytorch's batch_norm_momentum=0.99
_HEAD_BN_MOMENTUM = 0.1  # torch BatchNorm1d default (reference head)
_SE_RATIO = 0.25
_DROP_CONNECT = 0.2


def round_filters(filters: int, width: float) -> int:
    filters *= width
    divisor = 8
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kernel: int
    stride: int
    expand: int
    cin: int
    cout: int


@dataclasses.dataclass(frozen=True)
class EfficientNetSpec:
    variant: str
    stem_filters: int
    head_filters: int
    blocks: Tuple[BlockSpec, ...]
    resolution: int
    dropout: float

    @staticmethod
    def make(variant: str = "b0") -> "EfficientNetSpec":
        width, depth, res, drop = _SCALING[variant]
        blocks: List[BlockSpec] = []
        for (r, k, s, e, ci, co) in _B0_BLOCKS:
            ci, co = round_filters(ci, width), round_filters(co, width)
            for j in range(round_repeats(r, depth)):
                blocks.append(BlockSpec(
                    kernel=k, stride=s if j == 0 else 1, expand=e,
                    cin=ci if j == 0 else co, cout=co))
        return EfficientNetSpec(
            variant=variant, stem_filters=round_filters(32, width),
            head_filters=round_filters(1280, width), blocks=tuple(blocks),
            resolution=res, dropout=drop)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                groups: int = 1) -> torch.Tensor:
    """NCHW conv with TF-style SAME padding: out = ceil(in / stride), the
    total padding split with the smaller half before."""
    k_h, k_w = w.shape[-2], w.shape[-1]
    pads = []
    for n, k in ((x.shape[-1], k_w), (x.shape[-2], k_h)):
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    if any(pads):
        x = F.pad(x, pads)
    return F.conv2d(x, w, stride=stride, groups=groups)


class BNStats(list):
    """The new running statistics a training forward collects, in forward
    order: (batch norm module, mean, var), detached. `momentum` overrides
    every site's own (TrainConfig.bn_momentum)."""

    def __init__(self, momentum: Optional[float] = None):
        super().__init__()
        self.momentum = momentum


def _global_moments(x: torch.Tensor, dims, shape, n: int):
    """(mean, biased variance, count) over every rank's x, each rank holding
    n values per channel: two all-reduces that carry gradients (their
    backward sums the ranks' gradients), the sum, then the sum of squared
    deviations from the global mean."""
    from torch.distributed.nn.functional import all_reduce
    n = n * world_size()
    mean = all_reduce(x.sum(dims)) / n
    d = x - mean.view(shape)
    return mean, all_reduce((d * d).sum(dims)) / n, n


class BatchNorm(nn.Module):
    """Batch norm with the JAX package's formula and leaf names:
    (x - mean) * rsqrt(var + eps) * scale + bias over `channel_dim`. While
    `stats` holds a BNStats (models/backbones.collect_bn_stats) it
    normalises with the batch statistics (the biased variance) and appends
    the new running statistics, (1 - m) * old + m * batch with the unbiased
    variance, as torch's BatchNorm does. In a process group of more than
    one rank, the batch is the global one: the ranks' equal shards."""

    def __init__(self, c: int, eps: float, momentum: float = _BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.stats: Optional[BNStats] = None
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, channel_dim: int = 1) -> torch.Tensor:
        shape = [1] * x.ndim
        shape[channel_dim] = -1
        if self.stats is None:
            mean, var = self.mean, self.var
        else:
            dims = [d for d in range(x.ndim) if d != channel_dim % x.ndim]
            n = x.numel() // x.shape[channel_dim]
            if world_size() > 1:
                mean, var, n = _global_moments(x, dims, shape, n)
            else:
                mean, var = x.mean(dims), x.var(dims, correction=0)
            m = self.momentum if self.stats.momentum is None else self.stats.momentum
            self.stats.append((self, ((1 - m) * self.mean + m * mean).detach(),
                               ((1 - m) * self.var + m * (var * n / max(n - 1, 1))).detach()))
        inv = torch.rsqrt(var + self.eps)
        return ((x - mean.view(shape)) * inv.view(shape)
                * self.scale.view(shape) + self.bias.view(shape))


class Dense(nn.Module):
    """x @ w + b with w in the JAX (in, out) layout."""

    def __init__(self, cin: int, cout: int, generator: Optional[torch.Generator]):
        super().__init__()
        bound = 1.0 / math.sqrt(cin)
        self.w = nn.Parameter(_uniform((cin, cout), bound, generator))
        self.b = nn.Parameter(_uniform((cout,), bound, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class ConvBias(nn.Module):
    """1x1 conv weight + bias (the squeeze-excite convs)."""

    def __init__(self, cin: int, cout: int, generator: Optional[torch.Generator]):
        super().__init__()
        self.w = nn.Parameter(_conv_init(1, 1, cin, cout, 1, generator))
        self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.w, self.b)


def _conv_init(kh, kw, cin, cout, groups, generator) -> torch.Tensor:
    """He-normal over fan_out, the JAX package's init law, in (O, I, kh, kw)."""
    std = math.sqrt(2.0 / (kh * kw * cout))
    return torch.randn((cout, cin // groups, kh, kw), generator=generator) * std


def _uniform(shape, bound, generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class MBConv(nn.Module):
    def __init__(self, b: BlockSpec, generator: Optional[torch.Generator]):
        super().__init__()
        self.spec = b
        cexp = b.cin * b.expand
        nsq = max(1, int(b.cin * _SE_RATIO))
        if b.expand != 1:
            self.expand_conv = nn.Parameter(_conv_init(1, 1, b.cin, cexp, 1, generator))
            self.bn0 = BatchNorm(cexp, _BN_EPS)
        self.depthwise = nn.Parameter(
            _conv_init(b.kernel, b.kernel, cexp, cexp, cexp, generator))
        self.bn1 = BatchNorm(cexp, _BN_EPS)
        self.se_reduce = ConvBias(cexp, nsq, generator)
        self.se_expand = ConvBias(nsq, cexp, generator)
        self.project = nn.Parameter(_conv_init(1, 1, cexp, b.cout, 1, generator))
        self.bn2 = BatchNorm(b.cout, _BN_EPS)

    def forward(self, x: torch.Tensor, drop=None) -> torch.Tensor:
        """`drop`: (keep mask (B,), rate) of drop-connect, or None."""
        inp = x
        if self.spec.expand != 1:
            x = swish(self.bn0(F.conv2d(x, self.expand_conv)))
        x = conv2d_same(x, self.depthwise, self.spec.stride, groups=x.shape[1])
        x = swish(self.bn1(x))
        se = x.mean(dim=(2, 3), keepdim=True)
        se = self.se_expand(swish(self.se_reduce(se)))
        x = torch.sigmoid(se) * x
        x = self.bn2(F.conv2d(x, self.project))
        if self.has_skip:
            if drop is not None:
                mask, rate = drop
                x = x * mask.to(x.dtype).view(-1, 1, 1, 1) / (1.0 - rate)
            x = x + inp
        return x

    @property
    def has_skip(self) -> bool:
        return self.spec.stride == 1 and self.spec.cin == self.spec.cout


class _Stem(nn.Module):
    def __init__(self, c: int, generator):
        super().__init__()
        self.conv = nn.Parameter(_conv_init(3, 3, 3, c, 1, generator))
        self.bn = BatchNorm(c, _BN_EPS)


class _Head(nn.Module):
    def __init__(self, cin: int, c: int, generator):
        super().__init__()
        self.conv = nn.Parameter(_conv_init(1, 1, cin, c, 1, generator))
        self.bn = BatchNorm(c, _BN_EPS)


class _FC(nn.Module):
    def __init__(self, cin: int, dims, generator):
        super().__init__()
        d0, d1, d2 = dims
        self.fc1 = Dense(cin, d0, generator)
        self.bn1 = BatchNorm(d0, _HEAD_BN_EPS, _HEAD_BN_MOMENTUM)
        self.fc2 = Dense(d0, d1, generator)
        self.bn2 = BatchNorm(d1, _HEAD_BN_EPS, _HEAD_BN_MOMENTUM)
        self.fc3 = Dense(d1, d2, generator)


def _drop(x: torch.Tensor, drop) -> torch.Tensor:
    if drop is None:
        return x
    mask, rate = drop
    return x * mask.to(x.dtype) / (1.0 - rate)


class EfficientNet(nn.Module):
    """Backbone + the reference's custom head. Parameters
    are drawn from `generator` with the JAX package's init laws (He-normal
    convs over fan_out, uniform(+-1/sqrt(fan_in)) linears, unit BN); they
    are not JAX's numbers — load converted parameters to match a JAX
    model."""

    def __init__(self, spec: EfficientNetSpec, head_dims=(512, 256, 1),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        self.stem = _Stem(spec.stem_filters, generator)
        self.head = _Head(spec.blocks[-1].cout, spec.head_filters, generator)
        self.blocks = nn.ModuleList(MBConv(b, generator) for b in spec.blocks)
        self.fc = _FC(spec.head_filters, head_dims, generator)

    def feature_map(self, x_nhwc: torch.Tensor, drop_connect=None) -> torch.Tensor:
        """(B, H, W, 3) normalized RGB -> (B, head_filters, H', W'), the map
        after the head conv, batch norm and swish (GradCAM's target layer).
        `drop_connect`: draw_masks' per-block entries (training)."""
        x = x_nhwc.permute(0, 3, 1, 2)
        x = swish(self.stem.bn(conv2d_same(x, self.stem.conv, 2)))
        for i, blk in enumerate(self.blocks):
            x = blk(x, None if drop_connect is None else drop_connect[i])
        return swish(self.head.bn(F.conv2d(x, self.head.conv)))

    def extract_features(self, x_nhwc: torch.Tensor, drop_connect=None) -> torch.Tensor:
        """(B, H, W, 3) normalized RGB -> (B, head_filters) pooled features."""
        return self.feature_map(x_nhwc, drop_connect).mean(dim=(2, 3))

    def apply_head(self, feats: torch.Tensor, drops=None) -> torch.Tensor:
        """(B, head_filters) -> (B, 1) logits (model.py:50-61). `drops`:
        draw_masks' three head dropouts (training); identities without."""
        fc = self.fc
        drops = drops or (None, None, None)
        x = torch.relu(fc.bn1(fc.fc1(_drop(feats, drops[0]))))
        x = torch.relu(fc.bn2(fc.fc2(_drop(x, drops[1]))))
        return fc.fc3(_drop(x, drops[2]))

    def forward(self, x_nhwc: torch.Tensor, masks=None) -> torch.Tensor:
        masks = masks or {}
        return self.apply_head(self.extract_features(x_nhwc, masks.get("drop_connect")),
                               masks.get("head"))

    def draw_masks(self, n: int, generator: torch.Generator, dropout: float) -> dict:
        """Training masks for a batch of n from `generator` (on its
        device): drop-connect keep masks (n,) of the skip blocks at rate
        0.2 * i / len(blocks), and the head's dropouts at `dropout`,
        0.7 * dropout and 0.5 * dropout; a mask is kept with probability
        1 - rate (torch.rand >= rate) and scaled by 1 / (1 - rate). Entries
        are (mask, rate), or None where the rate is 0."""
        dev = generator.device

        def mask(shape, rate):
            if rate <= 0.0:
                return None
            return torch.rand(shape, generator=generator, device=dev) >= rate, rate

        nb = len(self.blocks)
        dc = [mask((n,), _DROP_CONNECT * i / nb) if blk.has_skip else None
              for i, blk in enumerate(self.blocks)]
        d0, d1 = self.fc.fc1.w.shape[1], self.fc.fc2.w.shape[1]
        head = [mask((n, self.fc.fc1.w.shape[0]), dropout),
                mask((n, d0), dropout * 0.7), mask((n, d1), dropout * 0.5)]
        return {"drop_connect": dc, "head": head}


def param_count(model: nn.Module) -> int:
    """Number of values in the parameter tree, BN statistics included (the
    JAX package's param_count counts every leaf)."""
    return sum(v.numel() for v in model.state_dict().values())
