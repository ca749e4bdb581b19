"""Vision Transformer classifier backbone (BASELINE config 5), as an
nn.Module.

Port of real_time_video_deepfake_detection_tpu/models/vit.py: patch embed
-> pre-LN transformer -> final LN -> mean pool (or the [CLS] row) ->
binary head, sized S/16, B/16 and L/16.

  x (B, H, W, 3) normalized NHWC -> patches in (py, px, c) order -> @ patch.w
  -> [+ cls] + pos -> depth x [LN, MHA softmax(q.k^T/sqrt(hd)).v, LN,
  erf-GELU MLP] -> final LN -> features -> head

The MLP's GELU is the exact erf form (the transformers/timm convention);
the layer norms use the population variance with eps spec.ln_eps (1e-6,
or the HF default 1e-12 for donor weights, utils/vit_convert.py).

Parameter names follow the JAX parameter tree (patch.w, blocks.3.qkv.w,
final_ln.scale, ...); linear weights keep the JAX (in, out) layout. The
JAX qkv kernel is (dim, 3, heads, hd): here it is (dim, 3 * dim) with the
output axis in (3, heads, hd) order, and utils/convert.params_from_jax
reshapes it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import LayerNorm, Linear

_SIZES = {
    # name: (depth, dim, heads, mlp_ratio, patch)
    "s16": (12, 384, 6, 4, 16),
    "b16": (12, 768, 12, 4, 16),
    "l16": (24, 1024, 16, 4, 16),
}


@dataclasses.dataclass(frozen=True)
class ViTSpec:
    variant: str
    depth: int
    dim: int
    heads: int
    mlp_ratio: int
    patch: int
    image_size: int = 224
    # use_cls=True prepends a learned [CLS] token and takes it (after the
    # final LN) as the feature vector instead of the token mean: the
    # transformers/timm convention of the donor-weight converter
    use_cls: bool = False
    ln_eps: float = 1e-6

    @staticmethod
    def make(variant: str) -> "ViTSpec":
        """The named size at 224x224, mean pool, eps 1e-6."""
        return ViTSpec(variant, *_SIZES[variant])

    @property
    def n_tokens(self) -> int:
        return (self.image_size // self.patch) ** 2 + (1 if self.use_cls else 0)


class _Block(nn.Module):
    def __init__(self, spec: ViTSpec, generator):
        super().__init__()
        d, eps = spec.dim, spec.ln_eps
        self.ln1 = LayerNorm(d, eps)
        self.qkv = Linear(d, 3 * d, generator)
        self.proj = Linear(d, d, generator)
        self.ln2 = LayerNorm(d, eps)
        self.mlp1 = Linear(d, d * spec.mlp_ratio, generator)
        self.mlp2 = Linear(d * spec.mlp_ratio, d, generator)


class ViT(nn.Module):
    """ViT backbone + linear head, inference. Parameters are drawn from
    `generator` with the JAX init laws (normal * sqrt(1/in) linears, zero
    biases, pos and cls normal * 0.02, unit LN); they are not JAX's
    numbers."""

    def __init__(self, spec: ViTSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        d = spec.dim
        self.patch = Linear(spec.patch * spec.patch * 3, d, generator)
        self.pos = nn.Parameter(torch.randn((spec.n_tokens, d), generator=generator) * 0.02)
        if spec.use_cls:
            self.cls = nn.Parameter(torch.randn((d,), generator=generator) * 0.02)
        self.blocks = nn.ModuleList(_Block(spec, generator) for _ in range(spec.depth))
        self.final_ln = LayerNorm(d, spec.ln_eps)
        self.head = Linear(d, 1, generator)

    def _attention(self, x: torch.Tensor, blk: _Block) -> torch.Tensor:
        b, t, d = x.shape
        h = self.spec.heads
        hd = d // h
        qkv = blk.qkv(x).view(b, t, 3, h, hd).permute(2, 0, 3, 1, 4)   # (3, b, h, t, c)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        return blk.proj((attn @ v).transpose(1, 2).reshape(b, t, d))

    def encode(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, n_tokens, dim) tokens after the final LN."""
        b, hgt, wid, _ = x_nhwc.shape
        p = self.spec.patch
        patches = x_nhwc.reshape(b, hgt // p, p, wid // p, p, 3)
        patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, p * p * 3)
        tok = self.patch(patches)
        if self.spec.use_cls:
            tok = torch.cat([self.cls.expand(b, 1, -1), tok], dim=1)
        tok = tok + self.pos
        for blk in self.blocks:
            tok = tok + self._attention(blk.ln1(tok), blk)
            tok = tok + blk.mlp2(F.gelu(blk.mlp1(blk.ln2(tok))))
        return self.final_ln(tok)

    def extract_features(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized RGB -> (B, dim): the [CLS] row when
        spec.use_cls, else the token mean."""
        tok = self.encode(x_nhwc)
        return tok[:, 0] if self.spec.use_cls else tok.mean(dim=1)

    def apply_head(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, dim) -> (B, 1) logits."""
        return self.head(feats)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        return self.apply_head(self.extract_features(x_nhwc))
