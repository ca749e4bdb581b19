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
from typing import Dict, Optional, Tuple

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
    def make(variant: str, image_size: int = 224) -> "ViTSpec":
        """The named size, mean pool, eps 1e-6."""
        return ViTSpec(variant, *_SIZES[variant], image_size=image_size)

    @property
    def n_tokens(self) -> int:
        return (self.image_size // self.patch) ** 2 + (1 if self.use_cls else 0)


def attend(qkv: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """(B, T, 3 * heads * hd) projections in (3, heads, hd) order ->
    (B, T, heads * hd) per-head softmax(q.k^T/sqrt(hd)).v, heads in order."""
    b, t, _ = qkv.shape
    qkv = qkv.view(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4)   # (3, b, h, t, c)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    return (attn @ v).transpose(1, 2).reshape(b, t, heads * hd)


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
        return blk.proj(attend(blk.qkv(x), self.spec.heads, self.spec.dim // self.spec.heads))

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


# ------------------------------------------------------ tensor parallelism

def vit_partition_specs(spec: ViTSpec) -> Dict[str, tuple]:
    """JAX vit_partition_specs (models/vit.py:141-165) keyed by state-dict
    name: per axis of the leaf's JAX shape, "model" where the leaf is split
    over the model axis, None elsewhere, () for a replicated leaf. qkv is
    split by heads, mlp1 by its hidden columns (weight and bias), mlp2 by
    its hidden rows; proj, the layer norms, patch, pos, cls and head are
    replicated."""
    out = {k: () for k in ("patch.w", "patch.b", "pos", "final_ln.scale",
                           "final_ln.bias", "head.w", "head.b")}
    if spec.use_cls:
        out["cls"] = ()
    for i in range(spec.depth):
        p = f"blocks.{i}."
        out.update({p + "ln1.scale": (), p + "ln1.bias": (),
                    p + "qkv.w": (None, None, "model", None), p + "qkv.b": (None, "model", None),
                    p + "proj.w": (None, None), p + "proj.b": (),
                    p + "ln2.scale": (), p + "ln2.bias": (),
                    p + "mlp1.w": (None, "model"), p + "mlp1.b": ("model",),
                    p + "mlp2.w": ("model", None), p + "mlp2.b": ()})
    return out


def _jax_shape(spec: ViTSpec, name: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The leaf's shape in the JAX tree: qkv's output axis as (3, heads, hd)."""
    hd = spec.dim // spec.heads
    if name.endswith("qkv.w"):
        return (shape[0], 3, spec.heads, hd)
    if name.endswith("qkv.b"):
        return (3, spec.heads, hd)
    return tuple(shape)


def shard_state_dict(spec: ViTSpec, state: Dict[str, torch.Tensor], tp: int,
                     j: int) -> Dict[str, torch.Tensor]:
    """Model shard j of `tp`: each leaf split along its "model" axis of
    vit_partition_specs into tp equal contiguous parts, part j kept (for
    qkv: heads j*H/tp .. (j+1)*H/tp of q, k and v, in the port's flat
    layout); replicated leaves whole. Raises when heads or the MLP's hidden
    width does not divide by tp."""
    hidden = spec.dim * spec.mlp_ratio
    if spec.heads % tp or hidden % tp:
        raise ValueError(f"tensor parallelism over {tp} shards needs heads ({spec.heads}) "
                         f"and the MLP width ({hidden}) to divide by {tp}")
    out = {}
    for name, pspec in vit_partition_specs(spec).items():
        t = state[name]
        if "model" not in pspec:
            out[name] = t
            continue
        axis = pspec.index("model")
        v = t.reshape(_jax_shape(spec, name, tuple(t.shape)))
        n = v.shape[axis] // tp
        part = v.narrow(axis, j * n, n)
        if name.endswith("qkv.w"):     # back to the port's (dim, 3 * heads/tp * hd)
            part = part.reshape(t.shape[0], -1)
        elif name.endswith("qkv.b"):
            part = part.reshape(-1)
        out[name] = part.contiguous()
    return out
