"""Clip-level temporal attention head (BASELINE config 5), as an nn.Module.

Port of real_time_video_deepfake_detection_tpu/models/temporal_head.py: in
place of the 10-frame majority vote, a small pre-LN transformer over the
time axis of per-frame backbone features, with masked learned-query
pooling, gives one fake logit for the clip.

  feats (B, T, feature_dim) -> inproj -> + pos[:T] -> depth x [LN, masked
  MHA, LN, tanh-GELU MLP] -> masked attention pooling -> head -> (B,)

Numerics kept from the JAX head: masked scores are filled with -1e9, not
-inf, so an all-false mask (an empty ring) still gives a finite logit; the
layer norms use the population variance with eps 1e-6; the MLP's GELU is
the tanh form (jax.nn.gelu's default).

Streaming: ClipState holds a batched per-stream ring of features
(N, window, feature_dim) with its fill count and write position;
clip_state_push writes one frame per stream where `valid`, and clip_verdict
scores every stream's window, oldest frame first, in one call.

Parameter names follow the JAX parameter tree (inproj.w, blocks.0.qkv.b,
pool_q, ...); linear weights keep the JAX (in, out) layout, so
utils/convert.params_from_jax maps leaf to leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import LayerNorm, Linear

_LN_EPS = 1e-6
_MASK_FILL = -1e9


@dataclasses.dataclass(frozen=True)
class TemporalHeadSpec:
    feature_dim: int = 1280       # B0 features; 384/768 for ViT
    dim: int = 256
    depth: int = 2
    heads: int = 4
    window: int = 64              # clip length (~2 s at 30 fps)


def _normal(shape, std: float, generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


class _Block(nn.Module):
    def __init__(self, d: int, generator):
        super().__init__()
        self.ln1 = LayerNorm(d, _LN_EPS)
        self.qkv = Linear(d, 3 * d, generator)
        self.proj = Linear(d, d, generator)
        self.ln2 = LayerNorm(d, _LN_EPS)
        self.mlp1 = Linear(d, 4 * d, generator)
        self.mlp2 = Linear(4 * d, d, generator)


class TemporalHead(nn.Module):
    """The clip head; parameters drawn from `generator` with the JAX init
    laws (not JAX's numbers: load converted parameters to match a JAX
    head)."""

    def __init__(self, spec: TemporalHeadSpec,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        d = spec.dim
        self.inproj = Linear(spec.feature_dim, d, generator)
        self.pos = _normal((spec.window, d), 0.02, generator)
        self.blocks = nn.ModuleList(_Block(d, generator) for _ in range(spec.depth))
        self.pool_q = _normal((d,), 0.02, generator)
        self.head = Linear(d, 1, generator)

    def _mha(self, x: torch.Tensor, blk: _Block, mask: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.spec.heads
        hd = d // h
        qkv = blk.qkv(x).view(b, t, 3, h, hd).permute(2, 0, 3, 1, 4)   # (3, b, h, t, c)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        attn = attn.masked_fill(~mask[:, None, None, :], _MASK_FILL)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, t, d)
        return blk.proj(out)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """feats (B, T, feature_dim), mask (B, T) bool valid-frame mask ->
        (B,) clip fake logits. Masked frames take part in neither attention
        nor pooling, so a ring with a partial fill gives the logit of the
        dense clip."""
        x = self.inproj(feats) + self.pos[:feats.shape[1]]
        for blk in self.blocks:
            x = x + self._mha(blk.ln1(x), blk, mask)
            y = F.gelu(blk.mlp1(blk.ln2(x)), approximate="tanh")
            x = x + blk.mlp2(y)
        score = (x @ self.pool_q) / math.sqrt(self.spec.dim)
        w = torch.softmax(score.masked_fill(~mask, _MASK_FILL), dim=-1)
        pooled = torch.einsum("bt,btd->bd", w, x)
        return self.head(pooled)[:, 0]


# ----------------------------------------------------- streaming clip state

@dataclasses.dataclass
class ClipState:
    feats: torch.Tensor   # f32 (N, window, feature_dim) ring
    n: torch.Tensor       # i32 (N,) frames held, at most window
    pos: torch.Tensor     # i32 (N,) next write position


def clip_state_init(n_streams: int, window: int, feature_dim: int,
                    device: Union[str, torch.device] = "cpu") -> ClipState:
    return ClipState(
        feats=torch.zeros((n_streams, window, feature_dim), dtype=torch.float32,
                          device=device),
        n=torch.zeros((n_streams,), dtype=torch.int32, device=device),
        pos=torch.zeros((n_streams,), dtype=torch.int32, device=device))


def clip_state_push(state: ClipState, feat: torch.Tensor,
                    valid: torch.Tensor) -> ClipState:
    """Write feat (N, feature_dim) at each stream's position where `valid`
    (bool (N,)); other streams keep their ring, count and position."""
    cap = state.feats.shape[1]
    rows = torch.arange(state.feats.shape[0], device=feat.device)
    pos = state.pos.to(torch.int64)
    cur = state.feats[rows, pos]
    feats = state.feats.index_put((rows, pos), torch.where(valid[:, None], feat, cur))
    n = torch.where(valid, torch.clamp(state.n + 1, max=cap), state.n)
    new_pos = torch.where(valid, torch.remainder(state.pos + 1, cap), state.pos)
    return ClipState(feats, n, new_pos)


def clip_verdict(head: TemporalHead, state: ClipState) -> torch.Tensor:
    """(N,) fake probability of each stream's window, its frames oldest
    first; an empty ring scores an all-false mask (finite)."""
    cap = state.feats.shape[1]
    i = torch.arange(cap, device=state.feats.device)
    idx = torch.remainder(state.pos[:, None] - state.n[:, None] + i, cap).to(torch.int64)
    ordered = torch.gather(state.feats, 1,
                           idx[..., None].expand(-1, -1, state.feats.shape[2]))
    mask = i[None] < state.n[:, None]
    return torch.sigmoid(head(ordered, mask))
