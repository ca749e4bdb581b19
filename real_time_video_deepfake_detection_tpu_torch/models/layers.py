"""Layers shared by the transformer backbone (models/vit.py), Xception's
head (models/xception.py) and the clip-attention head
(models/temporal_head.py), with the JAX package's leaf names and layouts."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Module):
    """x @ w + b with w in the JAX (in, out) layout; the JAX init law
    (normal * sqrt(1/in), zero bias)."""

    def __init__(self, cin: int, cout: int, generator: Optional[torch.Generator]):
        super().__init__()
        self.w = nn.Parameter(torch.randn((cin, cout), generator=generator)
                              * math.sqrt(1.0 / cin))
        self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class LayerNorm(nn.Module):
    """Layer norm over the last axis (the population variance) with the JAX
    leaf names (scale, bias)."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, self.eps)
