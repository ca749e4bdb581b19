"""Training losses. Port of real_time_video_deepfake_detection_tpu/train/
losses.py (reference train.py:360-392: focal loss with label smoothing on
binary logits)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def focal_loss_with_smoothing(logits: torch.Tensor, labels: torch.Tensor,
                              gamma: float = 2.0, alpha: float = 0.25,
                              label_smoothing: float = 0.1) -> torch.Tensor:
    """Binary focal loss, mean-reduced. The targets are smoothed to
    y * (1 - ls) + 0.5 * ls first, and the smoothed targets feed all three
    terms (the BCE, p_t and alpha_t), as the reference reassigns `targets`
    before computing any of them."""
    y = labels.to(torch.float32) * (1.0 - label_smoothing) + 0.5 * label_smoothing
    bce = -(y * F.logsigmoid(logits) + (1.0 - y) * F.logsigmoid(-logits))
    p = torch.sigmoid(logits)
    p_t = y * p + (1.0 - y) * (1.0 - p)
    a_t = y * alpha + (1.0 - y) * (1.0 - alpha)
    return torch.mean(a_t * (1.0 - p_t) ** gamma * bce)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    labels = labels.to(torch.float32)
    return torch.mean(-(labels * F.logsigmoid(logits)
                        + (1 - labels) * F.logsigmoid(-logits)))
