"""Temporal-attention head training (BASELINE config 5).

Port of extract_clip_features and train_clip_head of
real_time_video_deepfake_detection_tpu/train/clip_head.py: the clip head
(models/temporal_head.py) replaces the reference's 10-frame majority vote
(deepfake_detection.py:146-196) with a learned verdict over a window of
per-frame backbone features. Features are extracted once with the frozen
backbone, then the small head is fitted with the focal loss of the frame
classifier (train.py:360-392), AdamW(lr, weight decay 1e-4), batches in the
order of a numpy permutation seeded with 0, as in the JAX package.

    feats = extract_clip_features(backbone, clips_u8)        # (N, T, D)
    head, log = train_clip_head(feats, labels, TemporalHeadSpec(...))
    save_head(head, "clip_head.pt")   # serve: --batched --clip-window T --clip-head

The JAX package's `main` reads videos through cv2.VideoCapture; it is not
ported yet (the port has no video reader).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.temporal_head import TemporalHead, TemporalHeadSpec
from ..pipeline.classify import preprocess_aligned
from .checkpoint import save_checkpoint
from .losses import focal_loss_with_smoothing


@torch.no_grad()
def extract_clip_features(backbone: nn.Module, clips_rgb_raw: torch.Tensor,
                          batch_frames: int = 256) -> torch.Tensor:
    """(N, T, H, W, 3) raw-RGB face crops -> (N, T, feature_dim) pooled
    features of the frozen backbone, in chunks of batch_frames frames, on
    the backbone's device."""
    n, t = clips_rgb_raw.shape[:2]
    flat = clips_rgb_raw.reshape((n * t,) + tuple(clips_rgb_raw.shape[2:]))
    dev = next(backbone.parameters()).device
    outs = [backbone.extract_features(preprocess_aligned(
        flat[i:i + batch_frames].to(dev, torch.float32)))
        for i in range(0, n * t, batch_frames)]
    feats = torch.cat(outs, 0)
    return feats.reshape(n, t, feats.shape[-1])


def train_clip_head(feats: torch.Tensor, labels: torch.Tensor, hspec: TemporalHeadSpec,
                    epochs: int = 30, batch_size: int = 32, lr: float = 1e-3,
                    init: Optional[Dict[str, torch.Tensor]] = None,
                    seed: int = 0) -> Tuple[TemporalHead, list]:
    """feats (N, T, D) float32, labels (N,) in {0, 1} -> (head, log of
    {epoch, loss, acc}). The head starts from `init` (a state dict) or from
    parameters drawn with a generator seeded with `seed`, on feats'
    device. batch_size is clamped to N so small sets still take steps."""
    n = feats.shape[0]
    if n == 0:
        raise ValueError("train_clip_head: empty feature set")
    batch_size = min(batch_size, n)
    head = TemporalHead(hspec, generator=torch.Generator().manual_seed(seed))
    if init is not None:
        head.load_state_dict(init)
    head = head.to(feats.device).train()
    opt = torch.optim.AdamW(head.parameters(), lr=lr, weight_decay=1e-4)
    mask = torch.ones(feats.shape[:2], dtype=torch.bool, device=feats.device)
    rng = np.random.default_rng(0)
    log = []
    for epoch in range(epochs):
        order = rng.permutation(n)
        losses, accs = [], []
        for i in range(0, n - batch_size + 1, batch_size):
            idx = torch.as_tensor(order[i:i + batch_size], device=feats.device)
            y = labels[idx]
            logits = head(feats[idx], mask[idx])
            loss = focal_loss_with_smoothing(logits, y)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            accs.append(float(((torch.sigmoid(logits) > 0.5) == (y > 0.5)).float().mean()))
        log.append({"epoch": epoch, "loss": float(np.mean(losses)),
                    "acc": float(np.mean(accs))})
    return head.eval(), log


def save_head(head: TemporalHead, path: str, log: Optional[list] = None) -> None:
    """The head in the port's checkpoint format (read by --clip-head)."""
    save_checkpoint(path, {"params": {k: v.detach().cpu() for k, v in head.state_dict().items()},
                           "metadata": {"hspec": dataclasses.asdict(head.spec),
                                        "train_log_tail": (log or [])[-3:]}})
