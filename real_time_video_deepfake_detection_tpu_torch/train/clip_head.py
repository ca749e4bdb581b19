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

Or the operator path over labeled videos (`<root>/{train[,val]}/{real,fake}/`,
H.264 mp4 / mov (Constrained Baseline, Main, High), MPEG-4 Part 2 mp4 / mov
as FFmpeg's mpeg4 encoder writes it, or Motion-JPEG AVI, read by
utils/video.py with cv2's frames and cv2's seek landing; the JAX CLI reads
any video cv2 reads, interlaced, 4:2:2 and Xvid ones too):

    python -m real_time_video_deepfake_detection_tpu_torch.train.clip_head \
        --videos root --clip-window 16 --backbone-weights best_model.pt \
        --out clip_head.pt --device cuda

Without --backbone-weights the backbone is drawn from a torch.Generator
seeded with --seed, the head from one seeded with --seed + 1 (the JAX
CLI draws both from jax.random keys).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..models import backbones
from ..models.temporal_head import TemporalHead, TemporalHeadSpec
from ..pipeline.classify import preprocess_aligned
from ..utils.host_resize import resize_analysis
from ..utils.video import FORMATS, VideoReader
from . import checkpoint
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


def save_head(head: TemporalHead, path: str, log: Optional[list] = None,
              meta: Optional[dict] = None) -> None:
    """The head in the port's checkpoint format (read by --clip-head), with
    its hspec, the log's tail and `meta` in the metadata."""
    save_checkpoint(path, {"params": {k: v.detach().cpu() for k, v in head.state_dict().items()},
                           "metadata": {"hspec": dataclasses.asdict(head.spec),
                                        "train_log_tail": (log or [])[-3:], **(meta or {})}})


# ------------------------------------------------------------ operator CLI

def _clip_from_video(path: str, t: int, face_detector, crop_size: int) -> Optional[np.ndarray]:
    """`t` frames sampled uniformly in the video's 5-95% span (the trainer's
    pre-extraction convention, train.py:128-161), each the first detected
    face (the whole frame when none) resized to `crop_size`, RGB; a short
    video repeats its last frame. (t, crop, crop, 3) u8, or None when the
    video yields nothing."""
    reader = VideoReader(path)
    if not reader.is_opened():
        return None
    try:
        n = reader.frame_count
        if n <= 0:
            return None
        lo, hi = 0.05 * n, max(0.95 * n - 1, 0.05 * n)
        frames = []
        for i in np.unique(np.linspace(lo, hi, t).astype(int)):
            reader.seek(int(i))
            ok, f = reader.read()
            if not ok:
                continue
            crop = f
            boxes = face_detector(f)
            if boxes:
                x, y, w, h = boxes[0]
                candidate = f[y:y + h, x:x + w]
                if candidate.size:
                    crop = candidate
            frames.append(resize_analysis(crop, crop_size, crop_size)[..., ::-1])   # BGR -> RGB
    finally:
        reader.release()
    if not frames:
        return None
    while len(frames) < t:
        frames.append(frames[-1])
    return np.stack(frames[:t])


def _build_split(root: str, split: str, t: int, face_detector, crop_size: int):
    """(clips (N, t, crop, crop, 3) u8, labels (N,) float32: real 0, fake
    1) of root/split/{real,fake}/*, in sorted order; (None, None) when no
    video yields a clip."""
    clips, labels = [], []
    for label, y in (("real", 0.0), ("fake", 1.0)):
        d = os.path.join(root, split, label)
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            c = _clip_from_video(os.path.join(d, name), t, face_detector, crop_size)
            if c is not None:
                clips.append(c)
                labels.append(y)
    if not clips:
        return None, None
    return np.stack(clips), np.asarray(labels, np.float32)


def load_backbone_params(path: str, model: nn.Module) -> Dict[str, torch.Tensor]:
    """--backbone-weights as the JAX CLI reads them: the reference .pth; a
    JAX .npz params tree, or a resume TrainState's live params; the port's
    best_model.pt, or a resume checkpoint's live model."""
    if path.endswith(".npz"):
        return checkpoint.params_from_jax_npz(path, model, part="params")[0]
    if path.endswith(".pth"):
        from ..utils.weights import read_state_dict
        return read_state_dict(path, model)[0]
    ckpt = checkpoint.load_checkpoint(path)
    return ckpt["params"] if "params" in ckpt else ckpt["model"]


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Train the clip-attention verdict head (config 5) from labeled videos "
                    "(PyTorch port)")
    p.add_argument("--videos", required=True,
                   help=f"dir with train/{{real,fake}}/ (val/ optional) of {FORMATS} files")
    p.add_argument("--clip-window", type=int, default=16)
    p.add_argument("--backbone", default="b0", choices=backbones.backbone_names())
    p.add_argument("--backbone-weights", default=None,
                   help="frozen feature extractor: best_model.pth, a JAX .npz or the port's "
                        ".pt (drawn from --seed without: features are then arbitrary)")
    p.add_argument("--crop-size", type=int, default=160,
                   help="face-crop side fed to the backbone (the serving aligner's size)")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="clip_head.pt")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e).replace("device='cpu'", "--device cpu"))

    from ..pipeline.faces import FaceDetector

    spec = backbones.make(args.backbone)
    backbone = backbones.build_model(spec, generator=torch.Generator().manual_seed(args.seed))
    if args.backbone_weights:
        backbone.load_state_dict(load_backbone_params(args.backbone_weights, backbone))
    backbone = backbone.to(device).eval()

    fd = FaceDetector()
    t = args.clip_window
    clips, labels = _build_split(args.videos, "train", t, fd, args.crop_size)
    if clips is None:
        raise SystemExit(f"no usable videos under {args.videos}/train (the port reads "
                         f"{FORMATS})")
    print(f"  [clip-head] {len(clips)} train clips x {t} frames")
    feats = extract_clip_features(backbone, torch.from_numpy(clips))
    hspec = TemporalHeadSpec(feature_dim=backbones.feature_dim(spec), window=t)
    head, log = train_clip_head(feats, torch.from_numpy(labels).to(device), hspec,
                                epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                                seed=args.seed + 1)

    result = {"train_log_tail": log[-3:]}
    vclips, vlabels = _build_split(args.videos, "val", t, fd, args.crop_size)
    if vclips is not None:
        vfeats = extract_clip_features(backbone, torch.from_numpy(vclips))
        mask = torch.ones(vfeats.shape[:2], dtype=torch.bool, device=device)
        with torch.no_grad():
            probs = torch.sigmoid(head(vfeats, mask)).cpu().numpy()
        result["val_acc"] = float(((probs > 0.5) == (vlabels > 0.5)).mean())
        result["val_n"] = int(len(vlabels))

    save_head(head, args.out, log, {"backbone": args.backbone, "epochs": args.epochs})
    result["saved"] = args.out
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
