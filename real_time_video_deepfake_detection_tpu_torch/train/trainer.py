"""The trainer: epoch loop, validation, checkpoints, CLI.

Port of real_time_video_deepfake_detection_tpu/train/trainer.py (reference
train.py:770-1138): balanced sampler, the fused augment + mixup + focal
step, validation on the EMA weights, a best checkpoint on an F1 gain, a
JSON epoch log, an atomic resume checkpoint each epoch with every RNG
state, graceful SIGINT (the first finishes the epoch and saves, the second
aborts), early stopping, resume by rerunning the same command.

    python -m real_time_video_deepfake_detection_tpu_torch.train.trainer \\
        --dataset DIR [--device cpu] [--output-dir weights] ...

DIR holds train/{real,fake}/*.jpg and val/{real,fake}/*.jpg. The trainer
runs on the CUDA card unless given --device; without CUDA it raises. It
writes best_model.pt (the EMA weights), resume_checkpoint.pt and
training_log.json (the JAX trainer's keys) to --output-dir, and with
--fit-calibrator calibrator.pkl. One card: data-parallel training over
several is not ported yet, and --num-devices exits when more than one is
usable.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.device import resolve_device
from ..models import backbones
from ..models.efficientnet import EfficientNetSpec
from ..utils import torch_convert
from .augment import eval_preprocess_batch
from .calibration import fit_calibrator_from_validation
from .checkpoint import (
    host_rng_state, load_checkpoint, params_from_jax_npz, restore_host_rng_state,
    save_checkpoint,
)
from .data import BatchLoader, DeepfakeDataset
from .losses import focal_loss_with_smoothing
from .steps import fused_train_step, init_train_state

_stop_requested = False


def _sigint_handler(signum, frame):
    """(train.py:79-94)."""
    global _stop_requested
    if _stop_requested:
        print("\nSecond interrupt — aborting immediately.")
        raise KeyboardInterrupt
    _stop_requested = True
    print("\nStop requested — will save and exit after this epoch. "
          "Press Ctrl-C again to abort without saving.")


def auc_score(labels: np.ndarray, probs: np.ndarray) -> float:
    """Rank-based ROC AUC, ties at their average rank (no sklearn)."""
    order = np.argsort(probs, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(probs) + 1)
    sorted_p = probs[order]
    i = 0
    while i < len(sorted_p):
        j = i
        while j + 1 < len(sorted_p) and sorted_p[j + 1] == sorted_p[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    pos = labels == 1
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return 0.0
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


@torch.no_grad()
def validate(model, params, loader: BatchLoader, cfg: TrainConfig) -> dict:
    """(train.py:632-679): loss, accuracy, per-class accuracy, P/R/F1, AUC
    of `model` with `params` (the EMA state dict) in inference mode."""
    dev = next(model.parameters()).device
    probs_all, labels_all, loss_sum, n = [], [], 0.0, 0
    for imgs, labels in loader:
        x = eval_preprocess_batch(imgs.to(dev))
        logits = torch.func.functional_call(model, params, (x,))[:, 0]
        y = torch.from_numpy(labels).to(dev)
        loss = focal_loss_with_smoothing(logits, y, cfg.focal_gamma, cfg.focal_alpha,
                                         cfg.label_smoothing)
        loss_sum += float(loss) * len(labels)
        n += len(labels)
        probs_all.append(torch.sigmoid(logits).cpu().numpy())
        labels_all.append(labels)
    probs = np.concatenate(probs_all)
    labels = np.concatenate(labels_all)
    preds = (probs > 0.5).astype(np.float32)
    acc = float((preds == labels).mean())
    real_m, fake_m = labels == 0, labels == 1
    real_acc = float((preds[real_m] == 0).mean()) if real_m.any() else 0.0
    fake_acc = float((preds[fake_m] == 1).mean()) if fake_m.any() else 0.0
    tp = float(((preds == 1) & (labels == 1)).sum())
    fp = float(((preds == 1) & (labels == 0)).sum())
    fn = float(((preds == 0) & (labels == 1)).sum())
    precision = tp / (tp + fp + 1e-10)
    recall = tp / (tp + fn + 1e-10)
    f1 = 2 * precision * recall / (precision + recall + 1e-10)
    auc = auc_score(labels, probs)
    print(f"  Val Acc: {acc*100:.1f}% (Real: {real_acc*100:.1f}%, "
          f"Fake: {fake_acc*100:.1f}%) | F1: {f1:.4f} | AUC: {auc:.4f} "
          f"| Prec: {precision:.3f} Rec: {recall:.3f}")
    return {"loss": loss_sum / max(n, 1), "acc": acc, "real_acc": real_acc,
            "fake_acc": fake_acc, "precision": precision, "recall": recall,
            "f1": f1, "auc": auc}


def _pretrained_path(args, spec) -> str:
    if args.pretrained != "auto":
        return args.pretrained
    # each efficientnet_pytorch release file embeds its own sha256[:8]
    cands = sorted(c for d in (args.output_dir, "weights")
                   for c in glob.glob(os.path.join(d, f"efficientnet-{spec.variant}-*.pth")))
    if not cands:
        raise FileNotFoundError(
            f"--pretrained: no ImageNet efficientnet-{spec.variant}-*.pth found in "
            f"{args.output_dir} or weights/; pass an explicit path")
    return cands[0]


def _initial_params(args, spec, model, seed: int) -> None:
    """--pretrained (an ImageNet backbone + a fresh head) and --warm-start
    (the reference .pth, a JAX .npz or the port's .pt) into `model`."""
    if args.pretrained and not args.warm_start:
        if not isinstance(spec, EfficientNetSpec):
            raise ValueError("--pretrained loads an ImageNet EfficientNet .pth; use "
                             "--warm-start with a trainer checkpoint for other backbones")
        path = _pretrained_path(args, spec)
        model.load_state_dict(torch_convert.load_imagenet_checkpoint(
            path, spec, torch.Generator().manual_seed(seed)))
        print(f"  ImageNet-pretrained backbone from {path} "
              f"(fresh {spec.head_filters}->512->256->1 head)")
    if args.warm_start and os.path.exists(args.warm_start):
        ws = args.warm_start
        if ws.endswith(".pth"):
            if not isinstance(spec, EfficientNetSpec):
                raise ValueError(".pth warm-start is the reference EfficientNet checkpoint "
                                 "format; use a trainer checkpoint for other backbones")
            sd, _ = torch_convert.load_checkpoint(ws, spec)
        elif ws.endswith(".npz"):
            sd, _ = params_from_jax_npz(ws, model, part="params")
        else:
            ckpt = load_checkpoint(ws)
            sd = ckpt["params"] if "params" in ckpt else ckpt["model"]
        model.load_state_dict(sd)
        print(f"  Warm-started from {ws}")


def _usable_devices(args, device: torch.device) -> int:
    """The JAX trainer's rule: the largest count up to --num-devices (0 =
    all visible) that divides the batch."""
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    n_dev = min(args.num_devices or visible, visible)
    while args.batch_size % n_dev:
        n_dev -= 1
    return n_dev


def train(args) -> dict:
    global _stop_requested
    _stop_requested = False
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n_dev = _usable_devices(args, device)
    if n_dev > 1:
        raise SystemExit(f"{n_dev} devices are usable: data-parallel training is not "
                         "ported yet; pass --num-devices 1 to train on one card")
    previous = signal.signal(signal.SIGINT, _sigint_handler)
    try:
        return _train(args, device)
    finally:
        signal.signal(signal.SIGINT, previous)


def _train(args, device: torch.device) -> dict:
    cfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        image_size=args.image_size, seed=args.seed,
        early_stop_patience=args.patience, bf16_compute=args.bf16,
        weight_decay=args.weight_decay, head_dropout=args.dropout,
        label_smoothing=args.label_smoothing,
        mixup_alpha=args.mixup_alpha, cutmix_alpha=args.cutmix_alpha,
        focal_gamma=args.focal_gamma, focal_alpha=args.focal_alpha,
        ema_decay=args.ema_decay, backbone_lr_mult=args.backbone_lr_mult,
        freeze_frac=args.freeze_frac, clip_norm=args.clip_norm,
        bn_momentum=args.bn_momentum)
    spec = backbones.make(args.backbone, image_size=cfg.image_size)

    out_dir = args.output_dir
    os.makedirs(out_dir, exist_ok=True)
    resume_path = os.path.join(out_dir, "resume_checkpoint.pt")
    best_path = os.path.join(out_dir, "best_model.pt")
    log_path = os.path.join(out_dir, "training_log.json")

    train_ds = DeepfakeDataset(args.dataset, "train", cfg.image_size)
    val_ds = DeepfakeDataset(args.dataset, "val", cfg.image_size)
    print(f"  [train] {len(train_ds)} samples {tuple(train_ds.class_counts)}; "
          f"[val] {len(val_ds)} samples")
    train_loader = BatchLoader(train_ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
                               balanced=True, num_workers=args.num_workers, device=device)
    val_loader = BatchLoader(val_ds, cfg.batch_size, shuffle=False, drop_last=False,
                             num_workers=args.num_workers, device=device)
    total_steps = max(len(train_loader), 1) * cfg.epochs

    model = backbones.build_model(spec, torch.Generator().manual_seed(cfg.seed))
    _initial_params(args, spec, model, cfg.seed)
    state = init_train_state(model.to(device), spec, cfg, total_steps, cfg.seed)
    start_epoch, best, training_log = 0, {"f1": -1.0, "acc": 0.0}, []
    if not args.fresh and os.path.exists(resume_path):
        ckpt = load_checkpoint(resume_path)
        state.load_state_dict(ckpt)
        restore_host_rng_state(ckpt["rng"])
        meta = ckpt["metadata"]
        start_epoch, best = meta["epoch"] + 1, meta["best"]
        training_log = meta.get("training_log", [])
        print(f"  Resumed from epoch {meta['epoch']} (best F1 {best['f1']:.4f})")

    epochs_no_improve = 0
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        losses, accs = [], []
        for imgs, labels in train_loader:
            if _stop_requested:
                break
            m = fused_train_step(state, imgs, torch.from_numpy(labels).to(device))
            losses.append(float(m["loss"]))
            accs.append(float(m["accuracy"]))
        train_loss = float(np.mean(losses)) if losses else 0.0
        train_acc = float(np.mean(accs)) if accs else 0.0

        # validate with the EMA weights (train.py:992-999)
        ema = state.ema_state_dict()
        val = validate(state.model, ema, val_loader, cfg)
        entry = {"epoch": epoch, "train_loss": train_loss, "train_acc": train_acc,
                 "epoch_seconds": time.time() - t0,
                 **{f"val_{k}": v for k, v in val.items()}}
        training_log.append(entry)
        with open(log_path, "w") as f:
            json.dump(training_log, f, indent=2)
        print(f"Epoch {epoch}: loss {train_loss:.4f} acc {train_acc*100:.1f}% "
              f"| val F1 {val['f1']:.4f} ({entry['epoch_seconds']:.0f}s)")

        if val["f1"] > best["f1"]:
            best = {"f1": val["f1"], "acc": val["acc"], "epoch": epoch}
            save_checkpoint(best_path, {
                "params": {k: v.detach().cpu() for k, v in ema.items()},
                "metadata": {"epoch": epoch, "val_acc": val["acc"], "val_f1": val["f1"],
                             "config": vars(args)}})
            epochs_no_improve = 0
        else:
            epochs_no_improve += 1

        save_checkpoint(resume_path, {
            **state.state_dict(), "rng": host_rng_state(),
            "metadata": {"epoch": epoch, "best": best, "training_log": training_log,
                         "args": vars(args)}})

        if _stop_requested:
            print("  Stopped by request; checkpoint saved.")
            break
        if epochs_no_improve >= cfg.early_stop_patience:
            print(f"  Early stopping after {epochs_no_improve} epochs without F1 "
                  "improvement.")
            break

    if args.fit_calibrator:
        # isotonic calibration on validation predictions of the final EMA
        # weights (the reference's optional weights/calibrator.pkl)
        cal_path = os.path.join(out_dir, "calibrator.pkl")
        fit_calibrator_from_validation(state.model, state.ema_state_dict(), val_loader,
                                       cal_path)
        print(f"  Calibrator saved to {cal_path}")
    return {"best": best, "log": training_log, "state": state}


def build_parser() -> argparse.ArgumentParser:
    """The JAX trainer's flags and defaults (TrainConfig's, which carry the
    reference's train.py:1090-1138), plus --device."""
    d = TrainConfig()
    p = argparse.ArgumentParser(description="Train the deepfake classifier (PyTorch port)")
    p.add_argument("--dataset", required=True,
                   help="dir with train/{real,fake} and val/{real,fake}")
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--batch-size", type=int, default=d.batch_size)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--image-size", type=int, default=d.image_size)
    p.add_argument("--backbone", default="b0", choices=backbones.backbone_names(),
                   help="classifier backbone: EfficientNet b0..b7, vit_s16/b16/l16, "
                        "or xception")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--patience", type=int, default=d.early_stop_patience)
    p.add_argument("--weight-decay", type=float, default=d.weight_decay)
    p.add_argument("--dropout", type=float, default=d.head_dropout,
                   help="classifier-head base dropout; the second and third head "
                        "dropouts are 0.7x / 0.5x of it (model.py:51-59)")
    p.add_argument("--label-smoothing", type=float, default=d.label_smoothing)
    p.add_argument("--mixup-alpha", type=float, default=d.mixup_alpha)
    p.add_argument("--cutmix-alpha", type=float, default=d.cutmix_alpha)
    p.add_argument("--focal-gamma", type=float, default=d.focal_gamma)
    p.add_argument("--focal-alpha", type=float, default=d.focal_alpha)
    p.add_argument("--ema-decay", type=float, default=d.ema_decay)
    p.add_argument("--backbone-lr-mult", type=float, default=d.backbone_lr_mult,
                   help="differential LR: backbone groups train at this multiple of "
                        "--lr (train.py:891-910)")
    p.add_argument("--freeze-frac", type=float, default=d.freeze_frac,
                   help="freeze the stem + this fraction of early blocks "
                        "(train.py:863-876)")
    p.add_argument("--clip-norm", type=float, default=d.clip_norm)
    p.add_argument("--num-workers", type=int, default=8,
                   help="decode/prefetch threads in the batch loader")
    p.add_argument("--fit-calibrator", action="store_true",
                   help="after training, fit the isotonic calibrator on validation "
                        "predictions and save <output-dir>/calibrator.pkl")
    p.add_argument("--bn-momentum", type=float, default=None,
                   help="BN running-stat momentum override; default: backbone 0.01, "
                        "head 0.1 (cold starts want 0.1-0.2)")
    p.add_argument("--fresh", action="store_true", help="ignore resume checkpoint")
    p.add_argument("--warm-start", default=None,
                   help="best_model.pth (reference torch), a JAX trainer .npz or the "
                        "port's .pt to initialize from")
    p.add_argument("--pretrained", nargs="?", const="auto", default=None,
                   metavar="IMAGENET_PTH",
                   help="start from an ImageNet-pretrained backbone + fresh head "
                        "(model.py:40-41): an efficientnet_pytorch release .pth or a "
                        "timm state dict; the bare flag looks for "
                        "efficientnet-<variant>-*.pth in --output-dir then ./weights")
    p.add_argument("--output-dir", default="weights")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 forward/backward with f32 master params, no loss scaler")
    p.add_argument("--num-devices", type=int, default=0,
                   help="devices for data-parallel training (0 = all visible); more "
                        "than one is not ported yet and exits")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card, which must be present)")
    return p


def main(argv: Optional[list] = None):
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
