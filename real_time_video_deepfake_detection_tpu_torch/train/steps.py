"""The training step: augmentation, mixup/cutmix, forward, focal loss and
one AdamW / OneCycle / EMA update.

Port of real_time_video_deepfake_detection_tpu/train/steps.py (the
reference trains with AMP + clip + OneCycle + EMA, train.py:546-629,
891-927). One step is one optimizer update over the whole batch (no
gradient accumulation). The numerics kept from the JAX package:

- AdamW (betas 0.9/0.999, eps 1e-8, decay cfg.weight_decay) in two
  groups, "head" at sched(i) and "backbone" at sched(i) x
  backbone_lr_mult; "frozen" parameters (models/backbones.lr_group) carry
  requires_grad=False, so they get no update and no gradient before the
  global-norm clip (optax's clip_by_global_norm formula).
- Batch-norm statistics are buffers: outside the optimizer and outside
  the EMA. The EMA tracks every parameter (e * d + p * (1 - d)); the
  statistics it is evaluated with stay live (train.py:398-436).
- The schedule is torch's OneCycleLR with its float phase bounds
  (`onecycle_cos_schedule`), finite when pct_start * total < 1.
- A step whose gradient norm is not finite is skipped (optax's
  apply_if_finite, the reference's GradScaler): no parameter moves and the
  optimizer's count, which indexes the schedule, does not advance; the
  batch-norm statistics and the EMA still update.
- bf16 (cfg.bf16_compute) casts every float32 parameter and buffer and the
  input to bf16 at the module boundary (torch.func.functional_call), batch
  norm included, with float32 master weights and no loss scaler: the JAX
  package's recipe, not torch.autocast (which keeps batch norm in f32).

Randomness: the state carries a CPU generator (augmentation scalars), a
generator on the device (noise pixels, dropout masks) and a numpy
Generator (mixup scalars); a step's draws can also be passed in, which the
tests use to feed the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..core.config import TrainConfig
from ..models import backbones
from .augment import apply_augment, apply_mixup, draw_augment, draw_mixup
from .losses import focal_loss_with_smoothing

_BETAS = (0.9, 0.999)
_EPS = 1e-8


def onecycle_cos_schedule(total_steps: int, peak: float, pct_start: float = 0.1,
                          div_factor: float = 25.0, final_div_factor: float = 1000.0):
    """torch.optim.lr_scheduler.OneCycleLR with the reference's arguments
    (train.py:916-923: cos anneal, pct_start 0.1, div 25, final div 1000):
    its float phase bounds `pct_start * total - 1` and `total - 1`, finite
    when pct_start * total < 1 (torch then never enters the warm-up).
    sched(i) is the LR of 0-based optimizer step i. Evaluated in float32
    in the JAX package's order of operations, with the cosine correctly
    rounded from float64 (XLA's differs by up to an ulp)."""
    f32 = np.float32
    initial = peak / div_factor
    min_lr = initial / final_div_factor
    e1 = pct_start * total_steps - 1.0
    e2 = float(total_steps) - 1.0

    def anneal(a, b, pct):
        c = f32(math.cos(float(f32(math.pi) * f32(pct))))
        return f32(b) + f32((a - b) / 2.0) * (f32(1.0) + c)

    def sched(count: int) -> float:
        c = f32(count)
        if e1 > 0 and c <= f32(e1):
            return float(anneal(initial, peak, c / f32(e1)))
        pct2 = np.clip((c - f32(e1)) / f32(e2 - e1), f32(0), f32(1)) if e2 > e1 else 1.0
        return float(anneal(peak, min_lr, pct2))

    return sched


@dataclasses.dataclass
class TrainState:
    """The model (float32 master parameters and batch-norm buffers), its
    optimizer, the EMA of its parameters, the step (every call) and the
    optimizer's count (applied updates, the schedule's index), and the
    generators of the step's draws."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Dict[str, torch.Tensor]
    sched: object
    cfg: TrainConfig
    spec: object
    gen_host: torch.Generator
    gen_device: torch.Generator
    np_rng: np.random.Generator
    step: int = 0
    count: int = 0

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """What validation and the best checkpoint use: the EMA parameters
        with the live batch-norm statistics."""
        return {**self.model.state_dict(), **self.ema}

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "ema": dict(self.ema),
                "optimizer": self.optimizer.state_dict(), "step": self.step,
                "count": self.count, "gen_host": self.gen_host.get_state(),
                "gen_device": self.gen_device.get_state(),
                "np_rng": self.np_rng.bit_generator.state}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        with torch.no_grad():
            for k, v in sd["ema"].items():
                self.ema[k].copy_(v)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step, self.count = int(sd["step"]), int(sd["count"])
        self.gen_host.set_state(sd["gen_host"])
        self.gen_device.set_state(sd["gen_device"])
        self.np_rng.bit_generator.state = sd["np_rng"]


def make_optimizer(model: nn.Module, spec, cfg: TrainConfig, lr: float) -> torch.optim.AdamW:
    """Freeze the stem and the first freeze_frac of the blocks (train.py:
    863-876: requires_grad=False, so no update and no gradient), and put
    the rest in AdamW's "head" and "backbone" groups (train.py:891-927)."""
    n_frozen = int(cfg.freeze_frac * backbones.n_blocks(spec))
    groups: Dict[str, list] = {"head": [], "backbone": []}
    for name, p in model.named_parameters():
        g = backbones.lr_group(spec, name, n_frozen)
        p.requires_grad_(g != "frozen")
        if g != "frozen":
            groups[g].append(p)
    return torch.optim.AdamW([{"params": v, "group": k} for k, v in groups.items() if v],
                             lr=lr, betas=_BETAS, eps=_EPS, weight_decay=cfg.weight_decay)


def init_train_state(model: nn.Module, spec, cfg: TrainConfig, total_steps: int,
                     seed: int = 0) -> TrainState:
    """The optimizer over `model`, the schedule, the EMA copy of the
    parameters, the generators seeded (the device one on the model's
    device)."""
    sched = onecycle_cos_schedule(total_steps, cfg.lr)
    opt = make_optimizer(model, spec, cfg, sched(0))
    dev = next(model.parameters()).device
    ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return TrainState(model, opt, ema, sched, cfg, spec,
                      torch.Generator().manual_seed(seed),
                      torch.Generator(dev).manual_seed(seed + 1),
                      np.random.default_rng(seed))


def _bf16_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    out = {}
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        out[name] = t.to(torch.bfloat16) if t.dtype == torch.float32 else t
    return out


def forward_mixed(model: nn.Module, x: torch.Tensor, bf16: bool, masks=None,
                  bn_momentum: Optional[float] = None):
    """backbones.forward_train, optionally in bf16 at the module boundary;
    logits float32 either way (the statistics are cast when written)."""
    if not bf16:
        return backbones.forward_train(model, x, masks, bn_momentum)
    logits, stats = backbones.forward_train(model, x.to(torch.bfloat16), masks,
                                            bn_momentum, params=_bf16_params(model))
    return logits.float(), stats


@torch.no_grad()
def _ema_update(state: TrainState) -> None:
    d = state.cfg.ema_decay
    names = list(state.ema)
    ema = [state.ema[k] for k in names]
    params = dict(state.model.named_parameters())
    new = torch._foreach_mul([params[k] for k in names], 1.0 - d)
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, new)


def apply_update(state: TrainState, stats) -> torch.Tensor:
    """After a backward: clip, AdamW (skipped on a non-finite gradient
    norm), the batch-norm statistics of the forward, the EMA. Returns the
    gradient norm before the clip."""
    cfg = state.cfg
    grads = [p.grad for g in state.optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if bool(torch.isfinite(norm)):
        # optax clip_by_global_norm: unchanged below the norm, else g / n * clip
        torch._foreach_mul_(grads, torch.clamp(cfg.clip_norm / norm, max=1.0))
        lr = state.sched(state.count)
        for g in state.optimizer.param_groups:
            g["lr"] = (float(np.float32(lr) * np.float32(cfg.backbone_lr_mult))
                       if g["group"] == "backbone" else lr)
        state.optimizer.step()
        state.count += 1
    backbones.update_bn_stats(stats)
    _ema_update(state)
    state.step += 1
    return norm


def _update(state: TrainState, loss_fn) -> Dict[str, torch.Tensor]:
    """Forward and loss (`loss_fn()` -> (loss, logits, stats)), backward,
    apply_update."""
    loss, logits, stats = loss_fn()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    norm = apply_update(state, stats)
    return {"loss": loss.detach(), "logits": logits.detach(), "grad_norm": norm}


def _metrics(out: dict, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    preds = (torch.sigmoid(out["logits"]) > 0.5).to(torch.float32)
    return {"loss": out["loss"], "grad_norm": out["grad_norm"],
            "accuracy": torch.mean((preds == labels.to(torch.float32)).to(torch.float32))}


def _focal(cfg: TrainConfig, logits, labels):
    return focal_loss_with_smoothing(logits, labels, cfg.focal_gamma, cfg.focal_alpha,
                                     cfg.label_smoothing)


def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
               masks=None) -> Dict[str, torch.Tensor]:
    """One step on (B, H, W, 3) normalized float images (no augmentation);
    `masks` from backbones.draw_masks (drawn from the state when None)."""
    cfg = state.cfg
    if masks is None:
        masks = backbones.draw_masks(state.model, images.shape[0], state.gen_device,
                                     cfg.head_dropout)

    def loss_fn():
        logits, stats = forward_mixed(state.model, images, cfg.bf16_compute, masks,
                                      cfg.bn_momentum)
        return _focal(cfg, logits[:, 0], labels), logits[:, 0], stats

    return _metrics(_update(state, loss_fn), labels)


def draw_step(state: TrainState, n: int, big: int) -> dict:
    """The draws of one fused step, from the state's generators: the
    augmentation's, the mixup's and the dropout masks."""
    cfg = state.cfg
    size = cfg.image_size
    return {"augment": draw_augment(n, big, size, state.gen_host, state.gen_device),
            "mixup": draw_mixup(state.np_rng, n, size, size, cfg.mixup_alpha,
                                cfg.cutmix_alpha),
            "masks": backbones.draw_masks(state.model, n, state.gen_device,
                                          cfg.head_dropout)}


def draws_to(draws: dict, device) -> dict:
    """draw_step's draws moved to `device` (to feed the same draws to two
    devices)."""
    masks = draws["masks"]
    if masks is not None:
        masks = {k: [None if m is None else (m[0].to(device), m[1]) for m in v]
                 for k, v in masks.items()}
    return {"augment": {k: v.to(device) for k, v in draws["augment"].items()},
            "mixup": draws["mixup"], "masks": masks}


def fused_train_step(state: TrainState, imgs_u8: torch.Tensor, labels: torch.Tensor,
                     draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The trainer's step: the raw (B, size+20, size+20, 3) RGB u8 batch
    from the loader -> augmentation and mixup/cutmix on the device ->
    forward, focal loss on both label sets weighted by lam -> update.
    `draws` from draw_step (drawn from the state when None)."""
    cfg = state.cfg
    if draws is None:
        draws = draw_step(state, imgs_u8.shape[0], imgs_u8.shape[1])
    x = apply_augment(imgs_u8, draws["augment"], cfg.image_size)
    x, y_a, y_b, lam = apply_mixup(x, labels, draws["mixup"])

    def loss_fn():
        logits, stats = forward_mixed(state.model, x, cfg.bf16_compute, draws["masks"],
                                      cfg.bn_momentum)
        l = logits[:, 0]
        loss = lam * _focal(cfg, l, y_a) + (1 - lam) * _focal(cfg, l, y_b)
        return loss, l, stats

    return _metrics(_update(state, loss_fn), labels)


@torch.no_grad()
def eval_step(model: nn.Module, params: Dict[str, torch.Tensor],
              images: torch.Tensor) -> torch.Tensor:
    """Inference-mode fake probabilities (B,) of `model` with `params`
    (e.g. TrainState.ema_state_dict())."""
    logits = torch.func.functional_call(model, params, (images,))
    return torch.sigmoid(logits[:, 0])
