"""The --weights loader of the serving entry points, and of the detector.

Port of real_time_video_deepfake_detection_tpu/utils/weights.py: one
dispatch for every checkpoint an operator can point at, by its suffix:

- `.pth`: the reference's torch checkpoint (deepfake_detection.py:44-70),
  through utils/torch_convert; EfficientNet only.
- `.npz`: the JAX trainer's files (train/checkpoint.params_from_jax_npz):
  best_model.npz (the EMA parameters) or a resume TrainState, which serves
  its EMA parameters.
- anything else: the port trainer's files (train/checkpoint.py):
  best_model.pt, or resume_checkpoint.pt, which serves its EMA parameters
  with the live batch-norm statistics.

What validation scored and the best checkpoint holds are the EMA weights
(train.py:992-999), so a resume file serves those too.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..models import backbones
from ..models.efficientnet import EfficientNet
from ..train import checkpoint
from .convert import _check_against
from .torch_convert import load_checkpoint as load_reference_checkpoint

_META_KEYS = ("epoch", "val_acc", "config")


def read_state_dict(path: str, model: nn.Module) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(state dict for `model`, checkpoint metadata) from any of the three
    formats; keys and shapes are checked against `model`."""
    if path.endswith(".pth"):
        if not isinstance(model, EfficientNet):
            raise SystemExit("--weights *.pth is the reference torch EfficientNet format; "
                             "other backbones load the trainer's checkpoints")
        sd, meta = load_reference_checkpoint(path, model.spec)
    elif path.endswith(".npz"):
        sd, meta = checkpoint.params_from_jax_npz(path, model)
    else:
        ckpt = checkpoint.load_checkpoint(path)
        sd = ckpt["params"] if "params" in ckpt else {**ckpt["model"], **ckpt["ema"]}
        meta = ckpt.get("metadata", {})
    _check_against(sd, model, type(model).__name__)
    return sd, {k: meta[k] for k in _META_KEYS if k in meta}


def load_params_and_meta(path: str, spec) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(classifier state dict, metadata: 'epoch' / 'val_acc' / 'config'
    where the file has them) for backbone `spec`."""
    return read_state_dict(path, backbones.build_model(spec))


def load_params_any(path: Optional[str], spec) -> Optional[Dict[str, torch.Tensor]]:
    """The state dict at `path`, or None when no path is given."""
    return load_params_and_meta(path, spec)[0] if path else None
