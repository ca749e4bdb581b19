"""Carry the JAX package's parameter pytree into the port's modules.

`params_from_jax` takes the nested dict/list tree of numpy arrays that
real_time_video_deepfake_detection_tpu.models.efficientnet.init_params (or
a checkpoint of it) holds, and returns the state dict of
models.efficientnet.EfficientNet. Convolution kernels go from HWIO
(kh, kw, in, out) to torch's (out, in, kh, kw); a depthwise kernel
(k, k, 1, C) becomes (C, 1, k, k) for groups=C. Every other leaf keeps its
shape (linear weights stay (in, out)).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def params_from_jax(tree, model: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """JAX parameter pytree (numpy leaves) -> state dict. With `model`, the
    keys and shapes are checked against it: a leaf the model does not have,
    or a key of the model that no leaf fills, raises."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    sd = {}
    for k, v in flat.items():
        a = np.ascontiguousarray(v.transpose(3, 2, 0, 1) if v.ndim == 4 else v)
        sd[k] = torch.from_numpy(a.astype(np.float32, copy=False).copy())
    if model is not None:
        want = model.state_dict()
        extra = sorted(set(sd) - set(want))
        missing = sorted(set(want) - set(sd))
        if extra or missing:
            raise ValueError(f"parameter tree does not match the model: "
                             f"unused leaves {extra[:5]}, missing keys {missing[:5]}")
        for k, v in sd.items():
            if tuple(v.shape) != tuple(want[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} != model "
                                 f"{tuple(want[k].shape)}")
    return sd
