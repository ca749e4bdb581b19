"""Carry the JAX package's parameter pytree into the port's modules.

`params_from_jax` takes the nested dict/list tree of numpy arrays that an
init_params of the JAX package (or a checkpoint of it) holds, and returns
the state dict of the port's module: models.efficientnet.EfficientNet,
models.vit.ViT, models.xception.Xception or models.temporal_head.
TemporalHead. Convolution kernels go from HWIO (kh, kw, in, out) to
torch's (out, in, kh, kw); a depthwise kernel (k, k, 1, C) becomes
(C, 1, k, k) for groups=C. The ViT's qkv kernel (dim, 3, heads, hd) and
bias (3, heads, hd) are flattened to (dim, 3 * dim) and (3 * dim,), their
output axis kept in (3, heads, hd) order. Every other leaf keeps its shape
(linear weights stay (in, out); the ViT's patch kernel keeps its
(py, px, c) row order, which models/vit.py patchifies in).

`mtcnn_state_dicts_from_jax` takes the JAX package's MTCNN parameter tree
({"pnet", "rnet", "onet"}, as models/mtcnn.init_random_mtcnn or
convert_facenet_state_dict make it) and returns facenet-pytorch-keyed state
dicts of models/mtcnn's nets: HWIO convolutions to OIHW, dense (in, out) to
(out, in), PReLU (1, 1, 1, C) or (1, C) to (C,).
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
        if k.endswith("qkv.w") and v.ndim == 4:     # ViT (dim, 3, heads, hd)
            v = v.reshape(v.shape[0], -1)
        elif k.endswith("qkv.b") and v.ndim == 3:   # ViT (3, heads, hd)
            v = v.reshape(-1)
        a = np.ascontiguousarray(v.transpose(3, 2, 0, 1) if v.ndim == 4 else v)
        sd[k] = torch.from_numpy(a.astype(np.float32, copy=False).copy())
    if model is not None:
        _check_against(sd, model, type(model).__name__)
    return sd


def _check_against(sd: Dict[str, torch.Tensor], model: nn.Module, what: str) -> None:
    """A leaf the model does not have, a key of the model that no leaf
    fills, or a shape that differs raises."""
    want = model.state_dict()
    extra = sorted(set(sd) - set(want))
    missing = sorted(set(want) - set(sd))
    if extra or missing:
        raise ValueError(f"{what}: parameter tree does not match the model: "
                         f"unused leaves {extra[:5]}, missing keys {missing[:5]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{what} {k}: shape {tuple(v.shape)} != model "
                             f"{tuple(want[k].shape)}")


def mtcnn_state_dicts_from_jax(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX MTCNN parameter tree (numpy or JAX leaves) -> {"pnet", "rnet",
    "onet"} facenet-keyed state dicts, each checked against its module."""
    from ..models.mtcnn import NET_CLASSES, NETS
    out = {}
    for net in NETS:
        sd = {}
        for name, leaf in tree[net].items():
            if isinstance(leaf, dict):   # conv or dense: {"w", "b"}
                w = np.asarray(leaf["w"], np.float32)
                w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
                sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
                sd[f"{name}.bias"] = torch.from_numpy(np.array(leaf["b"], np.float32))
            else:                        # PReLU slope
                sd[f"{name}.weight"] = torch.from_numpy(
                    np.array(leaf, np.float32).reshape(-1))
        out[net] = sd
    for net in NETS:
        _check_against(out[net], NET_CLASSES[net](), net)
    return out
