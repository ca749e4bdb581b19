"""keras Xception weights -> the port's Xception (config-5 backbone swap).

Port of real_time_video_deepfake_detection_tpu/utils/xception_convert.py:
a keras Xception (include_top=False, random or carrying downloaded or
fine-tuned weights) becomes a state dict of models/xception.Xception,
whose pooled features then equal keras' `model.predict` with
pooling="avg".

Layouts:
  Conv2D kernels are HWIO in keras -> (out, in, kh, kw).
  SeparableConv2D depthwise kernels are (kh, kw, cin, 1) -> (cin, 1, kh, kw);
  its pointwise kernel is a 1x1 HWIO conv.
  BatchNormalization [gamma, beta, moving_mean, moving_var] -> scale, bias,
  mean, var; keras' default epsilon 1e-3 is models/xception's.
  The four residual 1x1 convs and their batch norms are keras' unnamed
  Conv2D / BatchNormalization layers, taken in model.layers order (entry
  128, 256, 728, then exit 1024), so keras' global layer-name counters
  never matter.
The fake-logit head is zero: donor backbones carry no deepfake head.

`from_keras` needs only `get_layer`, `layers` and `get_weights` of the
model; only `from_h5` imports keras.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..models.xception import Xception, XceptionSpec
from .convert import _check_against


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))   # HWIO -> OIHW


def _bn(prefix: str, layer, out: dict) -> None:
    gamma, beta, mean, var = layer.get_weights()
    out.update({prefix + "scale": gamma, prefix + "bias": beta, prefix + "mean": mean,
                prefix + "var": var})


def _sep(prefix: str, sep_layer, bn_layer, out: dict) -> None:
    dw, pw = sep_layer.get_weights()
    out[prefix + "dw"] = np.transpose(dw, (2, 3, 0, 1))   # (kh, kw, cin, 1) -> (cin, 1, kh, kw)
    out[prefix + "pw"] = _conv(pw)
    _bn(prefix + "bn.", bn_layer, out)


def from_keras(model) -> Tuple[Dict[str, torch.Tensor], XceptionSpec]:
    """keras Xception (include_top=False) -> (state dict of
    models/xception.Xception, spec)."""
    get = model.get_layer
    res_convs = [layer for layer in model.layers
                 if type(layer).__name__ == "Conv2D" and not layer.name.startswith("block")]
    res_bns = [layer for layer in model.layers
               if type(layer).__name__ == "BatchNormalization"
               and not layer.name.startswith("block")]
    if len(res_convs) != 4 or len(res_bns) != 4:
        raise ValueError(f"expected 4 unnamed residual conv/bn pairs, found "
                         f"{len(res_convs)}/{len(res_bns)}: not a stock keras Xception")
    spec = XceptionSpec()
    out: dict = {}
    for name, layer in (("conv1", "block1_conv1"), ("conv2", "block1_conv2")):
        out[name + ".w"] = _conv(get(layer).get_weights()[0])
        _bn(name + ".bn.", get(layer + "_bn"), out)
    for i, blk in enumerate((2, 3, 4)):
        for j in (1, 2):
            _sep(f"entry.{i}.sep{j}.", get(f"block{blk}_sepconv{j}"),
                 get(f"block{blk}_sepconv{j}_bn"), out)
        out[f"entry.{i}.res.w"] = _conv(res_convs[i].get_weights()[0])
        _bn(f"entry.{i}.res.bn.", res_bns[i], out)
    for i, blk in enumerate(range(5, 5 + spec.middle_blocks)):
        for j in (1, 2, 3):
            _sep(f"middle.{i}.sep{j}.", get(f"block{blk}_sepconv{j}"),
                 get(f"block{blk}_sepconv{j}_bn"), out)
    for ours, blk, j in (("sep1", 13, 1), ("sep2", 13, 2), ("sep3", 14, 1), ("sep4", 14, 2)):
        _sep(f"exit.{ours}.", get(f"block{blk}_sepconv{j}"), get(f"block{blk}_sepconv{j}_bn"),
             out)
    out["exit.res.w"] = _conv(res_convs[3].get_weights()[0])
    _bn("exit.res.bn.", res_bns[3], out)
    out["head.w"] = np.zeros((spec.feature_dim, 1), np.float32)
    out["head.b"] = np.zeros(1, np.float32)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in out.items()}
    with torch.device("meta"):
        shape_model = Xception(spec)
    _check_against(sd, shape_model, "Xception")
    return sd, spec


def from_h5(path: str) -> Tuple[Dict[str, torch.Tensor], XceptionSpec]:
    """A keras weight file (save_weights / the published .h5) -> (state
    dict, spec): loaded into a weightless keras Xception, then converted."""
    import keras
    model = keras.applications.Xception(weights=None, include_top=False,
                                        input_shape=(None, None, 3))
    model.load_weights(path)
    return from_keras(model)
