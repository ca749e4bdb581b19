"""GradCAM for the EfficientNet classifier (reference deepfake_detection.py:
5-7 imports pytorch_grad_cam; model.get_feature_extractor exposes
_conv_head, model.py:100-102).

Port of real_time_video_deepfake_detection_tpu/models/gradcam.py: the
gradient of the summed fake logit with respect to the map after the head
conv, batch norm and swish, averaged over the map to weight its channels;
ReLU of the weighted sum, min-max normalised per face and upsampled to the
input's size. The gradient comes from torch.autograd.grad on that map
alone: no parameter gradient is formed and no `.grad` is left on the
module.
"""

from __future__ import annotations

import torch

from ..ops.resize import resize_bilinear_f32
from .efficientnet import EfficientNet


def gradcam(model: EfficientNet, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 3) normalized RGB -> (B, H, W) heatmaps in [0, 1].
    Runs under torch.no_grad (autograd is switched on locally for the
    head), not under torch.inference_mode, whose tensors autograd refuses."""
    with torch.no_grad():
        fmap = model.feature_map(x)
    with torch.enable_grad():
        fmap.requires_grad_(True)
        logit = model.apply_head(fmap.mean(dim=(2, 3)))[:, 0].sum()
        (grads,) = torch.autograd.grad(logit, fmap)
    fmap = fmap.detach()
    weights = grads.mean(dim=(2, 3), keepdim=True)
    cam = torch.relu((fmap * weights).sum(dim=1))           # (B, H', W')
    lo = cam.amin(dim=(1, 2), keepdim=True)
    hi = cam.amax(dim=(1, 2), keepdim=True)
    cam = torch.where(hi - lo > 1e-8, (cam - lo) / (hi - lo), torch.zeros_like(cam))
    return resize_bilinear_f32(cam, x.shape[1], x.shape[2], axes=(1, 2))
