"""transformers ViT checkpoint -> the port's ViT (config-5 backbone swap).

Port of real_time_video_deepfake_detection_tpu/utils/vit_convert.py: a
HuggingFace `ViTModel` state dict (google/vit-base-patch16-224 and kin, or
a fine-tuned one) becomes a state dict of models/vit.ViT, whose encoder
output then equals `ViTModel.forward().last_hidden_state`.

Why the spec flips for donor weights:
  - HF ViT prepends a [CLS] token and takes it as the representation ->
    spec.use_cls=True (the pos table is (n_patches + 1, dim), row 0 = CLS)
  - HF layer_norm_eps defaults to 1e-12 (the port's ViT 1e-6) -> carried
    into the spec
  - HF hidden_act "gelu" is the exact erf GELU, as models/vit.py uses

`from_transformers` takes any object with `.config` and `.state_dict()`;
only `from_pretrained`, which reads a local checkpoint directory, imports
transformers.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.vit import ViT, ViTSpec
from .convert import _check_against


def _t(x) -> np.ndarray:
    """torch tensor / array -> numpy f32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def convert_vit_state_dict(sd: Dict[str, Any], *, hidden_size: int, num_layers: int,
                           num_heads: int, patch: int, image_size: int, mlp_dim: int,
                           ln_eps: float = 1e-12
                           ) -> Tuple[Dict[str, torch.Tensor], ViTSpec]:
    """HF ViTModel state dict -> (state dict of models/vit.ViT, spec). The
    binary fake-logit head is zero: donor backbones carry no deepfake
    head."""
    d = hidden_size
    if mlp_dim != 4 * d:
        raise ValueError(f"mlp_dim {mlp_dim} != 4*hidden ({4 * d}): "
                         "models/vit.py assumes the standard 4x MLP")
    variant = {384: "s16", 768: "b16", 1024: "l16"}.get(d, "custom")
    spec = ViTSpec(variant, num_layers, d, num_heads, 4, patch, image_size,
                   use_cls=True, ln_eps=ln_eps)

    g = lambda k: _t(sd[k])
    proj = g("embeddings.patch_embeddings.projection.weight")   # (D, 3, P, P)
    out = {
        # the conv projection as a matmul over (py, px, c)-flattened patches
        "patch.w": proj.transpose(2, 3, 1, 0).reshape(patch * patch * 3, d),
        "patch.b": g("embeddings.patch_embeddings.projection.bias"),
        "cls": g("embeddings.cls_token").reshape(d),
        "pos": g("embeddings.position_embeddings").reshape(-1, d),
        "final_ln.scale": g("layernorm.weight"),
        "final_ln.bias": g("layernorm.bias"),
        "head.w": np.zeros((d, 1), np.float32),
        "head.b": np.zeros(1, np.float32),
    }
    for i in range(num_layers):
        p = f"encoder.layer.{i}."
        att = (p + "attention.attention." if p + "attention.attention.query.weight" in sd
               else p + "attention.self.")
        b = f"blocks.{i}."
        # torch Linear weights are (out, in), the out axis (head, hd)-major
        out[b + "qkv.w"] = np.concatenate(
            [g(att + f"{n}.weight") for n in ("query", "key", "value")]).T
        out[b + "qkv.b"] = np.concatenate(
            [g(att + f"{n}.bias") for n in ("query", "key", "value")])
        for ours, theirs in (("ln1", "layernorm_before"), ("ln2", "layernorm_after")):
            out[b + ours + ".scale"] = g(p + theirs + ".weight")
            out[b + ours + ".bias"] = g(p + theirs + ".bias")
        for ours, theirs in (("proj", "attention.output.dense"),
                             ("mlp1", "intermediate.dense"), ("mlp2", "output.dense")):
            out[b + ours + ".w"] = g(p + theirs + ".weight").T
            out[b + ours + ".b"] = g(p + theirs + ".bias")
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}
    with torch.device("meta"):
        model = ViT(spec)
    _check_against(out, model, "ViT")
    return out, spec


def from_transformers(model) -> Tuple[Dict[str, torch.Tensor], ViTSpec]:
    """transformers.ViTModel (or ViTForImageClassification.vit) instance ->
    (state dict, spec)."""
    cfg = model.config
    return convert_vit_state_dict(
        dict(model.state_dict()), hidden_size=cfg.hidden_size,
        num_layers=cfg.num_hidden_layers, num_heads=cfg.num_attention_heads,
        patch=cfg.patch_size, image_size=cfg.image_size, mlp_dim=cfg.intermediate_size,
        ln_eps=cfg.layer_norm_eps)


def from_pretrained(path: str) -> Tuple[Dict[str, torch.Tensor], ViTSpec]:
    """A local transformers ViT directory (save_pretrained) -> (state dict,
    spec); transformers is imported here only."""
    from transformers import ViTModel
    return from_transformers(ViTModel.from_pretrained(path))
