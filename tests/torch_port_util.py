"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py):
a small EfficientNet spec built identically in both packages, parameters
made in JAX (with randomized BN statistics so features are not degenerate)
and carried into the port, a tiny ViT and the clip-attention head likewise,
and state-leaf helpers."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from real_time_video_deepfake_detection_tpu.models import efficientnet as JE
from real_time_video_deepfake_detection_tpu.models import temporal_head as JT
from real_time_video_deepfake_detection_tpu.models import vit as JV
from real_time_video_deepfake_detection_tpu_torch.models import efficientnet as TE
from real_time_video_deepfake_detection_tpu_torch.models import temporal_head as TT
from real_time_video_deepfake_detection_tpu_torch.models import vit as TV
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax

# 3 blocks: expand-1 with a skip, a stride-2 k5 block, an expand-6 skip block
SMALL_BLOCKS = ((3, 1, 1, 8, 8), (5, 2, 6, 8, 16), (3, 1, 6, 16, 16))
HEAD_DIMS = (16, 8, 1)


def small_specs():
    kw = dict(variant="b0", stem_filters=8, head_filters=32, resolution=64, dropout=0.2)
    spec_j = JE.EfficientNetSpec(blocks=tuple(JE.BlockSpec(*b) for b in SMALL_BLOCKS), **kw)
    spec_t = TE.EfficientNetSpec(blocks=tuple(TE.BlockSpec(*b) for b in SMALL_BLOCKS), **kw)
    return spec_j, spec_t


def randomize_bn(params, seed: int):
    """Numpy copy of a JAX parameter tree with random BN statistics and
    affine terms (inference BN then does real work)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            if set(t) == {"scale", "bias", "mean", "var"}:
                c = np.asarray(t["mean"]).shape
                return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                        "bias": rng.normal(0, 0.2, c).astype(np.float32),
                        "mean": rng.normal(0, 0.2, c).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return np.asarray(t)
    return walk(params)


def jax_params(spec_j, seed: int, head_dims=(512, 256, 1)):
    """A JAX EfficientNet parameter tree (numpy leaves) in init_params'
    layout, drawn with numpy from `seed`: He-normal convs, uniform linears,
    random BN. jax.eval_shape gives the layout without running the init."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: JE.init_params(k, spec_j, head_dims),
                            jax.random.PRNGKey(0))

    def draw(s):
        if len(s.shape) == 4:   # HWIO
            kh, kw, _, cout = s.shape
            return rng.normal(0, (2.0 / (kh * kw * cout)) ** 0.5, s.shape)
        if len(s.shape) == 2:
            return rng.uniform(-1, 1, s.shape) / s.shape[0] ** 0.5
        return rng.normal(0, 0.05, s.shape)
    tree = jax.tree.map(lambda s: draw(s).astype(np.float32), shapes)
    return randomize_bn(tree, seed)


def small_models(seed: int = 0, head_dims=(512, 256, 1)):
    """(spec_j, params_j as numpy, torch model with the same parameters)."""
    spec_j, spec_t = small_specs()
    pj = jax_params(spec_j, seed, tuple(head_dims))
    model = TE.EfficientNet(spec_t, head_dims=head_dims)
    model.load_state_dict(params_from_jax(pj, model))
    return spec_j, pj, model.eval()


def draw_params(shapes, seed: int):
    """Numpy leaves for a JAX parameter layout (jax.eval_shape of an
    init_params): He-normal 4-d kernels over kh * kw * in, normal(0,
    1/sqrt(rows)) matrices, normal(0, 0.2) vectors (biases and LN affine
    terms, so every leaf matters)."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) == 4:
            kh, kw, cin, _ = s.shape
            return rng.normal(0, (2.0 / (kh * kw * cin)) ** 0.5, s.shape)
        if len(s.shape) >= 2:
            return rng.normal(0, 1.0 / s.shape[0] ** 0.5, s.shape)
        return rng.normal(0, 0.2, s.shape)
    return jax.tree.map(lambda s: draw(s).astype(np.float32), shapes)


def vit_models(seed: int = 0, use_cls: bool = False, ln_eps: float = 1e-6):
    """(spec_j, params_j as numpy, the port's ViT with the same parameters):
    a tiny ViT, depth 2, dim 64, heads 2, patch 16, image 64."""
    kw = dict(variant="custom", depth=2, dim=64, heads=2, mlp_ratio=4, patch=16,
              image_size=64, use_cls=use_cls, ln_eps=ln_eps)
    spec_j = JV.ViTSpec(**kw)
    shapes = jax.eval_shape(lambda k: JV.init_params(k, spec_j), jax.random.PRNGKey(0))
    pj = draw_params(shapes, seed)
    model = TV.ViT(TV.ViTSpec(**kw))
    model.load_state_dict(params_from_jax(pj, model))
    return spec_j, pj, model.eval()


def clip_head_models(spec_j, seed: int = 0):
    """(params_j as numpy, the port's TemporalHead with the same
    parameters) for a JAX TemporalHeadSpec."""
    shapes = jax.eval_shape(lambda k: JT.init_params(k, spec_j), jax.random.PRNGKey(0))
    pj = draw_params(shapes, seed)
    head = TT.TemporalHead(TT.TemporalHeadSpec(**dataclasses.asdict(spec_j)))
    head.load_state_dict(params_from_jax(pj, head))
    return pj, head.eval()


def jax_state_leaves(states):
    """The JAX StreamStates leaves in the port's field order."""
    f, t, c = states.forensic, states.tracker, states.clip
    out = [getattr(f, x.name) for x in dataclasses.fields(f)]
    out += [getattr(t, x.name) for x in dataclasses.fields(t)]
    out += [states.frame_count] + [getattr(c, x.name) for x in dataclasses.fields(c)]
    return [np.asarray(v) for v in out]


def assert_same(a: np.ndarray, b, atol: float, what: str = ""):
    """Integers and booleans exactly, floats within `atol`."""
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    a = np.asarray(a)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=what)
    else:
        np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=what)
