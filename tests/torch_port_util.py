"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py):
a small EfficientNet spec built identically in both packages, parameters
made in JAX (with randomized BN statistics so features are not degenerate)
and carried into the port, and state-leaf helpers."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from real_time_video_deepfake_detection_tpu.models import efficientnet as JE
from real_time_video_deepfake_detection_tpu_torch.models import efficientnet as TE
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


def jax_state_leaves(states):
    """The JAX StreamStates leaves in the port's field order (the clip ring
    has no counterpart in this slice's port)."""
    f, t = states.forensic, states.tracker
    out = [getattr(f, x.name) for x in dataclasses.fields(f)]
    out += [getattr(t, x.name) for x in dataclasses.fields(t)]
    return [np.asarray(v) for v in out] + [np.asarray(states.frame_count)]


def assert_same(a: np.ndarray, b, atol: float, what: str = ""):
    """Integers and booleans exactly, floats within `atol`."""
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    a = np.asarray(a)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=what)
    else:
        np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=what)
