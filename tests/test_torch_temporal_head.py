"""Port parity: the clip-attention temporal head (models/temporal_head.py)
against the JAX head on the same parameters, carried with
utils/convert.params_from_jax. Small spec: feature_dim 32, dim 64, depth 2,
heads 4, window 16. Logits within 1e-5; the streaming ring's counts and
positions and its features exactly, probabilities within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_video_deepfake_detection_tpu.models import temporal_head as JT
from real_time_video_deepfake_detection_tpu_torch.models import temporal_head as TT

from tests.torch_port_util import clip_head_models

SPEC = dict(feature_dim=32, dim=64, depth=2, heads=4, window=16)
TOL = 1e-5


def heads(seed: int = 0, **kw):
    """(JAX spec, JAX params as numpy, the port's head with the same
    parameters); biases and LN affine terms are random too."""
    spec_j = JT.TemporalHeadSpec(**{**SPEC, **kw})
    return (spec_j, *clip_head_models(spec_j, seed))


def _masks(b, t, rng):
    full = np.ones((b, t), bool)
    partial = rng.random((b, t)) < 0.5
    none = np.zeros((b, t), bool)
    single = np.eye(b, t, k=t - b, dtype=bool)   # one valid frame, at the end
    return {"full": full, "partial": partial, "none": none, "single": single}


@pytest.mark.parametrize("which", ["full", "partial", "none", "single"])
def test_forward_matches_jax(which):
    spec_j, pj, head = heads(seed=1)
    rng = np.random.default_rng(2)
    feats = rng.normal(0, 1, (3, 16, 32)).astype(np.float32)
    mask = _masks(3, 16, rng)[which]
    want = np.asarray(JT.forward(pj, jnp.asarray(feats), jnp.asarray(mask), spec_j))
    with torch.no_grad():
        got = head(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if which == "none":   # -1e9, not -inf: an empty clip still scores
        assert np.isfinite(got).all()


def test_streaming_ring_matches_jax():
    """Three streams over 40 pushes (more than the window of 16), with
    valid=False pushes mixed in; the verdict after every push, from the
    empty ring (n = 0) through wrap-around."""
    spec_j, pj, head = heads(seed=5)
    rng = np.random.default_rng(6)
    n_streams = 3
    push = jax.jit(jax.vmap(JT.clip_state_push))
    verdict = jax.jit(jax.vmap(lambda s: JT.clip_verdict(pj, s, spec_j)))
    sj = jax.vmap(lambda _: JT.clip_state_init(spec_j))(jnp.arange(n_streams))
    st = TT.clip_state_init(n_streams, 16, 32)
    with torch.no_grad():
        p0 = TT.clip_verdict(head, st).numpy()
    np.testing.assert_allclose(p0, np.asarray(verdict(sj)), rtol=0, atol=TOL)
    assert np.isfinite(p0).all()
    for t in range(40):
        feat = rng.normal(0, 1, (n_streams, 32)).astype(np.float32)
        valid = rng.random(n_streams) < 0.7
        valid[2] = False             # stream 2 never gets a frame: n stays 0
        sj = push(sj, jnp.asarray(feat), jnp.asarray(valid))
        st = TT.clip_state_push(st, torch.from_numpy(feat), torch.from_numpy(valid))
        for f in dataclasses.fields(st):
            a, b = np.asarray(getattr(sj, f.name)), getattr(st, f.name).numpy()
            if f.name == "feats":
                np.testing.assert_allclose(b, a, rtol=0, atol=0)
            else:
                np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=f"push {t} {f.name}")
        with torch.no_grad():
            got = TT.clip_verdict(head, st).numpy()
        np.testing.assert_allclose(got, np.asarray(verdict(sj)), rtol=0, atol=TOL,
                                   err_msg=f"push {t}")
    assert int(st.n[0]) == 16 and int(st.n[2]) == 0   # wrapped, and still empty


def test_default_head_spec_empty_ring_is_finite():
    """The serving default (feature_dim 384, dim 256, depth 2, heads 4,
    window 64) on an empty ring and after one push: finite probabilities
    equal to JAX's on the same parameters."""
    kw = dict(feature_dim=384, dim=256, depth=2, heads=4, window=64)
    spec_j, pj, head = heads(seed=7, **kw)
    sj = JT.clip_state_init(spec_j)
    st = TT.clip_state_init(1, 64, 384)
    feat = np.random.default_rng(8).normal(0, 1, (384,)).astype(np.float32)
    for pushed in (False, True):
        if pushed:
            sj = JT.clip_state_push(sj, jnp.asarray(feat))
            st = TT.clip_state_push(st, torch.from_numpy(feat)[None], torch.tensor([True]))
        want = float(JT.clip_verdict(pj, sj, spec_j))
        with torch.no_grad():
            got = float(TT.clip_verdict(head, st)[0])
        assert np.isfinite(got) and abs(got - want) <= TOL, (pushed, got, want)
