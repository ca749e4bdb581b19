"""Port parity: the temporal head's long-clip scan, TemporalHead.
forward_blockwise, against the JAX head's forward_blockwise on the same
parameters (tests/torch_port_util.clip_head_models). JAX's own test's
spec (feature_dim 16, dim 32, depth 1, heads 2, window 64), three streams,
logits within 1e-5. The cases: JAX's T = 300 with block 128 (capped at
63), a clip shorter than one block, a masked tail, a window whose frames
are all masked (after a valid one, and as the first window, where it
attends uniformly), and a block far above the window."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_video_deepfake_detection_tpu.models import temporal_head as JT

from tests.torch_port_util import clip_head_models

SPEC = dict(feature_dim=16, dim=32, depth=1, heads=2, window=64)
TOL = 1e-5


def _mask(case: str, t: int, rng) -> np.ndarray:
    m = np.ones((3, t), bool)
    m[1] = rng.random(t) < 0.7
    if case == "masked_tail":
        m[:, t - 70:] = False
    elif case == "masked_window":
        m[0, 50:100] = False          # the second window: keeps the context
        m[2, :50] = False             # the first window: no context yet
    return m


@pytest.mark.parametrize("case,t,block", [
    ("jax_test", 300, 128), ("below_block", 40, 63), ("masked_tail", 200, 63),
    ("masked_window", 200, 50), ("block_over_window", 150, 1000)])
def test_forward_blockwise_matches_jax(case, t, block):
    spec_j = JT.TemporalHeadSpec(**SPEC)
    pj, head = clip_head_models(spec_j, seed=3)
    rng = np.random.default_rng(11)
    feats = rng.normal(0, 1, (3, t, SPEC["feature_dim"])).astype(np.float32)
    mask = _mask(case, t, rng)
    want = np.asarray(JT.forward_blockwise(pj, jnp.asarray(feats), jnp.asarray(mask),
                                           spec_j, block=block))
    with torch.no_grad():
        got = head.forward_blockwise(torch.from_numpy(feats), torch.from_numpy(mask),
                                     block=block).numpy()
    assert got.shape == (3,) and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
