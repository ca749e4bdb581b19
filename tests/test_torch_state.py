"""Port parity: the batched tracker and forensic state of
real_time_video_deepfake_detection_tpu_torch.state against the vmapped JAX
reducers, over random probability sequences with mixed `valid` masks.

Every integer leaf, the votes and the verdicts are compared exactly, and so
are the score and variance rings (the port sums the 5-score window left to
right, the order XLA's CPU reduction takes over so short a window). The
60-score averages (temporal_average, stability) are reductions whose order
differs between XLA and torch, so they are held to 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from real_time_video_deepfake_detection_tpu.ops import forensics as JF
from real_time_video_deepfake_detection_tpu.state import tracker as JT
from real_time_video_deepfake_detection_tpu.state.forensic_state import (
    forensic_state_init_batch as j_forensic_init,
)
from real_time_video_deepfake_detection_tpu_torch.core.config import TrackerConfig
from real_time_video_deepfake_detection_tpu_torch.ops import forensics as TF
from real_time_video_deepfake_detection_tpu_torch.state import (
    forensic_state_init_batch, forensic_state_reset, tracker_init_batch,
    tracker_reset, tracker_stability, tracker_temporal_average,
    tracker_update, tracker_verdict, tracker_voting_stats,
)
from real_time_video_deepfake_detection_tpu_torch.state.tree import tree_leaves

TRACKER_FIELDS = ("scores", "n_scores", "score_pos", "votes", "n_votes",
                  "vote_pos", "var_hist", "n_var", "var_pos")


@jax.jit
def _j_step(state, prob, valid, thr):
    s = jax.vmap(JT.tracker_update, in_axes=(0, 0, 0, None))(state, prob, valid, thr)
    fake, real, total = jax.vmap(JT.tracker_voting_stats)(s)
    return s, (jax.vmap(JT.tracker_verdict)(s), jax.vmap(JT.tracker_temporal_average)(s),
               jax.vmap(JT.tracker_stability)(s), fake, real, total)


@pytest.mark.parametrize("threshold,seed", [(0.5, 0), (0.55, 1), (0.3, 2)])
def test_tracker_matches_vmapped_jax(threshold, seed):
    rng = np.random.default_rng(seed)
    n, steps = 7, 75   # past the 60-score ring and the 30-entry variance ring
    js = JT.tracker_init_batch(n)
    ts = tracker_init_batch(n, TrackerConfig())
    for t in range(steps):
        prob = rng.random(n).astype(np.float32)
        prob[0] = threshold   # exactly at the threshold votes REAL (strict >)
        valid = rng.random(n) < 0.7
        valid[1] = True
        js, jo = _j_step(js, jnp.asarray(prob), jnp.asarray(valid), threshold)
        ts = tracker_update(ts, torch.from_numpy(prob), torch.from_numpy(valid), threshold)
        for f in TRACKER_FIELDS:
            a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f"step {t} {f}")
        fake, real, total = tracker_voting_stats(ts)
        for a, b in zip(jo[3:], (fake, real, total)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(tracker_verdict(ts).numpy(), np.asarray(jo[0]))
        np.testing.assert_allclose(tracker_temporal_average(ts).numpy(),
                                   np.asarray(jo[1]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tracker_stability(ts).numpy(),
                                   np.asarray(jo[2]), rtol=0, atol=1e-6)
    assert (np.asarray(jo[0]) != JT.VERDICT_UNCERTAIN).any()


def test_tracker_tie_is_real_and_uncertain_until_window():
    n = 1
    ts = tracker_init_batch(n)
    seq = [0.1, 0.9] * 5
    for i, p in enumerate(seq):
        ts = tracker_update(ts, torch.tensor([p]), torch.tensor([True]), 0.5)
        want = JT.VERDICT_UNCERTAIN if i < 9 else JT.VERDICT_REAL   # 5-5 tie
        assert int(tracker_verdict(ts)[0]) == want
    ts = tracker_update(ts, torch.tensor([0.9]), torch.tensor([True]), 0.5)
    assert int(tracker_verdict(ts)[0]) == JT.VERDICT_FAKE   # window slides: 6-4
    before = [x.clone() for x in tree_leaves(ts)]
    ts = tracker_update(ts, torch.tensor([0.1]), torch.tensor([False]), 0.5)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(ts)))
    assert all(int(x.abs().sum()) == 0 for x in tree_leaves(tracker_reset(ts)))


def test_forensic_state_init_and_reset_match_jax():
    js = j_forensic_init(3)
    ts = forensic_state_init_batch(3)
    names = ("prev_gray", "has_prev", "diffs", "n_diffs", "diff_pos", "frame_count")
    for name, b in zip(names, tree_leaves(ts)):
        a = np.asarray(getattr(js, name))
        assert a.shape == tuple(b.shape) and a.dtype == b.numpy().dtype, name
    ts.n_diffs += 3
    assert all(int(x.to(torch.float32).abs().sum()) == 0
               for x in tree_leaves(forensic_state_reset(ts)))


def test_forensic_state_evolution_matches_jax():
    """The temporal signal's state over a gray-frame sequence: the ring
    positions, counts and previous frame exactly; the stored mean |diff|
    values within 1e-6 (a 4096-pixel mean, reduced in another order)."""
    rng = np.random.default_rng(3)
    n, h = 3, 64
    from real_time_video_deepfake_detection_tpu.core.config import ForensicConfig as JC
    from real_time_video_deepfake_detection_tpu_torch.core.config import ForensicConfig as TC
    js = j_forensic_init(n, JC(analysis_size=(h, h), temporal_window=6))
    ts = forensic_state_init_batch(n, TC(analysis_size=(h, h), temporal_window=6))
    step = jax.jit(jax.vmap(JF.temporal_score))
    base = rng.integers(0, 256, (n, h, h)).astype(np.float32)
    for t in range(14):
        gray = np.clip(base + rng.normal(0, 2 + t % 3, base.shape), 0, 255).round()
        gray = gray.astype(np.float32)
        count = np.full(n, t + 1, np.int32)
        js_score, js = step(jnp.asarray(gray), js, jnp.asarray(count))
        ts_score, ts = TF.temporal_score(torch.from_numpy(gray), ts, torch.from_numpy(count))
        np.testing.assert_array_equal(ts_score.numpy(), np.asarray(js_score))
        for name in ("prev_gray", "has_prev", "n_diffs", "diff_pos", "frame_count"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)), err_msg=name)
        np.testing.assert_allclose(ts.diffs.numpy(), np.asarray(js.diffs),
                                   rtol=1e-6, atol=0)
