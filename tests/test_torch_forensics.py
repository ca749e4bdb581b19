"""Port parity: analyze_frame_batch of the port against the JAX package's
over a 20-frame sequence of a few streams, full analysis every 3rd frame,
with the color signal from the plain bitset path and from the unique-hue
kernel (its plain version here; the JAX kernel in interpret mode, as
analyze_frame_batch picks on the CPU). Each score within 1e-6; `full` and
`frame_number` equal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from real_time_video_deepfake_detection_tpu.ops import forensics as JF
from real_time_video_deepfake_detection_tpu.state.forensic_state import (
    forensic_state_init_batch as j_init,
)
from real_time_video_deepfake_detection_tpu_torch.ops import forensics as TF
from real_time_video_deepfake_detection_tpu_torch.state.forensic_state import (
    forensic_state_init_batch as t_init,
)

SCORES = ("frequency", "noise", "ela", "edge", "color", "temporal", "fake_probability")


def _sequence(n_frames, seed):
    """3 streams of 256x256 BGR: a textured scene drifting slowly, a
    low-contrast nearly static one, and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:256, :256]
    out = []
    for t in range(n_frames):
        a = 128 + 80 * np.sin((xx + 2 * t) / 9.0) * np.cos(yy / 13.0)
        a = np.stack([a, a * 0.8 + 20, 255 - a], -1) + rng.normal(0, 4, (256, 256, 3))
        b = 120 + rng.normal(0, 0.6, (256, 256, 3)) + 3 * np.sin(xx / 40.0)[..., None]
        c = rng.integers(0, 256, (256, 256, 3))
        out.append(np.clip(np.stack([a, b, c]), 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("use_pallas_color", [False, True])
def test_forensics_sequence_matches_jax(use_pallas_color):
    frames = _sequence(20, 5)
    n = frames[0].shape[0]
    step = jax.jit(lambda f, s, fu: JF.analyze_frame_batch(
        f, s, fu, use_pallas_color=use_pallas_color))
    js, ts = j_init(n), t_init(n)
    for t, fr in enumerate(frames):
        full = np.full(n, t % 3 == 0)
        jr, js = step(jnp.asarray(fr), js, jnp.asarray(full))
        tr, ts = TF.analyze_frame_batch(torch.from_numpy(fr), ts, torch.from_numpy(full),
                                        use_pallas_color=use_pallas_color)
        for k in SCORES:
            np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), rtol=0,
                                       atol=1e-6, err_msg=f"frame {t} {k}")
        np.testing.assert_array_equal(tr["full"].numpy(), np.asarray(jr["full"]))
        np.testing.assert_array_equal(tr["frame_number"].numpy(),
                                      np.asarray(jr["frame_number"]))
    # the sequence exercises the signals, not just zeros
    assert np.asarray(jr["temporal"]).max() > 0 and np.asarray(jr["edge"]).max() > 0


def test_fast_only_skips_full_signals():
    fr = _sequence(1, 6)[0]
    full = np.ones(fr.shape[0], bool)
    step = jax.jit(lambda f, s, fu: JF.analyze_frame_batch(f, s, fu, fast_only=True))
    jr, _ = step(jnp.asarray(fr), j_init(3), jnp.asarray(full))
    tr, _ = TF.analyze_frame_batch(torch.from_numpy(fr), t_init(3), torch.from_numpy(full),
                                   fast_only=True)
    for k in SCORES:
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), rtol=0, atol=1e-6)
    assert float(tr["noise"].abs().sum()) == 0.0
