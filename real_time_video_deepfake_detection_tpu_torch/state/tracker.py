"""Temporal voting tracker as batched ring-buffer tensors.

Port of real_time_video_deepfake_detection_tpu/state/tracker.py. Every
field carries a leading stream axis (N, ...), and the reducers are pure
functions over the whole batch, where the JAX package vmaps single-stream
reducers. Reference semantics kept exactly (deepfake_detection.py:93-289):

  - `valid=False` is a no-op (the reference's update(None), and the
    padded-slot mask of the batched tick)
  - a frame votes FAKE iff prob STRICTLY > detection_threshold; votes are
    an int8 ring
  - verdict is UNCERTAIN until `voting_window` votes are collected, then
    the majority of the window, a tie giving REAL
  - temporal_average = mean of the score history, 0.0 when empty
  - stability = 0.0 below 10 scores, else 1 - min(4*var, 1)
  - variance_history appends the population variance of the last 5 scores
    once 5 or more are collected
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple, Union

import torch

from ..core.config import TrackerConfig
from .tree import tree_map

VERDICT_UNCERTAIN = -1
VERDICT_REAL = 0
VERDICT_FAKE = 1

VERDICT_NAMES = {VERDICT_UNCERTAIN: "UNCERTAIN", VERDICT_REAL: "REAL",
                 VERDICT_FAKE: "FAKE"}


@dataclasses.dataclass
class TrackerState:
    scores: torch.Tensor     # f32[N, window_size] ring of fake probabilities
    n_scores: torch.Tensor   # i32[N] valid count (saturates at window_size)
    score_pos: torch.Tensor  # i32[N] next write index
    votes: torch.Tensor      # i8[N, voting_window] ring (1=FAKE, 0=REAL)
    n_votes: torch.Tensor    # i32[N]
    vote_pos: torch.Tensor   # i32[N]
    var_hist: torch.Tensor   # f32[N, variance_window] ring of 5-score variances
    n_var: torch.Tensor      # i32[N]
    var_pos: torch.Tensor    # i32[N]


def tracker_init_batch(n_streams: int, cfg: TrackerConfig = TrackerConfig(),
                       device: Union[str, torch.device] = "cpu") -> TrackerState:
    def z(*shape, dtype=torch.int32):
        return torch.zeros((n_streams,) + shape, dtype=dtype, device=device)
    return TrackerState(
        scores=z(cfg.window_size, dtype=torch.float32),
        n_scores=z(), score_pos=z(),
        votes=z(cfg.voting_window, dtype=torch.int8),
        n_votes=z(), vote_pos=z(),
        var_hist=z(cfg.variance_window, dtype=torch.float32),
        n_var=z(), var_pos=z(),
    )


def tracker_reset(state: TrackerState) -> TrackerState:
    return tree_map(torch.zeros_like, state)


def _ordered_window(buf: torch.Tensor, n: torch.Tensor, pos: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Last min(n, k) entries of each ring, oldest first, padded on the
    left, plus the validity mask. (N, k) each."""
    cap = buf.shape[1]
    m = torch.clamp(n, max=k)
    i = torch.arange(k, device=buf.device)
    idx = torch.remainder(pos[:, None] - m[:, None] + i, cap)
    return torch.gather(buf, 1, idx.long()), i < m[:, None]


def _push(buf: torch.Tensor, n: torch.Tensor, pos: torch.Tensor,
          value: torch.Tensor, do: torch.Tensor):
    """Where `do`, write `value` at `pos` of each ring. Returns (buf, n, pos)."""
    cap = buf.shape[1]
    new_buf = buf.scatter(1, pos[:, None].long(), value.to(buf.dtype)[:, None])
    buf = torch.where(do[:, None], new_buf, buf)
    n = torch.where(do, torch.clamp(n + 1, max=cap), n)
    pos = torch.where(do, torch.remainder(pos + 1, cap), pos)
    return buf, n, pos


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right — the order XLA's CPU
    reduction takes over windows this short, so ring statistics built from
    it match the JAX reducers to the bit."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def tracker_update(state: TrackerState, fake_probability: torch.Tensor,
                   valid: torch.Tensor,
                   detection_threshold: float = 0.5) -> TrackerState:
    """One update of every stream; `valid` (bool[N]) masks the no-ops."""
    prob = fake_probability.to(torch.float32)
    scores, n_scores, score_pos = _push(
        state.scores, state.n_scores, state.score_pos, prob, valid)

    # variance of the most recent 5 scores, on the post-push history
    recent, rmask = _ordered_window(scores, n_scores, score_pos, 5)
    rcount = torch.clamp(rmask.sum(1, dtype=torch.int32), min=1)
    zero = torch.zeros((), dtype=torch.float32, device=prob.device)
    rmean = _seq_sum(torch.where(rmask, recent, zero)) / rcount
    rvar = _seq_sum(torch.where(rmask, (recent - rmean[:, None]) ** 2, zero)) / rcount
    push_var = valid & (n_scores >= 5)
    var_hist, n_var, var_pos = _push(
        state.var_hist, state.n_var, state.var_pos, rvar, push_var)

    vote = (prob > detection_threshold).to(torch.int8)
    votes, n_votes, vote_pos = _push(
        state.votes, state.n_votes, state.vote_pos, vote, valid)
    return TrackerState(
        scores=scores, n_scores=n_scores, score_pos=score_pos,
        votes=votes, n_votes=n_votes, vote_pos=vote_pos,
        var_hist=var_hist, n_var=n_var, var_pos=var_pos)


def tracker_verdict(state: TrackerState) -> torch.Tensor:
    """int32[N]: -1 UNCERTAIN (window not yet full), 0 REAL (incl. tie),
    1 FAKE."""
    cap = state.votes.shape[1]
    fake = state.votes.sum(1, dtype=torch.int32)
    real = state.n_votes - fake
    majority = (fake > real).to(torch.int32)        # FAKE=1, REAL=0
    uncertain = torch.full_like(majority, VERDICT_UNCERTAIN)
    return torch.where(state.n_votes < cap, uncertain, majority)


def tracker_voting_stats(state: TrackerState):
    """(fake_count, real_count, total), each int32[N]."""
    fake = state.votes.sum(1, dtype=torch.int32)
    total = state.n_votes
    return fake, total - fake, total


def _chron(state: TrackerState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score history oldest first, padded at the tail, and its mask."""
    cap = state.scores.shape[1]
    i = torch.arange(cap, device=state.scores.device)
    idx = torch.remainder(state.score_pos[:, None] - state.n_scores[:, None] + i, cap)
    return torch.gather(state.scores, 1, idx.long()), i < state.n_scores[:, None]


def tracker_temporal_average(state: TrackerState) -> torch.Tensor:
    n = state.n_scores
    vals, mask = _chron(state)
    s = torch.where(mask, vals, torch.zeros((), device=vals.device)).sum(1)
    avg = s / torch.clamp(n, min=1)
    return torch.where(n == 0, torch.zeros_like(avg), avg).to(torch.float32)


def tracker_stability(state: TrackerState) -> torch.Tensor:
    n = state.n_scores
    vals, mask = _chron(state)
    zero = torch.zeros((), device=vals.device)
    nf = torch.clamp(n, min=1).to(torch.float32)
    mean = torch.where(mask, vals, zero).sum(1) / nf
    var = torch.where(mask, (vals - mean[:, None]) ** 2, zero).sum(1) / nf
    stab = 1.0 - torch.clamp(var * 4.0, max=1.0)
    return torch.where(n < 10, torch.zeros_like(stab), stab).to(torch.float32)


def tracker_weighted_average(state: TrackerState) -> torch.Tensor:
    """np.linspace(0.5, 1.0, n) recency weighting of the score history
    (deepfake_detection.py:204-212); 0.0 when empty. (N,) f32."""
    cap = state.scores.shape[1]
    n = state.n_scores
    vals, mask = _chron(state)
    i = torch.arange(cap, dtype=torch.float32, device=vals.device)
    nf = torch.clamp(n, min=1).to(torch.float32)[:, None]
    w = torch.where(n[:, None] > 1, 0.5 + 0.5 * i / torch.clamp(nf - 1.0, min=1.0),
                    torch.full_like(nf, 0.5))
    zero = torch.zeros((), device=vals.device)
    num = torch.where(mask, vals * w, zero).sum(1)
    den = torch.where(mask, w, zero).sum(1)
    avg = num / torch.clamp(den, min=1e-30)
    return torch.where(n == 0, torch.zeros_like(avg), avg).to(torch.float32)


def tracker_anomaly_score(state: TrackerState) -> torch.Tensor:
    """min(10 * mean(variance history), 1); 0.0 below 10 entries
    (deepfake_detection.py:223-233). (N,) f32."""
    cap = state.var_hist.shape[1]
    n = state.n_var
    mask = torch.arange(cap, device=n.device) < n[:, None]
    zero = torch.zeros((), device=n.device)
    mean = torch.where(mask, state.var_hist, zero).sum(1) / torch.clamp(n, min=1)
    score = torch.clamp(mean * 10.0, max=1.0)
    return torch.where(n < 10, torch.zeros_like(score), score).to(torch.float32)


class TemporalTracker:
    """Single-stream wrapper with the reference's Python API
    (deepfake_detection.py:93-289) over a one-stream TrackerState on
    `device`, for the single-stream detector; the batched serving tick uses
    the functions above directly."""

    def __init__(self, window_size: int = 60, high_confidence_threshold: float = 0.6,
                 voting_window: int = 10, detection_threshold: float = 0.5,
                 device: Union[str, torch.device] = "cpu"):
        self.cfg = TrackerConfig(window_size=window_size, voting_window=voting_window,
                                 detection_threshold=detection_threshold,
                                 high_confidence_threshold=high_confidence_threshold)
        self.detection_threshold = detection_threshold
        self.high_confidence_threshold = high_confidence_threshold
        self.window_size = window_size
        self.voting_window = voting_window
        self.last_alert_time = 0.0
        self.alert_cooldown = self.cfg.alert_cooldown
        self.device = torch.device(device)
        self.state = tracker_init_batch(1, self.cfg, self.device)
        self._valid = torch.ones(1, dtype=torch.bool, device=self.device)

    def update(self, fake_probability) -> None:
        if fake_probability is None:   # reference :122-124
            return
        prob = torch.tensor([float(fake_probability)], dtype=torch.float32, device=self.device)
        self.state = tracker_update(self.state, prob, self._valid, float(self.detection_threshold))

    def _stats(self) -> tuple:
        """(verdict, temporal average, weighted average, stability, anomaly,
        fake votes, real votes, total votes), in one device-to-host copy."""
        s = self.state
        fake, real, total = tracker_voting_stats(s)
        vals = [tracker_verdict(s), tracker_temporal_average(s), tracker_weighted_average(s),
                tracker_stability(s), tracker_anomaly_score(s), fake, real, total]
        return tuple(torch.stack([v[0].to(torch.float64) for v in vals]).cpu().tolist())

    def get_confidence_level(self) -> str:
        return VERDICT_NAMES[int(self._stats()[0])]

    @property
    def current_verdict(self):
        v = int(self._stats()[0])
        return None if v == VERDICT_UNCERTAIN else VERDICT_NAMES[v]

    def get_temporal_average(self) -> float:
        return self._stats()[1]

    def get_weighted_average(self) -> float:
        return self._stats()[2]

    def get_stability_score(self) -> float:
        return self._stats()[3]

    def detect_anomalies(self) -> float:
        return self._stats()[4]

    def get_voting_stats(self) -> dict:
        s = self._stats()
        return {"fake_count": int(s[5]), "real_count": int(s[6]), "total_frames": int(s[7])}

    @property
    def history_length(self) -> int:
        return int(self.state.n_scores[0])

    def should_trigger_forensic_analysis(self, now: Optional[float] = None) -> bool:
        """Forensic-trigger cooldown (reference :235-250); the wall clock
        stays on the host."""
        if self.history_length < self.window_size // 2:
            return False
        now = time.time() if now is None else now
        if (self.get_temporal_average() > self.high_confidence_threshold
                and self.get_stability_score() > 0.7
                and now - self.last_alert_time > self.alert_cooldown):
            self.last_alert_time = now
            return True
        return False

    def reset(self) -> None:
        self.state = tracker_reset(self.state)
        self.last_alert_time = 0.0
