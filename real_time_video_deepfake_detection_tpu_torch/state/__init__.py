from .tracker import (
    TrackerState,
    tracker_init_batch,
    tracker_update,
    tracker_verdict,
    tracker_temporal_average,
    tracker_stability,
    tracker_voting_stats,
    tracker_reset,
    VERDICT_UNCERTAIN,
    VERDICT_REAL,
    VERDICT_FAKE,
    VERDICT_NAMES,
)
from .forensic_state import (
    ForensicState, forensic_state_init_batch, forensic_state_reset,
)

__all__ = [
    "TrackerState",
    "tracker_init_batch",
    "tracker_update",
    "tracker_verdict",
    "tracker_temporal_average",
    "tracker_stability",
    "tracker_voting_stats",
    "tracker_reset",
    "VERDICT_UNCERTAIN",
    "VERDICT_REAL",
    "VERDICT_FAKE",
    "VERDICT_NAMES",
    "ForensicState",
    "forensic_state_init_batch",
    "forensic_state_reset",
]
