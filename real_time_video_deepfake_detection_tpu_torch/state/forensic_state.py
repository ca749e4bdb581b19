"""Per-stream forensic analyzer state as batched tensors.

Port of real_time_video_deepfake_detection_tpu/state/forensic_state.py:
the reference's mutable analyzer fields (frame_analysis.py:34-37:
`prev_frame_gray`, `temporal_diffs` deque(30), `frame_count`) with a
leading stream axis.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from ..core.config import ForensicConfig
from .tree import tree_map


@dataclasses.dataclass
class ForensicState:
    prev_gray: torch.Tensor    # f32[N, H, W] previous analysis-size gray frame
    has_prev: torch.Tensor     # bool[N]
    diffs: torch.Tensor        # f32[N, temporal_window] ring of mean |frame diffs|
    n_diffs: torch.Tensor      # i32[N]
    diff_pos: torch.Tensor     # i32[N]
    frame_count: torch.Tensor  # i32[N] analyzer frame counter


def forensic_state_init_batch(n_streams: int, cfg: ForensicConfig = ForensicConfig(),
                              device: Union[str, torch.device] = "cpu") -> ForensicState:
    h, w = cfg.analysis_size

    def z(*shape, dtype=torch.int32):
        return torch.zeros((n_streams,) + shape, dtype=dtype, device=device)
    return ForensicState(
        prev_gray=z(h, w, dtype=torch.float32),
        has_prev=z(dtype=torch.bool),
        diffs=z(cfg.temporal_window, dtype=torch.float32),
        n_diffs=z(), diff_pos=z(), frame_count=z())


def forensic_state_reset(state: ForensicState) -> ForensicState:
    return tree_map(torch.zeros_like, state)
