"""The rank functions of the data-parallel tests (tests/test_torch_dp_train.py),
run by parallel/mesh.spawn in processes of their own: it imports torch and
the port only, so that a rank starts without JAX."""

from __future__ import annotations

import time

import torch

from real_time_video_deepfake_detection_tpu_torch.models import efficientnet as TE
from real_time_video_deepfake_detection_tpu_torch.parallel import mesh
from real_time_video_deepfake_detection_tpu_torch.train import steps as TS


def run_steps(device, which, spec, head_dims, state_dict, cfg, total, x, labels, draws):
    """This rank's steps of make_sharded_train_step(TS.<which>) on its
    shard of the global batch (x, labels: numpy), one per entry of `draws`
    (fused_train_step's draws of the global batch, train_step's masks, or
    None: drawn from the state). Returns each step's metrics and the
    final parameters, statistics, EMA and counters, on the CPU."""
    model = TE.EfficientNet(spec, head_dims=head_dims)
    model.load_state_dict(state_dict)
    state = TS.init_train_state(model.to(device), spec, cfg, total, seed=0)
    step = TS.make_sharded_train_step(getattr(TS, which))
    b = len(x) // mesh.world_size()
    rows = slice(mesh.rank() * b, (mesh.rank() + 1) * b)
    xs = torch.from_numpy(x[rows]).to(device)
    ys = torch.from_numpy(labels[rows]).to(device)
    metrics = []
    for d in draws:
        m = step(state, xs, ys, d)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "rank": mesh.rank(),
            "model": {k: v.cpu() for k, v in state.model.state_dict().items()},
            "ema": {k: v.cpu() for k, v in state.ema.items()},
            "step": state.step, "count": state.count}


def fail_on_rank(device, bad, hang):
    """Rank `bad` raises, or with `hang` never returns; the others return
    their rank."""
    if mesh.rank() == bad:
        if hang:
            time.sleep(3600)
        raise ValueError("this rank fails")
    return mesh.rank()
