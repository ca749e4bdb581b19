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


def dcp_resume(device, spec, head_dims, state_dict, cfg, total, x, labels, ckdir):
    """One step of make_sharded_train_step(fused_train_step) on this rank's
    shard, then save_checkpoint_dcp of the train state, a fresh state
    (other weights) restored from it through a template, and one more step
    of both the live state and the restored one. Returns both second
    steps' metrics and parameters, on the CPU."""
    from real_time_video_deepfake_detection_tpu_torch.train import checkpoint as CK

    def state_from(seed):
        model = TE.EfficientNet(spec, head_dims=head_dims,
                                generator=torch.Generator().manual_seed(seed))
        return TS.init_train_state(model.to(device), spec, cfg, total, seed=seed)

    live = state_from(1)
    live.model.load_state_dict(state_dict)
    live.ema = {k: p.detach().clone() for k, p in live.model.named_parameters()}
    step = TS.make_sharded_train_step(TS.fused_train_step)
    b = len(x) // mesh.world_size()
    rows = slice(mesh.rank() * b, (mesh.rank() + 1) * b)
    xs = torch.from_numpy(x[rows]).to(device)
    ys = torch.from_numpy(labels[rows]).to(device)
    step(live, xs, ys)
    saved_rng = live.gen_host.get_state()
    CK.save_checkpoint_dcp(ckdir, live.state_dict(), {"step": 1}, saved_rng)
    restored = state_from(2)
    sd, meta, rng = CK.load_checkpoint_dcp(ckdir, CK.template_like(live.state_dict()))
    restored.load_state_dict(sd)
    out = {}
    for name, st in (("live", live), ("restored", restored)):
        m = step(st, xs, ys)
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "model": {k: v.cpu() for k, v in st.model.state_dict().items()},
                     "ema": {k: v.cpu() for k, v in st.ema.items()},
                     "step": st.step, "count": st.count}
    out["meta"] = meta
    out["rng_equal"] = bool(torch.equal(rng, saved_rng))
    return out
