"""Data-parallel training of the port on the CPU: two gloo ranks spawned by
parallel/mesh.spawn over a file:// store in tmp_path (no TCP port, so no
clash between test workers), each on one torch thread, every spawn bounded
by a timeout after which the ranks are terminated and the test fails.

- The data-parallel fused_train_step (make_sharded_train_step) equals the
  one-process step on the global batch with the same draws, mixup and then
  cutmix with permutations that cross the shards, then a step drawn from
  the ranks' own generators: loss within 1e-5; parameters, batch-norm
  statistics and EMA within atol 2e-5, rtol 2e-4 (JAX's
  test_spmd_train.py:72-74); the ranks bit for bit alike.
- Its train_step equals JAX's make_sharded_train_step on 2 virtual devices,
  at the tolerances tests/test_torch_train_step.py holds the one-device
  step to.
- trainer.main with --device cpu --num-devices 2 gives the loss curve of
  --num-devices 1 (train and validation losses within 1e-4, JAX's
  test_trainer_cli_dp_matches_single_device) and a best_model.pt whose
  probabilities equal the other's within 1e-5; rank 0 alone writes one set
  of outputs.
- A rank that raises or hangs fails the run.

A bias just before a train-mode batch norm has a gradient of rounding
noise; Adam moves it by up to the learning rate a step in the noise's
direction, which differs with the reduction order. Such leaves (found from
the one-process gradient) are held to that bound, and the batch means they
feed to 0.3 of it, as in tests/test_torch_train_step.py."""

from __future__ import annotations

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_video_deepfake_detection_tpu.core.config import TrainConfig as JTC
from real_time_video_deepfake_detection_tpu.parallel.mesh import make_mesh as jax_mesh
from real_time_video_deepfake_detection_tpu.train import steps as JS
from real_time_video_deepfake_detection_tpu_torch.core.config import TrainConfig
from real_time_video_deepfake_detection_tpu_torch.models import backbones as TB
from real_time_video_deepfake_detection_tpu_torch.parallel import mesh
from real_time_video_deepfake_detection_tpu_torch.train import checkpoint as TCK
from real_time_video_deepfake_detection_tpu_torch.train import steps as TS
from real_time_video_deepfake_detection_tpu_torch.train import trainer as TT
from real_time_video_deepfake_detection_tpu_torch.train.augment import (
    apply_augment, apply_mixup, eval_preprocess_batch,
)
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax

from tests import torch_dp_util
from tests.test_torch_trainer import _argv, _dataset
from tests.torch_port_util import HEAD_DIMS
from tests.torch_train_util import (
    BIG, SIZE, fixture_crops, jax_masks, one_torch_thread, small_effnet,
)  # noqa: F401

TIMEOUT = 240
B = 8


def _spawn(tmp_path, fn, args, world=2):
    return mesh.spawn(fn, ["cpu"] * world, args=args, store_dir=str(tmp_path),
                      timeout=TIMEOUT, num_threads=1)


def _null_leaves(model, loss) -> set:
    """Trainable leaves whose gradient of `loss(model)` is rounding noise."""
    m = copy.deepcopy(model)
    loss(m).backward()
    return {n for n, p in m.named_parameters()
            if p.grad is not None and float(p.grad.norm()) <= 1e-6}


def _fed(k: str, null: set) -> bool:
    """A head batch-norm mean that follows a noise-driven fc bias."""
    return (k.startswith("fc.bn") and k.endswith(".mean")
            and k.replace("bn", "fc").replace(".mean", ".b") in null)


def test_dp_fused_step_equals_one_process_on_the_global_batch(tmp_path):
    _, spec, _, model = small_effnet(3)
    cfg = TrainConfig(image_size=SIZE, batch_size=B, lr=1e-3, head_dropout=0.3)
    total = 100
    imgs = fixture_crops(B, BIG, seed=7)
    labels = np.array([0, 1] * (B // 2), np.float32)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    ref = TS.init_train_state(copy.deepcopy(model), spec, cfg, total, seed=0)
    # explicit draws of the global batch from a second, identically seeded
    # state, with the mixup arm and then the cutmix arm forced on; both
    # permutations send rows of each shard to the other
    d0 = TS.draw_step(TS.init_train_state(copy.deepcopy(model), spec, cfg, total, seed=5),
                      B, BIG)
    d1 = copy.deepcopy(d0)
    d0["mixup"] = dict(d0["mixup"], use_mix=True, use_mixup=True,
                       perm=np.array([5, 6, 7, 4, 1, 2, 3, 0]))
    d1["mixup"] = dict(d1["mixup"], use_mix=True, use_mixup=False, lam_c0=np.float32(0.4),
                       cy=SIZE // 2, cx=SIZE // 3, perm=np.array([7, 6, 5, 4, 3, 2, 1, 0]))
    draws = [d0, d1, None]   # the third from the states' own generators

    def loss0(m):
        x = apply_augment(torch.from_numpy(imgs), d0["augment"], SIZE)
        x, ya, yb, lam = apply_mixup(x, torch.from_numpy(labels), d0["mixup"])
        lg, _ = TB.forward_train(m, x, d0["masks"])
        return lam * TS._focal(cfg, lg[:, 0], ya) + (1 - lam) * TS._focal(cfg, lg[:, 0], yb)

    null = _null_leaves(model, loss0)
    want = [TS.fused_train_step(ref, torch.from_numpy(imgs), torch.from_numpy(labels), d)
            for d in draws]
    ranks = _spawn(tmp_path, torch_dp_util.run_steps,
                   ("fused_train_step", spec, HEAD_DIMS, init, cfg, total, imgs, labels, draws))
    r0, r1 = ranks
    for k in r0["model"]:
        assert torch.equal(r0["model"][k], r1["model"][k]), k
    for k in r0["ema"]:
        assert torch.equal(r0["ema"][k], r1["ema"][k]), k
    for i, m in enumerate(want):
        got = r0["metrics"][i]
        assert got == r1["metrics"][i]
        assert abs(got["loss"] - float(m["loss"])) <= 1e-5, i
        assert got["accuracy"] == float(m["accuracy"]), i
        assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-4), i
    assert (r0["step"], r0["count"]) == (ref.step, ref.count) == (3, 3)
    lr_sum = sum(ref.sched(i) for i in range(3))
    frozen = {n for n, p in ref.model.named_parameters() if not p.requires_grad}
    for k, v in ref.model.state_dict().items():
        got = r0["model"][k]
        if k in null:
            d_dp, d_one = (got - init[k]).abs().max(), (v - init[k]).abs().max()
            assert max(float(d_dp), float(d_one)) <= 1.5 * lr_sum, k
            continue
        np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=2e-4,
                                   atol=0.3 * lr_sum if _fed(k, null) else 2e-5, err_msg=k)
        if k in frozen:
            assert torch.equal(got, init[k]), k
        elif not (k.endswith(".mean") or k.endswith(".var")):
            # the update itself, not only the value it lands on
            delta, want_delta = (got - init[k]).numpy(), (v - init[k]).numpy()
            assert np.linalg.norm(delta - want_delta) <= 1e-3 * np.linalg.norm(want_delta), k
    for k, v in ref.ema.items():
        tol = 1.5 * lr_sum if k in null else 2e-5
        np.testing.assert_allclose(r0["ema"][k].numpy(), v.numpy(), rtol=2e-4, atol=tol,
                                   err_msg=k)


def test_dp_train_step_equals_jax_sharded_step(tmp_path):
    spec_j, spec_t, pj, model = small_effnet(5)
    kw = dict(image_size=64, batch_size=B, lr=1e-3, head_dropout=0.3)
    cfg_j, cfg_t = JTC(**kw), TrainConfig(**kw)
    total, n_steps = 6, 2
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (B, 64, 64, 3)).astype(np.float32)
    labels = np.array([0, 1, 1, 0, 1, 0, 0, 1], np.float32)
    tx = JS.make_optimizer(cfg_j, total, spec=spec_j)
    js = JS.init_train_state(jax.tree.map(jnp.asarray, pj), cfg_j, total, seed=0, tx=tx)
    jstep = JS.make_sharded_train_step(jax_mesh(2), spec_j, cfg_j, tx)
    widths = (spec_j.head_filters,) + HEAD_DIMS[:2]
    masks, mj = [], []
    for _ in range(n_steps):
        masks.append(jax_masks(jax.random.split(js.rng)[1], spec_j, B, cfg_j.head_dropout,
                               widths))
        js, m = jstep(js, jnp.asarray(x), jnp.asarray(labels))
        mj.append({k: float(v) for k, v in m.items()})
    init = {k: v.clone() for k, v in model.state_dict().items()}

    def loss0(m):
        lg, _ = TB.forward_train(m, torch.from_numpy(x), masks[0])
        return TS._focal(cfg_t, lg[:, 0], torch.from_numpy(labels))

    null = _null_leaves(model, loss0)
    r0, _ = _spawn(tmp_path, torch_dp_util.run_steps,
                   ("train_step", spec_t, HEAD_DIMS, init, cfg_t, total, x, labels, masks))
    for i, (got, want) in enumerate(zip(r0["metrics"], mj)):
        tol = 1e-5 if i == 0 else 1e-4
        assert abs(got["loss"] - want["loss"]) <= tol * abs(want["loss"]), i
        assert got["accuracy"] == want["accuracy"], i
    ts = TS.init_train_state(copy.deepcopy(model), spec_t, cfg_t, total)
    frozen = {n for n, p in ts.model.named_parameters() if not p.requires_grad}
    lr_sum = sum(ts.sched(i) for i in range(n_steps))
    after_j = params_from_jax(jax.tree.map(np.asarray, js.params))
    for k, v in r0["model"].items():
        d_t, d_j = (v - init[k]).numpy(), (after_j[k] - init[k]).numpy()
        if k.endswith(".mean") or k.endswith(".var"):
            np.testing.assert_allclose(v.numpy(), after_j[k].numpy(), rtol=0,
                                       atol=0.3 * lr_sum if _fed(k, null) else 1e-5,
                                       err_msg=k)
        elif k in frozen:
            np.testing.assert_array_equal(v.numpy(), init[k].numpy())
        elif k in null:
            assert max(np.abs(d_t).max(), np.abs(d_j).max()) <= 1.5 * lr_sum, k
        else:
            assert np.linalg.norm(d_t - d_j) <= 1e-2 * np.linalg.norm(d_j), k
    ema_j = params_from_jax(jax.tree.map(np.asarray, js.ema_params))
    for k in ("fc.fc3.w", "fc.bn1.scale", "blocks.2.bn2.scale"):
        np.testing.assert_allclose(r0["ema"][k].numpy(), ema_j[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """trainer.main on one process and on two gloo ranks, same arguments."""
    root = tmp_path_factory.mktemp("dp_trainer")
    ds = _dataset(root / "ds")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = {k: TT.main(_argv(ds, str(root / k), "--epochs", "2", "--seed", "7",
                                 "--num-devices", k, "--bn-momentum", "0.2"))
                for k in ("1", "2")}
    finally:
        torch.set_num_threads(n)
    return root, runs


def test_trainer_dp_gives_the_one_process_loss_curve(trainer_runs):
    root, runs = trainer_runs
    log1, log2 = runs["1"]["log"], runs["2"]["log"]
    assert [e["epoch"] for e in log2] == [e["epoch"] for e in log1] == [0, 1]
    for e1, e2 in zip(log1, log2):
        assert e2["train_loss"] == pytest.approx(e1["train_loss"], abs=1e-4)
        assert e2["val_loss"] == pytest.approx(e1["val_loss"], abs=1e-4)
        assert e2["val_f1"] == e1["val_f1"] and e2["train_acc"] == e1["train_acc"]
    assert runs["2"]["best"] == runs["1"]["best"]
    # the two best checkpoints serve alike: the EMA forward on the validation crops
    imgs = torch.from_numpy(fixture_crops(4, SIZE, seed=2))
    _, spec, _, _ = small_effnet()
    probs = []
    for k in ("1", "2"):
        ckpt = TCK.load_checkpoint(os.path.join(root, k, "best_model.pt"))
        model = TB.build_model(TB.make("b0"))
        model.load_state_dict(ckpt["params"])
        probs.append(TS.eval_step(model.eval(), ckpt["params"], eval_preprocess_batch(imgs)))
    np.testing.assert_allclose(probs[1].numpy(), probs[0].numpy(), rtol=0, atol=1e-5)


def test_trainer_dp_rank0_alone_writes_one_set_of_outputs(trainer_runs, tmp_path):
    root, runs = trainer_runs
    for k in ("1", "2"):
        assert sorted(os.listdir(root / k)) == ["best_model.pt", "resume_checkpoint.pt",
                                                "training_log.json"], k
    assert runs["2"]["state"] is None and runs["1"]["state"] is not None
    # the ranks' store lives in the temporary directory and is removed
    assert not [p for p in os.listdir(root) if p.startswith("pg_store_")]
    # a third epoch resumes on both ranks from rank 0's checkpoint
    ds = str(root / "ds")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r3 = TT.main(_argv(ds, str(root / "2"), "--epochs", "3", "--seed", "7",
                           "--num-devices", "2", "--bn-momentum", "0.2"))
    finally:
        torch.set_num_threads(n)
    assert [e["epoch"] for e in r3["log"]] == [0, 1, 2]
    assert sorted(os.listdir(root / "2")) == ["best_model.pt", "resume_checkpoint.pt",
                                              "training_log.json"]


def test_usable_devices_rule():
    parse = TT.build_parser().parse_args
    cpu = torch.device("cpu")
    for n, bs, want in ((0, 4, 1), (1, 4, 1), (2, 4, 2), (3, 4, 2), (8, 12, 6)):
        args = parse(["--dataset", "d", "--num-devices", str(n), "--batch-size", str(bs)])
        assert TT._usable_devices(args, cpu) == want, (n, bs)


def test_a_failed_or_hung_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        mesh.spawn(torch_dp_util.fail_on_rank, ["cpu", "cpu"], args=(1, False),
                   store_dir=str(tmp_path), timeout=TIMEOUT, num_threads=1)
    with pytest.raises(TimeoutError, match="did not finish"):
        mesh.spawn(torch_dp_util.fail_on_rank, ["cpu", "cpu"], args=(0, True),
                   store_dir=str(tmp_path), timeout=20, num_threads=1)
    assert not os.listdir(tmp_path)
