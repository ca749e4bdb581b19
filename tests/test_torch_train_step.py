"""The port's training forward and step against the JAX package on the CPU:
forward_train with the JAX package's drop-connect and dropout masks
(logits and every batch-norm statistic), the head dropout's rates, the
optimizer groups, three fused steps from the same parameters, batch and
draws (losses, gradients, weights, statistics, EMA, frozen leaves), the
skipped non-finite step and the bf16 step."""

from __future__ import annotations

import copy
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_video_deepfake_detection_tpu.core.config import TrainConfig as JTC
from real_time_video_deepfake_detection_tpu.models import backbones as JB
from real_time_video_deepfake_detection_tpu.train import augment as JA
from real_time_video_deepfake_detection_tpu.train import losses as JL
from real_time_video_deepfake_detection_tpu.train import steps as JS
from real_time_video_deepfake_detection_tpu_torch.core.config import TrainConfig
from real_time_video_deepfake_detection_tpu_torch.models import backbones as TB
from real_time_video_deepfake_detection_tpu_torch.models import efficientnet as TE
from real_time_video_deepfake_detection_tpu_torch.train import steps as TS
from real_time_video_deepfake_detection_tpu_torch.train.augment import apply_augment, apply_mixup
from real_time_video_deepfake_detection_tpu_torch.train.checkpoint import jax_leaf_order
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax

from tests.torch_port_util import HEAD_DIMS, vit_models
from tests.torch_train_util import (
    BIG, SIZE, fixture_crops, jax_draws, jax_masks, jax_mixup_draws, small_effnet,
    one_torch_thread, small_xception, stack_draws,
)  # noqa: F401

B = 8


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_forward_train(spec_j, params, x, key, **kw):
    """JAX's backbones.forward_train, jitted (op by op it is ~5x slower)."""
    fn = jax.jit(partial(JB.forward_train, spec=spec_j, **kw))
    return fn(jax.tree.map(jnp.asarray, params), jnp.asarray(x), rng=key)


def _stats_close(stats_t, stats_j, tol: float):
    assert len(stats_t) == len(stats_j)
    for i, ((_, m, v), sj) in enumerate(zip(stats_t, stats_j)):
        for got, want in ((m, sj["mean"]), (v, sj["var"])):
            assert _rel(got.numpy(), want) <= tol, i


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_effnet_forward_train_matches_jax(dropout):
    spec_j, _, pj, model = small_effnet(1)
    x = np.random.default_rng(2).normal(0, 1, (B, 64, 64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    lj, sj = _jax_forward_train(spec_j, pj, x, key, dropout=dropout)
    masks = jax_masks(key, spec_j, B, dropout, (spec_j.head_filters,) + HEAD_DIMS[:2])
    assert any(m is not None for m in masks["drop_connect"])
    lt, st = TB.forward_train(model, torch.from_numpy(x), masks)
    assert _rel(lt.detach().numpy(), lj) <= 1e-5
    _stats_close(st, sj, 1e-5)
    # the statistics land in the buffers only through update_bn_stats
    assert float(model.stem.bn.mean.abs().sum()) == pytest.approx(float(np.abs(pj["stem"]["bn"]["mean"]).sum()))
    TB.update_bn_stats(st)
    np.testing.assert_array_equal(model.stem.bn.mean.numpy(), st[0][1].numpy())


def test_xception_and_vit_forward_train_match_jax():
    spec_j, _, pj, model = small_xception()
    x = np.random.default_rng(3).normal(0, 1, (2, 96, 96, 3)).astype(np.float32)
    lj, sj = _jax_forward_train(spec_j, pj, x, jax.random.PRNGKey(0))
    lt, st = TB.forward_train(model, torch.from_numpy(x))
    assert _rel(lt.detach().numpy(), lj) <= 1e-5
    _stats_close(st, sj, 1e-5)
    vspec, vpj, vit = vit_models(seed=4)
    xv = np.random.default_rng(4).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    lj, sj = _jax_forward_train(vspec, vpj, xv, jax.random.PRNGKey(0))
    lt, st = TB.forward_train(vit, torch.from_numpy(xv))
    assert sj == [] and len(st) == 0
    assert _rel(lt.detach().numpy(), lj) <= 1e-5


def test_head_dropout_rates():
    _, _, _, model = small_effnet()
    n, p = 4096, 0.5
    masks = TB.draw_masks(model, n, torch.Generator().manual_seed(0), p)
    for (m, rate), want in zip(masks["head"], (p, 0.7 * p, 0.5 * p)):
        assert rate == want
        keep = float(m.float().mean())
        assert abs(keep - (1 - want)) <= 3 * (want * (1 - want) / m.numel()) ** 0.5
    dc = [d for d in masks["drop_connect"] if d is not None]
    assert [r for _, r in dc] == [0.2 * 2 / 3]
    assert abs(float(dc[0][0].float().mean()) - (1 - 0.4 / 3)) < 0.03
    assert TB.draw_masks(model, n, torch.Generator(), 0.0)["head"] == [None, None, None]


@pytest.mark.parametrize("which", ["effnet", "vit", "xception"])
def test_lr_group_partition_equals_jax(which):
    if which == "effnet":
        spec_j, spec_t, pj, model = small_effnet()
    elif which == "xception":
        spec_j, spec_t, pj, model = small_xception()
    else:
        spec_j, pj, model = vit_models()
        spec_t = model.spec
    for frac in (0.0, 0.6, 1.0):
        n_frozen = int(frac * JB.n_blocks(spec_j))
        assert TB.n_blocks(spec_t) == JB.n_blocks(spec_j)
        want = jax.tree_util.tree_leaves(jax.tree_util.tree_map_with_path(
            lambda path, _: JB.lr_group(spec_j, path, n_frozen), pj))
        names = jax_leaf_order(model.state_dict().keys())
        got = [TB.lr_group(spec_t, n, n_frozen) for n in names]
        assert got == want
        assert len(set(got)) >= 2


def _jax_fused_draws(key, spec_j, cfg, n: int = B):
    """The draws fused_train_step makes from its state's key for a batch
    of `n`, in the port's layout, and the key it leaves."""
    rng, k_aug, k_mix, k_drop = jax.random.split(key, 4)
    per = jax.random.split(k_aug, n)
    aug = stack_draws([jax_draws(k, BIG, SIZE) for k in per])
    mix = jax_mixup_draws(k_mix, n, SIZE, SIZE, cfg.mixup_alpha, cfg.cutmix_alpha)
    masks = jax_masks(k_drop, spec_j, n, cfg.head_dropout, (spec_j.head_filters,) + HEAD_DIMS[:2])
    return {"augment": aug, "mixup": mix, "masks": masks}, (k_aug, k_mix, k_drop)


def test_fused_train_step_matches_jax_over_three_steps():
    spec_j, spec_t, pj, model = small_effnet(3)
    kw = dict(image_size=SIZE, batch_size=B, lr=1e-3, head_dropout=0.3)
    cfg_j, cfg_t = JTC(**kw), TrainConfig(**kw)
    total = 6
    tx = JS.make_optimizer(cfg_j, total, spec=spec_j)
    js = JS.init_train_state(jax.tree.map(jnp.asarray, pj), cfg_j, total, seed=0, tx=tx)
    step_j = jax.jit(partial(JS.fused_train_step, spec=spec_j, cfg=cfg_j, tx=tx))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    grad_model = copy.deepcopy(model)
    ts = TS.init_train_state(model, spec_t, cfg_t, total, seed=0)
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert frozen and any(n.startswith("stem") for n in frozen)

    imgs = fixture_crops(B, BIG, seed=7)
    labels = np.array([0, 1] * (B // 2), np.float32)
    ema_formula = {k: v.clone() for k, v in ts.ema.items()}
    null, lr_sum = set(), sum(ts.sched(i) for i in range(3))
    for step in range(3):
        draws, (k_aug, k_mix, k_drop) = _jax_fused_draws(js.rng, spec_j, cfg_j)
        if step == 0:
            # step-1 gradients of every leaf from the same parameters and inputs
            # (jitted, as in JAX's step: op by op they take ~50 s here)
            x = jax.jit(JA.augment_batch, static_argnums=2)(k_aug, jnp.asarray(imgs), SIZE)
            x, ya, yb, lam = jax.jit(JA.mixup_cutmix, static_argnums=(3, 4))(
                k_mix, x, jnp.asarray(labels), cfg_j.mixup_alpha, cfg_j.cutmix_alpha)

            def loss_fn(p):
                lg, _ = JS._forward_mixed(p, x, spec_j, k_drop, False, cfg_j.head_dropout)
                f = partial(JL.focal_loss_with_smoothing, gamma=cfg_j.focal_gamma,
                            alpha=cfg_j.focal_alpha, label_smoothing=cfg_j.label_smoothing)
                return lam * f(lg[:, 0], ya) + (1 - lam) * f(lg[:, 0], yb)
            gj = params_from_jax(jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(js.params)))
            xt = apply_augment(torch.from_numpy(imgs), draws["augment"], SIZE)
            xt, yat, ybt, lamt = apply_mixup(xt, torch.from_numpy(labels), draws["mixup"])
            lt, _ = TB.forward_train(grad_model, xt, draws["masks"])
            f = partial(TS._focal, cfg_t)
            (lamt * f(lt[:, 0], yat) + (1 - lamt) * f(lt[:, 0], ybt)).backward()
            for n, p in grad_model.named_parameters():
                if float(np.linalg.norm(gj[n].numpy())) > 1e-6:
                    assert _rel(p.grad.numpy(), gj[n].numpy()) <= 1e-4, n
                else:
                    # a bias just before a train-mode batch norm: its gradient
                    # is zero in exact arithmetic, ~1e-9 of rounding here
                    null.add(n)
                    assert float(np.linalg.norm(p.grad.numpy())) <= 1e-6, n
        js, mj = step_j(js, jnp.asarray(imgs), jnp.asarray(labels))
        mt = TS.fused_train_step(ts, torch.from_numpy(imgs), torch.from_numpy(labels), draws)
        tol = 1e-5 if step == 0 else 1e-4
        assert abs(float(mt["loss"]) - float(mj["loss"])) <= tol * abs(float(mj["loss"])), step
        assert float(mt["accuracy"]) == float(mj["accuracy"])
        with torch.no_grad():
            for k, p in ts.model.named_parameters():
                ema_formula[k] = ema_formula[k] * cfg_t.ema_decay + p * (1.0 - cfg_t.ema_decay)
    assert ts.step == 3 and ts.count == 3
    after_j = params_from_jax(jax.tree.map(np.asarray, js.params))
    sd = ts.model.state_dict()
    for k, v in sd.items():
        d_t, d_j = (v - init[k]).numpy(), (after_j[k] - init[k]).numpy()
        if k.endswith(".mean") or k.endswith(".var"):
            # the head's batch means follow the noise-driven fc biases
            # (momentum 0.1); every other statistic is held to 1e-5
            fed = k.startswith("fc.bn") and k.endswith(".mean") and \
                k.replace("bn", "fc").replace(".mean", ".b") in null
            np.testing.assert_allclose(v.numpy(), after_j[k].numpy(), rtol=0,
                                       atol=0.3 * lr_sum if fed else 1e-5, err_msg=k)
        elif k in frozen:
            np.testing.assert_array_equal(v.numpy(), init[k].numpy())
        elif k in null:
            # Adam moves a leaf of rounding-noise gradients by ~lr a step, in
            # the noise's direction, in both packages alike
            assert max(np.abs(d_t).max(), np.abs(d_j).max()) <= 1.5 * lr_sum, k
        else:
            assert _rel(d_t, d_j) <= 1e-2, k
    for k, v in ts.ema.items():
        np.testing.assert_array_equal(v.numpy(), ema_formula[k].numpy())
    ema_j = params_from_jax(jax.tree.map(np.asarray, js.ema_params))
    esd = ts.ema_state_dict()
    for k in ("fc.fc3.w", "blocks.2.bn2.mean", "head.bn.var"):
        np.testing.assert_allclose(esd[k].numpy(), ema_j[k].numpy(), rtol=0, atol=1e-5)


def test_nonfinite_step_is_skipped_like_gradscaler():
    """JAX's test_nonfinite_grads_skip_the_step_like_gradscaler, on the
    port: an all-zero batch (batch variance exactly 0) overflows the
    backward; no weight moves, the optimizer's count (the schedule's
    index) stays, the statistics still update, and the next healthy batch
    trains. Nothing is frozen here: the port judges the gradients it
    computes, the trainable ones (as the reference's GradScaler does),
    and this batch overflows in the early blocks; JAX's apply_if_finite
    also sees the frozen leaves' gradients, which jax.grad computes."""
    spec = TE.EfficientNetSpec.make("b0")
    cfg = TrainConfig(batch_size=8, lr=1e-3, freeze_frac=0.0)
    model = TE.EfficientNet(spec, generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TS.init_train_state(model, spec, cfg, total_steps=8)
    labels = torch.tensor([0.0, 1.0] * 4)
    m1 = TS.train_step(state, torch.zeros((8, 64, 64, 3)), labels)
    assert not bool(torch.isfinite(m1["grad_norm"]))
    assert state.count == 0 and state.step == 1
    for k, p in model.named_parameters():
        assert torch.equal(p, before[k]), k
        assert bool(torch.isfinite(p).all())
    assert not torch.equal(model.stem.bn.var, before["stem.bn.var"])
    imgs = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (8, 64, 64, 3)).astype(np.float32))
    m2 = TS.train_step(state, imgs, labels)
    assert bool(torch.isfinite(m2["loss"])) and bool(torch.isfinite(m2["grad_norm"]))
    assert state.count == 1
    assert any(not torch.equal(p, before[k]) for k, p in model.named_parameters())


def test_bf16_step_close_to_f32():
    """JAX's test_bf16_train_step_close_to_f32 bound: one step's losses
    within 0.05, master parameters stay float32."""
    spec_j, spec_t, pj, model = small_effnet(6)
    cfg32 = TrainConfig(batch_size=4)
    cfg16 = dataclasses.replace(cfg32, bf16_compute=True)
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.standard_normal((4, 64, 64, 3)).astype(np.float32))
    labels = torch.from_numpy((rng.random(4) > 0.5).astype(np.float32))
    out = {}
    for name, cfg in (("f32", cfg32), ("bf16", cfg16)):
        m = copy.deepcopy(model)
        state = TS.init_train_state(m, spec_t, cfg, total_steps=10)
        masks = TB.draw_masks(m, 4, torch.Generator().manual_seed(1), cfg.head_dropout)
        out[name] = float(TS.train_step(state, images, labels, masks)["loss"])
        assert all(t.dtype == torch.float32 for t in m.state_dict().values())
        assert all(bool(torch.isfinite(t).all()) for t in m.state_dict().values())
    assert np.isfinite(out["bf16"]) and abs(out["bf16"] - out["f32"]) < 0.05
