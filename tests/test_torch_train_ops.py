"""The training slice's building blocks in the port against the JAX package
on the CPU: the losses, the OneCycle schedule, the per-sample JPEG round
trip, the augmentation's applies fed the JAX package's own draws, the two
warps, mixup/cutmix, the validation preprocess, the port's own draws by
their distributions, the balanced sampler, the AUC and the calibrator."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_video_deepfake_detection_tpu.ops import jpeg as JJ
from real_time_video_deepfake_detection_tpu.train import augment as JA
from real_time_video_deepfake_detection_tpu.train import calibration as JC
from real_time_video_deepfake_detection_tpu.train import data as JD
from real_time_video_deepfake_detection_tpu.train import losses as JL
from real_time_video_deepfake_detection_tpu.train import steps as JS
from real_time_video_deepfake_detection_tpu.train import trainer as JT
from real_time_video_deepfake_detection_tpu_torch.ops import jpeg as TJ
from real_time_video_deepfake_detection_tpu_torch.train import augment as TA
from real_time_video_deepfake_detection_tpu_torch.train import calibration as TC
from real_time_video_deepfake_detection_tpu_torch.train import data as TD
from real_time_video_deepfake_detection_tpu_torch.train import losses as TL
from real_time_video_deepfake_detection_tpu_torch.train import steps as TS
from real_time_video_deepfake_detection_tpu_torch.train import trainer as TT

from tests.torch_train_util import (
    BIG, SIZE, fixture_crops, jax_draws, jax_mixup_draws, one_torch_thread, stack_draws,
)  # noqa: F401


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, 64).astype(np.float32)
    labels = (rng.random(64) > 0.5).astype(np.float32)
    for kw in ({}, {"gamma": 0.0, "alpha": 0.5, "label_smoothing": 0.0},
               {"gamma": 3.0, "alpha": 0.1, "label_smoothing": 0.2}):
        want = float(JL.focal_loss_with_smoothing(jnp.asarray(logits), jnp.asarray(labels), **kw))
        got = float(TL.focal_loss_with_smoothing(torch.from_numpy(logits),
                                                 torch.from_numpy(labels), **kw))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), kw
    want = float(JL.bce_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(TL.bce_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("total", [1, 5, 37, 1000])
def test_onecycle_schedule_matches_jax(total):
    """Against the JAX schedule evaluated op by op, in the same float32
    order. Both round at every step; the port's cosine is the correctly
    rounded one, XLA's CPU cosine polynomial is one ulp off it on ~1.4% of
    arguments, so a step may differ by up to two float32 ulps (1.8e-7
    measured on 2 of the 1000 steps; the jitted JAX schedule itself moves
    by one ulp against its op-by-op form)."""
    js = JS.onecycle_cos_schedule(total, 3e-4)
    want = np.array([float(js(i)) for i in range(total)])
    ts = TS.onecycle_cos_schedule(total, 3e-4)
    got = np.array([ts(i) for i in range(total)])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    assert np.mean(got == want) >= 0.99


@pytest.mark.parametrize("q", [20, 47, 75])
def test_jpeg_table_roundtrip_batched_exact(q):
    """One quality's tables per sample, gathered from the stack as the
    augmentation does, against JAX's per-sample round trip."""
    crops = fixture_crops(4, 64, seed=q)
    lum, chr_ = TJ.quality_table_stack(20, 75)
    qs = np.array([q, 20, 75, q]) - 20
    got = TJ.jpeg_roundtrip_bgr_tables(torch.from_numpy(crops),
                                       torch.from_numpy(lum)[qs], torch.from_numpy(chr_)[qs])
    jl, jc = JJ.quality_table_stack(20, 75)
    fn = jax.jit(JJ.jpeg_roundtrip_bgr_tables)
    for i in range(4):
        want = np.asarray(fn(jnp.asarray(crops[i]), jnp.asarray(jl[qs[i]]), jnp.asarray(jc[qs[i]])))
        np.testing.assert_array_equal(got[i].numpy(), want)


def _keys_covering_every_arm(n: int) -> list:
    """At least n keys, more until each gated arm was drawn on and off."""
    gates = ("jpeg_gate", "flip", "gray", "blur_gate", "erase_gate", "noise_gate")
    keys, seen = [], {g: set() for g in gates}
    i = 0
    while len(keys) < n or any(len(v) < 2 for v in seen.values()):
        k = jax.random.PRNGKey(1000 + i)
        i += 1
        d = jax_draws(k)
        if len(keys) < n or any(bool(d[g]) not in seen[g] for g in gates):
            keys.append(k)
            for g in gates:
                seen[g].add(bool(d[g]))
    return keys


def test_augment_apply_fed_jax_draws_matches_augment_one():
    keys = _keys_covering_every_arm(8)
    imgs = fixture_crops(len(keys))
    draws = [jax_draws(k) for k in keys]
    fn = jax.jit(JA.augment_one, static_argnums=(2, 3))
    want = np.stack([np.asarray(fn(k, jnp.asarray(im), SIZE, True)) for k, im in zip(keys, imgs)])
    got = TA.apply_augment(torch.from_numpy(imgs), stack_draws(draws), SIZE).numpy()
    assert got.shape == (len(keys), SIZE, SIZE, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_augment_jpeg_arm_exact_with_pad_and_bgr_order():
    """The arm alone: reflect pad to a multiple of 16, BGR inside the
    codec, cropped back; against the JAX package's expression."""
    imgs = fixture_crops(3)
    pad = (-BIG) % 16
    lum, chr_ = JA._QLUM, JA._QCHR
    qs = np.array([0, 27, 55])
    padded = TA._reflect_pad_hw(torch.from_numpy(imgs), 0, pad)
    got = TJ.jpeg_roundtrip_bgr_tables(
        padded.flip(-1), torch.from_numpy(lum)[qs], torch.from_numpy(chr_)[qs]
    ).flip(-1)[:, :BIG, :BIG].numpy()
    for i, q in enumerate(qs):
        p = jnp.pad(jnp.asarray(imgs[i]), ((0, pad), (0, pad), (0, 0)), mode="reflect")
        np.testing.assert_array_equal(padded[i].numpy(), np.asarray(p))
        want = JJ.jpeg_roundtrip_bgr_tables(p[..., ::-1], jnp.asarray(lum)[q],
                                            jnp.asarray(chr_)[q])[..., ::-1][:BIG, :BIG]
        np.testing.assert_array_equal(got[i], np.asarray(want))


def test_warps_match_jax_and_each_other():
    img = (fixture_crops(4, SIZE) / 255.0).astype(np.float32)
    hs = [np.asarray(JA._sample_homography(jax.random.PRNGKey(s), SIZE, SIZE)) for s in range(4)]
    hs[0] = np.eye(3, dtype=np.float32)
    ht = torch.from_numpy(np.stack(hs))
    two = TA.warp_bilinear(torch.from_numpy(img), ht).numpy()
    direct = TA.warp_bilinear_gather(torch.from_numpy(img), ht).numpy()
    for i in range(4):
        want2 = np.asarray(JA._warp_bilinear(jnp.asarray(img[i]), jnp.asarray(hs[i])))
        wantd = np.asarray(JA._warp_bilinear_gather(jnp.asarray(img[i]), jnp.asarray(hs[i])))
        np.testing.assert_allclose(two[i], want2, rtol=0, atol=1e-5)
        np.testing.assert_allclose(direct[i], wantd, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(two[0], img[0])   # identity reproduces the input
    # the two passes against the direct warp: a fraction of a grey level
    assert np.abs(two - direct).max() * 255 < 1.0


@pytest.mark.parametrize("alphas", [(0.3, 0.3), (0.0, 0.3), (0.3, 0.0), (0.0, 0.0)])
def test_mixup_cutmix_fed_jax_draws_exact(alphas):
    ma, ca = alphas
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (6, SIZE, SIZE, 3)).astype(np.float32)
    y = np.array([0, 1, 0, 1, 1, 0], np.float32)
    arms = set()
    for s in range(40):
        key = jax.random.PRNGKey(s)
        xj, yaj, ybj, lamj = JA.mixup_cutmix(key, jnp.asarray(x), jnp.asarray(y), ma, ca)
        d = None if (ma <= 0 and ca <= 0) else jax_mixup_draws(key, 6, SIZE, SIZE, ma, ca)
        xt, yat, ybt, lamt = TA.apply_mixup(torch.from_numpy(x), torch.from_numpy(y), d)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(yat.numpy(), np.asarray(yaj))
        np.testing.assert_array_equal(ybt.numpy(), np.asarray(ybj))
        assert np.float32(lamt) == np.float32(lamj)
        arms.add("none" if d is None or not d["use_mix"] else
                 "mixup" if d["use_mixup"] else "cutmix")
    expect = {"none"} | ({"mixup"} if ma > 0 else set()) | ({"cutmix"} if ca > 0 else set())
    assert arms == expect


def test_eval_preprocess_matches_jax():
    imgs = fixture_crops(3, SIZE)
    want = np.asarray(JA.eval_preprocess_batch(jnp.asarray(imgs)))
    got = TA.eval_preprocess_batch(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_port_draws_shapes_ranges_and_rates():
    n = 4096
    d = TA.draw_augment(n, BIG, SIZE, torch.Generator().manual_seed(0))
    assert set(d) == set(TA.AUG_KEYS)
    assert d["noise_vals"].shape == (n, SIZE, SIZE, 3)
    assert d["homography"].shape == (n, 3, 3) and torch.isfinite(d["homography"]).all()
    assert d["jitter"].shape == (n, 4) and d["crop"].shape == (n, 2)
    assert 0 <= int(d["jpeg_q"].min()) and int(d["jpeg_q"].max()) == 55
    assert int(d["crop"].max()) == BIG - SIZE and int(d["crop"].min()) == 0
    assert int(d["erase_x"].min()) == 1 and int(d["erase_x"].max()) == SIZE - 1
    assert int(d["erase_y"].min()) == 0
    for name, lo, hi in (("blur_sigma", 0.1, 1.5), ("erase_area", 0.02, 0.2),
                         ("erase_aspect", 0.3, 3.3), ("noise_std", 0.01, 0.04)):
        assert lo <= float(d[name].min()) and float(d[name].max()) <= hi, name
    for i, (lo, hi) in enumerate(((0.7, 1.3), (0.7, 1.3), (0.75, 1.25), (-0.08, 0.08))):
        assert lo <= float(d["jitter"][:, i].min()) and float(d["jitter"][:, i].max()) <= hi
    for name, p in (("jpeg_gate", 0.5), ("flip", 0.5), ("gray", 0.08), ("blur_gate", 0.2),
                    ("erase_gate", 0.25), ("noise_gate", 0.3)):
        rate = float(d[name].float().mean())
        assert abs(rate - p) <= 3 * (p * (1 - p) / n) ** 0.5, (name, rate)
    # a perspective on ~30%: the homography's last row moves off (0, 0, 1)
    persp = float((d["homography"][:, 2, :2].abs().sum(1) > 1e-7).float().mean())
    assert abs(persp - 0.3) <= 3 * (0.21 / n) ** 0.5
    rng = np.random.default_rng(0)
    mix = [TA.draw_mixup(rng, 8, SIZE, SIZE, 0.3, 0.3) for _ in range(n)]
    rate = np.mean([m["use_mix"] for m in mix])
    assert abs(rate - 0.5) <= 3 * (0.25 / n) ** 0.5
    assert all(0 <= m["lam_m"] <= 1 and sorted(m["perm"]) == list(range(8)) for m in mix[:64])
    assert TA.draw_mixup(rng, 8, SIZE, SIZE, 0.0, 0.0) is None


def test_balanced_epoch_indices_equal_jax():
    labels = np.array([0] * 7 + [1] * 19)
    for seed in (0, 42):
        np.testing.assert_array_equal(
            TD.balanced_epoch_indices(labels, np.random.default_rng(seed)),
            JD.balanced_epoch_indices(labels, np.random.default_rng(seed)))
    with pytest.raises(RuntimeError, match="0 fake"):
        TD.balanced_epoch_indices(np.zeros(4, np.int64), np.random.default_rng(0))


def test_auc_score_matches_jax():
    rng = np.random.default_rng(3)
    labels = (rng.random(200) > 0.4).astype(np.float32)
    probs = np.round(rng.random(200), 2)   # ties
    assert TT.auc_score(labels, probs) == JT.auc_score(labels, probs)
    assert TT.auc_score(np.ones(3), np.array([0.1, 0.2, 0.3])) == 0.0


def test_calibrator_fit_and_files_cross_load(tmp_path):
    rng = np.random.default_rng(4)
    probs = rng.random(300)
    labels = (rng.random(300) < probs).astype(np.float32)
    cj = JC.IsotonicCalibrator().fit(probs, labels)
    ct = TC.IsotonicCalibrator().fit(probs, labels)
    np.testing.assert_array_equal(ct.x_, cj.x_)
    np.testing.assert_array_equal(ct.y_, cj.y_)
    ct.save(str(tmp_path / "t.pkl"))
    cj.save(str(tmp_path / "j.pkl"))
    a = JC.IsotonicCalibrator.load(str(tmp_path / "t.pkl"))
    b = TC.IsotonicCalibrator.load(str(tmp_path / "j.pkl"))
    q = np.linspace(0, 1, 17)
    np.testing.assert_array_equal(a.transform(q), cj.transform(q))
    np.testing.assert_array_equal(b.predict_proba(q[:, None]), ct.predict_proba(q[:, None]))
