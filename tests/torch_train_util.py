"""Shared fixtures of the training-slice parity tests (tests/test_torch_
train*.py, test_torch_checkpoint.py, test_torch_trainer.py): fixture
crops, the JAX package's augmentation, mixup and dropout draws computed
from its keys in the port's layouts, and small EfficientNet and Xception
models built identically in both packages."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_video_deepfake_detection_tpu.models import xception as JX
from real_time_video_deepfake_detection_tpu.train import augment as JA
from real_time_video_deepfake_detection_tpu_torch.models import efficientnet as TE
from real_time_video_deepfake_detection_tpu_torch.models import xception as TX
from real_time_video_deepfake_detection_tpu_torch.train import augment as TA
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax
from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import decode_jpeg

from tests.torch_port_util import HEAD_DIMS, draw_params, jax_params, randomize_bn, small_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG_DIR = os.path.join(REPO, "tests", "data", "torch_jpeg")
SIZE, BIG = 32, 52


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Training runs whole models on the CPU in these tests; beside the
    other test workers torch's thread pool only contends (up to 10x
    slower). Imported into a test module, it applies to its tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fixture_crops(n: int, big: int = BIG, seed: int = 0) -> np.ndarray:
    """n (big, big, 3) RGB u8 crops of the 480x640 fixture at seeded offsets."""
    with open(os.path.join(JPEG_DIR, "frame_640x480_q85_420.jpg"), "rb") as f:
        frame = decode_jpeg(f.read())[..., ::-1]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y, x = rng.integers(0, 480 - big, 2)
        out.append(frame[y:y + big, x:x + big])
    return np.ascontiguousarray(np.stack(out))


def jax_draws(key, big: int = BIG, size: int = SIZE) -> dict:
    """One sample's draws computed from the JAX package's keys with its own
    jax.random calls, named as the port's draw_augment names them."""
    k = JA._augment_keys(key)
    u = jax.random.uniform
    ks = jax.random.split(k["jitter"], 4)
    return {
        "jpeg_q": jax.random.randint(k["jpeg_q"], (), 0, JA._JPEG_QHI - JA._JPEG_QLO + 1),
        "jpeg_gate": jax.random.bernoulli(k["jpeg_gate"], 0.5),
        "crop": jax.random.randint(k["crop"], (2,), 0, big - size + 1),
        "flip": jax.random.bernoulli(k["flip"], 0.5),
        "jitter": jnp.stack([u(ks[0], (), minval=0.7, maxval=1.3), u(ks[1], (), minval=0.7, maxval=1.3),
                             u(ks[2], (), minval=0.75, maxval=1.25),
                             u(ks[3], (), minval=-0.08, maxval=0.08)]),
        "gray": jax.random.bernoulli(k["gray"], 0.08),
        "homography": JA._sample_homography(k["homography"], size, size),
        "blur_gate": jax.random.bernoulli(k["blur_gate"], 0.2),
        "blur_sigma": u(k["blur_sigma"], (), minval=0.1, maxval=1.5),
        "erase_gate": jax.random.bernoulli(k["erase_gate"], 0.25),
        "erase_area": u(k["erase_area"], (), minval=0.02, maxval=0.2),
        "erase_aspect": u(k["erase_aspect"], (), minval=0.3, maxval=3.3),
        "erase_y": jax.random.randint(k["erase_y"], (), 0, size),
        "erase_x": jax.random.randint(k["erase_x"], (), 1, size),
        "noise_gate": jax.random.bernoulli(k["noise_gate"], 0.3),
        "noise_std": u(k["noise_std"], (), minval=0.01, maxval=0.04),
        "noise_vals": jax.random.normal(k["noise_vals"], (size, size, 3)),
    }


def stack_draws(draws: list) -> dict:
    out = {}
    for name in TA.AUG_KEYS:
        v = np.stack([np.asarray(d[name]) for d in draws])
        out[name] = torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
    return out


def jax_mixup_draws(key, n, h, w, ma, ca) -> dict:
    ks = jax.random.split(key, 7)
    has_mix, has_cut = ma > 0, ca > 0
    return {"perm": np.asarray(jax.random.permutation(ks[0], n)),
            "lam_m": np.float32(jax.random.beta(ks[1], ma, ma)) if has_mix else np.float32(1),
            "lam_c0": np.float32(jax.random.beta(ks[2], ca, ca)) if has_cut else np.float32(1),
            "cy": int(jax.random.randint(ks[3], (), 0, h + 1)),
            "cx": int(jax.random.randint(ks[6], (), 0, w + 1)),
            "use_mix": bool(jax.random.bernoulli(ks[4], 0.5)),
            "use_mixup": bool(jax.random.bernoulli(ks[5], 0.5)) if (has_mix and has_cut)
            else has_mix}


def jax_masks(k_drop, spec_j, n: int, dropout: float, head_widths) -> dict:
    """The masks JAX's EfficientNet forward_train draws from k_drop, in the
    port's draw_masks layout."""
    r1, r2 = jax.random.split(k_drop)
    nb = len(spec_j.blocks)
    rngs = jax.random.split(r1, nb)
    dc = []
    for i, b in enumerate(spec_j.blocks):
        rate = 0.2 * i / nb
        if b.stride == 1 and b.cin == b.cout and rate > 0:
            m = np.asarray(jax.random.bernoulli(rngs[i], 1.0 - rate, (n, 1, 1, 1)))
            dc.append((torch.from_numpy(m.reshape(n).copy()), rate))
        else:
            dc.append(None)
    hr = jax.random.split(r2, 3)
    head = []
    for k, (rate, width) in enumerate(zip((dropout, dropout * 0.7, dropout * 0.5), head_widths)):
        m = np.asarray(jax.random.bernoulli(hr[k], 1.0 - rate, (n, width)))
        head.append((torch.from_numpy(m.copy()), rate) if rate > 0 else None)
    return {"drop_connect": dc, "head": head}


def small_effnet(seed: int = 0):
    spec_j, spec_t = small_specs()
    pj = jax_params(spec_j, seed, HEAD_DIMS)
    model = TE.EfficientNet(spec_t, head_dims=HEAD_DIMS)
    model.load_state_dict(params_from_jax(pj, model))
    return spec_j, spec_t, pj, model


def small_xception(seed: int = 9):
    spec_j = JX.XceptionSpec(middle_blocks=1)
    shapes = jax.eval_shape(lambda k: JX.init_params(k, spec_j), jax.random.PRNGKey(0))
    pj = randomize_bn(draw_params(shapes, seed), seed + 1)
    spec_t = TX.XceptionSpec(middle_blocks=1)
    model = TX.Xception(spec_t)
    model.load_state_dict(params_from_jax(pj, model))
    return spec_j, spec_t, pj, model
