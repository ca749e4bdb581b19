"""The sharded-state checkpoint backend (train/checkpoint.save_checkpoint_dcp /
load_checkpoint_dcp), the counterpart of the JAX package's orbax pair: the
cases of JAX's test_orbax_checkpoint_roundtrip (without a template, and
restored onto one), the two interrupted-swap states JAX's loader recovers
(.tmp and .old both present: the complete new .tmp wins; only .old: it is
rolled back), the metadata file readable with weights_only, and the JAX
dry run's section 1b on two gloo ranks of the CPU: a data-parallel step,
save, restore onto a template in a fresh state, and one more step equal
to the uninterrupted run's bit for bit."""

import os
import shutil

import numpy as np
import torch

from real_time_video_deepfake_detection_tpu_torch.core.config import TrainConfig
from real_time_video_deepfake_detection_tpu_torch.parallel import mesh
from real_time_video_deepfake_detection_tpu_torch.train.checkpoint import (
    load_checkpoint_dcp, save_checkpoint_dcp, template_like,
)

from tests import torch_dp_util
from tests.torch_port_util import HEAD_DIMS
from tests.torch_train_util import (  # noqa: F401 (one_torch_thread: autouse fixture)
    BIG, SIZE, fixture_crops, one_torch_thread, small_effnet,
)


def _state():
    return {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4),
            "n": {"c": torch.tensor(3)}}


def _assert_state(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_state(got[k], v)
        else:
            assert torch.equal(got[k], v), k


def test_dcp_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    key = torch.Generator().manual_seed(7).get_state()
    save_checkpoint_dcp(d, _state(), {"epoch": 5}, key)
    st, meta, rng = load_checkpoint_dcp(d)
    assert meta == {"epoch": 5} and torch.equal(rng, key)
    _assert_state(st, _state())
    template = template_like(_state())
    st2, _, _ = load_checkpoint_dcp(d, template)
    assert st2 is template
    _assert_state(st2, _state())
    side = torch.load(os.path.join(d, "meta.pt"), weights_only=True)
    assert side["metadata"] == {"epoch": 5}
    # a second save swaps the new checkpoint in and leaves nothing beside it
    save_checkpoint_dcp(d, {**_state(), "b": torch.zeros(4)}, {"epoch": 6})
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    st3, meta3, rng3 = load_checkpoint_dcp(d)
    assert meta3 == {"epoch": 6} and rng3 is None and torch.equal(st3["b"], torch.zeros(4))


def test_dcp_load_recovers_an_interrupted_swap(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint_dcp(d, _state(), {"epoch": 1})
    save_checkpoint_dcp(str(tmp_path / "new"), _state(), {"epoch": 2})
    # killed between rename(path, old) and rename(tmp, path)
    os.rename(d, d + ".old")
    os.rename(str(tmp_path / "new"), d + ".tmp")
    _, meta, _ = load_checkpoint_dcp(d)
    assert meta == {"epoch": 2} and sorted(os.listdir(tmp_path)) == ["ck", "ck.old"]
    # killed with only the previous checkpoint moved aside: roll back
    shutil.rmtree(d)
    _, meta, _ = load_checkpoint_dcp(d)
    assert meta == {"epoch": 1} and sorted(os.listdir(tmp_path)) == ["ck"]


def test_two_gloo_ranks_save_restore_and_resume_exactly(tmp_path):
    _, spec, _, model = small_effnet(3)
    b = 4
    cfg = TrainConfig(image_size=SIZE, batch_size=b, lr=1e-3, head_dropout=0.3)
    imgs = fixture_crops(b, BIG, seed=7)
    labels = np.array([0, 1] * (b // 2), np.float32)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    ranks = mesh.spawn(torch_dp_util.dcp_resume, ["cpu"] * 2,
                       args=(spec, HEAD_DIMS, init, cfg, 100, imgs, labels,
                             str(tmp_path / "ck")),
                       store_dir=str(tmp_path), timeout=240, num_threads=1)
    for r in ranks:
        live, restored = r["live"], r["restored"]
        assert r["meta"] == {"step": 1} and r["rng_equal"]
        assert live["metrics"] == restored["metrics"]
        assert (live["step"], live["count"]) == (restored["step"], restored["count"]) == (2, 2)
        for part in ("model", "ema"):
            for k, v in live[part].items():
                assert torch.equal(v, restored[part][k]), (part, k)
    for k, v in ranks[0]["live"]["model"].items():
        assert torch.equal(v, ranks[1]["live"]["model"][k]), k
