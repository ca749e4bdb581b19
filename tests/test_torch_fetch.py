"""The port's artifact fetchers, offline: cli/fetch_weights.py (the cases of
the JAX package's tests/test_fetch_weights.py, with the port's verifiers
on artifacts made here: the port's synthetic SSD pair, a seeded MTCNN
state dict, an ImageNet-shaped B0 state dict and the committed Haar XML;
the download stubbed) and data_tools/dfdc_download.py (the balanced
selection equal to JAX's on the same metadata.json, resume by size, and
the 429 backoff from 60 s capped at 15 minutes with a stub session and
time.sleep patched out). Nothing here touches the network."""

import hashlib
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from real_time_video_deepfake_detection_tpu.data_tools import dfdc_download as jdd
from real_time_video_deepfake_detection_tpu_torch.cli import fetch_weights as fw
from real_time_video_deepfake_detection_tpu_torch.data_tools import dfdc_download as dd
from real_time_video_deepfake_detection_tpu_torch.models.efficientnet import EfficientNetSpec
from real_time_video_deepfake_detection_tpu_torch.models.mtcnn import init_random_mtcnn
from real_time_video_deepfake_detection_tpu_torch.utils.ssd_synth import res10_class_ssd
from real_time_video_deepfake_detection_tpu_torch.utils.torch_convert import (
    make_imagenet_shaped_state_dict,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAAR_XML = os.path.join(REPO, "tests", "data", "torch_haar",
                        "haarcascade_frontalface_default.xml")


def test_list_and_dry_run(capsys, tmp_path):
    fw.main(["--list"])
    out = capsys.readouterr().out
    for name in ("res10_300x300_ssd_iter_140000_fp16.caffemodel", "deploy.prototxt",
                 "pnet.pt", "efficientnet-b0-355c32eb.pth"):
        assert name in out
    fw.main(["--dest", str(tmp_path), "--only", "ssd", "--dry-run"])
    assert "would fetch" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "deploy.prototxt")


def test_artifact_table_equals_jax():
    from real_time_video_deepfake_detection_tpu.cli import fetch_weights as jfw
    table = {k: [(f, u) for f, u, _ in v] for k, v in fw.ARTIFACTS.items()}
    assert table == {k: [(f, u) for f, u, _ in v] for k, v in jfw.ARTIFACTS.items()}
    assert fw._BUILTIN_SHA256_PREFIX == jfw._BUILTIN_SHA256_PREFIX


def test_verifiers_accept_real_format_artifacts(tmp_path):
    proto, cm = res10_class_ssd(str(tmp_path / "ssd"), seed=0)
    assert "layers" in fw._verify_prototxt(proto)
    assert "blobs" in fw._verify_caffemodel(cm)
    assert "stages" in fw._verify_haar_xml(HAAR_XML)
    for net, sd in init_random_mtcnn(3).items():
        path = str(tmp_path / f"{net}.pt")
        torch.save(sd, path)
        assert net in fw._verify_mtcnn_pt(net)(path)
    path = str(tmp_path / "efficientnet-b0.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                make_imagenet_shaped_state_dict(EfficientNetSpec.make("b0"), 0).items()}, path)
    assert "params" in fw._verify_effnet_imagenet(path)


def test_verifiers_reject_garbage(tmp_path):
    bad = str(tmp_path / "bad.bin")
    with open(bad, "wb") as f:
        f.write(b"\x00\x01garbage" * 100)
    for v in (fw._verify_prototxt, fw._verify_caffemodel, fw._verify_haar_xml,
              fw._verify_mtcnn_pt("pnet"), fw._verify_effnet_imagenet):
        with pytest.raises(Exception):
            v(bad)
    # a state dict of the wrong net fails the strict load
    path = str(tmp_path / "pnet.pt")
    torch.save(init_random_mtcnn(0)["rnet"], path)
    with pytest.raises(RuntimeError):
        fw._verify_mtcnn_pt("pnet")(path)


def _stub_ssd(monkeypatch, payload: bytes, calls: list):
    def fake_download(url, dest, retries=4, timeout=60.0):
        calls.append(url)
        with open(dest, "wb") as f:
            f.write(payload)

    monkeypatch.setattr(fw, "download", fake_download)
    monkeypatch.setitem(fw.ARTIFACTS, "ssd", [
        ("deploy.prototxt", "http://example/deploy.prototxt", fw._verify_prototxt)])


def test_fetch_skip_existing_verify_and_pin(tmp_path, monkeypatch, capsys):
    proto_src, _ = res10_class_ssd(str(tmp_path / "src"), seed=0)
    payload = open(proto_src, "rb").read()
    calls = []
    _stub_ssd(monkeypatch, payload, calls)
    dest = str(tmp_path / "w")
    assert fw.fetch(["ssd"], dest) == 0 and len(calls) == 1
    assert os.path.exists(os.path.join(dest, "deploy.prototxt"))
    # resume by existence: no new download, the present file re-verified
    assert fw.fetch(["ssd"], dest) == 0 and len(calls) == 1
    assert "already present, verified" in capsys.readouterr().out
    # a wrong pin fails and removes the file; the right one passes
    assert fw.fetch(["ssd"], dest, force=True, sha256={"deploy.prototxt": "0" * 64}) == 1
    assert not os.path.exists(os.path.join(dest, "deploy.prototxt"))
    good = hashlib.sha256(payload).hexdigest()
    assert fw.fetch(["ssd"], dest, sha256={"deploy.prototxt": good}) == 0


def test_fetch_removes_unparseable_download(tmp_path, monkeypatch):
    _stub_ssd(monkeypatch, b"not a prototxt at all {{{", [])
    dest = str(tmp_path / "w")
    assert fw.fetch(["ssd"], dest) == 1
    assert not os.path.exists(os.path.join(dest, "deploy.prototxt"))


def test_builtin_prefix_pin_refuses_a_stale_file(tmp_path, capsys):
    """The torch-hub name's 8 hex digits pin the file even when present."""
    path = tmp_path / "efficientnet-b0-355c32eb.pth"
    torch.save({k: torch.from_numpy(v) for k, v in
                make_imagenet_shaped_state_dict(EfficientNetSpec.make("b0"), 0).items()},
               str(path))
    assert fw.fetch(["effnet_b0_imagenet"], str(tmp_path)) == 1
    assert "torch-hub filename prefix" in capsys.readouterr().out


def test_haar_is_skipped_where_the_cascade_is_found(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HAARCASCADE_DIR", os.path.dirname(HAAR_XML))
    calls = []
    monkeypatch.setattr(fw, "download", lambda *a, **k: calls.append(a))
    assert fw.fetch(["haar"], str(tmp_path)) == 0 and not calls
    assert "[skip]" in capsys.readouterr().out


def test_dry_run_with_present_files_stays_dry(tmp_path, capsys):
    (tmp_path / "deploy.prototxt").write_bytes(b"garbage that would FAIL the verifier")
    assert fw.fetch(["ssd"], str(tmp_path), dry_run=True) == 0
    out = capsys.readouterr().out
    assert "[FAIL]" not in out and "[dry-run]" in out


def _metadata(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {f"v{i:04d}.mp4": {"label": "REAL" if rng.random() < 0.2 else "FAKE",
                              "split": "train"} for i in range(n)}


@pytest.mark.parametrize("part", [0, 3, 9])
def test_dfdc_selection_equals_jax(part, tmp_path):
    meta_file = tmp_path / "metadata.json"
    meta_file.write_text(json.dumps(_metadata(200, part)))
    meta = json.loads(meta_file.read_text())
    real, fake = dd.balanced_selection(meta, part)
    assert (real, fake) == jdd.balanced_selection(meta, part)
    assert len(real) == len(fake) > 0
    assert dd.part_prefix(part) == jdd.part_prefix(part)


class _StubSession:
    """Answers 429 `throttle` times, then the body."""

    def __init__(self, body: bytes, throttle: int = 0):
        self.body, self.throttle, self.urls = body, throttle, []

    def get(self, url, timeout=120):
        self.urls.append(url)
        if self.throttle:
            self.throttle -= 1
            return dd.Response(429, None, url)
        return dd.Response(200, io.BytesIO(self.body), url)


def test_dfdc_fetch_resumes_by_size_and_backs_off_capped(tmp_path, monkeypatch):
    sleeps = []
    monkeypatch.setattr(dd.time, "sleep", sleeps.append)
    local = tmp_path / "out" / "a.mp4"
    s = _StubSession(b"x" * 5000, throttle=6)
    assert dd.fetch_file(s, "part/a.mp4", local, delay=0.5)
    assert local.read_bytes() == b"x" * 5000
    assert sleeps == [60.0, 120.0, 240.0, 480.0, 900.0, 900.0, 0.5]
    assert s.urls[0].endswith("pranay22077/dfdc-10/part%2Fa.mp4")
    # present and over 1 KB: no request
    s2 = _StubSession(b"y" * 5000)
    assert dd.fetch_file(s2, "part/a.mp4", local) and s2.urls == []
    # a body of 1 KB or less is not kept; the retries run out
    small = tmp_path / "out" / "b.mp4"
    s3 = _StubSession(b"z" * 100)
    assert not dd.fetch_file(s3, "part/b.mp4", small, max_retries=3)
    assert not small.exists() and len(s3.urls) == 3


def test_dfdc_session_auth_methods(tmp_path, monkeypatch):
    monkeypatch.setattr(Path, "home", lambda: tmp_path)
    for k in ("KAGGLE_API_TOKEN", "KAGGLE_USERNAME", "KAGGLE_KEY"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="No Kaggle credentials"):
        dd.kaggle_session()
    monkeypatch.setenv("KAGGLE_USERNAME", "u")
    monkeypatch.setenv("KAGGLE_KEY", "k")
    assert dd.kaggle_session().headers == {"Authorization": "Basic dTpr"}
    (tmp_path / ".kaggle").mkdir()
    (tmp_path / ".kaggle" / "kaggle.json").write_text('{"username": "a", "key": "b"}')
    assert dd.kaggle_session().headers == {"Authorization": "Basic YTpi"}
    monkeypatch.setenv("KAGGLE_API_TOKEN", "t")
    assert dd.kaggle_session().headers == {"Authorization": "Bearer t"}
