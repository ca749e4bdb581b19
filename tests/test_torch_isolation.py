"""The port stands alone: it imports neither jax nor the JAX package (nor
cv2, PIL, orbax or requests), and its entry points do not drop to the CPU
when CUDA is absent."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import real_time_video_deepfake_detection_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(port.__file__)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([PORT_DIR], port.__name__ + "."))


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert len(mods) > 20
    p = port.__name__ + "."
    assert {p + "parallel.tensor_parallel", p + "ops.jpeg_scaled", p + "cli.fetch_weights",
            p + "data_tools.dfdc_download"} <= set(mods)
    code = (
        "import sys, importlib\n"
        "for blocked in ('jax', 'cv2', 'PIL', 'orbax', 'requests'):\n"
        "    sys.modules[blocked] = None\n"
        f"mods = {mods!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'real_time_video_deepfake_detection_tpu'\n"
        "       or m.startswith('real_time_video_deepfake_detection_tpu.')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]


def test_serving_imports_no_training_module():
    """The server, the engine and the detector load checkpoints and the
    calibrator lazily: importing them pulls in no module of train/."""
    code = (
        "import sys\n"
        "import real_time_video_deepfake_detection_tpu_torch.serving.server\n"
        "import real_time_video_deepfake_detection_tpu_torch.serving.multi\n"
        "import real_time_video_deepfake_detection_tpu_torch.pipeline.detector\n"
        "p = 'real_time_video_deepfake_detection_tpu_torch.'\n"
        "bad = [m for m in sys.modules if m.startswith(p + 'train.')\n"
        "       or m in (p + 'utils.weights', p + 'utils.torch_convert')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]


def test_parallel_imports_neither_jax_nor_training():
    """parallel/ (the mesh, the process group) imports no jax and no module
    of train/, nor do the sharded ticks of serving/batcher.py that use it."""
    code = (
        "import sys\n"
        "import real_time_video_deepfake_detection_tpu_torch.parallel.mesh\n"
        "import real_time_video_deepfake_detection_tpu_torch.serving.batcher as b\n"
        "assert callable(b.make_sharded_device_step_detect)\n"
        "p = 'real_time_video_deepfake_detection_tpu_torch.'\n"
        "bad = [m for m in sys.modules if m.startswith(p + 'train.')\n"
        "       or m.split('.')[0] in ('jax', 'jaxlib')\n"
        "       or m.startswith('real_time_video_deepfake_detection_tpu.')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]


def test_serving_and_detector_load_neither_keras_nor_transformers():
    """The donor converters import keras and transformers inside their file
    loaders only; serving and the detector never load them."""
    code = (
        "import sys\n"
        "import real_time_video_deepfake_detection_tpu_torch.serving.server\n"
        "import real_time_video_deepfake_detection_tpu_torch.serving.multi\n"
        "import real_time_video_deepfake_detection_tpu_torch.pipeline.detector\n"
        "import real_time_video_deepfake_detection_tpu_torch.models.gradcam\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('keras', 'tensorflow', 'transformers')]\n"
        "assert not bad, bad[:5]\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]


def test_every_port_module_imports_without_keras_or_transformers():
    mods = _port_modules()
    code = (
        "import sys, importlib\n"
        "for blocked in ('keras', 'tensorflow', 'transformers'):\n"
        "    sys.modules[blocked] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]


_JAX_PKG_IMPORT = re.compile(
    r"^\s*(from|import)\s+(jax\b|real_time_video_deepfake_detection_tpu(?!_torch)\b"
    r"|cv2\b|PIL\b)", re.MULTILINE)


def test_port_sources_and_chip_smoke_never_import_jax_package():
    """Nor cv2 or PIL, which the card's machine does not have."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PORT_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = []
    for f in files:
        with open(f) as fh:
            if _JAX_PKG_IMPORT.search(fh.read()):
                offenders.append(os.path.relpath(f, REPO))
    assert not offenders


def test_engine_without_device_raises_when_cuda_absent(monkeypatch):
    from real_time_video_deepfake_detection_tpu_torch.core.device import resolve_device
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import MultiStreamEngine
    from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import DeepfakeDetector
    from real_time_video_deepfake_detection_tpu_torch.serving.server import create_app
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (MultiStreamEngine, DeepfakeDetector, create_app):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_alone_fails_without_result(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as src:
        (tmp_path / "chip_smoke.py").write_text(src.read())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_video_entry_points_import_neither_jax_nor_cv2():
    """The video modules (reader and writer, encoder, drawing, the analyzer,
    the clip-head CLI, the data tools) load without jax, cv2 or the JAX
    package, and the walk of test_every_port_module_imports_without_jax
    covers them."""
    new = ["utils.video", "utils.jpeg_encode", "ops.draw", "ops.hershey", "cli.analyze",
           "train.clip_head", "data_tools.face_extract", "data_tools.dfdc_process"]
    mods = [f"{port.__name__}.{m}" for m in new]
    assert set(mods) <= set(_port_modules())
    code = (
        "import sys, importlib\n"
        "for blocked in ('jax', 'cv2', 'PIL'):\n"
        "    sys.modules[blocked] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and (\n"
        "       m.split('.')[0] in ('jax', 'jaxlib', 'cv2')\n"
        "       or m.startswith('real_time_video_deepfake_detection_tpu.'))]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
