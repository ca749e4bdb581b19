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
            p + "data_tools.dfdc_download", p + "utils.image_decode", p + "utils.exif",
            p + "utils.png", p + "utils.bmp", p + "utils.mp4", p + "utils.h264",
            p + "utils.mpeg4", p + "utils.mjpeg", p + "utils.pxm", p + "utils.sunras",
            p + "utils.hdr", p + "utils.gif", p + "utils.tiff", p + "utils.webp",
            p + "utils.jpeg2000"} <= set(mods)
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


def test_h264_decodes_with_jax_and_cv2_blocked():
    """utils/h264.py builds and decodes an mp4 in a process where jax, cv2
    and the JAX package cannot be imported: the first frame of the 160x96
    Baseline file equals cv2's (tests/data/torch_h264/digests.json)."""
    code = (
        "import sys, hashlib, json\n"
        "for blocked in ('jax', 'cv2', 'PIL', 'real_time_video_deepfake_detection_tpu'):\n"
        "    sys.modules[blocked] = None\n"
        "from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader\n"
        "r = VideoReader('tests/data/torch_mp4/baseline_160x96.mp4')\n"
        "ok, f = r.read()\n"
        "want = json.load(open('tests/data/torch_h264/digests.json'))\n"
        "want = want['files']['torch_mp4/baseline_160x96.mp4']['read'][0]['sha256']\n"
        "assert ok and hashlib.sha256(f.tobytes()).hexdigest() == want\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("path, digests, key", [
    ("tests/data/torch_image_formats/p3_ascii_83x41.ppm",
     "tests/data/torch_image_formats/digests.json", "p3_ascii_83x41.ppm"),
    ("tests/data/torch_image_formats/ras8_colormap_83x41.ras",
     "tests/data/torch_image_formats/digests.json", "ras8_colormap_83x41.ras"),
    ("tests/data/torch_image_formats/hdr_rle_cv2_83x41.hdr",
     "tests/data/torch_image_formats/digests.json", "hdr_rle_cv2_83x41.hdr"),
    ("tests/data/torch_image_formats/gif_interlaced_83x41.gif",
     "tests/data/torch_image_formats/digests.json", "gif_interlaced_83x41.gif"),
    ("tests/data/torch_tiff_webp/tiff_cv2_lzw_pred_83x41.tif",
     "tests/data/torch_tiff_webp/digests.json", "tiff_cv2_lzw_pred_83x41.tif"),
    ("tests/data/torch_tiff_webp/tiff_jpeg_ycbcr420_83x41.tif",
     "tests/data/torch_tiff_webp/digests.json", "tiff_jpeg_ycbcr420_83x41.tif"),
    ("tests/data/torch_tiff_webp/webp_cv2_lossless_83x41.webp",
     "tests/data/torch_tiff_webp/digests.json", "webp_cv2_lossless_83x41.webp"),
    ("tests/data/torch_tiff_webp/webp_cv2_bgra_q80_83x41.webp",
     "tests/data/torch_tiff_webp/digests.json", "webp_cv2_bgra_q80_83x41.webp"),
    ("tests/data/torch_jpeg2000/j2k_cv2_q100_83x41.jp2",
     "tests/data/torch_jpeg2000/digests.json", "j2k_cv2_q100_83x41.jp2"),
    ("tests/data/torch_jpeg2000/j2k_opj_style_all_lossy_83x41.j2k",
     "tests/data/torch_jpeg2000/digests.json", "j2k_opj_style_all_lossy_83x41.j2k"),
])
def test_image_formats_decode_with_jax_and_cv2_blocked(path, digests, key):
    """utils/image_decode.cv2_route decodes PxM, Sun raster, HDR, GIF
    (csrc/image_host.cpp), TIFF (csrc/tiff.cpp, Python's zlib, the port's
    JPEG decoder), WebP (csrc/webp_lossless.cpp, csrc/vp8.cpp) and JPEG
    2000 (csrc/jpeg2000.cpp), each
    library built on first use, where jax, cv2 and the JAX package cannot
    be imported, equal to the committed cv2 digest."""
    code = (
        "import sys, hashlib, json\n"
        "for blocked in ('jax', 'cv2', 'PIL', 'real_time_video_deepfake_detection_tpu'):\n"
        "    sys.modules[blocked] = None\n"
        "from real_time_video_deepfake_detection_tpu_torch.utils.image_decode import cv2_route\n"
        f"f = cv2_route(open({path!r}, 'rb').read())\n"
        f"want = json.load(open({digests!r}))['inputs'][{key!r}]['cv2']['sha256']\n"
        "assert hashlib.sha256(f.tobytes()).hexdigest() == want\n")
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


def test_image_decoders_decode_without_jax_cv2_or_pil():
    """The decoders of every format (utils/image_decode, exif, png, bmp)
    load and decode with jax, cv2 and PIL blocked."""
    data = os.path.join(REPO, "tests", "data", "torch_formats")
    code = (
        "import os, sys\n"
        "for blocked in ('jax', 'jaxlib', 'cv2', 'PIL'):\n"
        "    sys.modules[blocked] = None\n"
        "from real_time_video_deepfake_detection_tpu_torch.utils import image_decode\n"
        f"d = {data!r}\n"
        "for name in ('prog_420_83x41.jpg', 'cmyk_83x41.jpg', 'exif6_83x41.jpg',\n"
        "             'png_adam7_rgb8_83x41.png', 'bmp_rle8_83x41.bmp'):\n"
        "    with open(os.path.join(d, name), 'rb') as fh:\n"
        "        assert image_decode.decode_frame(fh.read()) is not None, name\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cv2', 'PIL')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]


def test_jpeg_modes_and_mp4_demux_without_jax_cv2_or_pil():
    """The arithmetic and lossless JPEG decodes, the mp4 demuxer and the
    H.264 and MPEG-4 Part 2 decoders (utils/mp4, utils/h264, utils/mpeg4
    through utils/video.VideoReader on the High and mp4v files) load and run
    with jax, cv2 and PIL blocked."""
    data = os.path.join(REPO, "tests", "data")
    code = (
        "import os, sys\n"
        "for blocked in ('jax', 'jaxlib', 'cv2', 'PIL'):\n"
        "    sys.modules[blocked] = None\n"
        "from real_time_video_deepfake_detection_tpu_torch.utils import image_decode, mp4\n"
        "from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader\n"
        f"d = {data!r}\n"
        "for name in ('arith_seq_720x405_420.jpg', 'arith_prog_dac_s444_319x241.jpg',\n"
        "             'lossless_rgb_p4_83x41.jpg', 'lossless_cmyk_83x41.jpg'):\n"
        "    with open(os.path.join(d, 'torch_jpeg_modes', name), 'rb') as fh:\n"
        "        assert image_decode.decode_frame(fh.read()) is not None, name\n"
        "for name in ('high_160x96.mp4', 'mp4v_160x96.mp4'):\n"
        "    path = os.path.join(d, 'torch_mp4', name)\n"
        "    assert mp4.read(path).frame_count > 0, name\n"
        "    r = VideoReader(path)\n"
        "    assert r.is_opened() and r.read()[1].shape == (96, 160, 3), r.reason\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cv2', 'PIL')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]


def test_mp4v_writer_writes_without_jax_cv2_or_pil(tmp_path):
    """The mp4v writer (utils/video.VideoWriter, utils/mpeg4.Encoder,
    utils/mp4's muxer) and the scenes chip_smoke.py rebuilds
    (tests/torch_mpeg4_scenes) load and run with jax, cv2 and PIL blocked:
    an mp4 and an AVI case written equal to cv2's digests and read back."""
    code = (
        "import hashlib, json, os, sys\n"
        "for blocked in ('jax', 'jaxlib', 'cv2', 'PIL'):\n"
        "    sys.modules[blocked] = None\n"
        "from tests import torch_mpeg4_scenes as scenes\n"
        "from real_time_video_deepfake_detection_tpu_torch.utils.video import (\n"
        "    VideoReader, VideoWriter)\n"
        "with open(os.path.join('tests', 'data', 'torch_mpeg4_writer', 'digests.json')) as fh:\n"
        "    ref = json.load(fh)['cases']\n"
        "for name in ('mp4_pan13', 'avi_face'):\n"
        "    _, n, h, w, fps, ext = scenes.CASES[name]\n"
        f"    path = os.path.join({str(tmp_path)!r}, 'o' + ext)\n"
        "    wr = VideoWriter(path, 'mp4v', fps, (w, h))\n"
        "    for f in scenes.case_frames(name):\n"
        "        wr.write(f)\n"
        "    wr.release()\n"
        "    with open(path, 'rb') as fh:\n"
        "        assert hashlib.sha256(fh.read()).hexdigest() == ref[name]['sha256'], name\n"
        "    r = VideoReader(path)\n"
        "    assert r.frame_count == n and r.read()[1].shape == (h, w, 3), r.reason\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cv2', 'PIL')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
