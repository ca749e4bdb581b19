"""ops/draw.py against cv2, bit for bit: cv2.rectangle (LINE_8, thickness
-1, 1, 2, 3, off-frame and negative coordinates), cv2.addWeighted on all
65,536 u8 pairs, COLORMAP_JET on all 256 levels, all against the installed
cv2 5.0; and the Hershey text of FONT_HERSHEY_SIMPLEX (putText,
getTextSize) against OpenCV 4.6.

cv2 5.0 draws FONT_HERSHEY_SIMPLEX through its TrueType text engine, with
other glyphs and metrics; the port draws the Hershey strokes cv2 drew up to
4.x. The text tests run OpenCV 4.6 through a Python that has it (Debian's
python3-opencv under /usr/bin/python3.11) and skip where there is none.
ops/hershey.py is held to a fresh run of tools/extract_hershey.py on the
system's libopencv_imgproc.so.4.6.0, skipped where the library is absent.
"""

import os
import pickle
import random
import subprocess
import sys

import cv2
import numpy as np
import pytest

from real_time_video_deepfake_detection_tpu_torch.ops import draw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY_OPENCV4 = "/usr/bin/python3.11"
LIBIMGPROC = "/usr/lib/x86_64-linux-gnu/libopencv_imgproc.so.4.6.0"

# run by OpenCV 4's Python: cases and results as builtin types only
_OPENCV4_SCRIPT = r"""
import pickle, sys
import cv2, numpy as np
assert cv2.__version__.startswith("4."), cv2.__version__
out = []
for kind, args in pickle.load(sys.stdin.buffer):
    if kind == "text":
        raw, shape, text, org, scale, color, th = args
        img = np.frombuffer(raw, np.uint8).reshape(shape).copy()
        cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, color, th)
        out.append(img.tobytes())
    else:
        text, scale, th = args
        (w, h), b = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, th)
        out.append(((int(w), int(h)), int(b)))
pickle.dump(out, sys.stdout.buffer, protocol=4)
"""


@pytest.fixture(scope="module")
def opencv4():
    """Runs a list of ("text" | "size", args) cases through OpenCV 4."""
    if not os.path.exists(PY_OPENCV4):
        pytest.skip(f"no {PY_OPENCV4} with OpenCV 4 to hold the Hershey text to")
    probe = subprocess.run([PY_OPENCV4, "-c", "import cv2; print(cv2.__version__)"],
                           capture_output=True, text=True, timeout=60)
    if probe.returncode != 0 or not probe.stdout.startswith("4."):
        pytest.skip("no OpenCV 4 for the Hershey text")

    def run(cases):
        r = subprocess.run([PY_OPENCV4, "-c", _OPENCV4_SCRIPT],
                           input=pickle.dumps(cases, protocol=4), capture_output=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        return pickle.loads(r.stdout)
    return run


def _rect_cases(n, seed):
    rng = random.Random(seed)
    for k in range(n):
        h, w = rng.randint(20, 90), rng.randint(20, 90)
        p1 = (rng.randint(-40, w + 40), rng.randint(-40, h + 40))
        p2 = (rng.randint(-40, w + 40), rng.randint(-40, h + 40))
        color = tuple(rng.randint(0, 255) for _ in range(3))
        yield k, (h, w), p1, p2, color, (-1, 1, 2, 3)[k % 4]


def test_rectangle_equals_cv2():
    """600 rectangles: every thickness, corners off the frame on every side."""
    for k, (h, w), p1, p2, color, t in _rect_cases(600, 0):
        img = np.random.default_rng(k).integers(0, 256, (h, w, 3), np.uint8)
        want = cv2.rectangle(img.copy(), p1, p2, color, t)
        got = draw.rectangle(img.copy(), p1, p2, color, t)
        np.testing.assert_array_equal(got, want, err_msg=str((h, w, p1, p2, t)))


def test_the_overlay_rectangles_equal_cv2():
    """What the detector draws: the face box (3), the label band from
    y - 30 (negative near the top), the frame border (2), the filled bar."""
    img = np.random.default_rng(1).integers(0, 256, (480, 640, 3), np.uint8)
    for p1, p2, t in (((250, 12), (390, 193), 3), ((250, -18), (461, 12), -1),
                      ((2, 2), (638, 478), 2), ((0, 0), (640, 30), -1),
                      ((600, 400), (700, 520), 3), ((-5, -40), (20, -1), -1)):
        np.testing.assert_array_equal(draw.rectangle(img.copy(), p1, p2, (0, 200, 255), t),
                                      cv2.rectangle(img.copy(), p1, p2, (0, 200, 255), t))


def test_add_weighted_equals_cv2_on_every_pair():
    a = np.repeat(np.arange(256, dtype=np.uint8), 256).reshape(256, 256, 1).repeat(3, 2)
    b = np.tile(np.arange(256, dtype=np.uint8), 256).reshape(256, 256, 1).repeat(3, 2)
    for alpha, beta, gamma in ((0.6, 0.4, 0.0), (0.4, 0.6, 0.0), (0.5, 0.5, 3.0)):
        np.testing.assert_array_equal(draw.add_weighted(a, alpha, b, beta, gamma),
                                      cv2.addWeighted(a, alpha, b, beta, gamma))


def test_jet_equals_cv2_on_every_level():
    levels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(draw.apply_colormap_jet(levels),
                                  cv2.applyColorMap(levels, cv2.COLORMAP_JET))


SCALES = (0.35, 0.5, 0.7)


def test_text_of_every_character_equals_opencv4(opencv4):
    cases, got = [], []
    for scale in SCALES:
        for th in (1, 2):
            for c in map(chr, range(32, 127)):
                img = np.zeros((40, 40, 3), np.uint8)
                cases.append(("text", (img.tobytes(), img.shape, c, (8, 28), scale,
                                       (255, 255, 255), th)))
                got.append(draw.put_text(img, c, (8, 28), scale, (255, 255, 255), th))
                cases.append(("size", (c, scale, th)))
                got.append(draw.get_text_size(c, scale, th))
    _compare(opencv4(cases), cases, got)


def test_text_strings_equal_opencv4(opencv4):
    """Random strings at random origins, off the frame and across its edges,
    in random colours over random pixels, and the detector's labels."""
    rng = random.Random(2)
    chars = [chr(c) for c in range(32, 127)]
    texts = [("FAKE (Frame: 97%)", 0.7, 2), ("REAL (Frame: 3%)", 0.7, 2),
             ("Votes: F:3 R:7 (Last 10 frames)", 0.5, 1),
             ("[Frame Analysis] ANALYZING (50%)", 0.5, 1),
             ("FFT:12 | Noise:40 | ELA:7 | Edge:99", 0.35, 1)]
    texts += [("".join(rng.choice(chars) for _ in range(rng.randint(1, 24))),
               rng.choice(SCALES), rng.choice((1, 2))) for _ in range(150)]
    cases, got = [], []
    for k, (text, scale, th) in enumerate(texts):
        h, w = rng.randint(10, 60), rng.randint(10, 240)
        img = np.random.default_rng(k).integers(0, 256, (h, w, 3), np.uint8)
        org = (rng.randint(-40, w), rng.randint(-10, h + 25))
        color = tuple(rng.randint(0, 255) for _ in range(3))
        cases.append(("text", (img.tobytes(), img.shape, text, org, scale, color, th)))
        got.append(draw.put_text(img, text, org, scale, color, th))
        cases.append(("size", (text, scale, th)))
        got.append(draw.get_text_size(text, scale, th))
    _compare(opencv4(cases), cases, got)


def _compare(want, cases, got):
    assert len(want) == len(cases)
    for (kind, args), w, g in zip(cases, want, got):
        if kind == "text":
            np.testing.assert_array_equal(g, np.frombuffer(w, np.uint8).reshape(g.shape),
                                          err_msg=repr(args[2:]))
        else:
            assert g == (tuple(w[0]), w[1]), args


def test_text_refuses_characters_outside_printable_ascii():
    with pytest.raises(ValueError):
        draw.put_text(np.zeros((20, 20, 3), np.uint8), "é", (2, 15), 0.5, (1, 2, 3), 1)


def test_committed_font_equals_a_fresh_extraction(tmp_path):
    if not os.path.exists(LIBIMGPROC):
        pytest.skip(f"{LIBIMGPROC} is absent")
    pytest.importorskip("elftools")
    out = tmp_path / "hershey.py"
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", "extract_hershey.py"),
                        "--out", str(out)], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "sha256" in r.stdout
    committed = os.path.join(REPO, "real_time_video_deepfake_detection_tpu_torch", "ops",
                             "hershey.py")
    with open(committed) as fh:
        assert out.read_text() == fh.read()
