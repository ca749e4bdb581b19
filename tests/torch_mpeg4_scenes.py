"""The frames of the mp4v writer's cases (tests/test_torch_mpeg4_writer.py,
tools/make_torch_mpeg4_writer_fixtures.py, chip_smoke.py's video phase):
integer numpy scenes from a seed, or the frames the port decodes from a
committed tests/data/torch_mpeg4 file, so that a machine without cv2
rebuilds them exactly. numpy and the port only.

CASES maps a case's name to (scene, frames, height, width, fps, extension):
every container (and an upper-case extension), 1, 12, 13 and 25 frames,
the fps values cv2 turns into odd time bases and bit rates (59.94 at
96x64 takes cv2's odd rounding, 600 at 1080p its INT_MAX cap, 60 at 1080p
a larger AVI index reserve), sizes from 96x64 to
1920x1080 (odd ones cut to even by the writer), a pan, noise (whose first
I-VOP rate control puts at quantiser 7), a cut to black (the encoder's
scene-change I-VOP inside a GOP), flat black and white, motion of 7 x 3
pixels a frame across GOPs (the previous vectors the search starts from),
jumps of 53 pixels (f_code 3 and more, long vectors made intra), a new
texture that pans after a cut the encoder codes as a P-VOP, half-pel
motion, 2x2 and 18x2 pictures, the decoded frames of two cv2-written
files, and "xy2": a band of noise (which holds the quantiser high) beside
white dots on black moving half a pixel a frame on the diagonal, whose
reconstructions ring down to 0, the one place where the row that
libavcodec's x86 sad16_approx_xy2 decrements (the odd rows of the block's
reference, saturating) changes a vector; its seed, found by a search,
separates that routine from decrementing the even rows and from
decrementing the lower row always (each writes other bytes than cv2's).
"""

from __future__ import annotations

import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_mpeg4")
SEED = 20

CASES = {
    "mp4_pan13": ("pan", 13, 112, 200, 25, ".mp4"),
    "mov_pan13": ("pan", 13, 112, 200, 25, ".mov"),
    "m4v_pan13": ("pan", 13, 112, 200, 25, ".m4v"),
    "avi_pan13": ("pan", 13, 112, 200, 25, ".avi"),
    "MP4_pan13": ("pan", 13, 112, 200, 25, ".MP4"),
    "mp4_pan1": ("pan", 1, 112, 200, 25, ".mp4"),
    "avi_pan12": ("pan", 12, 112, 200, 25, ".avi"),
    "mp4_pan25": ("pan", 25, 112, 200, 25, ".mp4"),
    "avi_pan25": ("pan", 25, 112, 200, 25, ".avi"),
    "mp4_ntsc": ("pan", 13, 64, 96, 30000 / 1001, ".mp4"),
    "avi_2997": ("pan", 13, 64, 96, 29.97, ".avi"),
    "mp4_12fps": ("pan", 13, 64, 96, 12, ".mp4"),
    "avi_7_5fps": ("pan", 13, 64, 96, 7.5, ".avi"),
    "mp4_59_94fps": ("pan", 13, 64, 96, 59.94, ".mp4"),
    "mp4_600fps_1920x1080": ("pan", 2, 1080, 1920, 600, ".mp4"),
    "avi_96x64": ("pan", 13, 64, 96, 25, ".avi"),
    "mp4_201x113": ("pan", 13, 113, 201, 25, ".mp4"),
    "avi_201x113": ("pan", 13, 113, 201, 25, ".avi"),
    "mp4_640x360": ("pan", 13, 360, 640, 25, ".mp4"),
    "mp4_1920x1080": ("pan", 2, 1080, 1920, 25, ".mp4"),
    "avi_1920x1080_60fps": ("pan", 2, 1080, 1920, 60, ".avi"),
    "avi_noise_640x360": ("noise", 4, 360, 640, 25, ".avi"),
    "mp4_cut": ("cut", 20, 112, 200, 25, ".mp4"),
    "avi_black": ("flat0", 13, 64, 96, 25, ".avi"),
    "mp4_white": ("flat255", 13, 64, 96, 25, ".mp4"),
    "avi_fast_96x64": ("fast", 30, 64, 96, 25, ".avi"),
    "mp4_jump_96x64": ("jump", 30, 64, 96, 25, ".mp4"),
    "avi_retexture_176x144": ("retexture", 30, 144, 176, 25, ".avi"),
    "mp4_halfpel_176x144": ("halfpel", 25, 144, 176, 25, ".mp4"),
    "mp4_2x2": ("fast", 30, 2, 2, 25, ".mp4"),
    "avi_18x2": ("fast", 30, 2, 18, 25, ".avi"),
    "mp4_clip": ("cv2_640x360.mp4", 12, 360, 640, 25, ".mp4"),
    "avi_face": ("cv2_face_272x320.mp4", 14, 320, 272, 12, ".avi"),
    "mp4_xy2": ("xy2", 13, 96, 128, 25, ".mp4"),
    "avi_xy2": ("xy2", 13, 96, 128, 25, ".avi"),
}
XY2_SEED = 2081
CUT_AT = 14   # the first black frame of the "cut" scene


def _texture(h: int, w: int, seed: int) -> np.ndarray:
    """A (h, w, 3) u8 scene: 8x8 blocks of random colour over ramps."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 192, (h // 8 + 1, w // 8 + 1, 3), dtype=np.int32)
    big = np.repeat(np.repeat(blocks, 8, 0), 8, 1)[:h, :w]
    ramp = (np.arange(h)[:, None, None] * 64 // max(h, 1)
            + np.arange(w)[None, :, None] * 64 // max(w, 1))
    return (big + ramp).clip(0, 255).astype(np.uint8)


def _xy2(n: int, h: int, w: int, seed: int):
    """The "xy2" scene: frame k is a dot texture bilinearly sampled at
    (k / 2, k / 2) with a band of fresh noise over its left 32-96 pixels."""
    rng = np.random.default_rng(seed)
    nf = rng.integers(1, 4)
    thick = rng.integers(1, 4)
    small = (rng.random((h // thick + 8, w // thick + 8)) < rng.uniform(0.05, 0.3))
    tex = np.repeat(np.repeat(small.astype(np.float32), thick, 0), thick, 1) * 255
    out = []
    for k in range(n):
        o = k // 2
        t = tex[o:o + h + 1, o:o + w + 1]
        f = (t[:-1, :-1] + t[1:, :-1] + t[:-1, 1:] + t[1:, 1:]) / 4 if k % 2 else t[:-1, :-1]
        f = np.repeat(f[:, :, None], 3, 2)
        f[:, :32 * nf] = rng.integers(0, 256, (h, 32 * nf, 3))
        out.append(np.ascontiguousarray(f.clip(0, 255).astype(np.uint8)))
    return out


def frames(scene: str, n: int, h: int, w: int, seed: int = SEED):
    """The n frames of a scene at h x w."""
    if scene.endswith(".mp4"):
        from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader
        reader = VideoReader(os.path.join(DATA, scene))
        out = []
        while len(out) < n:
            ok, f = reader.read()
            if not ok:
                break
            out.append(f)
        reader.release()
        assert len(out) == n and out[0].shape == (h, w, 3), (scene, len(out))
        return out
    if scene == "noise":
        rng = np.random.default_rng(seed)
        return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]
    if scene == "fast":
        y, x = np.mgrid[0:h, 0:w]
        return [np.ascontiguousarray(np.stack(
            [((((x + 7 * k) // 8 + (y + 3 * k) // 8) * 37 + 50 * c) & 255) for c in range(3)],
            -1).astype(np.uint8)) for k in range(n)]
    if scene == "jump":
        rng = np.random.default_rng(seed)
        base = np.repeat(np.repeat(rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3),
                                                dtype=np.uint8), 16, 0), 16, 1)[:h, :w]
        out, dy = [], 0
        for k in range(n):
            dy += 37 * (k % 3)
            out.append(np.ascontiguousarray(np.roll(base, (dy, -53 * k), (0, 1))))
        return out
    if scene == "retexture":
        rng = np.random.default_rng(seed)
        tex = np.repeat(np.repeat(rng.integers(0, 256, (h // 4 + 1, w // 4 + 1, 3),
                                               dtype=np.uint8), 4, 0), 4, 1)[:h, :w]
        fast = frames("fast", min(n, 7), h, w, seed)
        return fast + [np.ascontiguousarray(np.roll(tex, (-3 * (k - 7), -7 * (k - 7)), (0, 1)))
                       for k in range(7, n)]
    if scene == "halfpel":
        rng = np.random.default_rng(seed)
        t = rng.integers(0, 256, (h // 2 + n, w // 2 + n, 3)).astype(np.int32)
        r, d = np.roll(t, -1, 1), np.roll(t, -1, 0)
        big = np.zeros((2 * t.shape[0], 2 * t.shape[1], 3), np.int32)
        big[0::2, 0::2] = t
        big[0::2, 1::2] = (t + r + 1) // 2
        big[1::2, 0::2] = (t + d + 1) // 2
        big[1::2, 1::2] = (t + r + d + np.roll(d, -1, 1) + 2) // 4
        return [np.ascontiguousarray(big[k:k + h, k:k + w].astype(np.uint8)) for k in range(n)]
    if scene == "xy2":
        return _xy2(n, h, w, XY2_SEED)
    if scene in ("flat0", "flat255"):
        return [np.full((h, w, 3), 255 if scene == "flat255" else 0, np.uint8)] * n
    base = _texture(h + 64, w + 64, seed)
    out = [np.ascontiguousarray(np.roll(base, (-(k % 64), -(2 * k) % (w + 64)), (0, 1))[:h, :w])
           for k in range(n)]
    if scene == "cut":
        out = [f if k < CUT_AT else np.zeros_like(f) for k, f in enumerate(out)]
    return out


def case_frames(name: str):
    scene, n, h, w, _, _ = CASES[name]
    return frames(scene, n, h, w)
