"""Frequency-domain feature maps (reference model.py:105-149).

Port of real_time_video_deepfake_detection_tpu/ops/freq_features.py: the
FFT magnitude (fftshift, then log1p, min-max normalised) stacked with the
DCT-II coefficients (log1p(|dct(gray / 255)|), normalised) as a (2, size,
size) float32 tensor, on the input's device. The DCT-II is the matmul form
D @ X @ D^T with the orthonormal basis, cv2.dct's convention. As in the
JAX package nothing on a serving or training path calls it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .color import bgr_to_gray_u8
from .resize import resize_bilinear_u8_cv2


@functools.lru_cache(maxsize=None)
def _dct_basis(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis matrix (cv2.dct convention), float32."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2 * n))
    m[0] *= np.sqrt(1.0 / n)
    m[1:] *= np.sqrt(2.0 / n)
    return m.astype(np.float32)


def _bases(x: torch.Tensor):
    return (torch.from_numpy(_dct_basis(x.shape[0])).to(x.device),
            torch.from_numpy(_dct_basis(x.shape[1])).to(x.device))


def dct2(x: torch.Tensor) -> torch.Tensor:
    """2-D DCT-II of an (N, M) float tensor, cv2.dct(x)."""
    dn, dm = _bases(x)
    return dn @ x @ dm.T


def idct2(x: torch.Tensor) -> torch.Tensor:
    """The inverse of dct2."""
    dn, dm = _bases(x)
    return dn.T @ x @ dm


def _minmax_norm(x: torch.Tensor) -> torch.Tensor:
    lo, hi = x.min(), x.max()
    return torch.where(hi - lo > 1e-6, (x - lo) / (hi - lo), torch.zeros_like(x))


def compute_frequency_features(image: torch.Tensor, size: int = 224) -> torch.Tensor:
    """uint8 (H, W, 3) BGR or (H, W) gray -> (2, size, size) float32:
    [FFT-magnitude channel, DCT channel]."""
    gray = bgr_to_gray_u8(image) if image.ndim == 3 else image
    gray = resize_bilinear_u8_cv2(gray, size, size).to(torch.float32)
    mag = _minmax_norm(torch.log1p(torch.abs(torch.fft.fftshift(torch.fft.fft2(gray)))))
    d = _minmax_norm(torch.log1p(torch.abs(dct2(gray / 255.0))))
    return torch.stack([mag, d], dim=0).to(torch.float32)
