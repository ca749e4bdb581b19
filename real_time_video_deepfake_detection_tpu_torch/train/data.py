"""The data side of training: the dataset directory, balanced sampling,
and the prefetching loader that feeds uint8 batches to the device
augmentation.

Port of real_time_video_deepfake_detection_tpu/train/data.py (reference
DeepfakeDataset layout, train.py:442-462: data_dir/split/{real,fake}/*.jpg;
the balanced WeightedRandomSampler cut to 2x the minority class per epoch,
train.py:519-540; DataLoader prefetch workers, train.py:829-838). The
loader only decodes and resizes to the (size + 20) canvas; every random
decision runs on the device (train/augment.py).

The JAX package reads images with cv2.imread and cv2.resize(INTER_LINEAR)
on host threads. Here a batch is loaded in one pass by the port's baseline
JPEG decoder and the cv2-exact resize, which give the same bytes: one
pooled entropy decode on the host (utils/jpeg_ingest.py, C threads, the
GIL released), then one reconstruction per JPEG layout (ops/jpeg_decode.py)
and one resize per source size (ops/resize.resize_bilinear_u8_cv2 with
OpenCV's border rows), batched in torch on the loader's device: on the
trainer's card the host's share is the entropy decode alone. A file the
decoder does not support (progressive or arithmetic JPEG, PNG, any other
format) raises UnsupportedImage, which the loader does not swallow:
substituting another sample would silently change the training set. A
corrupt or unreadable file is substituted, as in the JAX package
(train.py:512-513).
"""

from __future__ import annotations

import threading
from pathlib import Path
from queue import Empty, Queue
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..ops.resize import resize_bilinear_u8_cv2
from ..utils.jpeg_ingest import JpegError, decode_coefs_batch, reconstruct

# JpegError statuses of a damaged stream (truncated, corrupt); every other
# refusal is a format the decoder does not support
_DAMAGED = (-2, -3)


class UnsupportedImage(ValueError):
    """An image in a format the port's decoder does not read; names the file."""


class DeepfakeDataset:
    def __init__(self, data_dir: str, split: str = "train", image_size: int = 224):
        self.dir = Path(data_dir) / split
        self.split = split
        self.image_size = image_size
        self.samples: List[Tuple[str, int]] = []
        for p in sorted((self.dir / "real").glob("*.jpg")):
            self.samples.append((str(p), 0))
        for p in sorted((self.dir / "fake").glob("*.jpg")):
            self.samples.append((str(p), 1))
        # PNGs are listed as in the JAX package (so the sampling is the
        # same); loading one raises UnsupportedImage
        for label, sub in ((0, "real"), (1, "fake")):
            for p in sorted((self.dir / sub).glob("*.png")):
                self.samples.append((str(p), label))
        self.labels = np.array([l for _, l in self.samples], np.int64)

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def class_counts(self) -> np.ndarray:
        return np.bincount(self.labels, minlength=2)

    def load_size(self) -> int:
        # train loads onto the +20 canvas for the device's random crop
        return self.image_size + (20 if self.split == "train" else 0)

    def load_image(self, idx: int) -> np.ndarray:
        """(s, s, 3) RGB u8 at load_size(). OSError for an unreadable or
        damaged file, UnsupportedImage for a format the decoder refuses."""
        img = self.load_images([idx])[0]
        if isinstance(img, Exception):
            raise img
        return img.numpy()

    def load_images(self, idxs, n_threads: int = 0, device="cpu") -> list:
        """load_image over `idxs` in one pass, the images as u8 tensors on
        `device`; an entry is the exception load_image would raise where
        it raises. n_threads: entropy decode threads (0 = one per core)."""
        out: list = [None] * len(idxs)
        todo = []
        for k, i in enumerate(idxs):
            path = self.samples[int(i)][0]
            try:
                with open(path, "rb") as f:
                    todo.append((k, path, f.read()))
            except OSError as e:
                out[k] = e
        groups: dict = {}
        for (k, path, _), r in zip(todo, decode_coefs_batch([d for *_, d in todo], n_threads)):
            if isinstance(r, JpegError):
                out[k] = (OSError if r.status in _DAMAGED else UnsupportedImage)(f"{path}: {r}")
            else:
                groups.setdefault(r.layout, []).append((k, r))
        s = self.load_size()
        for members in groups.values():
            bgr = reconstruct([r for _, r in members], device)
            rgb = resize_bilinear_u8_cv2(bgr, s, s, cv2_rows=True).flip(-1)
            for (k, _), img in zip(members, rgb):
                out[k] = img
        return out


def balanced_epoch_indices(labels: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """2x-minority weighted sample with replacement (train.py:519-540)."""
    counts = np.bincount(labels, minlength=2)
    if counts[0] == 0 or counts[1] == 0:
        missing = "fake" if counts[1] == 0 else "real"
        raise RuntimeError(f"Training set has 0 {missing} samples!")
    w = (1.0 / counts)[labels]
    w = w / w.sum()
    n = 2 * int(counts.min())
    return rng.choice(len(labels), size=n, replace=True, p=w)


class BatchLoader:
    """Prefetching batch iterator yielding (u8 RGB batch, a tensor on
    `device`; float32 labels, numpy), loaded by a producer thread
    (num_workers: its entropy-decode threads). Drops the last partial batch
    in training."""

    def __init__(self, dataset: DeepfakeDataset, batch_size: int, shuffle: bool,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 4,
                 balanced: bool = False, drop_last: Optional[bool] = None,
                 device="cpu"):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.balanced = balanced
        self.rng = np.random.default_rng(seed)
        self.workers = num_workers
        self.prefetch = prefetch
        self.drop_last = shuffle if drop_last is None else drop_last
        self.device = torch.device(device)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self.balanced:
            idx = balanced_epoch_indices(self.ds.labels, self.rng)
        else:
            idx = np.arange(len(self.ds))
            if self.shuffle:
                self.rng.shuffle(idx)
        nb = len(idx) // self.bs if self.drop_last else -(-len(idx) // self.bs)
        batches = [idx[i * self.bs:(i + 1) * self.bs] for i in range(nb)]

        q: Queue = Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                for b in batches:
                    if stop.is_set():
                        break
                    imgs = self.ds.load_images(b, self.workers, self.device)
                    for k, img in enumerate(imgs):
                        if isinstance(img, UnsupportedImage):
                            raise img
                        if isinstance(img, Exception):
                            imgs[k] = torch.from_numpy(self._safe_load(b[k])).to(self.device)
                    q.put((torch.stack(imgs), self.ds.labels[b].astype(np.float32)))
                q.put(None)
            except BaseException as e:   # handed to the consumer, re-raised there
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # end the producer before returning: a thread left running
            # torch ops aborts the interpreter's exit
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except Empty:
                    pass
            t.join()

    def _safe_load(self, i: int) -> np.ndarray:
        # corrupt file -> random other sample (train.py:512-513)
        for _ in range(10):
            try:
                return self.ds.load_image(int(i))
            except UnsupportedImage:
                raise
            except Exception:
                i = self.rng.integers(0, len(self.ds))
        s = self.ds.load_size()
        return np.zeros((s, s, 3), np.uint8)

    def __len__(self) -> int:
        n = 2 * int(self.ds.class_counts.min()) if self.balanced else len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

