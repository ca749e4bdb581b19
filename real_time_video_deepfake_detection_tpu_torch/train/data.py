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
on host threads. Here a batch is loaded in one pass on cv2.imread's route
(utils/image_decode) and the cv2-exact resize, which give the same bytes:
one pooled entropy decode of the batch's JPEGs on the host
(utils/jpeg_ingest.py, C threads, the GIL released), then one
reconstruction per JPEG layout (ops/jpeg_decode.py), each image turned by
its EXIF orientation, and one resize per source size
(ops/resize.resize_bilinear_u8_cv2 with OpenCV's border rows), batched in
torch on the loader's device: on the trainer's card the host's share is
the entropy decode alone. PNG and BMP files and lossless JPEGs decode on
the host (utils/png.py, utils/bmp.py, utils/jpeg_ingest.lossless_bgr). A
file cv2 would refuse (a truncated or corrupt JPEG, a 12-bit one, a
grayscale lossless one, a damaged PNG, anything unreadable) is
substituted, as in the JAX package (train.py:512-513). A file the port
cannot decode although cv2 might (AVIF, a TIFF with a compression or
photometric the port lacks, a JPEG 2000 file with a feature
utils/jpeg2000.py refuses by name, a JPEG over 2^25 pixels; WebP, TIFF and
JPEG 2000 are decoded, utils/image_decode) raises UnsupportedImage, which the
loader does not swallow: substituting another sample would silently
change the training set.
"""

from __future__ import annotations

import threading
from pathlib import Path
from queue import Empty, Queue
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..ops.resize import resize_bilinear_u8_cv2
from ..utils.exif import apply_orientation, jpeg_orientation
from ..utils.image_decode import JPEG_SIGNATURE, as_bgr, cv2_route, unported_format
from ..utils.jpeg_ingest import LOSSLESS, JpegError, decode_coefs_batch, reconstruct

# JpegError statuses of a stream cv2 refuses too (truncated, corrupt, 12- or
# 16-bit and the other unsupported codings); every other refusal is a
# stream the port cannot decode
_DAMAGED = (-2, -3, -4)


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
        # also accept png (the tooling writes jpg; users may add png)
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
        """(s, s, 3) RGB u8 at load_size(). OSError for a file cv2.imread
        refuses, UnsupportedImage for one the port cannot decode."""
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
        s = self.load_size()

        def resized(bgr: torch.Tensor) -> torch.Tensor:
            return resize_bilinear_u8_cv2(bgr, s, s, cv2_rows=True).flip(-1)

        jpegs = [t for t in todo if t[2].startswith(JPEG_SIGNATURE)]
        groups: dict = {}
        lossless = set()   # decoded below as samples, on cv2's route
        for (k, path, data), r in zip(jpegs, decode_coefs_batch([d for *_, d in jpegs],
                                                                n_threads, route="cv2")):
            if isinstance(r, JpegError) and r.status == LOSSLESS:
                lossless.add(k)
            elif isinstance(r, JpegError):
                out[k] = (OSError if r.status in _DAMAGED else UnsupportedImage)(f"{path}: {r}")
            else:
                groups.setdefault((r.layout, jpeg_orientation(data)), []).append((k, r))
        for (_, orientation), members in groups.items():
            bgr = apply_orientation(reconstruct([r for _, r in members], device), orientation)
            for (k, _), img in zip(members, resized(bgr)):
                out[k] = img
        for k, path, data in todo:
            if data.startswith(JPEG_SIGNATURE) and k not in lossless:
                continue
            frame = as_bgr(cv2_route(data, from_file=True))   # PNG, BMP, lossless JPEG, ...
            if frame is None:
                out[k] = UnsupportedImage(f"{path}: a format the port does not decode") \
                    if unported_format(data) else OSError(f"{path}: cv2.imread refuses it")
            else:
                out[k] = resized(torch.from_numpy(frame).to(device)[None])[0]
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
    in training.

    Data-parallel rank `rank` of `world_size` decodes only its contiguous
    batch_size / world_size rows of each global batch of batch_size; every
    rank draws the epoch order of one process from the same seed. A corrupt
    file's substitute comes from the epoch generator in one process (as in
    the JAX loader) and from a generator of the rank's own in a group, so
    that the epoch orders stay in step on every rank."""

    def __init__(self, dataset: DeepfakeDataset, batch_size: int, shuffle: bool,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 4,
                 balanced: bool = False, drop_last: Optional[bool] = None,
                 device="cpu", rank: int = 0, world_size: int = 1):
        if batch_size % world_size:
            raise ValueError(f"batch size {batch_size} does not divide over "
                             f"{world_size} ranks")
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.balanced = balanced
        self.rng = np.random.default_rng(seed)
        self.sub_rng = self.rng if world_size == 1 else np.random.default_rng([seed, rank])
        self.rank, self.world = rank, world_size
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
        batches = [self._own(idx[i * self.bs:(i + 1) * self.bs]) for i in range(nb)]

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

    def _own(self, batch: np.ndarray) -> np.ndarray:
        """This rank's contiguous rows of a global batch (a last partial
        batch, which only evaluation keeps, must divide too)."""
        if self.world == 1:
            return batch
        if len(batch) % self.world:
            raise ValueError(f"a batch of {len(batch)} does not divide over "
                             f"{self.world} ranks")
        b = len(batch) // self.world
        return batch[self.rank * b:(self.rank + 1) * b]

    def _safe_load(self, i: int) -> np.ndarray:
        # corrupt file -> random other sample (train.py:512-513)
        for _ in range(10):
            try:
                return self.ds.load_image(int(i))
            except UnsupportedImage:
                raise
            except Exception:
                i = self.sub_rng.integers(0, len(self.ds))
        s = self.ds.load_size()
        return np.zeros((s, s, 3), np.uint8)

    def __len__(self) -> int:
        n = 2 * int(self.ds.class_counts.min()) if self.balanced else len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

