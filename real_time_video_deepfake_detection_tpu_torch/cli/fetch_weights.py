"""Fetch the user-supplied detector/aligner weight artifacts.

Port of real_time_video_deepfake_detection_tpu/cli/fetch_weights.py (the
`rtvdd-fetch-weights` script), with the same artifact table, URLs, flags
(--list, --dry-run, --only, --force, --dest, --sha256), retries with
exponential backoff, resume-by-existence and built-in sha256 prefix pin.
The reference assumes the operator downloads the public face-detection
artifacts by hand (reference face_detection.py:19-34); this CLI pulls them
into a weights directory, skipping what is present, retrying transient
failures, and then verifies each file STRUCTURALLY with the port's own
loaders (utils/prototxt, utils/caffe_convert, models/haar_cascade, the
MTCNN nets of models/mtcnn, utils/torch_convert), so a corrupt or truncated
file fails here instead of at server boot. It needs the network only when
an operator runs it; --list and --dry-run touch nothing.

Artifacts:
  ssd    deploy.prototxt + res10_300x300_ssd_iter_140000_fp16.caffemodel
         (OpenCV's face-detector samples; serve with
         `--ssd-weights weights/res10_...caffemodel --device-detect`)
  haar   haarcascade_frontalface_default.xml (OpenCV data; the haar_native
         rung). Skipped when models/haar_cascade.find_cascade_xml already
         finds one ($HAARCASCADE_DIR or the distro's opencv4 directory);
         the JAX fetcher looks in the cv2 wheel instead
  mtcnn  pnet.pt / rnet.pt / onet.pt (facenet-pytorch's published weights;
         serve with `--mtcnn-weights weights/mtcnn [--mtcnn-device]`)
  effnet_b0_imagenet
         efficientnet-b0-355c32eb.pth, the ImageNet init the reference's
         model constructor downloads (reference model.py:40-41); train with
         `--pretrained` to start from it

    python -m real_time_video_deepfake_detection_tpu_torch.cli.fetch_weights --list

Checksum note: upstream republishes some of these files, so instead of
pinning hashes that rot, verification parses the bytes with the code that
will consume them. `--sha256 name=hexdigest` adds a strict pin.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time
import urllib.error
import urllib.request


def _verify_prototxt(path: str) -> str:
    from ..utils.prototxt import as_list, load_prototxt
    net = load_prototxt(path)
    layers = as_list(net.get("layer", []))
    if not layers:
        raise ValueError("no layers parsed")
    return f"{len(layers)} layers"


def _verify_caffemodel(path: str) -> str:
    from ..utils.caffe_convert import load_caffemodel
    blobs = load_caffemodel(path)
    if not blobs:
        raise ValueError("no weight blobs parsed")
    n = sum(len(v) for v in blobs.values())
    return f"{len(blobs)} layers / {n} blobs"


def _verify_haar_xml(path: str) -> str:
    from ..models.haar_cascade import HaarCascade
    c = HaarCascade.from_xml(path)
    return f"{len(c.stages)} stages, {c.win_w}x{c.win_h} window"


def _verify_mtcnn_pt(net: str):
    def check(path: str) -> str:
        import torch
        from ..models.mtcnn import build_nets
        # weights_only=True: facenet's pnet/rnet/onet .pt files are plain
        # tensor state dicts, so verification never unpickles arbitrary
        # objects from a just-downloaded file; the strict load of build_nets
        # refuses a missing or unexpected key
        sd = torch.load(path, map_location="cpu", weights_only=True)
        module = build_nets({net: sd}, "cpu", names=(net,))[net]
        n = sum(p.numel() for p in module.state_dict().values())
        return f"{net}: {n} params"
    return check


def _verify_effnet_imagenet(path: str) -> str:
    """Parse a bare efficientnet_pytorch/timm ImageNet checkpoint with the
    converter that the trainer's --pretrained path will use."""
    import torch
    from ..models.efficientnet import EfficientNet, EfficientNetSpec
    from ..utils.torch_convert import convert_imagenet_state_dict
    sd = torch.load(path, map_location="cpu", weights_only=True)
    spec = EfficientNetSpec.make("b0")
    state = convert_imagenet_state_dict(sd, spec, torch.Generator().manual_seed(0))
    EfficientNet(spec).load_state_dict(state)
    n = sum(v.numel() for v in state.values())
    return f"b0 imagenet backbone + fresh head: {n} params"


_OPENCV_RAW = "https://raw.githubusercontent.com/opencv/opencv/4.x"
_OPENCV_3RD = ("https://raw.githubusercontent.com/opencv/opencv_3rdparty/"
               "dnn_samples_face_detector_20180205_fp16")
_FACENET_RAW = "https://raw.githubusercontent.com/timesler/facenet-pytorch/master"
_EFFNET_REL = ("https://github.com/lukemelas/EfficientNet-PyTorch/releases/"
               "download/1.0")

# name -> list of (filename, url, verifier)
ARTIFACTS = {
    "ssd": [
        ("deploy.prototxt",
         f"{_OPENCV_RAW}/samples/dnn/face_detector/deploy.prototxt",
         _verify_prototxt),
        ("res10_300x300_ssd_iter_140000_fp16.caffemodel",
         f"{_OPENCV_3RD}/res10_300x300_ssd_iter_140000_fp16.caffemodel",
         _verify_caffemodel),
    ],
    "haar": [
        ("haarcascade_frontalface_default.xml",
         f"{_OPENCV_RAW}/data/haarcascades/haarcascade_frontalface_default.xml",
         _verify_haar_xml),
    ],
    "mtcnn": [
        (os.path.join("mtcnn", f"{net}.pt"),
         f"{_FACENET_RAW}/data/{net}.pt",
         _verify_mtcnn_pt(net))
        for net in ("pnet", "rnet", "onet")
    ],
    # The ImageNet-pretrained B0 the reference's constructor requires
    # (reference model.py:40-41 EfficientNet.from_pretrained): the
    # efficientnet_pytorch release artifact. The torch-hub filename suffix
    # (355c32eb) is the leading 8 hex chars of the file's sha256, which the
    # fetcher checks as a built-in pin.
    "effnet_b0_imagenet": [
        ("efficientnet-b0-355c32eb.pth",
         f"{_EFFNET_REL}/efficientnet-b0-355c32eb.pth",
         _verify_effnet_imagenet),
    ],
}

# torch-hub naming convention: <name>-<sha256[:8]>.<ext>. Checked on every
# fetch AND on resume-by-existence, so a stale/corrupt present file cannot
# report success.
_BUILTIN_SHA256_PREFIX = {
    "efficientnet-b0-355c32eb.pth": "355c32eb",
}


def download(url: str, dest: str, retries: int = 4,
             timeout: float = 60.0) -> None:
    """Stream `url` to `dest` atomically (tmp+rename), exponential backoff
    on transient failures (the download_dfdc.py retry ladder, capped)."""
    tmp = dest + ".part"
    delay = 5.0
    for attempt in range(retries):
        try:
            req = urllib.request.Request(
                url, headers={"User-Agent": "rtvdd-fetch-weights"})
            with urllib.request.urlopen(req, timeout=timeout) as r, \
                    open(tmp, "wb") as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            os.replace(tmp, dest)
            return
        except (urllib.error.URLError, OSError) as e:
            if os.path.exists(tmp):
                os.remove(tmp)
            if attempt == retries - 1:
                raise
            print(f"  retry {attempt + 1}/{retries - 1} in {delay:.0f}s "
                  f"({e})", flush=True)
            time.sleep(delay)
            delay = min(delay * 2, 300.0)


def _check_file(dest: str, fname: str, verify, want: str | None) -> str:
    """Pin-check (full sha256 or torch-hub 8-hex prefix) then structurally
    verify `dest`. Returns the verifier's detail string; raises on mismatch."""
    base = os.path.basename(fname)
    digest = None
    if want or base in _BUILTIN_SHA256_PREFIX:
        with open(dest, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
    if want and digest != want:
        raise ValueError(f"sha256 {digest} != pinned {want}")
    prefix = _BUILTIN_SHA256_PREFIX.get(base)
    if prefix and not digest.startswith(prefix):
        raise ValueError(
            f"sha256 {digest[:8]}... != torch-hub filename prefix {prefix}")
    return verify(dest)


def fetch(names, dest_dir: str, force: bool = False, dry_run: bool = False,
          sha256: dict | None = None) -> int:
    """Fetch + verify the named artifact groups. Returns count of failures.

    Already-present files are NOT trusted: they re-run the pin check and the
    structural verifier (so `--sha256` pins apply to resumed runs too), and
    only re-download on --force."""
    sha256 = sha256 or {}
    failures = 0
    for name in names:
        for fname, url, verify in ARTIFACTS[name]:
            dest = os.path.join(dest_dir, fname)
            if os.path.exists(dest) and not force:
                if dry_run:
                    # a dry run only LISTS planned work: it must not hash
                    # 20MB+ files or run the structural verifiers, and
                    # must never report failures
                    print(f"[dry-run] {fname} present; a real run would "
                          f"verify it (pin + structural parse)")
                    continue
                try:
                    detail = _check_file(dest, fname,
                                         verify, sha256.get(os.path.basename(fname)))
                    print(f"[ok] {fname} already present, verified ({detail})")
                except Exception as e:
                    print(f"[FAIL] {fname}: present but failed verification "
                          f"({type(e).__name__}: {e}); re-run with --force "
                          f"to replace")
                    failures += 1
                continue
            if name == "haar" and not force:
                # $HAARCASCADE_DIR or the distro's opencv4 data may hold it
                from ..models.haar_cascade import find_cascade_xml
                found = find_cascade_xml(os.path.basename(fname))
                if found:
                    print(f"[skip] {fname}: found at {found}")
                    continue
            if dry_run:
                print(f"[dry-run] would fetch {url} -> {dest}")
                continue
            os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
            print(f"[fetch] {url}")
            try:
                download(url, dest)
            except Exception as e:
                print(f"[FAIL] {fname}: download failed: {e}")
                failures += 1
                continue
            try:
                detail = _check_file(dest, fname,
                                     verify, sha256.get(os.path.basename(fname)))
            except Exception as e:
                print(f"[FAIL] {fname}: downloaded but failed verification "
                      f"({type(e).__name__}: {e}); removing")
                os.remove(dest)
                failures += 1
                continue
            print(f"[ok] {fname} ({detail})")
    return failures


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Download the public detector/aligner weight artifacts")
    p.add_argument("--dest", default="weights",
                   help="destination directory (default: ./weights, the "
                        "reference's layout)")
    p.add_argument("--only", nargs="*", choices=sorted(ARTIFACTS),
                   default=sorted(ARTIFACTS),
                   help="artifact groups to fetch (default: all)")
    p.add_argument("--force", action="store_true",
                   help="re-download even if present")
    p.add_argument("--dry-run", action="store_true",
                   help="print what would be fetched, touch nothing")
    p.add_argument("--list", action="store_true", dest="list_only",
                   help="list artifacts and exit")
    p.add_argument("--sha256", nargs="*", default=[], metavar="FILE=HEX",
                   help="optional strict pins, e.g. "
                        "deploy.prototxt=ab12...")
    args = p.parse_args(argv)

    if args.list_only:
        for name in sorted(ARTIFACTS):
            for fname, url, _ in ARTIFACTS[name]:
                print(f"{name:6} {fname:55} {url}")
        return

    pins = {}
    for spec in args.sha256:
        if "=" not in spec:
            sys.exit(f"--sha256 expects FILE=HEX, got {spec!r}")
        k, v = spec.split("=", 1)
        pins[k] = v.lower()

    failures = fetch(args.only, args.dest, force=args.force,
                     dry_run=args.dry_run, sha256=pins)
    if failures:
        sys.exit(f"{failures} artifact(s) failed")


if __name__ == "__main__":
    main()
