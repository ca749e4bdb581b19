"""DFDC video downloader (reference download_dfdc.py behavior).

Port of real_time_video_deepfake_detection_tpu/data_tools/dfdc_download.py
(the `rtvdd-download-dfdc` script): sequential Kaggle HTTP downloads with
three auth methods, exponential backoff on 429 from 60 s capped at 15
minutes, resumable by existence with a size check, and the balanced
real:fake selection (seed 42 + part) driven by the per-part metadata.json
files. The JAX tool uses `requests`; this one uses urllib.request, which
every Python has. It needs the network only when an operator runs it.

    python -m real_time_video_deepfake_detection_tpu_torch.data_tools.dfdc_download --parts 10
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import random
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

KAGGLE_DATASET = "pranay22077/dfdc-10"
NUM_PARTS = 10
OUTPUT_DIR = Path("dataset/dfdc_videos")
META_DIR = Path("dataset/dfdc_meta")
SEED = 42

_BACKOFF_START = 60.0
_BACKOFF_CAP = 15 * 60.0


def part_prefix(i: int) -> str:
    return f"dfdc_train_part_{i:02d}/dfdc_train_part_{i}"


class Response:
    """What fetch_file reads of an HTTP response: its status, and its body
    in chunks."""

    def __init__(self, status_code: int, body=None, url: str = ""):
        self.status_code = status_code
        self._body = body
        self.url = url

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise urllib.error.HTTPError(self.url, self.status_code, "HTTP error", None, None)

    def iter_content(self, n: int):
        try:
            while True:
                chunk = self._body.read(n)
                if not chunk:
                    return
                yield chunk
        finally:
            self._body.close()


class Session:
    """A urllib stand-in for the requests.Session the JAX tool uses: fixed
    headers on every request, GET only."""

    def __init__(self, headers: dict):
        self.headers = dict(headers)

    def get(self, url: str, timeout: float = 120) -> Response:
        req = urllib.request.Request(url, headers=self.headers)
        try:
            return Response(200, urllib.request.urlopen(req, timeout=timeout), url)
        except urllib.error.HTTPError as e:
            e.close()
            return Response(e.code, None, url)


def _basic(user: str, key: str) -> dict:
    token = base64.b64encode(f"{user}:{key}".encode()).decode()
    return {"Authorization": f"Basic {token}"}


def kaggle_session() -> Session:
    """A Session with whichever Kaggle credentials exist: a bearer token in
    $KAGGLE_API_TOKEN, ~/.kaggle/kaggle.json, or the KAGGLE_USERNAME /
    KAGGLE_KEY pair."""
    token = os.environ.get("KAGGLE_API_TOKEN")
    if token:
        return Session({"Authorization": f"Bearer {token}"})
    kj = Path.home() / ".kaggle" / "kaggle.json"
    if kj.exists():
        creds = json.loads(kj.read_text())
        return Session(_basic(creds["username"], creds["key"]))
    user, key = os.environ.get("KAGGLE_USERNAME"), os.environ.get("KAGGLE_KEY")
    if user and key:
        return Session(_basic(user, key))
    sys.exit("No Kaggle credentials: set KAGGLE_API_TOKEN, ~/.kaggle/"
             "kaggle.json, or KAGGLE_USERNAME/KAGGLE_KEY")


def fetch_file(session, remote: str, local: Path, delay: float = 0.5,
               max_retries: int = 20) -> bool:
    """One file: exponential backoff on 429, a body over 1 KB kept, resume
    by existence of a file over 1 KB."""
    if local.exists() and local.stat().st_size > 1000:
        return True
    local.parent.mkdir(parents=True, exist_ok=True)
    url = (f"https://www.kaggle.com/api/v1/datasets/download/"
           f"{KAGGLE_DATASET}/{urllib.parse.quote(remote, safe='')}")
    backoff = _BACKOFF_START
    for attempt in range(max_retries):
        try:
            r = session.get(url, timeout=120)
            if r.status_code == 429:
                print(f"    429 — backing off {backoff:.0f}s "
                      f"(attempt {attempt + 1})")
                time.sleep(backoff)
                backoff = min(backoff * 2, _BACKOFF_CAP)
                continue
            r.raise_for_status()
            tmp = local.with_suffix(local.suffix + ".part")
            with open(tmp, "wb") as f:
                for chunk in r.iter_content(1 << 20):
                    f.write(chunk)
            if tmp.stat().st_size > 1000:
                tmp.rename(local)
                time.sleep(delay)
                return True
            tmp.unlink()
        except Exception as e:   # any failure of one attempt: back off, retry
            print(f"    error: {e}; retrying in {backoff:.0f}s")
            time.sleep(backoff)
            backoff = min(backoff * 2, _BACKOFF_CAP)
    return False


def balanced_selection(meta: dict, part_idx: int):
    """All real + an equal-count deterministic sample of fakes
    (seed 42 + part, matching the processing tool)."""
    real = [f for f, m in meta.items() if m.get("label") == "REAL"]
    fake = [f for f, m in meta.items() if m.get("label") == "FAKE"]
    rng = random.Random(SEED + part_idx)
    rng.shuffle(fake)
    return sorted(real), fake[: len(real)]


def main(argv=None):
    p = argparse.ArgumentParser(description="Download balanced DFDC videos")
    p.add_argument("--delay", type=float, default=0.5)
    p.add_argument("--parts", type=int, default=NUM_PARTS)
    args = p.parse_args(argv)

    session = kaggle_session()
    for i in range(args.parts):
        prefix = part_prefix(i)
        meta_local = META_DIR / f"part_{i}_metadata.json"
        print(f"Part {i}: metadata...")
        if not fetch_file(session, f"{prefix}/metadata.json", meta_local,
                          args.delay):
            print(f"  part {i}: metadata failed, skipping")
            continue
        meta = json.loads(meta_local.read_text())
        real, fake = balanced_selection(meta, i)
        print(f"  {len(real)} real + {len(fake)} fake videos")
        for label, names in (("real", real), ("fake", fake)):
            outdir = OUTPUT_DIR / label
            for name in names:
                ok = fetch_file(session, f"{prefix}/{name}",
                                outdir / f"part{i}_{name}", args.delay)
                if not ok:
                    print(f"    FAILED: {name}")
    print("Done.")


if __name__ == "__main__":
    main()
