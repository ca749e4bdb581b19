"""DFDC zip processor (reference process_dfdc.py behavior): the port's own
copy of real_time_video_deepfake_detection_tpu/data_tools/dfdc_process.py
(standard library only).

One zip at a time to fit constrained disk: read metadata.json from inside
the archive, keep ALL real videos plus a deterministic per-part fake sample
of equal size (seed 42+part), extract with per-file size verification and
resume-by-existence, update a progress JSON, delete the zip afterwards
unless --keep-zip. `--status` prints progress.
"""

from __future__ import annotations

import argparse
import json
import random
import re
import zipfile
from pathlib import Path

SEED = 42
OUTPUT_DIR = Path("dataset/dfdc_videos")
PROGRESS_FILE = Path("dataset/dfdc_progress.json")


def load_progress() -> dict:
    if PROGRESS_FILE.exists():
        return json.loads(PROGRESS_FILE.read_text())
    return {"parts_done": [], "real_count": 0, "fake_count": 0}


def save_progress(progress: dict) -> None:
    PROGRESS_FILE.parent.mkdir(parents=True, exist_ok=True)
    PROGRESS_FILE.write_text(json.dumps(progress, indent=2))


def detect_part_index(path_str: str) -> int:
    m = re.search(r"part[_-]?(\d+)", Path(path_str).name)
    if not m:
        raise ValueError(f"cannot detect part index in {path_str}")
    return int(m.group(1))


def _extract(zf: zipfile.ZipFile, names, dst_dir: Path, part_idx: int) -> int:
    dst_dir.mkdir(parents=True, exist_ok=True)
    ok = 0
    for filename, member in names:
        dst = dst_dir / f"part{part_idx}_{filename}"
        if dst.exists() and dst.stat().st_size > 1000:
            ok += 1
            continue
        try:
            dst.write_bytes(zf.read(member))
            if dst.stat().st_size > 1000:
                ok += 1
            else:
                dst.unlink()
        except Exception:
            pass
    return ok


def process_zip(zip_path: str, keep_zip: bool = False) -> None:
    zip_path = Path(zip_path)
    part_idx = detect_part_index(str(zip_path))
    progress = load_progress()
    if part_idx in progress["parts_done"]:
        print(f"Part {part_idx} already done.")
        return

    with zipfile.ZipFile(zip_path) as zf:
        meta_members = [n for n in zf.namelist() if n.endswith("metadata.json")]
        if not meta_members:
            raise RuntimeError("no metadata.json inside zip")
        meta = json.loads(zf.read(meta_members[0]))

        real, fake = [], []
        by_name = {Path(n).name: n for n in zf.namelist() if n.endswith(".mp4")}
        for filename, m in meta.items():
            member = by_name.get(filename)
            if member is None:
                continue
            (real if m.get("label") == "REAL" else fake).append((filename, member))

        rng = random.Random(SEED + part_idx)
        rng.shuffle(fake)
        fake_sel = fake[: len(real)]
        print(f"Part {part_idx}: {len(real)} real, {len(fake)} fake "
              f"-> keeping {len(real)} + {len(fake_sel)}")

        real_ok = _extract(zf, real, OUTPUT_DIR / "real", part_idx)
        fake_ok = _extract(zf, fake_sel, OUTPUT_DIR / "fake", part_idx)
        print(f"  extracted {real_ok} real, {fake_ok} fake")

    progress["parts_done"].append(part_idx)
    progress["real_count"] += real_ok
    progress["fake_count"] += fake_ok
    save_progress(progress)

    if not keep_zip:
        size_gb = zip_path.stat().st_size / 1e9
        zip_path.unlink()
        print(f"  deleted zip ({size_gb:.1f} GB freed)")


def process_folder(folder: str) -> None:
    for z in sorted(Path(folder).glob("*.zip")):
        process_zip(str(z))


def show_status() -> None:
    p = load_progress()
    total_real = len(list((OUTPUT_DIR / "real").glob("*.mp4")))
    total_fake = len(list((OUTPUT_DIR / "fake").glob("*.mp4")))
    print(json.dumps({**p, "on_disk_real": total_real,
                      "on_disk_fake": total_fake}, indent=2))


def main(argv=None):
    p = argparse.ArgumentParser(description="Process DFDC part zips")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--zip", help="process one zip")
    g.add_argument("--folder", help="process all zips in a folder")
    g.add_argument("--status", action="store_true")
    p.add_argument("--keep-zip", action="store_true")
    args = p.parse_args(argv)
    if args.status:
        show_status()
    elif args.zip:
        process_zip(args.zip, args.keep_zip)
    else:
        process_folder(args.folder)


if __name__ == "__main__":
    main()
