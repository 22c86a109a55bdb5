"""Server-simulation data tooling — the reference's
``data/server_simulation/{distribute_data, calc_class_distribution,
delete_all_but_n}.py`` as one importable module + CLI.

Port of ``primia_tpu/data/distribute.py`` (which imports no JAX; the port
keeps its own copy): the same layout, seeds and file choices, so both
packages lay out the same files.

Semantics preserved:

* ``distribute``: shuffle the train set with seed 0, deal round-robin
  (``idcs[i::num_workers]``) into ``worker1..N/<class>/``, copy or
  symlink (``distribute_data.py:60-100``).
* ``class_distribution``: per-worker per-class image counts as a table
  (``calc_class_distribution.py``).
* ``trim``: keep only the first n images per class folder — the
  ``make minimal_server_folders`` smoke-scale path (``Makefile:37-38``),
  optionally sparing ``validation``.

CLI:
    python -m primia_tpu_torch.data.distribute distribute --train_data_src data/train --dest data/server_simulation [--num_workers 3] [--symbolic]
    python -m primia_tpu_torch.data.distribute stats --root data/server_simulation
    python -m primia_tpu_torch.data.distribute trim --root data/server_simulation -n 4 [--spare_validation]
"""

from __future__ import annotations

import argparse
import os
import random
import shutil
import sys
from pathlib import Path
from typing import Dict, List


_IMG_EXTS = {".jpeg", ".jpg", ".png", ".bmp", ".gif", ".tiff", ".dcm"}


def _images(folder: Path) -> List[Path]:
    return sorted(
        f for f in folder.iterdir()
        if f.is_file() and f.suffix.lower() in _IMG_EXTS and not f.name.startswith("._")
    )


def distribute(train_data_src, dest, num_workers: int = 3,
               symbolic: bool = False, seed: int = 0,
               validation_split: int = 10) -> Dict[str, int]:
    """Deal the train folder round-robin into worker1..N under ``dest``.

    The first ``validation_split`` percent of the seeded shuffle goes to
    a local ``validation/`` folder (the federated trainer evaluates on
    it; the reference's distribute script had the same split sketched
    and its shipped server_simulation data carries a validation folder).
    Set ``validation_split=0`` to deal everything to workers.
    """
    src = Path(train_data_src)
    dest = Path(dest)
    classes = sorted(d.name for d in src.iterdir() if d.is_dir())
    # (class, path) pairs in ImageFolder order, then a seeded shuffle
    pairs = [(c, p) for c in classes for p in _images(src / c)]
    idcs = list(range(len(pairs)))
    random.seed(seed)
    random.shuffle(idcs)

    n_val = (len(idcs) * validation_split) // 100 if validation_split else 0
    splits = {"validation": idcs[:n_val]} if n_val else {}
    train_idcs = idcs[n_val:]
    for w in range(num_workers):
        splits[f"worker{w + 1}"] = train_idcs[w::num_workers]

    counts: Dict[str, int] = {}
    for wname, take in splits.items():
        counts[wname] = len(take)
        for cls in classes:  # every class dir exists even when it gets 0 images
            (dest / wname / cls).mkdir(parents=True, exist_ok=True)
        for i in take:
            cls, p = pairs[i]
            d = dest / wname / cls
            target = d / p.name
            if target.exists():
                continue
            if symbolic:
                target.symlink_to(p.resolve())
            else:
                shutil.copyfile(p, target)
    return counts


def class_distribution(root) -> Dict[str, Dict[str, int]]:
    """{worker -> {class -> #images}} for a worker1..N/class tree."""
    root = Path(root)
    dist: Dict[str, Dict[str, int]] = {}
    for worker in sorted(d for d in root.iterdir() if d.is_dir()):
        for cls in sorted(d for d in worker.iterdir() if d.is_dir()):
            dist.setdefault(worker.name, {})[cls.name] = len(_images(cls))
    return dist


def format_distribution(dist: Dict[str, Dict[str, int]]) -> str:
    classes = sorted({c for d in dist.values() for c in d})
    header = ["worker"] + classes + ["total"]
    rows = [header]
    for w, d in sorted(dist.items()):
        rows.append([w] + [str(d.get(c, 0)) for c in classes]
                    + [str(sum(d.values()))])
    widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
    lines = ["  ".join(v.ljust(widths[i]) for i, v in enumerate(r)) for r in rows]
    return "\n".join(lines)


def trim(root, n: int, spare_validation: bool = False) -> int:
    """Delete all but the first n images in every class folder under
    ``root`` (the 4-image smoke fixture recipe). Returns #deleted."""
    root = Path(root)
    deleted = 0
    for dirpath, dirnames, filenames in os.walk(root):
        if spare_validation and "validation" in Path(dirpath).parts:
            continue
        imgs = _images(Path(dirpath))
        for p in imgs[n:]:
            p.unlink()
            deleted += 1
    return deleted


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("distribute")
    d.add_argument("--train_data_src", default="data/train")
    d.add_argument("--dest", default="data/server_simulation")
    d.add_argument("--num_workers", type=int, default=3)
    d.add_argument("-s", "--symbolic", action="store_true")

    s = sub.add_parser("stats")
    s.add_argument("--root", default="data/server_simulation")

    t = sub.add_parser("trim")
    t.add_argument("-n", type=int, required=True)
    t.add_argument("--root", default="data/server_simulation")
    t.add_argument("--spare_validation", action="store_true")
    t.add_argument("--yes", action="store_true",
                   help="skip the interactive double confirmation")

    a = p.parse_args(argv)
    if a.cmd == "distribute":
        counts = distribute(a.train_data_src, a.dest, a.num_workers, a.symbolic)
        print(counts)
    elif a.cmd == "stats":
        print(format_distribution(class_distribution(a.root)))
    elif a.cmd == "trim":
        if not a.yes:
            # the reference's double confirmation (this DELETES data)
            if input("This DELETES data. Proceed? [y/N]\t").lower() not in ("y", "yes") \
               or input("Are you really sure? [y/N]\t").lower() not in ("y", "yes"):
                print("aborting")
                return 1
        print(f"deleted {trim(a.root, a.n, a.spare_validation)} files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
