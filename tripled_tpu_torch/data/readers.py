"""Split-file readers (`tripled_tpu/data/readers.py`). The split lists are
data, read from `$TRIPLED_SPLITS_DIR/<split>/` or this package's
`data/splits/<split>/`, the first that holds the file."""

from __future__ import annotations

import os


def _split_dirs() -> tuple:
    # read at call time, so that a program may set TRIPLED_SPLITS_DIR after
    # importing the package
    return (
        os.environ.get("TRIPLED_SPLITS_DIR", ""),
        os.path.join(os.path.dirname(__file__), "splits"),
    )


def readlines(path: str) -> list[str]:
    with open(path) as f:
        return [line.rstrip() for line in f if line.strip()]


def split_file_path(split: str, filename: str) -> str:
    """Resolve e.g. ('exp', 'train_files.txt') against the split roots."""
    for root in _split_dirs():
        if not root:
            continue
        p = os.path.join(root, split, filename)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"split file {split}/{filename} not found in {_split_dirs()}; set TRIPLED_SPLITS_DIR")
