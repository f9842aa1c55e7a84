"""Loader for the JSON dataset-metadata tables shipped with the package.

The tables (class names, benchmark id maps, head/common/tail and base/novel
splits) are public ScanNet200 / ScanNet++ / Replica / S3DIS benchmark metadata
(reference: evaluation/dataset/scannet200.py etc.), stored as data files
rather than as thousands of lines of Python constants. The port's copy of
beyondff_tpu/data/_tables.py, with its own copies of the tables and splits.
"""

import functools
import json
import os

_TABLE_DIR = os.path.join(os.path.dirname(__file__), "tables")
_SPLIT_DIR = os.path.join(os.path.dirname(__file__), "splits")


@functools.lru_cache(maxsize=None)
def load_table(name: str) -> dict:
    with open(os.path.join(_TABLE_DIR, f"{name}.json")) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def load_split(name: str) -> tuple:
    """Scene-id list from a split file, e.g. ``scannetv2_val``."""
    with open(os.path.join(_SPLIT_DIR, f"{name}.txt")) as f:
        return tuple(line.strip() for line in f if line.strip())
