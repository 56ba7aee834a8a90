"""Dataset discovery with reference directory-layout parity.

The port's own copy of ``brepgen_tpu/data/discovery.py``.

Native equivalents of the reference's file-discovery helpers
(``data_process/convert_utils.py:40-183``): given the official
DeepCAD/ABC/Furniture on-disk layouts, produce the same train/val/test
uid lists the reference pipelines consume.

Layouts:
  * DeepCAD / ABC pkls: ``root/0000/123.pkl`` .. ``root/0099/...`` —
    10k-solid shard folders named by zero-padded ``id // 10000``.
  * DeepCAD split: the official ``train_val_test_split.json`` with
    ``{"train"|"validation"|"test": ["0000/00001234", ...]}`` entries
    (reference ``convert_utils.py:56-60``). Not shipped here — point
    ``split_json`` at the file from the dataset release.
  * ABC / Furniture: seeded 90/5/5 random split
    (``convert_utils.py:64-75,118-126``; the reference uses an unseeded
    ``random.shuffle`` — here the rng is explicit so splits reproduce).
  * ABC STEP: ``root/abc_0000_step_v00/00001234/*.step``
    (``convert_utils.py:146-156``).
  * Furniture: flat ``root/<class>/<file>.pkl`` / recursive ``.step``.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

_SHARD_RE = re.compile(r"^\d{4}$")


def load_deepcad_split(split_json: str) -> Tuple[Set[str], Set[str], Set[str]]:
    """Official DeepCAD uid sets, keyed by the file-id half of 'shard/id'."""
    with open(split_json) as f:
        data = json.load(f)
    pick = lambda key: {uid.split("/")[1] for uid in data[key]}
    return pick("train"), pick("validation"), pick("test")


def _shard_dirs(root_dir: str) -> List[str]:
    """Existing 4-digit shard folders under root, sorted."""
    try:
        names = sorted(os.listdir(root_dir))
    except FileNotFoundError:
        return []
    return [n for n in names if _SHARD_RE.match(n) and os.path.isdir(os.path.join(root_dir, n))]


def load_abc_pkl(
    root_dir: str,
    use_deepcad: bool,
    split_json: str = "train_val_test_split.json",
    seed: int = 0,
) -> Tuple[List[str], List[str], List[str]]:
    """Discover sharded pkls and split them (``convert_utils.py:40-95``).

    Returns (train, val, test) as bare pkl file names, exactly like the
    reference (paths are re-derived from the id via the shard rule,
    ``dataset.py:94-100``). DeepCAD uses the official split json; ABC a
    seeded 90/5/5 shuffle. Files whose uid appears in no split are
    skipped with a warning (the reference hard-asserts).
    """
    shards = _shard_dirs(root_dir)
    files: List[str] = []
    for shard in shards:
        files += sorted(os.listdir(os.path.join(root_dir, shard)))
    files = [f for f in files if f.endswith(".pkl")]

    if use_deepcad:
        train_uid, val_uid, test_uid = load_deepcad_split(split_json)
    else:
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(files))
        n_train = int(len(files) * 0.9)
        n_val = int(len(files) * 0.95)
        key = lambda f: f.split(".")[0]
        train_uid = {key(files[i]) for i in order[:n_train]}
        val_uid = {key(files[i]) for i in order[n_train:n_val]}
        test_uid = {key(files[i]) for i in order[n_val:]}

    train, val, test, unknown = [], [], [], 0
    for f in files:
        key_id = f.split(".")[0]
        if key_id in train_uid:
            train.append(f)
        elif key_id in val_uid:
            val.append(f)
        elif key_id in test_uid:
            test.append(f)
        else:
            unknown += 1
    if unknown:
        print(f"load_abc_pkl: {unknown} pkls not in any split (skipped)")
    return train, val, test


def load_furniture_pkl(
    root_dir: str, seed: int = 0
) -> Tuple[List[str], List[str], List[str]]:
    """Recursive furniture pkl discovery + seeded 90/5/5 split
    (``convert_utils.py:98-126``). Uids keep their 'class/file.pkl' tail
    so the class label stays derivable (``dataset.py:100``)."""
    full: List[str] = []
    for root, _dirs, files in os.walk(root_dir):
        for name in sorted(files):
            if name.endswith(".pkl"):
                full.append(os.path.join(root, name))
    rng = np.random.default_rng(seed)
    full = [full[i] for i in rng.permutation(len(full))]
    n_train = int(len(full) * 0.9)
    n_val = int(len(full) * 0.95)
    tail = lambda p: "/".join(p.replace(os.sep, "/").split("/")[-2:])
    return (
        [tail(p) for p in full[:n_train]],
        [tail(p) for p in full[n_train:n_val]],
        [tail(p) for p in full[n_val:]],
    )


def load_abc_step(
    root_dir: str,
    use_deepcad: bool,
    split_json: str = "train_val_test_split.json",
    n_chunks: int = 100,
) -> List[str]:
    """ABC STEP folder paths in release layout (``convert_utils.py:132-161``):
    chunk ``abc_{i:04d}_step_v00`` holds solids ``{i*10000:08d}`` onward."""
    uid_filter: Optional[Set[str]] = None
    if use_deepcad:
        train, val, test = load_deepcad_split(split_json)
        uid_filter = train | val | test

    step_dirs = []
    for i in range(n_chunks):
        chunk = f"{root_dir}/abc_{str(i).zfill(4)}_step_v00"
        for j in range(i * 10000, (i + 1) * 10000):
            sub = str(j).zfill(8)
            if uid_filter is None or sub in uid_filter:
                step_dirs.append(f"{chunk}/{sub}")
    return step_dirs


def load_furniture_step(root_dir: str) -> List[str]:
    """Recursive .step discovery (``convert_utils.py:164-183``)."""
    out = []
    for root, _dirs, files in os.walk(root_dir):
        for name in sorted(files):
            if name.endswith(".step"):
                out.append(os.path.join(root, name))
    return out


def discover_split(
    data_dir: str,
    option: str,
    split_json: str = "train_val_test_split.json",
    seed: int = 0,
) -> Tuple[List[str], List[str], List[str]]:
    """Uid lists for a dataset directory in the reference layout.

    Falls back to a flat recursive walk + seeded 90/5/5 split when the
    tree has no 4-digit shard folders (e.g. synthetic data produced by
    ``process_main`` into one directory).
    """
    if option == "furniture":
        return load_furniture_pkl(data_dir, seed=seed)
    if _shard_dirs(data_dir):
        return load_abc_pkl(
            data_dir, option == "deepcad", split_json=split_json, seed=seed
        )
    # flat layout fallback
    uids = []
    for root, _dirs, files in os.walk(data_dir):
        for name in sorted(files):
            if name.endswith(".pkl"):
                uids.append(os.path.relpath(os.path.join(root, name), data_dir))
    rng = np.random.default_rng(seed)
    uids = [uids[i] for i in rng.permutation(len(uids))]
    n_train = int(len(uids) * 0.9)
    n_val = int(len(uids) * 0.95)
    return uids[:n_train], uids[n_train:n_val], uids[n_val:]
