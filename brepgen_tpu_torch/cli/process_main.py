"""Data-extraction CLI: STEP files or synthetic solids into the sharded pkl
layout.

Port of ``brepgen_tpu/cli/process_main.py`` (reference
``data_process/process_brep.py``):

    python -m brepgen_tpu_torch.cli.process_main --input STEP_DIR --output DIR \\
        [--uid_list FILE]
    python -m brepgen_tpu_torch.cli.process_main --synthetic N --output DIR \\
        [--option abc|deepcad|furniture] [--bit 6] [--seed 0]

``--input`` walks ``STEP_DIR`` (or, with ``--uid_list``, the STEP folders
and files the list names, one per line, as ``cli/shard_driver.py`` writes
it) for ``.step``/``.stp`` files and extracts each with the native STEP
reader (``geometry/native_extract.py``) into
``DIR/<uid // 10000:04d>/<uid>.pkl`` (``DIR/<uid>.pkl`` for a non-numeric
uid). A file that fails to parse or is out of scope (more than 70 faces, no
manifold edge) is skipped, as the reference skips it. The JAX package
extracts through OpenCASCADE when pythonocc is installed; the port has no
OCC backend (``geometry/occ_backend.py`` and ``occ_extract.py`` are out of
its scope), so it always takes the native reader.

``--synthetic N`` draws N analytic solids (``data/synthetic.py``), drops
repeated solids by their quantized face hash (reference
``deduplicate_cad.py``), writes each to ``DIR/<id // 10000:04d>/<id:08d>.pkl``
and a train/val/test split, drawn from ``default_rng(seed)``, to
``<option>_data_split_<bit>bit.pkl`` in the working directory, as the JAX
CLI does.
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from brepgen_tpu_torch.data.dedup import dedup_solids
from brepgen_tpu_torch.data.synthetic import make_dataset

def write_sharded(samples: List[Dict], out_dir: str) -> List[str]:
    """Write sample i to ``out_dir/<i // 10000:04d>/<i:08d>.pkl``; returns
    the uids (file names)."""
    paths = []
    for i, data in enumerate(samples):
        uid = f"{i:08d}.pkl"
        shard = str(math.floor(i / 10000)).zfill(4)
        os.makedirs(os.path.join(out_dir, shard), exist_ok=True)
        with open(os.path.join(out_dir, shard, uid), "wb") as f:
            pickle.dump(data, f)
        paths.append(uid)
    return paths


def split_uids(uids: List[str], seed: int) -> Dict[str, List[str]]:
    """A tenth each (at least one) to val and test, the rest to train, in
    the order of ``default_rng(seed).permutation``."""
    order = np.random.default_rng(seed).permutation(len(uids))
    n_val = max(len(uids) // 10, 1)
    n_test = max(len(uids) // 10, 1)
    return {
        "train": [uids[i] for i in order[: len(uids) - n_val - n_test]],
        "val": [uids[i] for i in order[len(uids) - n_val - n_test: len(uids) - n_test]],
        "test": [uids[i] for i in order[len(uids) - n_test:]],
    }


def main(argv: Optional[List[str]] = None) -> Optional[str]:
    """Returns the path of the split pkl (``--synthetic``), else None."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", type=str, default=None, help="STEP root dir")
    p.add_argument("--output", type=str, required=True, help="parsed pkl output dir")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--option", type=str, default="abc", choices=["abc", "deepcad", "furniture"])
    p.add_argument("--bit", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--uid_list", type=str, default=None,
                   help="file of STEP dirs/files to restrict extraction to "
                        "(written by the shard driver)")
    args = p.parse_args(argv)

    if not args.synthetic:
        if args.input is None and args.uid_list is None:
            p.error("pass --input STEP_DIR (or --uid_list FILE) or --synthetic N")
        roots = None
        if args.uid_list:
            with open(args.uid_list) as f:
                roots = [line.strip() for line in f if line.strip()]
        n_ok = native_process_dir(args.input, args.output, roots=roots)
        print(f"extracted {n_ok} solids with the native STEP reader to {args.output}")
        return None

    samples = make_dataset(args.synthetic, seed=args.seed)
    keep = dedup_solids(samples, n_bits=args.bit)
    uids = write_sharded([samples[i] for i in keep], args.output)
    split_path = f"{args.option}_data_split_{args.bit}bit.pkl"
    with open(split_path, "wb") as f:
        pickle.dump(split_uids(uids, args.seed), f)
    print(f"wrote {len(uids)} solids to {args.output}; split -> {split_path}")
    return split_path


def native_process_dir(in_dir: Optional[str], out_dir: str,
                       roots: Optional[List[str]] = None) -> int:
    """Extract every STEP file under ``in_dir`` (or under each of ``roots``,
    a folder or a file) into ``out_dir``; returns the count written."""
    from brepgen_tpu_torch.geometry.native_extract import extract_step_file

    paths = []
    for base in roots if roots is not None else [in_dir]:
        if os.path.isfile(base):
            paths.append(base)
            continue
        for root, _dirs, files in os.walk(base):
            for f in sorted(files):
                if f.lower().endswith((".step", ".stp")):
                    paths.append(os.path.join(root, f))
    n_ok = 0
    for path in paths:
        try:
            data = extract_step_file(path)
        except Exception:  # noqa: BLE001 -- the reference skips a file that fails
            continue
        if data is None:
            continue
        uid = data["uid"]
        try:
            shard = str(math.floor(int(uid.split(".")[0]) / 10000)).zfill(4)
        except ValueError:
            shard = ""
        os.makedirs(os.path.join(out_dir, shard), exist_ok=True)
        with open(os.path.join(out_dir, shard, uid), "wb") as f:
            pickle.dump(data, f)
        n_ok += 1
    return n_ok


if __name__ == "__main__":
    main()
