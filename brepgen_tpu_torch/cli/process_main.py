"""Data-extraction CLI: synthetic solids into the sharded pkl layout.

Port of ``brepgen_tpu/cli/process_main.py:25-74`` (reference
``data_process/process_brep.py``):

    python -m brepgen_tpu_torch.cli.process_main --synthetic N --output DIR \\
        [--option abc|deepcad|furniture] [--bit 6] [--seed 0]

``--synthetic N`` draws N analytic solids (``data/synthetic.py``), drops
repeated solids by their quantized face hash (reference
``deduplicate_cad.py``), writes each to ``DIR/<id // 10000:04d>/<id:08d>.pkl``
and a train/val/test split, drawn from ``default_rng(seed)``, to
``<option>_data_split_<bit>bit.pkl`` in the working directory, as the JAX
CLI does. STEP extraction needs the native STEP reader of the JAX package
(``geometry/native_extract.py``, ROADMAP queue 1 item 3) or pythonocc,
neither of which the port has: without ``--synthetic`` the CLI exits with a
message naming that item.
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

STEP_NOT_PORTED = ("STEP extraction is not ported yet (ROADMAP queue 1, item 3: the native "
                   "STEP reader); pass --synthetic N")


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


def main(argv: Optional[List[str]] = None) -> str:
    """Returns the path of the split pkl."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", type=str, default=None, help="STEP root dir (not ported)")
    p.add_argument("--output", type=str, required=True, help="parsed pkl output dir")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--option", type=str, default="abc", choices=["abc", "deepcad", "furniture"])
    p.add_argument("--bit", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--uid_list", type=str, default=None,
                   help="file of STEP dirs/files to restrict extraction to (not ported)")
    args = p.parse_args(argv)
    if not args.synthetic:
        raise SystemExit(f"process_main: {STEP_NOT_PORTED}")

    samples = make_dataset(args.synthetic, seed=args.seed)
    keep = dedup_solids(samples, n_bits=args.bit)
    uids = write_sharded([samples[i] for i in keep], args.output)
    split_path = f"{args.option}_data_split_{args.bit}bit.pkl"
    with open(split_path, "wb") as f:
        pickle.dump(split_uids(uids, args.seed), f)
    print(f"wrote {len(uids)} solids to {args.output}; split -> {split_path}")
    return split_path


if __name__ == "__main__":
    main()
