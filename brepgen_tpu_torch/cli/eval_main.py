"""Evaluation CLIs: point sampling (reference ``sample_points.py``), the
JSD/MMD/COV metric protocol (reference ``pc_metric.py``) and deduplication
(reference ``deduplicate_cad.py`` / ``deduplicate_surfedge.py``).

Port of ``brepgen_tpu/cli/eval_main.py``:

    python -m brepgen_tpu_torch.cli.eval_main sample_points --in_dir D --out_dir P
    python -m brepgen_tpu_torch.cli.eval_main pc_metric --fake P --real Q [--device cpu]
    python -m brepgen_tpu_torch.cli.eval_main dedup --data D [--list SPLIT.pkl [--edge]]

The Chamfer matrices of ``pc_metric`` go through kernel K4 on the card.
"""

from __future__ import annotations

import argparse
import sys


def sample_points_main(argv=None):
    from brepgen_tpu_torch.eval.pipeline import sample_points_dir

    p = argparse.ArgumentParser(prog="eval_main sample_points")
    p.add_argument("--in_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--workers", type=int, default=0)
    args = p.parse_args(argv)
    n = sample_points_dir(args.in_dir, args.out_dir, workers=args.workers)
    print(f"sampled {n} meshes")


def pc_metric_main(argv=None):
    from brepgen_tpu_torch.eval.pipeline import run_metrics

    p = argparse.ArgumentParser(prog="eval_main pc_metric")
    p.add_argument("--fake", type=str, required=True)
    p.add_argument("--real", type=str, required=True)
    p.add_argument("--n_test", type=int, default=1000)
    p.add_argument("--multi", type=int, default=3)
    p.add_argument("--times", type=int, default=10)
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the cloud selection (default: unseeded, as the reference)")
    p.add_argument("--batch_size", type=int, default=None,
                   help="accepted for the JAX CLI's device tile size and ignored: kernel K4 "
                        "takes every cloud pair in one launch, so results do not depend on it")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    avg = run_metrics(
        args.fake, args.real, n_test=args.n_test, multi=args.multi,
        times=args.times, seed=args.seed, device=args.device,
    )
    print("average result:")
    print(avg)


def dedup_main(argv=None) -> str:
    """Deduplicate parsed solids (no ``--list``: the train list of the
    discovered split, by whole-solid hash, into
    ``<option>_data_split_<bit>bit.pkl``) or their primitives (``--list``:
    the unique surface grids, or edge curves with ``--edge``, of the list's
    train solids as one flat array in ``<list stem>_surface.pkl`` /
    ``_edge.pkl``). Returns the path written."""
    import os
    import pickle

    from brepgen_tpu_torch.cli.build import uid_to_path
    from brepgen_tpu_torch.data.dedup import dedup_primitives, solid_hash
    from brepgen_tpu_torch.data.discovery import discover_split

    p = argparse.ArgumentParser(prog="eval_main dedup")
    p.add_argument("--data", type=str, required=True, help="parsed pkl dir")
    p.add_argument("--list", type=str, default=None,
                   help="split pkl (primitive dedup mode); omit for CAD dedup")
    p.add_argument("--edge", action="store_true")
    p.add_argument("--bit", type=int, default=6)
    p.add_argument("--option", type=str, default="abc", choices=["abc", "deepcad", "furniture"])
    p.add_argument("--split_json", type=str, default="train_val_test_split.json",
                   help="official DeepCAD split (the reference reads it from the cwd)")
    args = p.parse_args(argv)

    if args.list is None:
        # CAD dedup (reference deduplicate_cad.py:23-72): only the training
        # list is deduplicated; val and test stay as discovered
        train_uids, val, test = discover_split(args.data, args.option,
                                               split_json=args.split_json)
        seen, train = set(), []
        for uid in train_uids:
            with open(uid_to_path(args.data, uid), "rb") as fh:
                data = pickle.load(fh)
            h = solid_hash(data["surf_wcs"], args.bit)
            if h not in seen:
                seen.add(h)
                train.append(uid)
        out = f"{args.option}_data_split_{args.bit}bit.pkl"
        with open(out, "wb") as fh:
            pickle.dump({"train": train, "val": val, "test": test}, fh)
        print(f"{len(train)}/{len(train_uids)} unique train"
              f" (+{len(val)} val, +{len(test)} test) -> {out}")
        return out

    with open(args.list, "rb") as fh:
        uids = pickle.load(fh)["train"]
    samples = []
    for uid in uids:
        with open(uid_to_path(args.data, uid), "rb") as fh:
            samples.append(pickle.load(fh))
    arr = dedup_primitives(samples, "edge" if args.edge else "surface", args.bit)
    out = args.list.split(".")[0] + ("_edge.pkl" if args.edge else "_surface.pkl")
    with open(out, "wb") as fh:
        pickle.dump(arr, fh)
    print(f"{len(arr)} unique primitives -> {out}")
    return out


COMMANDS = {"sample_points": sample_points_main, "pc_metric": pc_metric_main,
            "dedup": dedup_main}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(f"usage: python -m brepgen_tpu_torch.cli.eval_main "
                         f"{{{','.join(COMMANDS)}}} [options]")
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
