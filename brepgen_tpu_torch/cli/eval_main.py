"""Evaluation CLIs: point sampling (reference ``sample_points.py``) and the
JSD/MMD/COV metric protocol (reference ``pc_metric.py``).

Port of ``brepgen_tpu/cli/eval_main.py:sample_points_main, pc_metric_main``:

    python -m brepgen_tpu_torch.cli.eval_main sample_points --in_dir D --out_dir P
    python -m brepgen_tpu_torch.cli.eval_main pc_metric --fake P --real Q [--device cpu]

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
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    avg = run_metrics(
        args.fake, args.real, n_test=args.n_test, multi=args.multi,
        times=args.times, seed=args.seed, device=args.device,
    )
    print("average result:")
    print(avg)


COMMANDS = {"sample_points": sample_points_main, "pc_metric": pc_metric_main}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(f"usage: python -m brepgen_tpu_torch.cli.eval_main "
                         f"{{{','.join(COMMANDS)}}} [options]")
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
