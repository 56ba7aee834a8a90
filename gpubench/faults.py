"""Faults planted under a cell's timed path, for the check to catch::

    python3 -m gpubench.faults --workload <cell> --fault <name> --seeds 11 12 13

prints, for each seed, the readings of the numbers the check compares with
the fault in place (at the cell's own size on the card: the readings that
a training limit's upper end may come from). Benchmark runs never plant a
fault; ``gpubench/tests/test_gpubench_faults.py`` plants each one at a small
size on the CPU and sees ``correct`` come out false.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

# fault -> the kinds of cell it applies to
FAULTS = {
    "state_unchanged": ("sample", "train"),  # a step returns its state unchanged
    "half_batch": ("sample", "train", "eval"),  # half the batch (or points) left out
    "answer_altered": ("sample", "train", "eval"),  # an answer altered where produced
    "protocol_step_unchanged": ("sample",),  # the DDPM step returns its state
    "decode_altered": ("sample",),
    "metric_altered": ("eval",),
}


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _sample(fault):
    from brepgen_tpu_torch.diffusion import ddpm
    from brepgen_tpu_torch.nn import SurfVAE
    from brepgen_tpu_torch.nn.denoiser import DenoiserTransformer
    from brepgen_tpu_torch.sampling import cascade

    if fault == "state_unchanged":
        def ddim_loop(model_fn, x, plan, noise_fn=None, clip_range=None):
            for t in plan.t:
                model_fn(x, int(t))
            return x
        return _patched(cascade, "ddim_loop", ddim_loop)
    if fault == "protocol_step_unchanged":
        return _patched(ddpm, "ddpm_step", lambda c, x, eps, noise, clip_range=None: x)
    if fault == "half_batch":
        orig = DenoiserTransformer.denoise

        def denoise(self, *a, **k):
            out = orig(self, *a, **k)
            n = out.shape[0] // 2
            return torch.cat([out[:n], torch.zeros_like(out[n:])])
        return _patched(DenoiserTransformer, "denoise", denoise)
    if fault == "answer_altered":
        orig = cascade.dedup_bboxes

        def dedup(boxes, threshold):
            keep = orig(boxes, threshold).clone()
            keep[..., -1] = ~keep[..., -1]
            return keep
        return _patched(cascade, "dedup_bboxes", dedup)
    orig = SurfVAE.decode

    def decode(self, z):
        out = orig(self, z)
        return out + (torch.arange(out.shape[0], device=out.device) == 0).reshape(
            -1, *[1] * (out.dim() - 1))
    return _patched(SurfVAE, "decode", decode)


def _train(fault):
    from brepgen_tpu_torch.train import common, ldm_train

    if fault == "state_unchanged":
        def step(self):
            norm = self.global_norm()
            self.adamw.zero_grad(set_to_none=True)
            return norm
        return _patched(common.ClippedAdamW, "step", step)
    if fault == "half_batch":
        orig = ldm_train.masked_mse

        def half(pred, target, mask, row_split=None):
            n = pred.shape[0] // 2
            return orig(pred[:n], target[:n], mask[:n], row_split)
        return _patched(ldm_train, "masked_mse", half)
    orig = ldm_train.add_noise
    return _patched(ldm_train, "add_noise",
                    lambda tables, x0, noise, t: orig(tables, x0, noise, t) + 0.05)


def _eval(fault):
    from brepgen_tpu_torch.eval import metrics

    if fault == "metric_altered":
        orig = metrics.cov_mmd_from_matrix

        def altered(d):
            out = orig(d)
            out["MMD-CD"] *= 1.01
            return out
        return _patched(metrics, "cov_mmd_from_matrix", altered)
    orig = metrics.chamfer_matrix
    if fault == "half_batch":  # half of every cloud's points
        return _patched(metrics, "chamfer_matrix",
                        lambda x, y, n_pts=None: orig(x, y, x.shape[1] // 2))
    return _patched(metrics, "chamfer_matrix", lambda x, y, n_pts=None: orig(x, y) * 1.001)


def planted(kind: str, fault: str):
    """A context in which ``fault`` is planted in the program a cell of
    ``kind`` runs."""
    if kind not in FAULTS.get(fault, ()):
        raise ValueError(f"fault {fault!r} does not apply to a {kind} cell")
    return {"sample": _sample, "train": _train, "eval": _eval}[kind](fault)


def main(argv=None) -> int:
    from gpubench import control
    from gpubench import run as harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    for seed in args.seeds:
        run, _ = control.build(args.workload, seed)
        with planted(type(run).__module__.rsplit(".", 1)[-1], args.fault):
            run.setup()
            run.window(args.seconds)
        run.release()
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "readings": run.readings(False)}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
