"""Fault F5's checks on the CPU: the cf160k prism class at ``resample_main
--cf``'s size (10 x 8, B=16, w=0.6, f32), run by the JAX package and by the
port on the same draws, and tallied by either package's postprocess.

    python tests/torch_port_f5_check.py demo
        JAX's ``scripts/resample_demo.py --cf --classes 2`` with its own keys
        (5000 + 200 + 6000 + b, b < 16); prints its JSON line
    python tests/torch_port_f5_check.py port_jax_draws OUT.npz
        the port's cascade fed the draws of those same keys; writes the
        batches as a ``batches.npz`` dump and prints the kept-face counts of
        the first 64 samples (the demo prints the same list)
    python tests/torch_port_f5_check.py tally jax|port DUMP.npz
        strict / recovered / solid counts of a dump (``resample_main --dump``
        or the line above) through that package's ``process_one``, z 0.2,
        with the recovery ladder; one JSON line

Run from the repository root; JAX runs on the CPU. Each takes 10-20
minutes on an 8-core CPU.
"""

from __future__ import annotations

import json
import os
import runpy
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

CF160K = os.path.join(ROOT, "artifacts", "demo_round5", "cf160k", "ckpt_packed")
PRISM, W, BATCHES = 2, 0.6, 16
CONFIG = dict(batch_size=16, num_surfaces=10, num_edges=8, use_cf=True, class_label=PRISM,
              cfg_weight=W)


def demo(out_dir: str) -> None:
    sys.argv = ["resample_demo.py", "--ckpt", CF160K, "--out", out_dir, "--cf", "--classes",
                str(PRISM), "--cfg_weights", str(W), "--sample_batches", str(BATCHES),
                "--z_thresholds", "0.2", "--recover"]
    runpy.run_path(os.path.join(ROOT, "scripts", "resample_demo.py"), run_name="__main__")


def port_jax_draws(dump: str) -> None:
    import torch

    from brepgen_tpu.sampling import CascadeConfig as JCascadeConfig
    from brepgen_tpu_torch.cli.sample_main import load_models
    from brepgen_tpu_torch.sampling import Cascade, CascadeConfig
    from test_torch_port_sampling import JaxDraws

    jcfg = JCascadeConfig(**CONFIG)
    cascade = Cascade(*load_models(True, CF160K, device="cpu"), CascadeConfig(**CONFIG))
    batches, t0 = [], time.time()
    for b in range(BATCHES):
        key = jax.random.PRNGKey(5000 + 100 * PRISM + int(W * 10) * 1000 + b)
        with torch.no_grad():
            out = cascade(JaxDraws(key, jcfg, jcfg.ddpm_tail))
        batches.append({k: v.numpy() for k, v in out.items()})
        print(f"batch {b}: {time.time() - t0:.0f} s", flush=True)
    np.savez_compressed(dump, **{f"{k}__{b}": v for b, batch in enumerate(batches)
                                 for k, v in batch.items()})
    faces = [int(n) for batch in batches for n in (~batch["surf_mask"]).sum(1)]
    print(json.dumps({"dedup_face_counts": faces[:64]}))


def tally(which: str, dump: str) -> None:
    out_dir = os.path.splitext(dump)[0] + f"_{which}_solids"
    os.makedirs(out_dir, exist_ok=True)
    with np.load(dump) as raw:
        n = 1 + max(int(k.rsplit("__", 1)[1]) for k in raw.files)
        batches = [{k.rsplit("__", 1)[0]: raw[k] for k in raw.files if k.endswith(f"__{b}")}
                   for b in range(n)]
    if which == "jax":
        from brepgen_tpu.cli.sample_main import make_padded_decoder, process_one
        from brepgen_tpu.nn import EdgeVAE, SurfVAE
        from brepgen_tpu.train.checkpoint import load_params
        from brepgen_tpu.train.vae_train import make_decoder_fn

        sv = SurfVAE(block_out_channels=(32, 64, 128, 128))
        ev = EdgeVAE(block_out_channels=(32, 64, 128))
        decoders = (
            make_padded_decoder(make_decoder_fn(sv),
                                load_params(os.path.join(CF160K, "surf_vae.npz")), (4, 4, 3)),
            make_padded_decoder(make_decoder_fn(ev),
                                load_params(os.path.join(CF160K, "edge_vae.npz")), (4, 3)))

        def run(batch, b):
            return process_one(batch, b, *decoders, 0.2, out_dir, True)
    else:
        from brepgen_tpu_torch.cli.sample_main import load_models, process_one
        from brepgen_tpu_torch.postprocess.pipeline import make_padded_decoder

        _, surf_vae, edge_vae = load_models(True, CF160K, device="cpu")
        decoders = (make_padded_decoder(surf_vae.decode, (4, 4, 3), "cpu"),
                    make_padded_decoder(edge_vae.decode, (4, 3), "cpu"))

        def run(batch, b):
            return process_one(batch, b, *decoders, 0.2, out_dir, True, "cpu")
    notes = [run(batch, b) for batch in batches for b in range(batch["surf_mask"].shape[0])]
    outcome = [("failed" if name is None else (note or "strict").split(";")[0].strip())
               for name, note in notes]
    print(json.dumps({
        "which": which, "attempted": len(notes),
        "valid": sum(name is not None for name, _ in notes),
        "strict": outcome.count("strict"),
        "solid": sum(name is not None and "nonsolid" not in (note or "") for name, note in notes),
        "rungs": {r: outcome.count(r) for r in sorted(set(outcome)) if r.startswith("recovered")},
        "per_sample": outcome,
    }))


if __name__ == "__main__":
    cmd, *rest = sys.argv[1:]
    if cmd == "demo":
        demo(rest[0] if rest else os.path.join(ROOT, "build", "f5_demo"))
    elif cmd == "port_jax_draws":
        port_jax_draws(rest[0])
    elif cmd == "tally":
        tally(*rest)
    else:
        raise SystemExit(__doc__)
