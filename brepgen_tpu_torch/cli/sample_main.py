"""Generation CLI: ``python -m brepgen_tpu_torch.cli.sample_main --mode abc``.

Port of ``brepgen_tpu/cli/sample_main.py``: builds the four denoisers and the
two VAEs, fills them from npz packs (``--weights_dir`` holding
``surfpos.npz``, ``surfz.npz``, ``edgepos.npz``, ``edgez.npz``,
``surf_vae.npz``, ``edge_vae.npz`` as ``train/checkpoint.py`` writes them,
e.g. a ``ckpt_packed/`` folder; the architecture and class count are read
from them) or with random weights at the production widths from ``--seed``
when none are given, and runs the cascade batch by batch on the card. The
mode's preset (``eval_config_tpu.yaml``'s values) sets the face and edge
slots, thresholds, batch size and class label; ``--config`` overrides them
from a file of that form, and ``--compact`` runs the edge stages on the kept
faces only. On the card each stage's denoiser call replays a CUDA graph
(``sampling/aot.py``), captured at its first call; ``--aot_cache DIR``
writes the graphs' manifest. ``--small`` is the tiny debug architecture;
``--profile DIR`` traces the second batch. Each sample is
post-processed on the host (topology recovery, re-decode through the VAEs,
joint optimization on the card) in a thread pool that overlaps the next
batch's cascade, and written as STEP + STL to ``--save_folder``. With
recovery (the default; ``--strict`` turns it off) a sample the reference
semantics reject is retried through the recovery ladder. ``--num_samples N``
stops after N valid B-reps (the JAX CLI's meaning), ``--max_batches N``
after N batches; with neither it samples until it is stopped (Ctrl-C or
SIGTERM: the batch in flight finishes, the postprocess pool drains, the
summary is printed and it exits 0), the JAX CLI's ``--num_samples 0``. The
raw batches also go to ``<save_folder>`` as ``{key}__{batch}`` arrays, the
format ``scripts/replay_postprocess.py`` and ``resample_main --from_dump``
read: in one ``batches.npz`` at the end of a bounded run, and, without a
limit, one ``batches/<batch>.npz`` as each batch finishes (nothing of them
is kept in memory).

Split sampling, the counterpart of the JAX CLI's mesh over several devices:
started by ``torchrun --nproc_per_node N`` (one card a rank, NCCL), each
rank runs the cascade on its B/N rows of every batch (``sampling/cascade.py``
says how the draws stay those of one process), post-processes its own
samples, names them by their index in the global batch, and rank 0 writes
the global ``batches.npz`` and prints the counts summed over the ranks.
``--batch_size`` (or the preset's) is the global batch and must divide
among the ranks, where the JAX CLI would silently run unsharded.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import random
import signal
import string
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from brepgen_tpu_torch import resolve_device
from brepgen_tpu_torch.cli.build import (
    arch_of_packs,
    build_denoiser,
    build_vae,
    classes_of_pack,
    seed_weights,
)
from brepgen_tpu_torch.geometry.brep_build import construct_brep
from brepgen_tpu_torch.nn.layers import cast_compute
from brepgen_tpu_torch.parallel.distributed import RowSplit, all_reduce_max, all_reduce_sum, \
    launched, maybe_initialize_distributed
from brepgen_tpu_torch.postprocess.pipeline import make_padded_decoder, postprocess_single
from brepgen_tpu_torch.postprocess.vertex_merge import PostprocessError
from brepgen_tpu_torch.sampling import Cascade, CascadeConfig, GeneratorNoise, RowNoise
from brepgen_tpu_torch.sampling.aot import MANIFEST, StageGraphs, stage_graphs
from brepgen_tpu_torch.utils.profiling import TRACE_FILE, device_trace, format_summary, \
    summarize_trace
from brepgen_tpu_torch.weights import load_flax_params

DENOISERS = ("surfpos", "surfz", "edgepos", "edgez")
BATCH_DIR = "batches"  # an unbounded run's per-batch files, in the save folder
PACKS = {"surface": "surf_vae.npz", "edge": "edge_vae.npz"}


def _materialise(make: Callable[[], torch.nn.Module], device: torch.device,
                 pack: Optional[str], generator: torch.Generator) -> torch.nn.Module:
    """Build without initialising, then fill from a pack or from the generator."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device).eval()
    if pack is not None:
        return load_flax_params(module, pack)
    return seed_weights(module, generator)


def load_models(use_cf: bool, weights_dir: Optional[str] = None, seed: int = 0,
                dtype: torch.dtype = torch.float32, device: str = "cuda", small: bool = False,
                attn_impl: Optional[str] = None):
    """(denoisers by stage, surface VAE, edge VAE) with weights from
    ``weights_dir`` (npz packs, at the architecture and class count they
    hold) or seeded from ``seed`` at the production widths (the tiny debug
    architecture with ``small``), in ``dtype`` on ``device``. ``attn_impl``
    ("kernel" or "plain") sets every denoiser's attention; by default the
    edge stages take the kernels and the surf stages plain attention."""
    dev = resolve_device(device)
    arch = arch_of_packs(weights_dir) if weights_dir else "small" if small else "production"
    if small and arch != "small":
        raise ValueError(f"--small: the packs in {weights_dir} hold the {arch} architecture")
    gen = torch.Generator(device=dev).manual_seed(seed)
    pack = (lambda name: os.path.join(weights_dir, name)) if weights_dir else (lambda name: None)

    def denoiser(path, stage):
        classes = classes_of_pack(path) if path else None
        kw = {"num_classes": classes} if classes else {}
        if attn_impl is not None:
            kw["attn_impl"] = attn_impl
        return build_denoiser(stage, use_cf, arch, **kw)

    nets = {}
    for stage in DENOISERS:
        path = pack(f"{stage}.npz")
        nets[stage] = _materialise(lambda: denoiser(path, stage), dev, path, gen)
    surf_vae, edge_vae = (
        _materialise(lambda o=option: build_vae(o, arch), dev, pack(PACKS[option]), gen)
        for option in ("surface", "edge")
    )
    if dtype != torch.float32:
        for m in (*nets.values(), surf_vae, edge_vae):
            cast_compute(m, dtype)
    return nets, surf_vae, edge_vae


def init_cascade(mode: str = "abc", weights_dir: Optional[str] = None, seed: int = 0,
                 batch_size: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 device: str = "cuda", step_overrides: Optional[Dict] = None,
                 config: Optional[str] = None, small: bool = False,
                 aot_cache: Optional[str] = None, row_split: Optional[RowSplit] = None
                 ) -> Cascade:
    """The cascade for ``mode`` on the models of ``load_models``. The mode's
    preset, overridden by the file ``config`` (``eval_config_tpu.yaml``'s
    form) where given, sets the sizes, thresholds, class label and batch
    size; ``batch_size`` and ``step_overrides`` override both. On a CUDA
    card each stage's denoiser calls replay a CUDA graph, whose manifest
    goes to ``aot_cache``. With ``row_split`` the batch size is the global
    batch and the cascade runs this rank's share of it."""
    config = CascadeConfig.for_mode(mode, batch_size=batch_size, config=config,
                                    **(step_overrides or {}))
    if row_split is not None:
        if config.batch_size % row_split.world:
            raise ValueError(f"batch size {config.batch_size} does not divide among "
                             f"{row_split.world} ranks")
        config = dataclasses.replace(config, batch_size=config.batch_size // row_split.world)
    models = load_models(config.use_cf, weights_dir, seed, dtype, device, small)
    return Cascade(*models, config, graphs=stage_graphs(resolve_device(device), aot_cache),
                   row_split=row_split)


def random_string(length=15):
    return "".join(random.choice(string.ascii_letters + string.digits) for _ in range(length))


def host_decoders(cascade: Cascade):
    """The cascade's VAE decoders for host postprocess: numpy latents in,
    numpy geometry out, run on the cascade's device."""
    dev = cascade.device
    return (make_padded_decoder(cascade.surf_vae.decode, (4, 4, 3), dev),
            make_padded_decoder(cascade.edge_vae.decode, (4, 3), dev))


def process_one(sample_np, batch_idx, surf_decode, edge_decode, z_threshold, save_folder,
                recovery=False, device: str | torch.device = "cuda",
                name_index: Optional[int] = None):
    """Postprocess + assemble one sample, written under ``<random>_<index>``
    (``name_index``, by default ``batch_idx``). With ``recovery``, a sample the
    strict reference semantics would reject is retried through the
    edge-pairing recovery ladder (postprocess/edge_merge.py); a rescued
    sample returns its name with a "recovered: rung N" note instead of
    err=None, so callers can account strict vs recovered validity."""
    note = None
    try:
        rec = postprocess_single(sample_np, batch_idx, surf_decode, edge_decode, z_threshold,
                                 device=device)
    except (PostprocessError, AssertionError, IndexError, ValueError) as e:
        if not recovery:
            return None, f"postprocess failed: {e}"
        try:
            rec = postprocess_single(sample_np, batch_idx, surf_decode, edge_decode,
                                     z_threshold, recovery=True, device=device)
            note = f"recovered: rung {rec.recovery_rung}"
        except (PostprocessError, AssertionError, IndexError, ValueError) as e2:
            # report BOTH failures: the strict reason is the taxonomy key,
            # the recovery reason says which ladder rung gave up
            return None, f"postprocess failed: {e} [recovery failed: {e2}]"
    try:
        solid = construct_brep(
            rec.surf_wcs, rec.edge_wcs, rec.face_edge_adj, rec.edge_vertex_adj,
            vertices=rec.unique_vertices,
        )
    except Exception as e:  # noqa: BLE001 -- parity with reference's skip
        return None, f"brep rebuild failed: {e}"
    name = f"{random_string()}_{batch_idx if name_index is None else name_index}"
    solid.write_step(os.path.join(save_folder, name + ".step"))
    solid.write_stl(os.path.join(save_folder, name + ".stl"))
    if not solid.topology_ok():
        # counted valid (the reference's criterion is surviving postprocess
        # + rebuild), but the STEP export degrades to a loose GEOMETRIC_SET
        # instead of a MANIFOLD_SOLID_BREP -- callers report this honestly
        # as validity vs validity_solid
        note = f"{note}; nonsolid" if note else "nonsolid"
    return name, note


@dataclasses.dataclass
class SampleRun:
    """What one ``sample_loop`` produced."""

    batches: List[Dict[str, np.ndarray]]  # the raw batches (none kept without a limit)
    n_batches: int = 0                  # batches run
    attempted: int = 0                  # samples sent to postprocess
    names: List[str] = dataclasses.field(default_factory=list)  # valid B-reps
    strict: int = 0                     # valid without the recovery ladder
    solid: int = 0                      # valid and exported as a solid
    failures: Dict[str, int] = dataclasses.field(default_factory=dict)
    rungs: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    @property
    def produced(self) -> int:
        return len(self.names)

    def add(self, name: Optional[str], note: Optional[str]) -> None:
        if name is None:
            key = note.split(":")[0]
            self.failures[key] = self.failures.get(key, 0) + 1
            return
        self.names.append(name)
        parts = (note or "").split("; ")
        self.strict += not parts[0].startswith("recovered")
        self.solid += "nonsolid" not in parts
        if parts[0].startswith("recovered"):
            self.rungs[parts[0]] = self.rungs.get(parts[0], 0) + 1

    def merge(self, other: "SampleRun") -> None:
        """Add ``other``'s counts to this run's (its batches are not added)."""
        self.attempted += other.attempted
        self.names += other.names
        self.strict += other.strict
        self.solid += other.solid
        for mine, theirs in ((self.failures, other.failures), (self.rungs, other.rungs)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0) + v

    def report(self) -> str:
        lines = [f"produced {self.produced}/{self.attempted} valid B-reps from "
                 f"{self.n_batches} batches (strict {self.strict}, recovered "
                 f"{self.produced - self.strict}, solid {self.solid}) in {self.seconds:.2f} s"]
        if self.rungs:
            lines.append(f"recovery rungs: {dict(sorted(self.rungs.items()))}")
        if self.failures:
            lines.append(f"failure breakdown: {self.failures}")
        return "\n".join(lines)


class StopRequest:
    """Set by SIGINT or SIGTERM while an unbounded ``sample_loop`` runs (a
    second signal raises KeyboardInterrupt at once); the handlers are
    installed from the main thread only and restored on exit."""

    SIGNALS = (signal.SIGINT, signal.SIGTERM)

    def __init__(self):
        self.requested = False
        self.saved = {}

    def _handle(self, signum, frame):
        if self.requested:
            raise KeyboardInterrupt
        self.requested = True
        print(f"{signal.Signals(signum).name}: stopping after the batch in flight", flush=True)

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            self.saved = {s: signal.signal(s, self._handle) for s in self.SIGNALS}
        return self

    def __exit__(self, *exc):
        for s, handler in self.saved.items():
            signal.signal(s, handler)
        return False


def write_batch(save_folder: str, index: int, batch: Dict[str, np.ndarray]) -> str:
    """``batch`` as ``{key}__{index}`` arrays in ``save_folder/batches/<index>.npz``,
    written whole before it takes its name."""
    folder = os.path.join(save_folder, BATCH_DIR)
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"{index:06d}.npz")
    with open(path + ".tmp", "wb") as f:
        np.savez_compressed(f, **{f"{k}__{index}": v for k, v in batch.items()})
    os.replace(path + ".tmp", path)
    return path


def sample_loop(cascade: Cascade, num_samples: int = 0, max_batches: int = 0, seed: int = 0,
                save_folder: Optional[str] = None, stage_times: Optional[Dict] = None,
                after_stage: Optional[Callable[[str], None]] = None, postprocess: bool = True,
                recovery: bool = True, workers: int = 8,
                profile_dir: Optional[str] = None) -> SampleRun:
    """Run batches until ``num_samples`` valid B-reps or ``max_batches``
    batches; with neither (both 0) until it is stopped. Each batch's samples
    are post-processed in a pool of ``workers`` threads while the next batch
    runs, and written as STEP + STL to ``save_folder``; the raw batches go
    to ``batches.npz`` there. ``postprocess=False`` runs the cascade alone
    and then counts raw samples against ``num_samples``. With
    ``profile_dir`` the second batch (the first captures or warms up) is
    traced into ``profile_dir/trace.json`` and its summary printed.

    Without a limit (the JAX CLI's ``while True``) SIGINT or SIGTERM stops
    the loop once the batch in flight is done (a KeyboardInterrupt in the
    cascade stops it at once); the postprocess pool drains either way and
    the run is returned. Memory stays bounded: each batch's raw arrays go to
    ``save_folder/batches/<index>.npz`` as it finishes (``write_batch``)
    and ``run.batches`` stays empty.

    A cascade with a ``row_split`` is one rank's share of split sampling:
    every rank calls this with the same arguments, stops at the same batch
    (the counts, and a stop request, are reduced over the ranks), and
    returns the counts and batches of all ranks (rank 0 writes the raw
    batches)."""
    split = getattr(cascade, "row_split", None)
    unbounded = not (num_samples or max_batches)
    if postprocess and not save_folder:
        raise ValueError("sample_loop: postprocess writes STEP/STL and needs a save_folder")
    if save_folder:
        os.makedirs(save_folder, exist_ok=True)
    gen = torch.Generator(device=cascade.device).manual_seed(seed)
    noise = GeneratorNoise(gen)
    B = cascade.cfg.batch_size
    first = 0
    main_rank = split is None or split.rank == 0
    if split is not None:
        noise = RowNoise(noise, split)
        first = split.rank * B  # global index of this rank's first row
    run = SampleRun(batches=[])
    surf_decode, edge_decode = host_decoders(cascade)
    t0 = time.perf_counter()
    stop = StopRequest()
    with ThreadPoolExecutor(max(workers, 1)) as pool, \
            (stop if unbounded else contextlib.nullcontext()):
        pending: List[Future] = []

        def collect(done):
            for f in done:
                run.add(*f.result())
                pending.remove(f)

        try:
            while True:
                traced = profile_dir is not None and run.n_batches == 1
                with device_trace(profile_dir if traced else None):
                    out = cascade(noise, stage_times=stage_times, after_stage=after_stage)
                    sample_np = {k: v.cpu().numpy() for k, v in out.items()}
                if traced:
                    path = os.path.join(profile_dir, TRACE_FILE)
                    print(f"profile: batch 1: {format_summary(summarize_trace(path))}; trace "
                          f"{path}", flush=True)
                if not unbounded:
                    run.batches.append(sample_np)
                elif save_folder:
                    whole = sample_np if split is None else gather_batch(sample_np)
                    if main_rank:
                        write_batch(save_folder, run.n_batches, whole)
                run.n_batches += 1
                if postprocess:
                    # host postprocess of batch k overlaps the cascade of batch k + 1
                    pending += [pool.submit(process_one, sample_np, b, surf_decode,
                                            edge_decode, cascade.cfg.z_threshold, save_folder,
                                            recovery, cascade.device, first + b)
                                for b in range(B)]
                    run.attempted += B
                    collect([f for f in pending if f.done()])
                count = run.produced if postprocess else run.n_batches * B
                stopping = stop.requested
                if split is not None:  # every rank stops at the same batch
                    count = int(all_reduce_sum(torch.tensor([count],
                                                            device=cascade.device)).item())
                    stopping = bool(all_reduce_max(int(stopping), cascade.device))
                if stopping or (num_samples and count >= num_samples) or (
                        max_batches and run.n_batches >= max_batches):
                    break
                # backpressure: the next batch starts once less than two batches
                # of samples wait, so a postprocess slower than the cascade does
                # not queue without bound
                while len(pending) >= 2 * B:
                    collect(wait(pending, return_when=FIRST_COMPLETED).done)
        except KeyboardInterrupt:
            if not unbounded:
                raise
            print("interrupted: draining the postprocess pool", flush=True)
        collect(list(pending))
    run.seconds = time.perf_counter() - t0
    if split is not None:
        run = gather_runs(run)
    if save_folder and not unbounded and main_rank:
        np.savez_compressed(
            os.path.join(save_folder, "batches.npz"),
            **{f"{k}__{bi}": v for bi, b in enumerate(run.batches) for k, v in b.items()},
        )
    return run


def gather_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The ranks' rows of one batch concatenated in rank order (the global
    batch), on every rank."""
    parts: List[Optional[Dict]] = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(parts, batch)
    return {k: np.concatenate([p[k] for p in parts]) for k in batch}


def gather_runs(run: SampleRun) -> SampleRun:
    """Every rank's run merged, on every rank: counts summed, names in rank
    order, each batch the ranks' rows concatenated in rank order (the global
    batch)."""
    runs: List[Optional[SampleRun]] = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(runs, run)
    merged = SampleRun(batches=[{k: np.concatenate([r.batches[i][k] for r in runs])
                                 for k in run.batches[i]} for i in range(len(run.batches))],
                       n_batches=run.n_batches, seconds=max(r.seconds for r in runs))
    for r in runs:
        merged.merge(r)
    return merged


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=["abc", "deepcad", "furniture"], default="abc")
    p.add_argument("--config", default=None,
                   help="file of eval_config_tpu.yaml's form: its batch_size, z_threshold, "
                        "bbox_threshold, num_surfaces, num_edges, use_cf and class_label of "
                        "--mode override the preset (its *_weight keys are not read; pass npz "
                        "packs with --weights_dir)")
    p.add_argument("--weights_dir", default=None,
                   help="folder of npz packs; random production-width weights from --seed "
                        "when absent")
    p.add_argument("--num_samples", type=int, default=0,
                   help="stop after N valid B-reps (0 = no limit)")
    p.add_argument("--max_batches", type=int, default=0,
                   help="stop after N batches (0 = no limit); with neither limit it samples "
                        "until Ctrl-C or SIGTERM, writing each batch to "
                        "SAVE_FOLDER/batches/<batch>.npz")
    p.add_argument("--batch_size", type=int, default=None,
                   help="default: the mode's batch_size (16 in every preset)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--pndm_steps", type=int, default=None)
    p.add_argument("--pos_pndm_calls", type=int, default=None)
    p.add_argument("--ddpm_tail", type=int, default=None)
    p.add_argument("--fast_steps", type=int, default=None,
                   help="N-step DDIM per stage instead of the full protocol")
    p.add_argument("--save_folder", default=None, help="default: samples_<mode>")
    p.add_argument("--device", default="cuda")
    p.add_argument("--strict", action="store_true",
                   help="reference postprocess semantics: reject any sample whose edge "
                        "pairing is ambiguous instead of running the recovery ladder")
    p.add_argument("--workers", type=int, default=8, help="host postprocess threads")
    p.add_argument("--compact", action="store_true",
                   help="run the edge stages on a compacted face bucket after dedup (trained "
                        "models dedup heavily; cuts the quadratic attention cost ~2x at ABC "
                        "scale)")
    p.add_argument("--small", action="store_true",
                   help="tiny debug architecture (width 32, 2 heads: head width 16), seeded "
                        "unless --weights_dir is given")
    p.add_argument("--aot_cache", default=None,
                   help="DIR for the graphs.json manifest of the stages' CUDA graphs (on the "
                        "card each stage's denoiser call is captured once per input signature "
                        "and replayed; JAX's flag name, but a CUDA graph is not kept on disk). "
                        "Needs a CUDA card")
    p.add_argument("--profile", default=None,
                   help="torch.profiler trace of the second batch into DIR/trace.json, with "
                        "its device busy time, idle share and top kernels printed")
    return p.parse_args(argv)


def cascade_from_args(args: argparse.Namespace, row_split: Optional[RowSplit] = None
                      ) -> Cascade:
    """The cascade the command line asks for (this rank's share under a
    ``row_split``)."""
    overrides = {k: getattr(args, k)
                 for k in ("pndm_steps", "pos_pndm_calls", "ddpm_tail", "fast_steps")
                 if getattr(args, k) is not None}
    if args.compact:
        overrides["compact"] = True
    main_rank = row_split is None or row_split.rank == 0
    return init_cascade(args.mode, args.weights_dir, args.seed, args.batch_size,
                        torch.bfloat16 if args.bf16 else torch.float32, args.device,
                        overrides, args.config, args.small,
                        args.aot_cache if main_rank else None, row_split)


def main(argv=None):
    args = parse_args(argv)
    split = None
    if launched():  # split sampling over torchrun's ranks
        maybe_initialize_distributed(device=args.device)
        split = RowSplit.of_group()
        print(f"rank {split.rank} of {split.world}: split sampling", flush=True)
    try:
        _run(args, split)
    finally:
        if split is not None:
            torch.distributed.destroy_process_group()


def _run(args, split: Optional[RowSplit]) -> None:
    main_rank = split is None or split.rank == 0
    cascade = cascade_from_args(args, split)
    stage_times: Dict[str, float] = {}
    run = sample_loop(cascade, args.num_samples, args.max_batches, args.seed,
                      args.save_folder or f"samples_{args.mode}", stage_times,
                      recovery=not args.strict, workers=args.workers,
                      profile_dir=args.profile if main_rank else None)
    if not main_rank:
        return
    print(run.report())
    if cascade.cfg.compact:
        print(f"edge stages of the last batch on {cascade.last_bucket} of "
              f"{cascade.cfg.faces} face slots")
    if cascade.graphs is not None:
        print(graphs_report(cascade.graphs))
    print("cascade seconds per stage: "
          + ", ".join(f"{k} {v:.2f}" for k, v in stage_times.items()))


def graphs_report(graphs: StageGraphs) -> str:
    entries = graphs.entries
    return (f"captured {len(entries)} stage graphs in "
            f"{sum(e['capture_seconds'] for e in entries):.2f} s: "
            + ", ".join(f"{e['stage']} {e['shapes']['x']} ({e['kernel_nodes']} kernel nodes)"
                        for e in entries)
            + (f"; manifest {os.path.join(graphs.cache_dir, MANIFEST)}"
               if graphs.cache_dir else ""))


if __name__ == "__main__":
    main()
