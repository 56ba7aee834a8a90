"""Stage capture as CUDA graphs: the counterpart of ``brepgen_tpu/sampling/aot.py``.

The JAX package runs each cascade stage as one compiled program and keeps the
executables on disk (``AotCache``, ``maybe_aot``, ``wrap_stage``). Eager
PyTorch launches every op of every denoiser call from Python instead, and at
the surf stages' few tokens those launches are most of a stage's time. Here
the denoiser call of a stage, the ``eps(x, t)`` of ``Cascade.stage_eps``, is
captured once as a CUDA graph per (stage, argument signature), as JAX keeps
one executable per signature (``aot.py:80-84``; a compaction bucket is a new
signature), and every later call replays it. The scheduler loops, the noise
draws and ``model_calls`` stay in Python, unchanged.

What a captured call holds:

- Its inputs are static buffers written before each replay: ``x``; the
  timestep as a device scalar (the denoiser takes it as a tensor, so no
  host-to-device copy is captured); the per-batch conditioning (the streams'
  embedding, the token mask, the class labels), copied in once per batch
  before that batch's first replay.
- Its output is cloned after each replay: the schedulers keep eps outputs
  across calls (PNDM's history).
- All graphs share one memory pool. Inputs live outside it and outputs are
  cloned at once, so graphs may replay in any order. ``StageGraphs`` holds
  every graph it captured for as long as it lives, also those of cascades
  that are gone (``resample_main --cf`` builds one cascade per class and
  guidance weight over one ``StageGraphs``): PyTorch keeps a pool whose
  graphs have all been destroyed until its memory is freed, and refuses a
  new capture into it.
- A replay runs none of the kernel wrappers, so each graph records what its
  capture added to ``LAUNCH_COUNTS`` and adds that at every replay. The
  record is held to the graph itself: the capture counts the graph's kernel
  nodes that run each wrapper's device functions (``KERNEL_FUNCTIONS``,
  named through libcuda) and raises where they differ. The eager warm-up
  before a capture (on a side stream, so that kernel attributes, the TMA
  encoder's entry point and the cuBLAS handles are set up outside the
  capture) and the capture itself count nothing.

Capture follows the device: a cascade on a CUDA card captures its stages
(``stage_graphs``), one on the CPU runs them eagerly. A CUDA graph cannot be
written to disk, so the cache directory (the sample CLI's ``--aot_cache``)
receives ``graphs.json`` instead, one entry per captured graph (stage,
shapes, dtype, capture seconds, kernel nodes, launches per replay); asking
for it off the card raises. A capture that fails raises and names the
stage; nothing falls back to eager (JAX's ``wrap`` falls back to plain jit,
``aot.py:58-59``).
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from brepgen_tpu_torch.kernels import KERNEL_FUNCTIONS, LAUNCH_COUNTS

MANIFEST = "graphs.json"
INPUTS = ("x", "cond_embed", "tok_mask", "labels")
CU_GRAPH_NODE_TYPE_KERNEL = 0


def signature(*tensors: Optional[torch.Tensor]) -> Tuple:
    """Shapes and types of the inputs: one graph per distinct signature."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype) for t in tensors)


class _KernelNodeParams(ctypes.Structure):
    """libcuda's CUDA_KERNEL_NODE_PARAMS_v2."""

    _fields_ = [("func", ctypes.c_void_p), *((f"dim{i}", ctypes.c_uint) for i in range(6)),
                ("shared_mem_bytes", ctypes.c_uint), ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


@functools.cache
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    vp, pvp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    lib.cuGraphGetNodes.argtypes = [vp, vp, ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphKernelNodeGetParams_v2.argtypes = [vp, ctypes.POINTER(_KernelNodeParams)]
    lib.cuKernelGetFunction.argtypes = [pvp, vp]
    lib.cuFuncGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p), vp]
    return lib


def _check(rc: int, call: str) -> None:
    if rc:
        raise RuntimeError(f"{call} failed with CUDA driver error {rc}")


def kernel_names(graph: "torch.cuda.CUDAGraph") -> List[str]:
    """The device function of every kernel node of a captured, not yet
    instantiated graph, by its (mangled) name, through libcuda's graph
    queries."""
    lib, handle = _libcuda(), ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(lib.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind, params, name, names = ctypes.c_int(), _KernelNodeParams(), ctypes.c_char_p(), []
    for node in nodes:
        node = ctypes.c_void_p(node)
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != CU_GRAPH_NODE_TYPE_KERNEL:
            continue
        _check(lib.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
               "cuGraphKernelNodeGetParams")
        func = ctypes.c_void_p(params.func)
        if not func.value:  # a node made from a CUkernel
            _check(lib.cuKernelGetFunction(ctypes.byref(func), ctypes.c_void_p(params.kern)),
                   "cuKernelGetFunction")
        _check(lib.cuFuncGetName(ctypes.byref(name), func), "cuFuncGetName")
        names.append(name.value.decode())
    return names


def graph_launches(names: Sequence[str], recorded: Dict[str, int]) -> Dict[str, int]:
    """The wrapper launches a graph holds: ``recorded``, what the capture
    added to ``LAUNCH_COUNTS``, held to the graph's kernel nodes by their
    device functions (``KERNEL_FUNCTIONS``; wrappers that share functions
    are held by their sum). Raises where the graph says otherwise."""
    families: Dict[Tuple[str, ...], List[str]] = {}
    for wrapper, (functions, _) in KERNEL_FUNCTIONS.items():
        families.setdefault(functions, []).append(wrapper)
    for functions, wrappers in families.items():
        nodes = sum(any(f in n for f in functions) for n in names)
        want = sum(recorded.get(w, 0) * KERNEL_FUNCTIONS[w][1] for w in wrappers)
        if nodes != want:
            raise RuntimeError(f"the graph holds {nodes} kernel nodes of {'/'.join(functions)}, "
                               f"the capture counted {want} ({recorded})")
    return {w: n for w, n in recorded.items() if n}


class CapturedCall:
    """One captured denoiser call with its static inputs and output."""

    def __init__(self, graph, x, t, consts, out, launches: Dict[str, int]):
        self.graph, self.x, self.t, self.consts, self.out = graph, x, t, consts, out
        self.launches = launches

    def bind(self, consts: Sequence[Optional[torch.Tensor]]) -> None:
        """Copy a batch's conditioning into the static buffers."""
        for static, c in zip(self.consts, consts):
            if static is not None:
                static.copy_(c)

    def replay(self, x: torch.Tensor, t) -> torch.Tensor:
        self.x.copy_(x)
        self.t.fill_(t)
        self.graph.replay()
        for name, n in self.launches.items():
            LAUNCH_COUNTS[name] += n
        return self.out.clone()


class StageGraphs:
    """Captures and replays the cascade's denoiser calls as CUDA graphs;
    the manifest goes to ``cache_dir/graphs.json`` (none for None)."""

    def __init__(self, cache_dir: Optional[str], device: str | torch.device = "cuda"):
        dev = torch.device(device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(f"stage capture records CUDA graphs (--aot_cache keeps their "
                               f"manifest) and needs a CUDA card; device {dev} is not one")
        self.cache_dir = cache_dir
        self.pool = torch.cuda.graph_pool_handle()
        self.calls: List[CapturedCall] = []  # keeps the pool live (module docstring)
        self.entries: List[Dict] = []
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def stage(self, stage: str, fn: Callable, consts: Sequence[Optional[torch.Tensor]],
              captured: Dict, dtype: torch.dtype) -> Callable[[torch.Tensor, object], torch.Tensor]:
        """``eps(x, t)`` replaying ``fn(x, t, *consts)`` from the graph of its
        signature in ``captured`` (the owner's store), capturing it first
        when there is none; ``consts`` are this batch's conditioning."""
        bound = set()

        def eps(x: torch.Tensor, t) -> torch.Tensor:
            key = (stage, signature(x, *consts))
            call = captured.get(key)
            if call is None:
                call = captured[key] = self._capture(stage, fn, x, consts, dtype)
            elif key not in bound:
                call.bind(consts)
            bound.add(key)
            return call.replay(x, t)

        return eps

    def _capture(self, stage, fn, x, consts, dtype) -> CapturedCall:
        counts = dict(LAUNCH_COUNTS)
        t0 = time.perf_counter()
        try:
            sx = x.clone()
            st = torch.zeros((), dtype=torch.long, device=x.device)
            sc = tuple(None if c is None else c.clone() for c in consts)
            side = torch.cuda.Stream(device=x.device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(sx, st, *sc)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            before = dict(LAUNCH_COUNTS)
            # thread_local: the postprocess threads keep using the card
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                out = fn(sx, st, *sc)
            names = kernel_names(graph)
            launches = graph_launches(names, {k: LAUNCH_COUNTS[k] - before[k]
                                              for k in LAUNCH_COUNTS})
            graph.instantiate()
            torch.cuda.synchronize(x.device)
        except Exception as e:  # noqa: BLE001 -- re-raised with the stage named
            raise RuntimeError(f"CUDA graph capture of stage {stage} failed for inputs "
                               f"{signature(x, *consts)}: {e}") from e
        finally:
            LAUNCH_COUNTS.update(counts)
        self.entries.append(dict(
            stage=stage,
            shapes={name: list(t.shape) for name, t in zip(INPUTS, (x, *consts))
                    if t is not None},
            dtype=str(dtype).removeprefix("torch."),
            capture_seconds=time.perf_counter() - t0,
            kernel_nodes=len(names),
            launches=launches,
        ))
        self._write_manifest()
        self.calls.append(CapturedCall(graph, sx, st, sc, out, launches))
        return self.calls[-1]

    def _write_manifest(self) -> None:
        if not self.cache_dir:
            return
        path = os.path.join(self.cache_dir, MANIFEST)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.entries, f, indent=1)
        os.replace(tmp, path)


def stage_graphs(device: str | torch.device,
                 cache_dir: Optional[str] = None) -> Optional[StageGraphs]:
    """StageGraphs for a cascade on ``device``, writing its manifest to
    ``cache_dir`` where given: on a CUDA card the stages are captured, on
    the CPU they run eagerly (None), and a manifest asked for there raises."""
    if torch.device(device).type == "cuda" or cache_dir:
        return StageGraphs(cache_dir, device)
    return None
