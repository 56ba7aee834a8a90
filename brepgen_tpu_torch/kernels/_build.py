"""Build the port's CUDA kernels with nvcc into plain shared libraries.

Each source under ``csrc/`` exposes a plain ``extern "C"`` launcher, so it is
compiled without PyTorch's headers (seconds, not minutes) and loaded with
``ctypes``. A library is built at first use into
``build/torch_kernels/<name>-<hash>/`` at the repository root (override with
``BREPGEN_TORCH_BUILD_DIR``), keyed by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# name -> (seconds spent building in this process, nvcc's -Xptxas=-v report,
# kept beside the library as ptxas.txt for a library built earlier)
BUILD_LOG: dict[str, tuple[float, str]] = {}
_LOADED: dict[str, ctypes.CDLL] = {}


def build_root() -> Path:
    env = os.environ.get("BREPGEN_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME``, else ``PATH``, else the toolkit's default place."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin); "
        "the CUDA kernels are built from source at first use"
    )


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``lib<name>.so`` unless already built."""
    src = CSRC / f"{name}.cu"
    key = b"".join(p.read_bytes() for p in [src, *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(key + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_root() / f"{name}-{digest}"
    lib = out_dir / f"lib{name}.so"
    report = out_dir / "ptxas.txt"
    if lib.is_file():
        if name not in BUILD_LOG and report.is_file():
            BUILD_LOG[name] = (0.0, report.read_text())
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.NamedTemporaryFile(dir=out_dir, suffix=".so", delete=False) as tmp:
        tmp_path = tmp.name
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp_path, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stdout}\n{proc.stderr}")
        report.write_text(proc.stdout + proc.stderr)
        os.replace(tmp_path, lib)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    BUILD_LOG[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)))
    return _LOADED[name]


# SASS opcodes counted per kernel function: tensor-core products of mma.sync
# (HMMA) and of wgmma (HGMMA), and TMA tile loads (UTMALDG)
SASS_OPCODES = ("HMMA", "HGMMA", "UTMALDG")


def sass_counts(name: str, opcodes=SASS_OPCODES) -> dict[str, dict[str, int]] | None:
    """{kernel function: {opcode: count}} of ``opcodes`` in the built library,
    read with the toolkit's ``cuobjdump -sass``; None where the toolkit has
    no ``cuobjdump``. Counts are of the compiled code, not of executed
    instructions."""
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.access(tool, os.X_OK):
        return None
    sass = subprocess.run([tool, "-sass", str(build(name))], capture_output=True, text=True,
                          check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    func = None
    for line in sass.splitlines():
        if "Function :" in line:
            func = line.split("Function :", 1)[1].strip()
            counts[func] = dict.fromkeys(opcodes, 0)
        elif func is not None:
            words = line.replace(";", " ").split()
            for op in opcodes:
                if any(w.split(".")[0] == op for w in words):
                    counts[func][op] += 1
    return counts
