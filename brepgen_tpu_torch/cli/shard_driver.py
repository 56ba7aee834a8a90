"""Sharded extraction driver: timeout isolation, retry, and resume.

The reference drives million-file ABC extraction with a shell loop that
runs each 10k-id interval under ``timeout`` and ``pkill``s stragglers
(``data_process/process.sh:3-21``) — no record of what finished, so a
restart redoes everything. This driver keeps those semantics (per-shard
wall-clock bound, hard kill of the whole process group on hang) and adds
what a million-file run actually needs: a manifest of completed/failed
shards so interrupted runs resume exactly where they stopped, and bounded
retries before a shard is marked failed and skipped.

Generic core (``run_shards``) + the CLI that shards a STEP tree and runs
``python -m brepgen_tpu_torch.cli.process_main`` per shard
(``process_shards_main``)::

    python -m brepgen_tpu_torch.cli.shard_driver --input STEP_DIR --output DIR \\
        [--option abc|deepcad|furniture] [--shard_size 10000] [--timeout 1000] \\
        [--retries 2]

``--option furniture`` shards every ``.step`` under ``STEP_DIR``; ``abc`` and
``deepcad`` shard the ABC release layout (``data/discovery.py``). The
manifest is ``DIR/_shards.json``.

The port's own copy of ``brepgen_tpu/cli/shard_driver.py``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
from typing import Callable, Dict, List, Sequence


def _items_fingerprint(items: Sequence[str], shard_size: int) -> str:
    h = hashlib.sha256()
    h.update(str(shard_size).encode())
    for it in items:
        h.update(it.encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def _load_manifest(path: str) -> Dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"done": [], "failed": []}


def _save_manifest(path: str, manifest: Dict) -> None:
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, path)


def run_shards(
    items: Sequence[str],
    cmd_for_shard: Callable[[str, int], List[str]],
    manifest_path: str,
    shard_size: int = 10000,
    timeout: float = 1000.0,
    retries: int = 2,
) -> Dict:
    """Run ``cmd_for_shard(uid_list_file, shard_id)`` per shard of items.

    Each shard's subprocess gets its own process group; on timeout the
    whole group is killed (the reference's ``pkill`` equivalent, without
    the risk of matching unrelated processes). Completed/failed shard ids
    are persisted to ``manifest_path`` after every shard, so re-running
    with the same arguments resumes.
    """
    manifest = _load_manifest(manifest_path)
    # Shard ids are positions into (items, shard_size); resuming against a
    # different item list or shard size would silently map 'done' ids onto
    # different file subsets. Refuse instead.
    fp = _items_fingerprint(items, shard_size)
    old_fp = manifest.get("fingerprint")
    if old_fp is not None and old_fp != fp and (manifest["done"] or manifest["failed"]):
        raise RuntimeError(
            f"manifest {manifest_path} was written for a different item list "
            f"or shard_size (fingerprint {old_fp} != {fp}); delete it or use "
            "a fresh manifest path to start over"
        )
    manifest["fingerprint"] = fp
    done = set(manifest["done"])
    failed = set(manifest["failed"])

    n_shards = -(-len(items) // shard_size)
    for sid in range(n_shards):
        if sid in done or sid in failed:
            continue
        shard = items[sid * shard_size : (sid + 1) * shard_size]
        with tempfile.NamedTemporaryFile(
            "w", suffix=f".shard{sid}.txt", delete=False
        ) as f:
            f.write("\n".join(shard))
            list_file = f.name
        try:
            ok = False
            for attempt in range(retries + 1):
                cmd = cmd_for_shard(list_file, sid)
                proc = subprocess.Popen(cmd, start_new_session=True)
                try:
                    rc = proc.wait(timeout=timeout)
                    if rc == 0:
                        ok = True
                        break
                    print(f"shard {sid}: rc={rc} (attempt {attempt + 1})")
                except subprocess.TimeoutExpired:
                    # kill the shard's WHOLE process group (worker pools
                    # included) -- bounded, unlike pattern-matching pkill
                    try:
                        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
                    except ProcessLookupError:
                        pass  # child exited in the TimeoutExpired->kill window
                    proc.wait()
                    print(f"shard {sid}: timeout after {timeout}s (attempt {attempt + 1})")
            (done if ok else failed).add(sid)
            manifest["done"] = sorted(done)
            manifest["failed"] = sorted(failed)
            _save_manifest(manifest_path, manifest)
        finally:
            os.unlink(list_file)
    return manifest


def process_shards_main(argv=None) -> Dict:
    """Shard a STEP release tree and extract each shard in isolation;
    returns the manifest."""
    from brepgen_tpu_torch.data.discovery import load_abc_step, load_furniture_step

    p = argparse.ArgumentParser()
    p.add_argument("--input", type=str, required=True, help="STEP root dir")
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--option", type=str, default="abc",
                   choices=["abc", "deepcad", "furniture"])
    p.add_argument("--split_json", type=str, default="train_val_test_split.json")
    p.add_argument("--shard_size", type=int, default=10000)
    p.add_argument("--timeout", type=float, default=1000.0,
                   help="per-shard wall clock (reference process.sh:10)")
    p.add_argument("--retries", type=int, default=2)
    args = p.parse_args(argv)

    if args.option == "furniture":
        items = load_furniture_step(args.input)
    else:
        items = load_abc_step(
            args.input, args.option == "deepcad", split_json=args.split_json
        )
    os.makedirs(args.output, exist_ok=True)
    manifest_path = os.path.join(args.output, "_shards.json")

    def cmd(list_file: str, sid: int) -> List[str]:
        return [
            sys.executable, "-m", "brepgen_tpu_torch.cli.process_main",
            "--input", args.input, "--uid_list", list_file,
            "--output", args.output, "--option", args.option,
        ]

    manifest = run_shards(
        items, cmd, manifest_path,
        shard_size=args.shard_size, timeout=args.timeout, retries=args.retries,
    )
    print(
        f"shards done={len(manifest['done'])} failed={len(manifest['failed'])}"
        f" -> {manifest_path}"
    )
    return manifest


if __name__ == "__main__":
    process_shards_main()
