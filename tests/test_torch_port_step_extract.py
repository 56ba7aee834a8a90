"""Port: STEP -> pkl extraction (``geometry/native_extract.py``), the
``process_main --input`` CLI and the shard driver (``cli/shard_driver.py``)
against the JAX package.

Extraction of the committed corpus and of round trips of the port's own
exports gives the JAX package's pkl dict, array by array (atol 0), and the
same bytes on disk; a file the JAX extraction raises on raises the same
exception in the port. The shard driver is held to its contract with a stub
worker (timeout and process-group kill, retry, resume, manifest), then run
for real over a small STEP tree.
"""

import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

from brepgen_tpu.cli import process_main as j_process_main
from brepgen_tpu.geometry import native_extract as j_extract
from brepgen_tpu_torch.cli import process_main, shard_driver
from brepgen_tpu_torch.data import synthetic
from brepgen_tpu_torch.data.schema import validate_brep
from brepgen_tpu_torch.geometry import construct_brep
from brepgen_tpu_torch.geometry import native_extract as t_extract
from test_torch_port_step_reader import CORPUS, ROOT, corpus_path, outcome
from test_torch_port_process import _tree_bytes

SOLIDS = {
    "cuboid": synthetic.make_cuboid,
    "prism6": lambda: synthetic.make_prism(6),
    "cylinder": synthetic.make_cylinder,
    "lblock": synthetic.make_lblock,
    "frustum": synthetic.make_frustum,
}


def _export(data, path):
    construct_brep(data["surf_wcs"], data["edge_wcs"], data["faceEdge_adj"],
                   data["edgeCorner_adj"]).write_step(str(path))
    return str(path)


def _assert_same_sample(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif isinstance(w, list):
            assert len(g) == len(w), k
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert g == w, k
    assert pickle.dumps(got) == pickle.dumps(want)


@pytest.mark.parametrize("rel", CORPUS, ids=lambda p: p.split("/")[-1])
def test_corpus_extracts_as_in_jax(rel):
    path = corpus_path(rel)
    want, got = outcome(j_extract.extract_step_file, path), outcome(t_extract.extract_step_file,
                                                                      path)
    if want[0] == "raised":
        assert got == want
        return
    assert got[0] == "ok" and (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        _assert_same_sample(got[1], want[1])
        validate_brep(got[1])


@pytest.mark.parametrize("shape", sorted(SOLIDS))
def test_export_round_trip(tmp_path, shape):
    """The port's export, read back by the port: the JAX package's dict, and
    the source grids within 5e-2 (both sides normalized to [-1, 1]^3)."""
    data = SOLIDS[shape]()
    path = _export(data, tmp_path / f"{shape}.step")
    got = t_extract.extract_step_file(path)
    _assert_same_sample(got, j_extract.extract_step_file(path))
    validate_brep(got)
    assert got["uid"] == f"{shape}.pkl"
    assert len(got["surf_wcs"]) == len(data["surf_wcs"])
    assert len(got["edge_wcs"]) == len(data["edge_wcs"])
    assert np.abs(got["surf_wcs"] - data["surf_wcs"]).max() < 5e-2


def test_sampling_helpers_as_in_jax():
    from brepgen_tpu.geometry import step_reader as j_reader
    from brepgen_tpu_torch.geometry import step_reader as t_reader

    path = corpus_path(CORPUS[1])
    jb, tb = j_reader.load_brep(path), t_reader.load_brep(path)
    for je, te in zip(jb.edges, tb.edges):
        np.testing.assert_array_equal(
            t_extract.sample_curve_grid(te.curve, tb.vertices[te.v_start], tb.vertices[te.v_end]),
            j_extract.sample_curve_grid(je.curve, jb.vertices[je.v_start],
                                        jb.vertices[je.v_end]))
    for jf, tf in zip(jb.faces, tb.faces):
        np.testing.assert_array_equal(t_extract.sample_surface_grid(tf.surface, num=8),
                                      j_extract.sample_surface_grid(jf.surface, num=8))


def _step_tree(root, names):
    os.makedirs(root, exist_ok=True)
    for name, maker in zip(names, (synthetic.make_cuboid, lambda: synthetic.make_prism(5),
                                   synthetic.make_cylinder)):
        os.makedirs(os.path.dirname(os.path.join(root, name)), exist_ok=True)
        _export(maker(), os.path.join(root, name))
    return str(root)


def test_native_process_dir_as_in_jax(tmp_path):
    """``native_process_dir`` over a folder and over a list of roots (a
    folder and a file, as the shard driver writes it): the JAX package's
    files byte for byte; a non-numeric uid lands at the top of the output."""
    steps = _step_tree(tmp_path / "steps", ["00000000.step", "sub/00010001.step",
                                            "solid_a.step"])
    roots = [os.path.join(steps, "sub"), os.path.join(steps, "solid_a.step")]
    for args, n in (((steps,), 3), ((None, roots), 2)):
        tag = "roots" if len(args) > 1 else "dir"
        outs = [str(tmp_path / f"{side}_{tag}") for side in ("port", "jax")]
        got_n = process_main.native_process_dir(args[0], outs[0], *args[1:])
        assert got_n == j_process_main.native_process_dir(args[0], outs[1], *args[1:]) == n
        got, want = _tree_bytes(outs[0]), _tree_bytes(outs[1])
        assert got == want and "solid_a.pkl" in got
    assert sorted(got) == ["0001/00010001.pkl", "solid_a.pkl"]


def _stub_cmd(tmp_path, behavior):
    """A worker that appends its uids to done.txt; a 'hang' shard starts a
    grandchild that records its pid, then both sleep an hour; a 'flaky' one
    fails its first attempt."""
    script = tmp_path / "worker.py"
    script.write_text(f"""
import os, subprocess, sys, time
uids = [l.strip() for l in open(sys.argv[1]) if l.strip()]
mode = {behavior!r}.get(uids[0], "ok")
marker = {str(tmp_path)!r} + "/attempt_" + uids[0]
if mode == "flaky" and not os.path.exists(marker):
    open(marker, "w").write("x")
    sys.exit(1)
if mode == "hang":
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(3600)"])
    with open({str(tmp_path)!r} + "/grandchildren.txt", "a") as f:
        f.write(str(child.pid) + "\\n")
    time.sleep(3600)
with open({str(tmp_path)!r} + "/done.txt", "a") as f:
    for u in uids:
        f.write(u + "\\n")
""")
    return lambda list_file, sid: [sys.executable, str(script), list_file]


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_run_shards_timeout_retry_resume(tmp_path):
    items = [f"uid{i}" for i in range(9)]  # 3 shards of 3
    behavior = {"uid3": "flaky", "uid6": "hang"}
    manifest_path = str(tmp_path / "m.json")
    t = time.perf_counter()
    m = shard_driver.run_shards(items, _stub_cmd(tmp_path, behavior), manifest_path,
                                shard_size=3, timeout=3.0, retries=1)
    # shard 0 ok; shard 1 fails, is retried and passes; shard 2 hangs, is
    # killed with its process group, retried, killed again: failed
    assert m["done"] == [0, 1] and m["failed"] == [2]
    assert time.perf_counter() - t >= 6.0
    assert set(open(tmp_path / "done.txt").read().split()) == {f"uid{i}" for i in range(6)}
    grandchildren = [int(p) for p in open(tmp_path / "grandchildren.txt").read().split()]
    assert len(grandchildren) == 2
    deadline = time.time() + 5
    while any(_alive(p) for p in grandchildren) and time.time() < deadline:
        time.sleep(0.05)
    assert not any(_alive(p) for p in grandchildren)
    with open(manifest_path) as f:
        assert json.load(f) == m

    # resume: nothing finished or failed runs again
    os.unlink(tmp_path / "done.txt")
    assert shard_driver.run_shards(items, _stub_cmd(tmp_path, behavior), manifest_path,
                                   shard_size=3, timeout=3.0, retries=1) == m
    assert not os.path.exists(tmp_path / "done.txt")
    # another item list against that manifest is refused
    with pytest.raises(RuntimeError, match="different item list"):
        shard_driver.run_shards(items[:6], _stub_cmd(tmp_path, behavior), manifest_path,
                                shard_size=3)


def test_process_shards_main_extracts_a_tree(tmp_path, monkeypatch):
    """The driver's CLI over a tree of three exports in two shards, each a
    ``python -m brepgen_tpu_torch.cli.process_main`` subprocess."""
    steps = _step_tree(tmp_path / "steps", ["a/00000000.step", "a/00000001.step",
                                            "b/00000002.step"])
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    out = str(tmp_path / "parsed")
    manifest = shard_driver.process_shards_main(
        ["--input", steps, "--output", out, "--option", "furniture", "--shard_size", "2",
         "--timeout", "300", "--retries", "0"])
    assert manifest["done"] == [0, 1] and manifest["failed"] == []
    got = _tree_bytes(out)
    assert sorted(got) == ["0000/00000000.pkl", "0000/00000001.pkl", "0000/00000002.pkl",
                           "_shards.json"]
    assert j_process_main.native_process_dir(steps, str(tmp_path / "jax")) == 3
    want = _tree_bytes(tmp_path / "jax")
    for k in want:
        assert got[k] == want[k], k
    cmd = subprocess.run([sys.executable, "-m", "brepgen_tpu_torch.cli.shard_driver", "--help"],
                         cwd=ROOT, capture_output=True, text=True)
    assert cmd.returncode == 0 and "--shard_size" in cmd.stdout
