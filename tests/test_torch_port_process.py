"""Port: the data path from solids to deduplicated training sets, against
the JAX package on the CPU.

``process_main --synthetic`` and ``--input``, ``dedup_solids`` / ``dedup_primitives``,
``discover_split`` and ``eval_main dedup`` in both packages, on the same
seeds and on a tree in the reference layout (as ``tests/test_discovery.py``
lays it out): the files they write are byte-identical, the arrays and lists
equal.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from brepgen_tpu.cli import eval_main as j_eval_main
from brepgen_tpu.cli import process_main as j_process_main
from brepgen_tpu.data import dedup as j_dedup
from brepgen_tpu.data import discovery as j_discovery
from brepgen_tpu.data.synthetic import make_dataset as j_make_dataset
from brepgen_tpu_torch.cli import eval_main, process_main
from brepgen_tpu_torch.data import dedup, discovery
from brepgen_tpu_torch.data.synthetic import make_dataset


def _tree_bytes(root):
    """{relative path: file bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _run_in(path, monkeypatch, fn, argv):
    os.makedirs(path, exist_ok=True)
    monkeypatch.chdir(path)
    fn(argv)


def test_process_main_synthetic_writes_the_same_files(tmp_path, monkeypatch):
    # 20 solids: repeated ones dropped, the rest sharded, the split drawn
    # from default_rng(seed); every pkl and the split byte for byte
    for name, fn in (("jax", j_process_main.main), ("port", process_main.main)):
        _run_in(tmp_path / name, monkeypatch, fn,
                ["--synthetic", "20", "--output", "parsed", "--option", "deepcad", "--seed", "3"])
    want, got = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert "deepcad_data_split_6bit.pkl" in got and len(got) > 10
    for k in want:
        assert got[k] == want[k], k
    with open(tmp_path / "port" / "deepcad_data_split_6bit.pkl", "rb") as f:
        split = pickle.load(f)
    assert len(split["val"]) == len(split["test"]) >= 1 and split["train"]


def test_process_main_input_extracts_every_export(tmp_path, monkeypatch):
    """``process_main --input DIR --output OUT`` (run as ``python -m``)
    extracts every STEP export in DIR with the native reader: one pkl each,
    the JAX package's native backend's files byte for byte."""
    from brepgen_tpu_torch.geometry import construct_brep

    steps = tmp_path / "steps"
    os.makedirs(steps)
    for i, data in enumerate(make_dataset(6, seed=1)):
        construct_brep(data["surf_wcs"], data["edge_wcs"], data["faceEdge_adj"],
                       data["edgeCorner_adj"]).write_step(str(steps / f"{i:08d}.step"))
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    run = subprocess.run([sys.executable, "-m", "brepgen_tpu_torch.cli.process_main", "--input",
                          str(steps), "--output", str(tmp_path / "port")], cwd=root,
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stderr
    assert "extracted 6 solids" in run.stdout
    assert j_process_main.native_process_dir(str(steps), str(tmp_path / "jax")) == 6
    got, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert sorted(got) == [f"0000/{i:08d}.pkl" for i in range(6)] and got == want
    with pytest.raises(SystemExit):
        process_main.main(["--output", str(tmp_path / "none")])


@pytest.mark.parametrize("n_bits", [4, 6])
def test_dedup_matches_jax(n_bits):
    ds, jds = make_dataset(40, seed=2), j_make_dataset(40, seed=2)
    keep = dedup.dedup_solids(ds, n_bits)
    assert keep == j_dedup.dedup_solids(jds, n_bits) and len(keep) < 40
    assert dedup.solid_hash(ds[0]["surf_wcs"], n_bits) == j_dedup.solid_hash(
        jds[0]["surf_wcs"], n_bits)
    for kind in ("surface", "edge"):
        got = dedup.dedup_primitives(ds, kind, n_bits)
        want = j_dedup.dedup_primitives(jds, kind, n_bits)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    x = np.linspace(-1.2, 1.2, 101)
    assert np.array_equal(dedup.real2bit(x, n_bits), j_dedup.real2bit(x, n_bits))


def _write_pkl(path, surf=None, seed=0):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        pickle.dump({"surf_wcs": surf if surf is not None else rng.normal(size=(3, 4, 4, 3))}, f)


@pytest.fixture
def trees(tmp_path):
    """The layouts of tests/test_discovery.py: DeepCAD shards with the
    official split json, furniture classes, a flat folder."""
    root = tmp_path / "deepcad_parsed"
    for i in (0, 1, 2, 7, 10000, 10001, 20005):
        _write_pkl(str(root / str(i // 10000).zfill(4) / f"{i:08d}.pkl"), seed=i)
    dup = np.ones((2, 4, 4, 3))  # two identical train solids
    _write_pkl(str(root / "0000" / "00000001.pkl"), surf=dup)
    _write_pkl(str(root / "0000" / "00000002.pkl"), surf=dup)
    split = {
        "train": [f"{i // 10000:04d}/{i:08d}" for i in (0, 1, 2, 10000)],
        "validation": ["0000/00000007", "0001/00010001"],
        "test": ["0002/00020005"],
    }
    sj = tmp_path / "train_val_test_split.json"
    sj.write_text(json.dumps(split))
    furniture = tmp_path / "furniture"
    for cls in ("chair", "table"):
        for i in range(10):
            _write_pkl(str(furniture / cls / f"{cls}_{i}.pkl"), seed=i)
    flat = tmp_path / "flat"
    for i in range(20):
        _write_pkl(str(flat / f"solid_{i}.pkl"), seed=i)
    return dict(deepcad=(str(root), str(sj)), furniture=str(furniture), flat=str(flat))


def test_discover_split_matches_jax(trees):
    root, sj = trees["deepcad"]
    cases = [((root, "deepcad"), dict(split_json=sj)), ((root, "abc"), dict(seed=4)),
             ((trees["furniture"], "furniture"), dict(seed=1)), ((trees["flat"], "abc"), {})]
    for args, kw in cases:
        got = discovery.discover_split(*args, **kw)
        assert got == j_discovery.discover_split(*args, **kw), args
        assert sum(len(x) for x in got) > 0
    assert discovery.load_abc_step("/abc", True, sj, n_chunks=3) == j_discovery.load_abc_step(
        "/abc", True, sj, n_chunks=3)
    assert discovery.load_furniture_step(trees["furniture"]) == []


def test_dedup_main_writes_the_same_files(tmp_path, monkeypatch, trees):
    # CAD mode on the reference layout (the duplicate train solid dropped,
    # the official val and test kept), then both primitive modes on
    # process_main's output
    root, sj = trees["deepcad"]
    for name, fn in (("jax", j_eval_main.dedup_main), ("port", eval_main.dedup_main)):
        _run_in(tmp_path / name, monkeypatch, fn,
                ["--data", root, "--option", "deepcad", "--split_json", sj])
    want = (tmp_path / "jax" / "deepcad_data_split_6bit.pkl").read_bytes()
    assert (tmp_path / "port" / "deepcad_data_split_6bit.pkl").read_bytes() == want
    split = pickle.loads(want)
    assert len(split["train"]) == 3 and len(split["val"]) == 2 and len(split["test"]) == 1

    for name, fn in (("jax", j_process_main.main), ("port", process_main.main)):
        _run_in(tmp_path / name, monkeypatch, fn,
                ["--synthetic", "16", "--output", "parsed", "--option", "deepcad"])
        for extra in ([], ["--edge"]):
            dedup_fn = j_eval_main.dedup_main if name == "jax" else eval_main.dedup_main
            dedup_fn(["--data", "parsed", "--list", "deepcad_data_split_6bit.pkl", *extra])
    for suffix in ("surface", "edge"):
        got = (tmp_path / "port" / f"deepcad_data_split_6bit_{suffix}.pkl").read_bytes()
        assert got == (tmp_path / "jax" / f"deepcad_data_split_6bit_{suffix}.pkl").read_bytes()
        assert len(pickle.loads(got)) > 1
