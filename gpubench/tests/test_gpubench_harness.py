"""``BENCHMARK.json`` against the contract's rules, and the harness finding a
configuration, a mix, limits and a metric reader by name alone."""

import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for kind in ("end_to_end", "per_layer", "workloads", "configs"):
        got = [x["name"] for x in BENCH[kind]]
        assert len(got) == len(set(got)), kind


def test_every_cell_reports_what_it_must():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25

    def reports(metric, cell):
        return cell in metric.get("workloads", cells)

    for cell in cells:
        assert sum(reports(m, cell) for m in BENCH["end_to_end"]) >= 2, cell
        assert any(reports(m, cell) for m in BENCH["per_layer"]), cell
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(len(cells) * 0.25))


def test_files_named_by_the_benchmark_exist():
    here = ROOT / "gpubench"
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert (here / "mixes" / f"{w['traffic']}.json").is_file()
        assert (here / "limits" / f"{w['name']}.json").is_file()
    for m in BENCH["per_layer"]:
        assert (here / "metrics" / f"{m['name']}.py").is_file()


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A configuration, a mix, limits and a metric dropped in as new files,
    with entries in BENCHMARK.json, run as a cell: no file that is there is
    edited."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = tmp_path / "gpubench"
    config = json.loads((here / "configs" / "deepcad.json").read_text())
    config["name"] = "deepcad2"
    (here / "configs" / "deepcad2.json").write_text(json.dumps(config))
    mix = json.loads((here / "mixes" / "eval-chamfer.json").read_text())
    (here / "mixes" / "eval-chamfer2.json").write_text(json.dumps(mix))
    limits = json.loads((here / "limits" / "deepcad-eval.json").read_text())
    (here / "limits" / "deepcad2-eval.json").write_text(json.dumps(limits))
    (here / "metrics" / "repeats_done.eval2.py").write_text(
        'def read(rec):\n    return float(rec["window"]["repeats"])\n')
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "deepcad2", "source": "https://example.org",
                             "file": "gpubench/configs/deepcad2.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "deepcad2-eval", "config": "deepcad2",
                               "traffic": "eval-chamfer2", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "eval_s_per_repeat":
            m["workloads"].append("deepcad2-eval")
    bench["per_layer"].append({"name": "repeats_done.eval2", "unit": "repeats",
                               "better": "higher", "source": "program_counter", "layer": "eval",
                               "moves": "eval_s_per_repeat", "workloads": ["deepcad2-eval"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT)]))
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload", "deepcad2-eval", "--seed",
         "2147483659", "--seconds", "0.2", "--trace", "1", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["repeats_done.eval2"]["value"] >= 1
    assert list(line)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    for name in ("run.py", "kinds/eval.py", "trace.py"):
        assert (here / name).read_bytes() == (ROOT / "gpubench" / name).read_bytes()


def test_no_card_no_result(tmp_path):
    """Without a card a run exits non-zero and prints nothing on stdout."""
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", "deepcad-eval",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_only_the_benchmark_is_not_enough(tmp_path):
    """In a directory that holds only BENCHMARK.json and gpubench/, a run
    fails and prints no result."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", "deepcad-eval",
                          "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
                         cwd=tmp_path, env=env, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
