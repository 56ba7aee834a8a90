"""On the card: a short run of a cell through the command the driver runs,
and its last line as the contract reads it. Skips without a card; run on
the card with ``python3 -m pytest --noconftest -m cuda gpubench/tests``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_short_eval_run(card, trace):
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", "deepcad-eval",
                          "--seed", "2147483659", "--seconds", "1", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=360)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == card and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert set(line["metrics"]) == {"chamfer_roofline.eval", "mfu.eval", "idle_share.eval"}
    else:
        assert set(line["metrics"]) == {"eval_s_per_repeat", "setup_s"}
