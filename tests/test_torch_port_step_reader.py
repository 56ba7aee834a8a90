"""Port: the native STEP reader (``geometry/step_reader.py``) against the JAX
package's, on committed STEP files and the hand-written texts of
``tests/test_geometry.py``.

``parse_step``, ``load_brep`` and ``validate_solid`` give equal entity
counts, equal topology and equal arrays (atol 0), and raise the same
exception type with the same text where the JAX reader raises.
"""

import os

import numpy as np
import pytest

from brepgen_tpu.geometry import step_reader as j_reader
from brepgen_tpu_torch.geometry import step_reader as t_reader
from test_geometry import _capped_cylinder_step, _swept_cylinder_step

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

# STEP files the JAX pipeline wrote (committed), from seven folders: the
# first two of each sample folder in name order (solids of 4 to 8 faces with
# 2 to 8 conformance errors each), the geometric-set fallbacks without a
# shell (``04j7bKl0zrZm3Pb_4``, ``25w9BX0t30eCyCc_0``: ``no B-rep shell
# found``) and one whose extraction fails an assertion (``9S7FyQ8ejW3lg8p_7``)
CORPUS = (
    "artifacts/demo_round1/04j7bKl0zrZm3Pb_4.step",
    "artifacts/demo_round3/all160k/samples/08Fmi3tGeAss4ut_3.step",
    "artifacts/demo_round3/all160k/samples/0M9liI4wVvTSTFw_11.step",
    "artifacts/demo_round3/all40k/samples/2ilLta11z9GQmPg_4.step",
    "artifacts/demo_round3/all40k/samples/6yh1ZWOULkvad2w_12.step",
    "artifacts/demo_round3/cuboid40k/samples/7ccCsFGbY3WYWuJ_10.step",
    "artifacts/demo_round3/cuboid40k/samples/9HUjORIQjXKfpfZ_6.step",
    "artifacts/demo_round4/resample_dbg/z0.2/2Lg8hQIyRX0G5fD_15.step",
    "artifacts/demo_round4/resample_dbg/z0.2/2fYSq1vyaeLaqsX_2.step",
    "artifacts/demo_round4/resample_recover/z0.2/0vzRFVAw50rmMpK_0.step",
    "artifacts/demo_round4/resample_recover/z0.2/0xcPKFwnjcmLwZC_5.step",
    "artifacts/demo_round4/resample_v3/z0.2/0oQgoyAYeLkgdOV_1.step",
    "artifacts/demo_round4/resample_v3/z0.2/1Ap47zYoGLlMQGI_15.step",
    "artifacts/demo_round4/resample_v3/z0.2/25w9BX0t30eCyCc_0.step",
    "artifacts/demo_round4/resample_v3/z0.2/9S7FyQ8ejW3lg8p_7.step",
)
NO_SHELL = ("04j7bKl0zrZm3Pb_4.step", "25w9BX0t30eCyCc_0.step")


def corpus_path(rel):
    path = os.path.join(ROOT, rel)
    assert os.path.isfile(path), path
    return path


def assert_same(got, want, where="root"):
    """Equal structure, types (by name) and values; arrays bit for bit."""
    assert type(got).__name__ == type(want).__name__, (where, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, tuple) and hasattr(want, "_fields"):
        assert got._fields == want._fields, where
        for name in want._fields:
            assert_same(getattr(got, name), getattr(want, name), f"{where}.{name}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    else:
        assert got == want, (where, got, want)


def outcome(fn, *args):
    """('ok', result) or ('raised', exception type name, message)."""
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 -- the exception is what is compared
        return "raised", type(e).__name__, str(e)


def _inline_texts(tmp_path):
    paths = {}
    paths["capped_cylinder"] = str(tmp_path / "capped.step")
    _capped_cylinder_step(paths["capped_cylinder"])
    for mode in ("extrusion", "revolution"):
        paths[f"swept_{mode}"] = str(tmp_path / f"{mode}.step")
        _swept_cylinder_step(paths[f"swept_{mode}"], mode=mode)
    return paths


def _check_file(path):
    want, got = outcome(j_reader.parse_step, path), outcome(t_reader.parse_step, path)
    assert_same(got, want, "parse_step")
    want, got = outcome(j_reader.load_brep, path), outcome(t_reader.load_brep, path)
    assert_same(got, want, "load_brep")
    if want[0] == "ok":
        brep = want[1]
        assert len(got[1].faces) == len(brep.faces) and len(got[1].edges) == len(brep.edges)
        assert_same(t_reader.validate_solid(got[1]), j_reader.validate_solid(brep),
                    "validate_solid")
    return want


@pytest.mark.parametrize("rel", CORPUS, ids=lambda p: p.split("/")[-1])
def test_corpus_file_reads_as_in_jax(rel):
    want = _check_file(corpus_path(rel))
    if rel.endswith(NO_SHELL):
        assert want[0] == "raised" and want[1] == "ValueError"
        assert want[2].endswith("no B-rep shell found")
    else:
        assert want[0] == "ok" and 4 <= len(want[1].faces) <= 8
        assert j_reader.validate_solid(want[1])["ok"]


@pytest.mark.parametrize("name", ["capped_cylinder", "swept_extrusion", "swept_revolution"])
def test_inline_text_reads_as_in_jax(tmp_path, name):
    want = _check_file(_inline_texts(tmp_path)[name])
    assert want[0] == "ok" and len(want[1].faces) == 3 and len(want[1].edges) == 2
    assert j_reader.validate_solid(want[1])["ok"]


def test_tokenizer_quoted_semicolons_and_escapes(tmp_path):
    # ';' and ''-escaped quotes inside string attributes
    path = str(tmp_path / "quoted.step")
    with open(path, "w") as f:
        f.write("ISO-10303-21;\nHEADER;ENDSEC;\nDATA;\n")
        f.write("#1=PRODUCT('part;rev2','it''s a name','',());\n")
        f.write("#2=CARTESIAN_POINT('p;q',(1.,2.,3.));\n")
        f.write("#3=(BOUNDED_CURVE()CURVE());\n")
        f.write("\nENDSEC;\nEND-ISO-10303-21;\n")
    got = t_reader.parse_step(path)
    assert_same(got, j_reader.parse_step(path))
    assert got[1].args[:2] == ["part;rev2", "it's a name"]
    assert isinstance(got[1].args[3], list) and got[2].args[1] == [1.0, 2.0, 3.0]
    text = "'a;b''c';#12=X(1);"
    assert t_reader._split_records(text) == j_reader._split_records(text)
    assert t_reader._tokenize("#5,.T.,$,*,(1,2.5E-1),'x''y'") == j_reader._tokenize(
        "#5,.T.,$,*,(1,2.5E-1),'x''y'")


def test_missing_data_section_raises_as_in_jax(tmp_path):
    path = str(tmp_path / "empty.step")
    with open(path, "w") as f:
        f.write("ISO-10303-21;\nHEADER;ENDSEC;\nEND-ISO-10303-21;\n")
    want, got = outcome(j_reader.parse_step, path), outcome(t_reader.parse_step, path)
    assert want[0] == "raised" and got == want
