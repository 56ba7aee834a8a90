"""Port: the independent STEP conformance validator
(``geometry/step_conformance.py``) against the JAX package's.

The same error lists, item for item, on the committed corpus and on
mutated exports; the port's own exports pass it; its command line reports
as the JAX one does.
"""

import re
import subprocess
import sys

import pytest

from brepgen_tpu.geometry import step_conformance as j_conf
from brepgen_tpu_torch.data import synthetic
from brepgen_tpu_torch.geometry import construct_brep
from brepgen_tpu_torch.geometry import step_conformance as t_conf
from test_torch_port_step_reader import CORPUS, NO_SHELL, ROOT, corpus_path

SOLIDS = {
    "cuboid": synthetic.make_cuboid,
    "prism6": lambda: synthetic.make_prism(6),
    "cylinder": synthetic.make_cylinder,
}


def _export(maker, path):
    data = maker()
    construct_brep(data["surf_wcs"], data["edge_wcs"], data["faceEdge_adj"],
                   data["edgeCorner_adj"]).write_step(str(path))
    return str(path)


@pytest.mark.parametrize("rel", CORPUS, ids=lambda p: p.split("/")[-1])
def test_corpus_errors_equal_jax(rel):
    with open(corpus_path(rel)) as f:
        text = f.read()
    want = j_conf.validate_step_text(text)
    assert t_conf.validate_step_text(text) == want
    # the older exports carry 2 to 8 violations each; the geometric-set
    # fallbacks, with no shell to check, none
    assert (want == []) == rel.endswith(NO_SHELL)


@pytest.mark.parametrize("shape", sorted(SOLIDS))
def test_port_exports_pass(tmp_path, shape):
    path = _export(SOLIDS[shape], tmp_path / f"{shape}.step")
    assert t_conf.validate_step_file(path) == [] == j_conf.validate_step_file(path)


def test_mutations_caught_as_in_jax(tmp_path):
    """The mutation classes of ``tests/test_geometry.py``: each caught, with
    the JAX validator's error list."""
    text = open(_export(synthetic.make_cuboid, tmp_path / "c.step")).read()
    cyl = open(_export(synthetic.make_cylinder, tmp_path / "c2.step")).read()
    mutants = {}
    oe = re.search(r"#\d+=ORIENTED_EDGE\('',\*,\*,#\d+,(\.[TF]\.)\);", text)
    mutants["flipped edge"] = (text[:oe.start(1)] + (".F." if oe.group(1) == ".T." else ".T.")
                               + text[oe.end(1):], ("SAME direction", "not vertex-connected"))
    mutants["dangling"] = (re.sub(r"#(\d+)=CLOSED_SHELL\('',\(#(\d+)",
                                  lambda m: f"#{m.group(1)}=CLOSED_SHELL('',(#99999", text, 1),
                           ("dangling",))
    m = re.search(r"B_SPLINE_CURVE_WITH_KNOTS\('',3,(\([^)]*\)),"
                  r"\.UNSPECIFIED\.,\.F\.,\.F\.,\((\d+)", text)
    mutants["knot law"] = (text[:m.start(2)] + str(int(m.group(2)) + 1) + text[m.end(2):],
                           ("knot law",))
    m = re.search(r"CLOSED_SHELL\('',\(#(\d+),", text)
    mutants["dropped face"] = (text[:m.start()] + "CLOSED_SHELL('',(" + text[m.end():],
                               ("used 1x",))
    mutants["outer bound"] = (cyl.replace("FACE_OUTER_BOUND(", "FACE_BOUND(", 1),
                              ("FACE_OUTER_BOUND",))
    mutants["truncated"] = (text.replace("END-ISO-10303-21;", ""), ("",))
    for name, (mutant, needles) in mutants.items():
        got = t_conf.validate_step_text(mutant)
        assert got == j_conf.validate_step_text(mutant), name
        assert any(n in e for e in got for n in needles), (name, got)


def test_command_line(tmp_path, capsys):
    """``python -m brepgen_tpu_torch.geometry.step_conformance FILE ...``
    prints what the JAX package's ``main`` prints and exits 1 when a file
    has a violation, 2 without files."""
    good = _export(synthetic.make_cuboid, tmp_path / "good.step")
    files = [good, corpus_path(CORPUS[1])]
    run = subprocess.run([sys.executable, "-m", "brepgen_tpu_torch.geometry.step_conformance",
                          *files], cwd=ROOT, capture_output=True, text=True)
    assert j_conf.main(files) == run.returncode == 1
    assert run.stdout == capsys.readouterr().out
    assert "CONFORMANT" in run.stdout and "6 violations" in run.stdout
    assert t_conf.main([good]) == 0 and t_conf.main([]) == 2
