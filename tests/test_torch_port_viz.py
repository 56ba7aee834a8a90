"""Port: ``utils/viz.py`` draws the PNGs of the JAX package's, pixel for
pixel, from tensors or arrays; without matplotlib it names what is missing."""

import builtins
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")

from brepgen_tpu.geometry.brep_build import SolidMesh as JSolidMesh  # noqa: E402
from brepgen_tpu.utils import viz as jviz  # noqa: E402
from brepgen_tpu_torch.geometry.brep_build import SolidMesh  # noqa: E402
from brepgen_tpu_torch.utils import viz  # noqa: E402


def _pixels(path):
    import matplotlib.image

    return matplotlib.image.imread(str(path))


def _sample():
    rng = np.random.default_rng(0)
    lo = rng.uniform(-0.9, 0.0, size=(2, 6, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.1, 0.8, size=(2, 6, 3))], -1)
    mask = np.zeros((2, 6), bool)
    mask[1, 3:] = True
    return {"surf_pos": boxes.astype(np.float32), "surf_mask": mask}


@pytest.mark.parametrize("as_tensor", [False, True])
def test_plot_sample_matches_jax(tmp_path, as_tensor):
    sample = _sample()
    jviz.plot_sample(sample, 1, str(tmp_path / "jax.png"))
    if as_tensor:
        sample = {k: torch.from_numpy(v) for k, v in sample.items()}
    viz.plot_sample(sample, 1, str(tmp_path / "port.png"))
    want, got = _pixels(tmp_path / "jax.png"), _pixels(tmp_path / "port.png")
    assert got.shape == want.shape == (600, 600, 4)
    np.testing.assert_array_equal(got, want)
    assert (got[..., :3] < 1).any()  # something was drawn


def test_plot_solid_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    faces = [rng.normal(size=(n, 3, 3)) for n in (4, 0, 7)]
    jviz.plot_solid(JSolidMesh([], [], faces, []), str(tmp_path / "jax.png"))
    viz.plot_solid(SolidMesh([], [], faces, []), str(tmp_path / "port.png"))
    np.testing.assert_array_equal(_pixels(tmp_path / "port.png"), _pixels(tmp_path / "jax.png"))


def test_without_matplotlib_the_error_names_it(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] in ("matplotlib", "mpl_toolkits"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    for mod in [m for m in sys.modules if m.split(".")[0] in ("matplotlib", "mpl_toolkits")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="needs matplotlib"):
        viz.plot_sample(_sample(), 0, str(tmp_path / "x.png"))
    with pytest.raises(ImportError, match="needs matplotlib"):
        viz.plot_3d_bbox(None, np.zeros(3), np.ones(3))
