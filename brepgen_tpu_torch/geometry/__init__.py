"""B-rep assembly and export (B-spline fit, trimmed tessellation, STEP, STL)
and point-cloud I/O: the port's own copies of ``brepgen_tpu/geometry``."""

from brepgen_tpu_torch.geometry.brep_build import SolidMesh, construct_brep
from brepgen_tpu_torch.geometry.bspline import fit_bspline_curve, fit_bspline_surface
from brepgen_tpu_torch.geometry.ply import read_ply, write_ply
from brepgen_tpu_torch.geometry.sampling import sample_surface
from brepgen_tpu_torch.geometry.stl import read_stl, write_stl

__all__ = ["SolidMesh", "construct_brep", "fit_bspline_curve", "fit_bspline_surface",
           "read_ply", "read_stl", "sample_surface", "write_ply", "write_stl"]
