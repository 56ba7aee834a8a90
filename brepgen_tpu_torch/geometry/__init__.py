"""B-rep assembly and export (B-spline fit, trimmed tessellation, STEP, STL),
STEP ingestion (reader, conformance validator, analytic and swept
evaluators, extraction) and point-cloud I/O: the port's own copies of
``brepgen_tpu/geometry``."""

from brepgen_tpu_torch.geometry.brep_build import SolidMesh, construct_brep
from brepgen_tpu_torch.geometry.bspline import (
    eval_bspline_curve,
    eval_bspline_surface,
    fit_bspline_curve,
    fit_bspline_surface,
)
from brepgen_tpu_torch.geometry.ply import read_ply, write_ply
from brepgen_tpu_torch.geometry.sampling import sample_surface
from brepgen_tpu_torch.geometry.step_reader import load_brep, parse_step, validate_solid
from brepgen_tpu_torch.geometry.stl import read_stl, write_stl

__all__ = ["SolidMesh", "construct_brep", "eval_bspline_curve", "eval_bspline_surface",
           "fit_bspline_curve", "fit_bspline_surface", "load_brep", "parse_step",
           "read_ply", "read_stl", "sample_surface", "validate_solid", "write_ply",
           "write_stl"]
