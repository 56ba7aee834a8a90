"""Host postprocess of cascade samples: topology recovery (numpy) and joint
optimization (torch), as in ``brepgen_tpu/postprocess``."""

from brepgen_tpu_torch.postprocess.edge_merge import detect_shared_edge
from brepgen_tpu_torch.postprocess.joint_opt import joint_optimize
from brepgen_tpu_torch.postprocess.pipeline import (
    RecoveredBrep,
    make_padded_decoder,
    postprocess_single,
)
from brepgen_tpu_torch.postprocess.vertex_merge import PostprocessError, detect_shared_vertex

__all__ = ["PostprocessError", "RecoveredBrep", "detect_shared_edge", "detect_shared_vertex",
           "joint_optimize", "make_padded_decoder", "postprocess_single"]
