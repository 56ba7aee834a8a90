from brepgen_tpu_torch.sampling.cascade import Cascade, CascadeConfig, GeneratorNoise
from brepgen_tpu_torch.sampling.dedup import dedup_bboxes, dedup_edges_per_face

__all__ = ["Cascade", "CascadeConfig", "GeneratorNoise", "dedup_bboxes", "dedup_edges_per_face"]
