from brepgen_tpu_torch.sampling.cascade import Cascade, CascadeConfig, GeneratorNoise, RowNoise
from brepgen_tpu_torch.sampling.dedup import dedup_bboxes, dedup_edges_per_face

__all__ = ["Cascade", "CascadeConfig", "GeneratorNoise", "RowNoise", "dedup_bboxes",
           "dedup_edges_per_face"]
