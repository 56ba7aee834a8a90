"""JSD / MMD-CD / COV-CD evaluation of generated solids (port of
``brepgen_tpu/eval``); the Chamfer matrix goes through kernel K4."""

from brepgen_tpu_torch.eval.metrics import (
    compute_cov_mmd,
    cov_mmd_from_matrix,
    jsd_between_point_cloud_sets,
    normalize_pc,
    pairwise_chamfer,
)

__all__ = ["compute_cov_mmd", "cov_mmd_from_matrix", "jsd_between_point_cloud_sets",
           "normalize_pc", "pairwise_chamfer"]
