"""Per-sample post-processing driver (STEP 3 of the reference sampler).

Takes one CAD's slice of the cascade outputs and produces the optimized
world-space geometry + recovered topology ready for B-rep assembly
(reference ``sample.py:305-356``):

  endpoints from bboxes -> detect_shared_vertex -> detect_shared_edge ->
  re-decode unique faces/edges through the VAEs -> joint_optimize.

Raises PostprocessError when topology recovery fails (caller counts and
skips, like the reference's try/except-and-continue).

Port of ``brepgen_tpu/postprocess/pipeline.py``: the same driver, with the
face-offset optimization of ``joint_optimize`` on ``device``, and
``make_padded_decoder`` (``brepgen_tpu/cli/sample_main.py:44-56``) to wrap
the port's VAE decoders for the host.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from brepgen_tpu_torch.data.augment import compute_bbox_center_and_size
from brepgen_tpu_torch.postprocess.edge_merge import detect_shared_edge, redundant_faces
from brepgen_tpu_torch.postprocess.joint_opt import joint_optimize
from brepgen_tpu_torch.postprocess.vertex_merge import PostprocessError, detect_shared_vertex


class RecoveredBrep(NamedTuple):
    surf_wcs: np.ndarray           # [F, 32, 32, 3]
    edge_wcs: np.ndarray           # [E, 32, 3]
    face_edge_adj: list            # list[F] of edge id lists
    edge_vertex_adj: np.ndarray    # [E, 2]
    unique_vertices: np.ndarray    # [V, 3]
    # 0 = strict pairing; 1-4 = deepest edge-pairing recovery rung used
    # (edge_merge.py docstring); 5 = loop-closure rescue (vertex_merge.py
    # edge2loop_greedy); only set when recovery was requested
    recovery_rung: int = 0


def edge_endpoints_from_bbox(
    edge_pos: np.ndarray, edge_ncs: np.ndarray, edge_mask: np.ndarray
):
    """Per-face endpoint pairs in world coords (``sample.py:317-329``)."""
    out = []
    for bbox_row, ncs_row, mask_row in zip(edge_pos, edge_ncs, edge_mask):
        epos = bbox_row[~mask_row]
        curves = ncs_row[~mask_row]
        startends = []
        for bb, ee in zip(epos, curves):
            center, size = compute_bbox_center_and_size(bb[0:3], bb[3:])
            wcs = ee * (size / 2) + center
            startends.append(wcs[[0, -1]].reshape(1, 2, 3))
        out.append(np.vstack(startends))
    return out


def postprocess_single(
    sample: Dict[str, np.ndarray],
    batch_idx: int,
    surf_decode: Callable[[np.ndarray], np.ndarray],  # [N,48] -> [N,32,32,3]
    edge_decode: Callable[[np.ndarray], np.ndarray],  # [N,12] -> [N,32,3]
    z_threshold: float = 0.2,
    recovery: bool = False,
    device: str | torch.device = "cuda",
) -> RecoveredBrep:
    """One sample through topology recovery + optimization.

    With ``recovery``, a PostprocessError triggers the bounded retry
    ladder: first the in-place edge-pairing/loop-closure rungs (1-5,
    edge_merge.py / vertex_merge.py), then up to two FACE drops (rung 6):
    when the pairing structure shows whole hallucinated duplicate faces
    (``redundant_faces``), those faces are masked out and the full
    topology recovery re-runs on the reduced sample -- the same shape of
    fix as the reference's bbox face dedup (sample.py:159-183), driven by
    edge-pairing evidence instead of bboxes.
    """
    if not recovery:
        return _postprocess_once(sample, batch_idx, surf_decode, edge_decode,
                                 z_threshold, False, frozenset(), False, device)

    face_drops: set = set()
    allow_singletons = False
    for _ in range(4):  # try + <=2 face-drop retries + singleton last resort
        try:
            rec = _postprocess_once(sample, batch_idx, surf_decode,
                                    edge_decode, z_threshold, True,
                                    frozenset(face_drops), allow_singletons, device)
            if face_drops:
                rec = rec._replace(recovery_rung=6)
            return rec
        except PostprocessError as e:
            info = getattr(e, "pairing_info", None)
            if not info or "vsets" not in info:
                raise
            new = []
            if not allow_singletons:
                new = redundant_faces(info["vsets"], info["ranges"],
                                      max_faces=2 - len(face_drops))
            if not new:
                if allow_singletons:
                    raise
                allow_singletons = True  # keep unpairables single-adjacency
                continue
            # map valid-face-space indices back to absolute face slots
            valid_idx = np.where(~np.asarray(sample["surf_mask"][batch_idx])
                                 & ~np.isin(
                                     np.arange(len(sample["surf_mask"][batch_idx])),
                                     list(face_drops)))[0]
            face_drops.update(int(valid_idx[f]) for f in new)
    raise PostprocessError("face-drop retries exhausted")


def _postprocess_once(
    sample: Dict[str, np.ndarray],
    batch_idx: int,
    surf_decode: Callable[[np.ndarray], np.ndarray],
    edge_decode: Callable[[np.ndarray], np.ndarray],
    z_threshold: float,
    recovery: bool,
    face_drops: frozenset,
    allow_singletons: bool,
    device: str | torch.device,
) -> RecoveredBrep:
    surf_mask = np.asarray(sample["surf_mask"][batch_idx])
    valid = ~surf_mask
    if face_drops:
        valid = valid.copy()
        valid[list(face_drops)] = False

    edge_mask_cad = np.asarray(sample["edge_mask"][batch_idx])[valid]
    edge_pos_cad = np.asarray(sample["edge_pos"][batch_idx])[valid]
    edge_ncs_cad = np.asarray(sample["edge_ncs"][batch_idx])[valid]
    edgeV_cad = np.asarray(sample["edge_v"][batch_idx])[valid]
    edge_z_cad = np.asarray(sample["edge_z"][batch_idx])[valid][~edge_mask_cad]
    surf_z_cad = np.asarray(sample["surf_z"][batch_idx])[valid]
    surf_pos_cad = np.asarray(sample["surf_pos"][batch_idx])[valid]

    edgeV_bbox = edge_endpoints_from_bbox(edge_pos_cad, edge_ncs_cad, edge_mask_cad)

    info: dict = {}
    try:
        unique_vertices, new_vertex_dict = detect_shared_vertex(
            edgeV_cad, edge_mask_cad, edgeV_bbox, recovery=recovery, info=info
        )
        unique_faces_z, unique_edges_z, face_edge_adj, edge_vertex_adj = detect_shared_edge(
            unique_vertices, new_vertex_dict, edge_z_cad, surf_z_cad,
            z_threshold, edge_mask_cad, recovery=recovery, info=info,
            allow_singletons=allow_singletons,
        )
    except PostprocessError as e:
        e.pairing_info = info  # lets the face-drop retry read the structure
        raise

    surf_ncs = np.asarray(surf_decode(unique_faces_z))
    edge_ncs = np.asarray(edge_decode(unique_edges_z))

    surf_wcs, edge_wcs = joint_optimize(
        surf_ncs, edge_ncs, surf_pos_cad, unique_vertices,
        edge_vertex_adj, face_edge_adj, len(edge_ncs), len(surf_ncs), device,
    )
    rung = info.get("recovery_rung", 0)
    if info.get("vertex_rescued_faces", 0) or info.get(
            "chained_proximity_merges", 0):
        rung = max(rung, 5)  # vertex-stage rescue (vertex_merge.py rung 5)
    return RecoveredBrep(surf_wcs, edge_wcs, face_edge_adj, edge_vertex_adj,
                         unique_vertices, rung)


def make_padded_decoder(decode: Callable[[torch.Tensor], torch.Tensor],
                        item_shape: Tuple[int, ...],
                        device: str | torch.device) -> Callable[[np.ndarray], np.ndarray]:
    """Host decode of a variable number N of latents: pad N to a power of two
    (as the JAX CLI does, so few distinct shapes reach the convolutions),
    decode on ``device`` and return the first N as numpy."""

    @torch.no_grad()
    def decode_np(z: np.ndarray) -> np.ndarray:
        n = len(z)
        n_pad = 1 << max(n - 1, 1).bit_length()
        z_pad = np.zeros((n_pad,) + z.shape[1:], np.float32)
        z_pad[:n] = z
        zt = torch.from_numpy(z_pad).to(device).reshape((n_pad,) + item_shape)
        return decode(zt).cpu().numpy()[:n]

    return decode_np
