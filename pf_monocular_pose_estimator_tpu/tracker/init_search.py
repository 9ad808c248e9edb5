"""Brute-force combinatorial initialisation as one fused batched program.

Functional parity targets:
  * PoseEstimator::initialise voting sweep —
    pf_mpe_lib/src/pose_estimator.cpp:1503-1716: for every 3-combination
    of detections x 3-permutation of markers, run P3P, back-project the
    remaining markers over each of the 4 candidate poses, and vote
    (detection, LED) pairs within `back_projection_pixel_tolerance_`
    into a histogram;
  * correspondence extraction from the histogram —
    correspondencesFromHistogram (:1134-1288) with the ambiguity check
    (:2447-2458).

Fixed-shape redesign: the reference's quadruple nested loop with early
`continue`s becomes a flat (C(K,3) * P(M,3)) batch: every gate (cluster
heuristics :1557-1581, P3P validity, duplicate-solution skip :1661-1665,
finiteness) is a mask, and the histogram is one big masked sum.  The
histogram's data-dependent cartesian product of per-LED candidates becomes
a fixed-radix enumeration over the top-`max_candidates_per_led` detections
per LED.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.camera import Camera, bearing_vectors, project
from ..ops.blob import Detections
from ..solvers import combination_table, p3p_kneip, p3p_object_to_camera, permutation_table
from ..utils.config import TrackerConfig
from ..utils.dynamic import DynamicParams


def brute_force_histogram(
    camera: Camera,
    det: Detections,
    markers_h: jnp.ndarray,
    marker_mask: jnp.ndarray,
    config: TrackerConfig,
    dyn: DynamicParams | None = None,
) -> jnp.ndarray:
    """Vote histogram over (detection, marker) pairs — (K, M) int32."""
    if dyn is None:
        dyn = DynamicParams.from_config(config)
    k_cap = det.xy.shape[0]
    m_cap = markers_h.shape[0]
    combos = jnp.asarray(combination_table(k_cap, 3))  # (C,3)
    perms = jnp.asarray(permutation_table(m_cap, 3))  # (P,3)
    n_c, n_p = combos.shape[0], perms.shape[0]

    bearings = bearing_vectors(camera, det.xy)  # (K,3)
    tol = dyn.back_projection_pixel_tolerance.astype(det.xy.dtype)

    # --- per-combo gates (pose_estimator.cpp:1554-1581) ---
    c_xy = det.xy[combos]  # (C,3,2)
    c_valid = det.mask[combos].all(axis=-1)  # (C,)
    pair_gate_sq = dyn.init_pair_distance_gate**2
    d01 = jnp.sum((c_xy[:, 0] - c_xy[:, 1]) ** 2, -1)
    d02 = jnp.sum((c_xy[:, 0] - c_xy[:, 2]) ** 2, -1)
    d12 = jnp.sum((c_xy[:, 1] - c_xy[:, 2]) ** 2, -1)
    c_valid &= (d01 <= pair_gate_sq) & (d02 <= pair_gate_sq) & (d12 <= pair_gate_sq)
    centre = jnp.mean(c_xy, axis=1)  # (C,2)
    rad_sq = dyn.init_cluster_radius**2
    # cluster membership of every detection wrt every combo centre
    dist_centre = jnp.sum((det.xy[None, :, :] - centre[:, None, :]) ** 2, -1)  # (C,K)
    in_cluster = (dist_centre < rad_sq) & det.mask[None, :]
    c_valid &= jnp.sum(in_cluster, axis=-1) >= config.init_cluster_min

    p_valid = marker_mask[perms].all(axis=-1)  # (P,)

    # --- flat (combo, perm) bank ---
    ci = jnp.repeat(jnp.arange(n_c), n_p)
    pi = jnp.tile(jnp.arange(n_p), n_c)
    f_combos = combos[ci]  # (F,3)
    f_perms = perms[pi]  # (F,3)
    f_valid = c_valid[ci] & p_valid[pi]  # (F,)

    fv = bearings[f_combos]  # (F,3,3) rows
    wp = markers_h[f_perms][..., :3]  # (F,3,3) rows
    sols, p3p_ok = p3p_kneip(fv, wp)  # (F,4,4,4)
    t_oc = p3p_object_to_camera(sols)  # (F,4,4,4)

    # duplicate-solution skip (:1661-1665): sol k == sol k-1 -> skip k
    diff = jnp.max(jnp.abs(sols[:, 1:] - sols[:, :-1]), axis=(-1, -2))  # (F,3)
    not_dup = jnp.concatenate([jnp.ones((sols.shape[0], 1), bool), diff > 0], axis=1)
    finite = jnp.isfinite(t_oc).all(axis=(-1, -2))  # (F,4)
    sol_ok = f_valid[:, None] & p3p_ok[:, None] & not_dup & finite  # (F,4)

    uv = project(camera, t_oc, markers_h)  # (F,4,M,2)
    dist2 = jnp.sum((det.xy[None, None, :, None, :] - uv[:, :, None, :, :]) ** 2, -1)  # (F,4,K,M)

    # row mask: valid detections, in this combo's cluster, not in the combo
    in_combo = (
        jnp.arange(k_cap)[None, :, None] == f_combos[:, None, :]
    ).any(-1)  # (F,K)
    row_ok = in_cluster[ci] & ~in_combo  # (F,K)
    # col mask: valid markers not in this perm
    in_perm = (jnp.arange(m_cap)[None, :, None] == f_perms[:, None, :]).any(-1)  # (F,M)
    col_ok = marker_mask[None, :] & ~in_perm  # (F,M)

    big = jnp.asarray(1e12, dist2.dtype)
    dist2 = jnp.where(col_ok[:, None, None, :], dist2, big)
    nearest = jnp.argmin(dist2, axis=-1)  # (F,4,K) nearest marker per det
    min_d2 = jnp.min(dist2, axis=-1)
    within = (min_d2 <= tol * tol) & row_ok[:, None, :] & sol_ok[..., None]  # (F,4,K)
    any_within = within.any(axis=-1)  # (F,4)

    # votes from NN pairs: one-hot over markers at `nearest`
    nn_votes = (
        (jnp.arange(m_cap)[None, None, None, :] == nearest[..., None]) & within[..., None]
    )  # (F,4,K,M)
    # votes for the 3 chosen (combo, perm) pairs, gated by any_within
    combo_onehot = jnp.arange(k_cap)[None, :, None] == f_combos[:, None, :]  # (F,K,3)
    perm_onehot = jnp.arange(m_cap)[None, :, None] == f_perms[:, None, :]  # (F,M,3)
    chosen = jnp.einsum("fkt,fmt->fkm", combo_onehot, perm_onehot)  # (F,K,M) 0/1
    chosen_votes = chosen[:, None, :, :] * any_within[..., None, None]  # (F,4,K,M)

    hist = jnp.sum(
        nn_votes.astype(jnp.int32) + chosen_votes.astype(jnp.int32), axis=(0, 1)
    )  # (K,M)
    return hist


class CorrespondenceCandidates(NamedTuple):
    """Ranked full-correspondence hypotheses from the vote histogram."""

    det_for_marker: jnp.ndarray  # (R, M) detection index per marker, -1 none
    probability: jnp.ndarray  # (R,) normalised, descending
    valid: jnp.ndarray  # (R,) bool


def correspondences_from_histogram(
    hist: jnp.ndarray,
    det_mask: jnp.ndarray,
    marker_mask: jnp.ndarray,
    config: TrackerConfig,
    initialisation: bool,
) -> CorrespondenceCandidates:
    """Extract ranked correspondence vectors (pose_estimator.cpp:1134-1288).

    hist: (K, M).  Probability model: p(d,m) = h^2 / (colsum * rowsum),
    zeroed below 1.3/(n_det * n_markers); candidates are the fixed-radix
    cartesian product over each marker's top-T detections, scored by the
    product of member probabilities, normalised, and ranked.  During
    initialisation, hypotheses assigning one detection to two markers are
    ambiguous and dropped (:1263-1267, checkAmbiguity :2447-2458).
    """
    k_cap, m_cap = hist.shape
    t_cap = config.max_candidates_per_led
    r_cap = config.max_correspondence_candidates

    h = hist.astype(jnp.float32)
    colsum = jnp.sum(h, axis=0)  # (M,)
    rowsum = jnp.sum(h, axis=1)  # (K,)
    denom = colsum[None, :] * rowsum[:, None]
    prob = jnp.where(denom > 0, h * h / jnp.maximum(denom, 1e-12), 0.0)
    n_det = jnp.maximum(jnp.sum(det_mask.astype(jnp.float32)), 1.0)
    n_mark = jnp.maximum(jnp.sum(marker_mask.astype(jnp.float32)), 1.0)
    prob_threshold = 1.3 / (n_det * n_mark)
    prob = jnp.where(prob >= prob_threshold, prob, 0.0)
    prob = jnp.where(det_mask[:, None] & marker_mask[None, :], prob, 0.0)

    # top-T candidate detections per marker
    top_p, top_i = jax.lax.top_k(prob.T, t_cap)  # (M,T)
    n_cand = jnp.sum(top_p > 0, axis=-1)  # (M,)

    # fixed-radix enumeration of candidate vectors
    n_combo = t_cap**m_cap
    digits = np.stack(
        [
            (np.arange(n_combo) // (t_cap**j)) % t_cap
            for j in range(m_cap)
        ],
        axis=-1,
    ).astype(np.int32)  # (n_combo, M)
    digits = jnp.asarray(digits)

    # canonical: digit_j < max(1, n_cand_j)
    radix = jnp.maximum(n_cand, 1)[None, :]  # (1,M)
    canonical = (digits < radix).all(axis=-1)  # (n_combo,)

    has_cand = (n_cand > 0)[None, :]  # (1,M)
    cand_prob = jnp.take_along_axis(top_p, digits.T, axis=-1).T  # (n_combo, M)
    member_prob = jnp.where(has_cand, cand_prob, 1.0)
    combo_prob = jnp.prod(member_prob, axis=-1) * canonical  # (n_combo,)
    cand_det = jnp.where(has_cand, jnp.take_along_axis(top_i, digits.T, axis=-1).T, -1)

    if initialisation:
        # ambiguity: same detection used by two markers
        same = (cand_det[:, :, None] == cand_det[:, None, :]) & (cand_det[:, :, None] >= 0)
        dup = jnp.triu(same, k=1).any(axis=(-1, -2))
        combo_prob = jnp.where(dup, 0.0, combo_prob)

    total = jnp.sum(combo_prob)
    combo_prob = jnp.where(total > 0, combo_prob / jnp.maximum(total, 1e-12), 0.0)

    top_cp, top_ci = jax.lax.top_k(combo_prob, r_cap)  # (R,)
    det_for_marker = cand_det[top_ci]  # (R, M)
    valid = top_cp > 0
    det_for_marker = jnp.where(valid[:, None], det_for_marker, -1)
    return CorrespondenceCandidates(
        det_for_marker=det_for_marker.astype(jnp.int32),
        probability=top_cp,
        valid=valid,
    )
