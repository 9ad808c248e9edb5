"""Particle weighting — the PF measurement model and the engine's hottest op.

Functional parity target: calculateEstimationProbability
(pf_mpe_lib/src/pose_estimator.cpp:2385-2445), called once per particle per
retry in the reference (the N x M x 80 scalar hot loop of SURVEY.md §3.2).

Semantics reproduced exactly:
  * distances between every detection and every projected marker;
  * greedy global-min matching: repeatedly take the smallest remaining
    distance; stop as soon as it exceeds `tol_pf`;
  * each match adds  M + ((tol_init - d) / tol_init)^2   — note the
    deliberate mix of the PF tolerance (gate) and the init tolerance
    (score), as in the reference (:2414-2416);
  * a matched *marker* (column) is retired; the matched detection stays
    available — re-use costs an escalating self-occlusion penalty
    -3, -6, ... (:2421-2425);
  * a downgraded marker costs -2 (:2431-2432);
  * the implied (marker, detection) pairs are emitted for the GN refiner.

Fixed-shape design: the whole bank is weighted in one program —
projection is a batched einsum, the distance tensor is (N, K, M), and the
greedy loop becomes an unrolled fixed-M sweep of masked argmin reductions
over the bank (M <= ~8, so the unroll is cheap and XLA fuses each sweep).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..geometry.camera import Camera, project


def weight_particles(
    camera: Camera,
    bank: jnp.ndarray,
    markers_h: jnp.ndarray,
    marker_mask: jnp.ndarray,
    det_xy: jnp.ndarray,
    det_mask: jnp.ndarray,
    tol_pf: float,
    tol_init: float,
    downgrade: jnp.ndarray,
    num_markers_score: jnp.ndarray | None = None,
):
    """Weight a particle bank against the frame's detections.

    bank      : (N, 4, 4) object->camera particle poses
    markers_h : (M, 4) homogeneous marker points, marker_mask: (M,)
    det_xy    : (K, 2) undistorted detections, det_mask: (K,)
    downgrade : (M,) bool — bMarkerDowngrade flags (cfg:33-37)

    Returns:
      weights : (N,) float
      pairs   : (N, M, 2) int32 (marker_idx, det_idx), -1 where unused
      n_corr  : (N,) int32 number of matched pairs
    """
    n = bank.shape[0]
    m = markers_h.shape[0]
    dtype = bank.dtype
    big = jnp.asarray(jnp.finfo(dtype).max / 4, dtype)

    if num_markers_score is None:
        num_markers_score = jnp.sum(marker_mask.astype(dtype))

    uv = project(camera, bank, markers_h)  # (N, M, 2)
    diff = det_xy[None, :, None, :] - uv[:, None, :, :]  # (N, K, M, 2)
    dist2 = jnp.sum(diff * diff, axis=-1)  # (N, K, M)
    invalid = (~det_mask)[None, :, None] | (~marker_mask)[None, None, :]
    dist2 = jnp.where(invalid, big, dist2)

    tol_pf = jnp.asarray(tol_pf, dtype)
    tol_init = jnp.asarray(tol_init, dtype)

    weights = jnp.zeros((n,), dtype)
    pairs = jnp.full((n, m, 2), -1, jnp.int32)
    n_corr = jnp.zeros((n,), jnp.int32)
    used_det = jnp.zeros((n, det_xy.shape[0]), jnp.int32)
    n_self_occ = jnp.ones((n,), dtype)
    done = jnp.zeros((n,), bool)

    k_cap = det_xy.shape[0]
    for step in range(m):
        flat = dist2.reshape(n, -1)
        idx = jnp.argmin(flat, axis=-1)  # (N,)
        min_val = jnp.take_along_axis(flat, idx[:, None], axis=-1)[:, 0]
        d = jnp.sqrt(jnp.maximum(min_val, 0.0))
        row = idx // m  # detection index
        col = idx % m  # marker index

        ok = (d <= tol_pf) & ~done
        done = done | ~ok

        score = num_markers_score + ((tol_init - d) / tol_init) ** 2
        reused = jnp.take_along_axis(used_det, row[:, None], axis=-1)[:, 0] > 0
        penal_occ = jnp.where(ok & reused, 3.0 * n_self_occ, 0.0)
        n_self_occ = n_self_occ + (ok & reused).astype(dtype)
        downg = downgrade[col]
        penal_down = jnp.where(ok & downg, 2.0, 0.0)
        weights = weights + jnp.where(ok, score, 0.0) - penal_occ - penal_down

        pair = jnp.stack([col, row], axis=-1).astype(jnp.int32)
        pairs = pairs.at[:, step, :].set(jnp.where(ok[:, None], pair, -1))
        n_corr = n_corr + ok.astype(jnp.int32)

        used_det = used_det + (jnp.arange(k_cap)[None, :] == row[:, None]).astype(jnp.int32) * ok[
            :, None
        ].astype(jnp.int32)
        retire = (jnp.arange(m)[None, None, :] == col[:, None, None]) & ok[:, None, None]
        dist2 = jnp.where(retire, big, dist2)

    return weights, pairs, n_corr
