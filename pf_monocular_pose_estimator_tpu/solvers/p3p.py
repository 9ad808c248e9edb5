"""Kneip (2011) perspective-3-point, batched and branch-free.

Functional parity target: P3P::computePoses (pf_mpe_lib/src/p3p.cpp:65-236).

Batched design: the reference solves one triple at a time with early
returns; here a whole bank of B triples is solved as fixed-shape array math
(the `f3_z > 0` frame swap becomes a `where`-select; the collinearity early
-return becomes a validity mask), so the combinatorial initialiser can
evaluate C(n,3) x P(m,3) triples in a single fused XLA program.
"""

from __future__ import annotations

import jax.numpy as jnp

from .quartic import solve_quartic


def _normalize(v: jnp.ndarray) -> jnp.ndarray:
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def p3p_kneip(feature_vectors: jnp.ndarray, world_points: jnp.ndarray):
    """Solve P3P for a bank of correspondence triples.

    feature_vectors: (..., 3, 3) rows [f1, f2, f3] — unit bearing rays.
    world_points:    (..., 3, 3) rows [P1, P2, P3] — object-frame points.

    Returns:
      solutions: (..., 4, 4, 4) four candidate camera poses in the world
                 frame (R_wc | C; camera->world, Kneip's output convention,
                 matching the reference's `solutions`).
      valid:     (...,) bool — False where world points are collinear
                 (reference returns -1 there, p3p.cpp:77-80).
    """
    p1 = world_points[..., 0, :]
    p2 = world_points[..., 1, :]
    p3 = world_points[..., 2, :]

    cross = jnp.cross(p2 - p1, p3 - p1)
    valid = jnp.linalg.norm(cross, axis=-1) > 1e-12

    f1 = feature_vectors[..., 0, :]
    f2 = feature_vectors[..., 1, :]
    f3 = feature_vectors[..., 2, :]

    def cam_frame(f1, f2):
        e1 = f1
        e3 = _normalize(jnp.cross(f1, f2))
        e2 = jnp.cross(e3, e1)
        return jnp.stack([e1, e2, e3], axis=-2)  # rows

    t_first = cam_frame(f1, f2)
    f3_t = jnp.einsum("...ij,...j->...i", t_first, f3)
    swap = f3_t[..., 2] > 0  # reinforce theta in [0, pi]

    f1s = jnp.where(swap[..., None], f2, f1)
    f2s = jnp.where(swap[..., None], f1, f2)
    p1s = jnp.where(swap[..., None], p2, p1)
    p2s = jnp.where(swap[..., None], p1, p2)

    t_mat = cam_frame(f1s, f2s)
    f3_t = jnp.einsum("...ij,...j->...i", t_mat, f3)

    n1 = _normalize(p2s - p1s)
    n3 = _normalize(jnp.cross(n1, p3 - p1s))
    n2 = jnp.cross(n3, n1)
    n_mat = jnp.stack([n1, n2, n3], axis=-2)  # rows

    p3_n = jnp.einsum("...ij,...j->...i", n_mat, p3 - p1s)
    d_12 = jnp.linalg.norm(p2s - p1s, axis=-1)
    f3z = jnp.where(jnp.abs(f3_t[..., 2]) < 1e-12, 1e-12, f3_t[..., 2])
    f_1 = f3_t[..., 0] / f3z
    f_2 = f3_t[..., 1] / f3z
    pp_1 = p3_n[..., 0]
    pp_2 = p3_n[..., 1]

    cos_beta = jnp.sum(f1s * f2s, axis=-1)
    b_sq = 1.0 / jnp.maximum(1.0 - cos_beta * cos_beta, 1e-12) - 1.0
    b = jnp.sign(cos_beta) * jnp.sqrt(jnp.maximum(b_sq, 0.0))

    f1p2 = f_1 * f_1
    f2p2 = f_2 * f_2
    p1p2 = pp_1 * pp_1
    p1p3 = p1p2 * pp_1
    p1p4 = p1p3 * pp_1
    p2p2 = pp_2 * pp_2
    p2p3 = p2p2 * pp_2
    p2p4 = p2p3 * pp_2
    d12p2 = d_12 * d_12
    bp2 = b * b

    c0 = -f2p2 * p2p4 - p2p4 * f1p2 - p2p4
    c1 = 2.0 * p2p3 * d_12 * b + 2.0 * f2p2 * p2p3 * d_12 * b - 2.0 * f_2 * p2p3 * f_1 * d_12
    c2 = (
        -f2p2 * p2p2 * p1p2
        - f2p2 * p2p2 * d12p2 * bp2
        - f2p2 * p2p2 * d12p2
        + f2p2 * p2p4
        + p2p4 * f1p2
        + 2.0 * pp_1 * p2p2 * d_12
        + 2.0 * f_1 * f_2 * pp_1 * p2p2 * d_12 * b
        - p2p2 * p1p2 * f1p2
        + 2.0 * pp_1 * p2p2 * f2p2 * d_12
        - p2p2 * d12p2 * bp2
        - 2.0 * p1p2 * p2p2
    )
    c3 = (
        2.0 * p1p2 * pp_2 * d_12 * b
        + 2.0 * f_2 * p2p3 * f_1 * d_12
        - 2.0 * f2p2 * p2p3 * d_12 * b
        - 2.0 * pp_1 * pp_2 * d12p2 * b
    )
    c4 = (
        -2.0 * f_2 * p2p2 * f_1 * pp_1 * d_12 * b
        + f2p2 * p2p2 * d12p2
        + 2.0 * p1p3 * d_12
        - p1p2 * d12p2
        + f2p2 * p2p2 * p1p2
        - p1p4
        - 2.0 * f2p2 * p2p2 * pp_1 * d_12
        + p2p2 * f1p2 * p1p2
        + f2p2 * p2p2 * d12p2 * bp2
    )

    coeffs = jnp.stack([c0, c1, c2, c3, c4], axis=-1)
    cos_theta = solve_quartic(coeffs)  # (..., 4)

    # Back-substitution for all 4 roots at once (vectorised over root axis).
    f_1r = f_1[..., None]
    f_2r = f_2[..., None]
    p_1r = pp_1[..., None]
    p_2r = pp_2[..., None]
    d12r = d_12[..., None]
    br = b[..., None]

    denom = -f_1r * cos_theta * p_2r / f_2r + p_1r - d12r
    denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    cot_alpha = (-f_1r * p_1r / f_2r - cos_theta * p_2r + d12r * br) / denom

    cos_theta_c = jnp.clip(cos_theta, -1.0, 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta_c * cos_theta_c, 0.0))
    sin_alpha = jnp.sqrt(1.0 / (cot_alpha * cot_alpha + 1.0))
    cos_alpha = jnp.sqrt(jnp.maximum(1.0 - sin_alpha * sin_alpha, 0.0))
    cos_alpha = jnp.where(cot_alpha < 0, -cos_alpha, cos_alpha)

    scale = sin_alpha * br + cos_alpha
    c_int = jnp.stack(
        [
            d12r * cos_alpha * scale,
            cos_theta_c * d12r * sin_alpha * scale,
            sin_theta * d12r * sin_alpha * scale,
        ],
        axis=-1,
    )  # (..., 4roots, 3)
    n_t = jnp.swapaxes(n_mat, -1, -2)
    centers = p1s[..., None, :] + jnp.einsum("...ij,...rj->...ri", n_t, c_int)

    zeros = jnp.zeros_like(cos_alpha)
    r_int = jnp.stack(
        [
            jnp.stack([-cos_alpha, -sin_alpha * cos_theta_c, -sin_alpha * sin_theta], axis=-1),
            jnp.stack([sin_alpha, -cos_alpha * cos_theta_c, -cos_alpha * sin_theta], axis=-1),
            jnp.stack([zeros, -sin_theta, cos_theta_c], axis=-1),
        ],
        axis=-2,
    )  # (..., 4roots, 3, 3)
    # R = N^T R_int^T T
    rot = jnp.einsum(
        "...ij,...rkj,...kl->...ril", n_t, r_int, t_mat
    )  # N^T @ R_int^T @ T per root

    top = jnp.concatenate([rot, centers[..., :, None]], axis=-1)  # (...,4,3,4)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    solutions = jnp.concatenate([top, bottom], axis=-2)  # (...,4,4,4)
    return solutions, valid


def p3p_object_to_camera(solutions: jnp.ndarray) -> jnp.ndarray:
    """Invert Kneip camera-in-world solutions to object->camera transforms.

    The reference always consumes `solution.inverse()` for projection
    (pose_estimator.cpp:1404,1435,1677); this closed-form inverse avoids a
    general 4x4 solve on the bank.
    """
    rot = solutions[..., :3, :3]
    c = solutions[..., :3, 3]
    rot_t = jnp.swapaxes(rot, -1, -2)
    t = -(rot_t @ c[..., None])[..., 0]
    top = jnp.concatenate([rot_t, t[..., None]], axis=-1)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)
