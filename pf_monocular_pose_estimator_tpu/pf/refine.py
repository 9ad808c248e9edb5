"""Gauss-Newton pose refinement on SE(3), jittable and batchable.

Functional parity target: PoseEstimator::optimisePose
(pf_mpe_lib/src/pose_estimator.cpp:1805-2009) with the Eade A.14 projection
Jacobian (computeJacobian, :2163-2192), left-multiplicative update
T <- exp(dT) @ T, LDLT normal equations, and covariance (J^T R^-1 J)^-1.

Fixed-shape redesign:
  * fixed iteration budget with a convergence mask instead of `break`
    (data-dependent early exit doesn't exist under jit); converged poses
    simply stop moving, so the result is identical;
  * correspondences arrive as a fixed-size (C, 2) (marker, detection)
    index array with -1 padding — masked residuals replace the
    `continue` at :1847;
  * the divergence guard compares initial vs final *total* error and
    reverts (the reference intended this but its `e_init =+`/`e_end =+`
    typos at :1859-1861 made the guard compare single residuals; we
    implement the intended semantics — documented delta, SURVEY.md §7).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.camera import Camera, project
from ..geometry.se3 import exp_se3


def _inv3(m: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 inverse via the adjugate (batched)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = -(d * i - f * g)
    cc = d * h - e * g
    cd = -(b * i - c * h)
    ce = a * i - c * g
    cf = -(a * h - b * g)
    cg = b * f - c * e
    ch = -(a * f - c * d)
    ci = a * e - b * d
    det = a * ca + b * cb + c * cc
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    adj = jnp.stack(
        [
            jnp.stack([ca, cd, cg], axis=-1),
            jnp.stack([cb, ce, ch], axis=-1),
            jnp.stack([cc, cf, ci], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def _solve6_scaled(a_s: jnp.ndarray, b_s: jnp.ndarray) -> jnp.ndarray:
    """Solve a Jacobi-scaled SPD 6x6 system via 3x3-blocked Schur."""
    p = a_s[..., :3, :3]
    q = a_s[..., :3, 3:]
    s = a_s[..., 3:, 3:]
    p_inv = _inv3(p)
    qt_pinv = jnp.swapaxes(q, -1, -2) @ p_inv
    schur_inv = _inv3(s - qt_pinv @ q)
    b1 = b_s[..., :3, None]
    b2 = b_s[..., 3:, None]
    x2 = schur_inv @ (b2 - qt_pinv @ b1)
    x1 = p_inv @ (b1 - q @ x2)
    return jnp.concatenate([x1, x2], axis=-2)[..., 0]


def solve6_spd(a: jnp.ndarray, b: jnp.ndarray, refine: bool = True) -> jnp.ndarray:
    """Solve the 6x6 SPD normal equations without an LU custom-call.

    ``jnp.linalg.solve`` lowers to LU-factorisation and triangular-solve
    library calls (several dispatches per solve, which XLA cannot fuse);
    unrolled over the GN budget that multiplies per frame.  This
    closed-form path (Jacobi scaling, 3x3-blocked Schur complement
    with adjugate inverses, optional iterative-refinement step) is pure
    elementwise/dot ops that XLA fuses into the surrounding iteration.

    Accuracy: at the estimator's typical conditioning (cond(A) ~ 1e1-1e3)
    forward error is ~1e-6 relative; for near-singular systems it
    degrades like any f32 factorisation (the reference's LDLT in f64,
    pose_estimator.cpp:1872, is shielded by double precision instead —
    GN's step tolerance and divergence guard absorb the difference).
    """
    diag = jnp.sqrt(jnp.abs(jnp.diagonal(a, axis1=-2, axis2=-1)))
    diag = jnp.where(diag > 0, diag, 1.0)
    inv_d = 1.0 / diag
    a_s = a * inv_d[..., :, None] * inv_d[..., None, :]
    b_s = b * inv_d
    x = _solve6_scaled(a_s, b_s)
    if refine:
        r = b_s - (a_s @ x[..., None])[..., 0]
        x = x + _solve6_scaled(a_s, r)
    return x * inv_d


def inv6_spd(a: jnp.ndarray) -> jnp.ndarray:
    """Closed-form SPD 6x6 inverse (same blocked-Schur scheme)."""
    diag = jnp.sqrt(jnp.abs(jnp.diagonal(a, axis1=-2, axis2=-1)))
    diag = jnp.where(diag > 0, diag, 1.0)
    inv_d = 1.0 / diag
    a_s = a * inv_d[..., :, None] * inv_d[..., None, :]
    p = a_s[..., :3, :3]
    q = a_s[..., :3, 3:]
    s = a_s[..., 3:, 3:]
    p_inv = _inv3(p)
    qt_pinv = jnp.swapaxes(q, -1, -2) @ p_inv
    schur_inv = _inv3(s - qt_pinv @ q)
    top_left = p_inv + jnp.swapaxes(qt_pinv, -1, -2) @ schur_inv @ qt_pinv
    top_right = -jnp.swapaxes(qt_pinv, -1, -2) @ schur_inv
    inv_s = jnp.concatenate(
        [
            jnp.concatenate([top_left, top_right], axis=-1),
            jnp.concatenate([jnp.swapaxes(top_right, -1, -2), schur_inv], axis=-1),
        ],
        axis=-2,
    )
    return inv_s * inv_d[..., :, None] * inv_d[..., None, :]


class RefineResult(NamedTuple):
    pose: jnp.ndarray  # (..., 4, 4)
    covariance: jnp.ndarray  # (..., 6, 6)
    num_iterations: jnp.ndarray  # (...,) int32 — first converged iteration
    final_error: jnp.ndarray  # (...,) sum of squared residuals
    initial_error: jnp.ndarray  # (...,)
    converged: jnp.ndarray  # (...,) bool
    max_residual: jnp.ndarray  # (...,) largest per-pair pixel residual


def _residuals_and_normal_eqs(camera, pose, markers_h, det_xy, corr, corr_mask):
    """Masked residuals + normal equations for one pose.

    corr: (C, 2) int32 (marker_idx, det_idx); corr_mask: (C,) bool.
    """
    c = corr.shape[0]
    m_idx = jnp.clip(corr[:, 0], 0, markers_h.shape[0] - 1)
    d_idx = jnp.clip(corr[:, 1], 0, det_xy.shape[0] - 1)
    pts = markers_h[m_idx]  # (C, 4)
    uv_pred = project(camera, pose, pts)  # (C, 2)
    e = det_xy[d_idx] - uv_pred  # (C, 2)
    e = jnp.where(corr_mask[:, None], e, 0.0)
    max_resid = jnp.max(jnp.linalg.norm(e, axis=-1))

    # Eade A.14 Jacobian, twist = [translation, rotation].
    pc = jnp.einsum("ij,cj->ci", pose[:3, :], pts)  # (C, 3) camera-frame
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    z2 = z * z
    fx, fy = camera.fx, camera.fy
    j_u = jnp.stack(
        [fx / z, jnp.zeros_like(z), -fx * x / z2, -fx * x * y / z2, fx * (1 + x * x / z2), -fx * y / z],
        axis=-1,
    )
    j_v = jnp.stack(
        [jnp.zeros_like(z), fy / z, -fy * y / z2, -fy * (1 + y * y / z2), fy * x * y / z2, fy * x / z],
        axis=-1,
    )
    jac = jnp.stack([j_u, j_v], axis=-2)  # (C, 2, 6)
    jac = jnp.where(corr_mask[:, None, None], jac, 0.0)

    a_mat = jnp.einsum("cri,crj->ij", jac, jac)  # (6, 6), R = I
    b_vec = jnp.einsum("cri,cr->i", jac, e)  # (6,)
    err = jnp.sum(e * e)
    return a_mat, b_vec, err, max_resid


def gauss_newton_refine(
    camera: Camera,
    pose0: jnp.ndarray,
    markers_h: jnp.ndarray,
    det_xy: jnp.ndarray,
    corr: jnp.ndarray,
    corr_mask: jnp.ndarray,
    max_iterations: int = 50,
    convergence_tol: float = 1e-4,
) -> RefineResult:
    """Refine a single pose; vmap for banks of candidates.

    The reference's 500-iteration / 1e-13 budget (pose_estimator.cpp:
    1809-1810) is double-precision CPU tuning; in float32 the update
    saturates near 1e-6, so the defaults here are a 50-iteration budget
    with 1e-4 tolerance (~0.1 mm / 0.1 mrad — far below the estimator's
    accuracy floor) and a genuine early-exit while_loop (typical
    convergence: 4-10 iterations).

    Note: under vmap the while_loop runs until every lane converges —
    fine for the small candidate banks this is vmapped over.
    """
    dtype = pose0.dtype
    damping = jnp.asarray(1e-8, dtype)

    def body(carry):
        pose, done, n_iter, _ = carry
        done = done | (n_iter >= max_iterations)  # exact budget under chunking
        a_mat, b_vec, err, _ = _residuals_and_normal_eqs(
            camera, pose, markers_h, det_xy, corr, corr_mask
        )
        a_reg = a_mat + damping * jnp.eye(6, dtype=dtype)
        # no iterative-refinement pass: dt is a step *direction*; GN's
        # convergence tol is 1e-4 and the divergence guard reverts bad
        # steps, so the plain closed-form solve's accuracy suffices —
        # and the hot path runs this body 25 times per hypothesis
        dt = solve6_spd(a_reg, b_vec, refine=False)
        dt = jnp.where(jnp.isfinite(dt), dt, 0.0)
        new_pose = exp_se3(dt) @ pose
        step = jnp.max(jnp.abs(dt))
        now_done = done | (step <= convergence_tol)
        pose = jnp.where(done, pose, new_pose)
        n_iter = n_iter + (~done).astype(jnp.int32)
        return pose, now_done, n_iter, err

    def cond(carry):
        _, done, n_iter, _ = carry
        return (~done) & (n_iter < max_iterations)

    _, _, err0, _ = _residuals_and_normal_eqs(camera, pose0, markers_h, det_xy, corr, corr_mask)
    init = (pose0, jnp.asarray(False), jnp.zeros((), jnp.int32), err0)
    if max_iterations <= 32:
        # small budgets: a fixed-trip-count scan with convergence masking
        # instead of an early-exit while_loop, whose data-dependent
        # predicate would cost a device-to-host check per trip.  The scan
        # stays rolled: fully unrolling its 25 trips at each call site
        # multiplied the step's GPU compile time.
        carry, _ = jax.lax.scan(
            lambda c, _: (body(c), None),
            init,
            None,
            length=max_iterations,
        )
        pose, done, n_iter, _ = carry
    else:
        pose, done, n_iter, _ = jax.lax.while_loop(cond, body, init)

    a_mat, _, err_final, max_resid = _residuals_and_normal_eqs(
        camera, pose, markers_h, det_xy, corr, corr_mask
    )
    # Divergence guard (intended semantics of :1886-1895): revert if worse.
    diverged = err_final > err0
    pose = jnp.where(diverged, pose0, pose)
    err_out = jnp.where(diverged, err0, err_final)
    cov = inv6_spd(a_mat + damping * jnp.eye(6, dtype=dtype))
    return RefineResult(
        pose=pose,
        covariance=cov,
        num_iterations=n_iter,
        final_error=err_out,
        initial_error=err0,
        converged=done,
        max_residual=max_resid,
    )
