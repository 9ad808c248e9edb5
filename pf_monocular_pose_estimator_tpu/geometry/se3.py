"""SE(3) calculus as branch-free, batched JAX ops.

Functional parity targets (behaviour, not code) in the reference engine:
  * exponential map  — pf_mpe_lib/src/pose_estimator.cpp:2194-2226
  * logarithm map    — pf_mpe_lib/src/pose_estimator.cpp:2228-2296
  * skew matrix      — pf_mpe_lib/src/pose_estimator.cpp:2298-2303
  * constant-velocity prediction — pose_estimator.cpp:995-1010

Design notes (fixed-shape, batched):
  * All ops broadcast over arbitrary leading batch dimensions so a particle
    bank of shape (N, 4, 4) is first-class.
  * Branches of the reference (theta == 0 special cases) become
    `jnp.where` selects with Taylor-series fallbacks, keeping everything
    differentiable and jit/vmap-safe with static shapes.

Twist layout follows the reference: xi = [upsilon (3,), omega (3,)].
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def skew(w: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    rows = [
        jnp.stack([zeros, -wz, wy], axis=-1),
        jnp.stack([wz, zeros, -wx], axis=-1),
        jnp.stack([-wy, wx, zeros], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def _sinc_terms(theta_sq: jnp.ndarray):
    """Return (A, B, C) = sin t/t, (1-cos t)/t^2, (t - sin t)/t^3, Taylor-safe.

    theta_sq has any shape; outputs broadcast with it.
    """
    theta = jnp.sqrt(jnp.maximum(theta_sq, 0.0))
    small = theta_sq < _EPS
    # Taylor expansions around 0.
    a_small = 1.0 - theta_sq / 6.0
    b_small = 0.5 - theta_sq / 24.0
    c_small = 1.0 / 6.0 - theta_sq / 120.0
    safe_theta = jnp.where(small, 1.0, theta)
    a = jnp.where(small, a_small, jnp.sin(safe_theta) / safe_theta)
    b = jnp.where(small, b_small, (1.0 - jnp.cos(safe_theta)) / jnp.maximum(theta_sq, _EPS))
    c = jnp.where(
        small, c_small, (safe_theta - jnp.sin(safe_theta)) / jnp.maximum(theta_sq * safe_theta, _EPS)
    )
    return a, b, c


def exp_se3(twist: jnp.ndarray) -> jnp.ndarray:
    """Exponential map, (..., 6) twist -> (..., 4, 4) homogeneous transform.

    Matches the reference Rodrigues + V-matrix form
    (pose_estimator.cpp:2194-2226) with Taylor-safe small-angle handling.
    """
    ups = twist[..., :3]
    omega = twist[..., 3:]
    theta_sq = jnp.sum(omega * omega, axis=-1)[..., None, None]
    om = skew(omega)
    om2 = om @ om
    a, b, c = _sinc_terms(theta_sq)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=twist.dtype), om.shape)
    rot = eye + a * om + b * om2
    v_mat = eye + b * om + c * om2
    t = (v_mat @ ups[..., None])[..., 0]
    top = jnp.concatenate([rot, t[..., None]], axis=-1)  # (...,3,4)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def log_se3(transform: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map, (..., 4, 4) -> (..., 6) twist = [upsilon, omega].

    Mirrors pose_estimator.cpp:2228-2296 (acos-trace rotation log + closed
    form A^{-1} translation), expressed branch-free.
    """
    rot = transform[..., :3, :3]
    t = transform[..., :3, 3]
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_phi = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    phi = jnp.arccos(cos_phi)
    sin_phi = jnp.sin(phi)
    small = jnp.abs(sin_phi) < _EPS
    # w_hat = (R - R^T) * phi / (2 sin phi); for phi ~ 0 use 0.5*(R - R^T)
    scale = jnp.where(small, 0.5, phi / jnp.maximum(2.0 * sin_phi, _EPS))
    w_hat = (rot - jnp.swapaxes(rot, -1, -2)) * scale[..., None, None]
    w = jnp.stack([w_hat[..., 2, 1], w_hat[..., 0, 2], w_hat[..., 1, 0]], axis=-1)

    w_sq = jnp.sum(w * w, axis=-1)[..., None, None]
    w_norm = jnp.sqrt(jnp.maximum(w_sq, 0.0))
    sin_w = jnp.sin(w_norm)
    small_w = (w_sq < _EPS) | (jnp.abs(sin_w) < _EPS)
    # A_inv = I - w_hat/2 + coef * w_hat^2
    # coef = (2 sin|w| - |w| (1 + cos|w|)) / (2 w^2 sin|w|); Taylor: 1/12.
    denom = 2.0 * w_sq * sin_w
    coef = jnp.where(
        small_w,
        1.0 / 12.0,
        (2.0 * sin_w - w_norm * (1.0 + jnp.cos(w_norm))) / jnp.where(small_w, 1.0, denom),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=transform.dtype), rot.shape)
    a_inv = eye - 0.5 * w_hat + coef * (w_hat @ w_hat)
    ups = (a_inv @ t[..., None])[..., 0]
    return jnp.concatenate([ups, w], axis=-1)


def inverse(transform: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    rot = transform[..., :3, :3]
    t = transform[..., :3, 3]
    rot_t = jnp.swapaxes(rot, -1, -2)
    t_new = -(rot_t @ t[..., None])[..., 0]
    top = jnp.concatenate([rot_t, t_new[..., None]], axis=-1)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def compose(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Matrix product with broadcasting over leading dims."""
    return a @ b


def rotation_rpy(angles: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) [a, b, c] -> Rz(c) @ Ry(b) @ Rx(a) as a (..., 4, 4) transform.

    This is the composition order of the particle-propagation noise in the
    reference PF (pose_estimator.cpp:567-582: pose * rotZ * rotY * rotX).
    """
    a, b, c = angles[..., 0], angles[..., 1], angles[..., 2]
    ca, sa = jnp.cos(a), jnp.sin(a)
    cb, sb = jnp.cos(b), jnp.sin(b)
    cc, sc = jnp.cos(c), jnp.sin(c)
    # R = Rz(c) Ry(b) Rx(a)
    r00 = cc * cb
    r01 = cc * sb * sa - sc * ca
    r02 = cc * sb * ca + sc * sa
    r10 = sc * cb
    r11 = sc * sb * sa + cc * ca
    r12 = sc * sb * ca - cc * sa
    r20 = -sb
    r21 = cb * sa
    r22 = cb * ca
    zeros = jnp.zeros_like(a)
    ones = jnp.ones_like(a)
    rows = [
        jnp.stack([r00, r01, r02, zeros], axis=-1),
        jnp.stack([r10, r11, r12, zeros], axis=-1),
        jnp.stack([r20, r21, r22, zeros], axis=-1),
        jnp.stack([zeros, zeros, zeros, ones], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def predict_constant_velocity(
    previous_pose: jnp.ndarray,
    current_pose: jnp.ndarray,
    dt_past: jnp.ndarray,
    dt_future: jnp.ndarray,
) -> jnp.ndarray:
    """Constant-velocity prediction matrix (pose_estimator.cpp:995-1010).

    Returns the right-multiplicative prediction increment `P` such that
    predicted = current_pose @ P, where P = exp(log(prev^-1 @ cur) *
    dt_future / dt_past).
    """
    delta = log_se3(inverse(previous_pose) @ current_pose)
    safe_dt = jnp.where(jnp.abs(dt_past) < 1e-9, 1.0, dt_past)
    ratio = jnp.where(jnp.abs(dt_past) < 1e-9, 0.0, dt_future / safe_dt)
    return exp_se3(delta * ratio)
