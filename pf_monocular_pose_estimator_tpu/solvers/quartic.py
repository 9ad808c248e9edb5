"""Closed-form quartic roots (Ferrari), batched and branch-free.

Functional parity target: P3P::solveQuartic (pf_mpe_lib/src/p3p.cpp:238-292)
— complex Ferrari resolvent, real parts of the four roots returned.

Design notes: the whole resolvent is elementwise complex arithmetic, so a
bank of B quartics solves as (B,) complex vectors — no per-root loop.
Complex dtype follows the input dtype (float32 -> complex64).
"""

from __future__ import annotations

import jax.numpy as jnp


def solve_quartic(coeffs: jnp.ndarray) -> jnp.ndarray:
    """Roots of A x^4 + B x^3 + C x^2 + D x + E.

    coeffs: (..., 5) real [A, B, C, D, E];  returns (..., 4) real parts of
    the roots (imaginary parts discarded, as the consumer gates solutions
    by reprojection checks downstream — same contract as the reference).
    """
    a = coeffs[..., 0]
    b = coeffs[..., 1]
    c = coeffs[..., 2]
    d = coeffs[..., 3]
    e = coeffs[..., 4]

    safe_a = jnp.where(jnp.abs(a) < 1e-30, 1e-30, a)
    a2 = safe_a * safe_a
    a3 = a2 * safe_a
    a4 = a3 * safe_a
    b2 = b * b
    b3 = b2 * b
    b4 = b3 * b

    alpha = -3.0 * b2 / (8.0 * a2) + c / safe_a
    beta = b3 / (8.0 * a3) - b * c / (2.0 * a2) + d / safe_a
    gamma = -3.0 * b4 / (256.0 * a4) + b2 * c / (16.0 * a3) - b * d / (4.0 * a2) + e / safe_a

    cdtype = jnp.complex64 if coeffs.dtype == jnp.float32 else jnp.complex128
    alpha_c = alpha.astype(cdtype)
    beta_c = beta.astype(cdtype)

    p = (-alpha * alpha / 12.0 - gamma).astype(cdtype)
    q = (-alpha * alpha * alpha / 108.0 + alpha * gamma / 3.0 - beta * beta / 8.0).astype(cdtype)
    r = -q / 2.0 + jnp.sqrt(q * q / 4.0 + p * p * p / 27.0)
    u = r ** (1.0 / 3.0)

    u_zero = jnp.abs(u) < 1e-30
    safe_u = jnp.where(u_zero, 1.0, u)
    y = jnp.where(
        u_zero,
        -5.0 * alpha_c / 6.0 - q ** (1.0 / 3.0),
        -5.0 * alpha_c / 6.0 - p / (3.0 * safe_u) + u,
    )

    w = jnp.sqrt(alpha_c + 2.0 * y)
    safe_w = jnp.where(jnp.abs(w) < 1e-30, 1e-30, w)
    shift = (-b / (4.0 * safe_a)).astype(cdtype)
    s_plus = jnp.sqrt(-(3.0 * alpha_c + 2.0 * y + 2.0 * beta_c / safe_w))
    s_minus = jnp.sqrt(-(3.0 * alpha_c + 2.0 * y - 2.0 * beta_c / safe_w))

    roots = jnp.stack(
        [
            shift + 0.5 * (w + s_plus),
            shift + 0.5 * (w - s_plus),
            shift + 0.5 * (-w + s_minus),
            shift + 0.5 * (-w - s_minus),
        ],
        axis=-1,
    )
    return jnp.real(roots).astype(coeffs.dtype)
