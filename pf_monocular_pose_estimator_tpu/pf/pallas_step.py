"""Fused propagate+weight kernel for one PF iteration, Pallas through
Triton (`backend="triton"`).

The PF iteration body (reference: pose_estimator.cpp:543-616 propagate,
:2385-2445 weight) is two bank-scale stages: `pf.soa.propagate_soa`
(ego-motion/prediction compose, uniform SE(3) noise, rotation apply,
candidate pinning) and `pf.soa.weight_particles_soa` (projection and
the M-round greedy marker<->detection matching).  As plain XLA the
matching builds a (K*M, N) distance volume in device memory and reads
and rewrites it once per round.

This kernel gives each program a 1-D block of particles and keeps every
per-particle quantity in registers: it reads the (16, block) bank slice
and the six uniform rows once, composes `L @ T @ R`, applies the noise,
pins the two candidate lanes, projects the markers, runs the greedy
matching — recomputing the K*M distances in each round from the M
projected markers rather than holding them, with the used detections
and available markers as bit masks, so nothing spills and the matching
is two small loops — and writes the propagated bank and the weights.  Lanes are independent and
nothing carries between programs.

Semantics are those of `propagate_soa` + `weight_particles_soa`: the
uniforms are drawn outside the kernel with the same `jax.random`
key discipline and passed in, the minval/maxval affine is jax's
`max(lo, u*(hi-lo)+lo)`, and the argmin scans the distances in the XLA
path's detection-major order (k*M + m, first minimum wins).  Results
agree to float rounding (FMA contraction, division and sin/cos
implementations differ between the compilers); tests/test_pallas_step.py
pins the agreement in interpret mode.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..geometry.camera import Camera
from .propagate import NoiseBounds

_BIG = 3.0e37  # distance sentinel for masked / retired cells (~finfo.max/4)

# Layout of the packed scalar operand (one f32 vector, loaded per scalar).
_SCAL, _LR, _PIN, _PROP = 0, 8, 40, 72
_MARK = 84


def _layout(m_cap: int, k_cap: int):
    det = _MARK + 3 * m_cap
    down = det + 2 * k_cap
    det_ok = down + m_cap
    mark_bits = det_ok + k_cap
    size = 1 << mark_bits.bit_length()
    return det, down, det_ok, mark_bits, size


def _make_kernel(m_cap: int, k_cap: int, block: int, n: int):
    det_off, down_off, det_ok_off, mark_bits_off, _ = _layout(m_cap, k_cap)

    def kernel(par_ref, off_ref, bank_ref, u01_ref, out_ref, w_ref):
        start = pl.program_id(0) * block
        local = start + jnp.arange(block, dtype=jnp.int32)
        valid = local < n
        glane = local + off_ref[0]

        def load_row(ref, i):
            return plgpu.load(
                ref.at[i, pl.ds(start, block)], mask=valid, other=0.0
            )

        def p(i):
            return par_ref[i]

        # --- base = L @ (T @ R), compose_const_right then _left order ---
        t = [load_row(bank_ref, i) for i in range(16)]
        tr = []
        for i in range(4):
            for j in range(4):
                acc = t[i * 4] * p(_LR + 16 + j)
                for k in range(1, 4):
                    acc = acc + t[i * 4 + k] * p(_LR + 16 + k * 4 + j)
                tr.append(acc)
        base = []
        for i in range(4):
            for j in range(4):
                acc = p(_LR + i * 4) * tr[j]
                for k in range(1, 4):
                    acc = acc + p(_LR + i * 4 + k) * tr[k * 4 + j]
                base.append(acc)

        # --- uniform noise: jax.random.uniform's minval/maxval affine ---
        def unif(row):
            lo = p(_PROP + 2 * row)
            hi = p(_PROP + 2 * row + 1)
            return jnp.maximum(lo, load_row(u01_ref, row) * (hi - lo) + lo)

        a, b, c = unif(0), unif(1), unif(2)
        dts = (unif(3), unif(4), unif(5))
        # Rz(c) @ Ry(b) @ Rx(a), pf.soa._rotation_entries order
        ca, sa = jnp.cos(a), jnp.sin(a)
        cb, sb = jnp.cos(b), jnp.sin(b)
        cc, sc = jnp.cos(c), jnp.sin(c)
        rn = (
            cc * cb,
            cc * sb * sa - sc * ca,
            cc * sb * ca + sc * sa,
            sc * cb,
            sc * sb * sa + cc * ca,
            sc * sb * ca - cc * sa,
            -sb,
            cb * sa,
            cb * ca,
        )

        # --- noise rotation on the right, additive translation; pin the
        # global lanes 0/1 to the current/predicted pose ---
        rows = []
        for i in range(4):
            for j in range(4):
                if j == 3:
                    r = base[i * 4 + 3] + dts[i] if i < 3 else base[15]
                elif i == 3:
                    r = base[12 + j]
                else:
                    r = base[i * 4] * rn[j]
                    r = r + base[i * 4 + 1] * rn[3 + j]
                    r = r + base[i * 4 + 2] * rn[6 + j]
                r = jnp.where(glane == 0, p(_PIN + i * 4 + j), r)
                r = jnp.where(glane == 1, p(_PIN + 16 + i * 4 + j), r)
                plgpu.store(out_ref.at[i * 4 + j, pl.ds(start, block)], r, mask=valid)
                rows.append(r)

        # --- weight: projection + greedy matching, pf.soa semantics.  The
        # K*M distances are recomputed in each round from the M projected
        # markers instead of being held, and the used-detection /
        # available-marker sets are bit masks, so a lane's live state is a
        # few dozen registers and the rounds and detections are loops ---
        fx, fy, cx, cy = p(_SCAL), p(_SCAL + 1), p(_SCAL + 2), p(_SCAL + 3)
        tol_pf, tol_init, nms = p(_SCAL + 4), p(_SCAL + 5), p(_SCAL + 6)
        uv = []
        for m in range(m_cap):
            mx, my, mz = (p(_MARK + 3 * m + e) for e in range(3))
            xc = rows[0] * mx + rows[1] * my + rows[2] * mz + rows[3]
            yc = rows[4] * mx + rows[5] * my + rows[6] * mz + rows[7]
            zc = rows[8] * mx + rows[9] * my + rows[10] * mz + rows[11]
            safe_z = jnp.where(jnp.abs(zc) < 1e-12, 1e-12, zc)
            uv.append((fx * xc / safe_z + cx, fy * yc / safe_z + cy))
        zeros_i = jnp.zeros((block,), jnp.int32)
        marker_bits = zeros_i + p(mark_bits_off).astype(jnp.int32)

        def scan_cells(k, carry):
            # argmin over the cells in weight_particles_soa's detection-
            # major order (k*M + m); strict < keeps the first minimum
            minv, k_sel, m_sel, avail = carry
            det_x = par_ref[det_off + 2 * k]
            det_y = par_ref[det_off + 2 * k + 1]
            det_ok = par_ref[det_ok_off + k] > 0.5
            for m in range(m_cap):
                du = det_x - uv[m][0]
                dv = det_y - uv[m][1]
                live = det_ok & (((avail >> m) & 1) != 0)
                v = jnp.where(live, du * du + dv * dv, _BIG)
                better = v < minv
                minv = jnp.where(better, v, minv)
                k_sel = jnp.where(better, k, k_sel)
                m_sel = jnp.where(better, m, m_sel)
            return minv, k_sel, m_sel, avail

        def match_round(_, carry):
            weights, n_self_occ, done, used, avail = carry
            minv, k_sel, m_sel, _ = jax.lax.fori_loop(
                0, k_cap, scan_cells,
                (jnp.full((block,), jnp.inf, jnp.float32), zeros_i, zeros_i, avail),
            )
            d = jnp.sqrt(jnp.maximum(minv, 0.0))
            ok = (d <= tol_pf) & ~done
            done = done | ~ok

            score = nms + ((tol_init - d) / tol_init) ** 2
            occ = ok & (((used >> k_sel) & 1) != 0)
            penal_occ = jnp.where(occ, 3.0 * n_self_occ, 0.0)
            n_self_occ = n_self_occ + occ.astype(jnp.float32)
            dpen = jnp.zeros((block,), jnp.float32)
            for m in range(m_cap):
                dpen = jnp.where(m_sel == m, p(down_off + m), dpen)
            penal_down = jnp.where(ok, dpen, 0.0)
            weights = weights + jnp.where(ok, score, 0.0) - penal_occ - penal_down
            used = used | jnp.where(ok, 1 << k_sel, 0)
            avail = avail & ~jnp.where(ok, 1 << m_sel, 0)  # retire the marker
            return weights, n_self_occ, done, used, avail

        weights, *_ = jax.lax.fori_loop(
            0, m_cap, match_round,
            (
                jnp.zeros((block,), jnp.float32),
                jnp.ones((block,), jnp.float32),
                jnp.zeros((block,), jnp.bool_),
                zeros_i,
                marker_bits,
            ),
        )

        plgpu.store(w_ref.at[pl.ds(start, block)], weights, mask=valid)

    return kernel


@functools.partial(
    jax.jit, static_argnames=("block", "num_warps", "interpret", "n_total")
)
def fused_propagate_weight_pallas(
    key: jax.Array,
    resampled16: jnp.ndarray,
    current_pose: jnp.ndarray,
    predicted_pose: jnp.ndarray,
    prediction_matrix: jnp.ndarray,
    cam_move_inv: jnp.ndarray,
    noise: NoiseBounds,
    fac_trans,
    fac_rot,
    tracking,
    apply_prediction,
    inflation,
    camera: Camera,
    markers_h: jnp.ndarray,
    marker_mask: jnp.ndarray,
    det_xy: jnp.ndarray,
    det_mask: jnp.ndarray,
    tol_pf,
    tol_init,
    downgrade: jnp.ndarray,
    num_markers_score=None,
    block: int = 128,
    num_warps: int = 4,
    interpret: bool = False,
    lane_offset=None,
    n_total: int | None = None,
):
    """Fused `propagate_soa` + `weight_particles_soa`: returns
    (bank16 (16, N), weights (N,)).

    block: particles per program (a power of two); num_warps: Triton
    warps per program.  interpret=True runs the kernel in the Pallas
    interpreter (CPU tests).

    lane_offset / n_total: for running the kernel per shard inside a
    shard_map over the particles mesh axis (parallel/pf_kernels.py).
    `resampled16` is then the shard's (16, N/P) block, `lane_offset` the
    traced global index of its first lane and `n_total` the global bank
    width.  The uniform draws and the lane-0/1 candidate pins are taken
    at global lane indices, so the sharded program draws and pins
    exactly as the unsharded one."""
    assert block > 0 and block & (block - 1) == 0, "block must be a power of two"
    m_cap = markers_h.shape[0]
    k_cap = det_xy.shape[0]
    # the marker and detection sets are int32 bit masks; the marker mask
    # rides in the f32 scalar operand, exact up to 24 bits
    assert m_cap <= 24 and k_cap <= 31, "too many markers or detections"
    n = resampled16.shape[1]
    f32 = jnp.float32
    if n_total is None:
        n_total = n
    off = jnp.zeros((), jnp.int32) if lane_offset is None else jnp.asarray(
        lane_offset, jnp.int32
    )
    if num_markers_score is None:
        num_markers_score = jnp.sum(marker_mask.astype(f32))

    # same key discipline as propagate_soa
    k_rot, k_trans = jax.random.split(key)

    def _u01_rows(k):
        """(3, n) u01 block at global flat positions [r*n_total + off + i]
        — equal to jax.random.uniform(k, (3, n_total))[:, off:off+n] via
        the partitionable threefry counter stream (pf.soa._uniform_at)."""
        if lane_offset is None and n_total == n:
            return jax.random.uniform(k, (3, n), f32)
        from .soa import _uniform_at

        idx = off + jnp.arange(n, dtype=jnp.int32)
        return jnp.stack([_uniform_at(k, r * n_total + idx, n_total) for r in range(3)])

    u01 = jnp.concatenate([_u01_rows(k_rot), _u01_rows(k_trans)], axis=0)

    eye = jnp.eye(4, dtype=f32)
    tracking = jnp.asarray(tracking)
    left = jnp.where(tracking, cam_move_inv.astype(f32), eye)
    right = jnp.where(
        tracking & jnp.asarray(apply_prediction), prediction_matrix.astype(f32), eye
    )
    infl = jnp.asarray(inflation, f32)
    three = jnp.ones((3,), f32)
    # per-axis [lo, hi] pairs, rows 0-2 angular, 3-5 translation — the
    # exact products propagate_soa computes (fac_* may be (3,) or scalar)
    lo = jnp.concatenate([
        jnp.asarray(noise.min_angular, f32) * three * fac_rot * infl,
        jnp.asarray(noise.min_translation, f32) * three * fac_trans * infl,
    ])
    hi = jnp.concatenate([
        jnp.asarray(noise.max_angular, f32) * three * fac_rot * infl,
        jnp.asarray(noise.max_translation, f32) * three * fac_trans * infl,
    ])
    scal = jnp.stack([
        jnp.asarray(v, f32)
        for v in (camera.fx, camera.fy, camera.cx, camera.cy, tol_pf, tol_init,
                  num_markers_score, 0.0)
    ])
    *_, size = _layout(m_cap, k_cap)
    par = jnp.concatenate([
        scal,
        left.reshape(16), right.reshape(16),
        current_pose.astype(f32).reshape(16), predicted_pose.astype(f32).reshape(16),
        jnp.stack([lo, hi], axis=1).reshape(12),
        markers_h[:, :3].astype(f32).reshape(-1),
        det_xy.astype(f32).reshape(-1),
        jnp.where(downgrade, 2.0, 0.0).astype(f32),
        det_mask.astype(f32),
        # the valid markers as one bit mask (exact in f32 for M <= 24)
        jnp.sum(jnp.where(marker_mask, 2 ** jnp.arange(m_cap), 0)).astype(f32)[None],
    ])
    par = jnp.pad(par, (0, size - par.shape[0]))

    bank_out, w = pl.pallas_call(
        _make_kernel(m_cap, k_cap, block, n),
        grid=(pl.cdiv(n, block),),
        out_shape=[
            jax.ShapeDtypeStruct((16, n), f32),
            jax.ShapeDtypeStruct((n,), f32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="pf_propagate_weight",
    )(par, off.reshape(1), resampled16.astype(f32), u01)
    return bank_out, w
