"""Structure-of-arrays (SoA) particle programs — the plain XLA hot path.

Why: the bank is stored as (16, N) — sixteen row-major pose entries,
particles along the minor axis — so every elementwise op, 4x4 compose,
projection and distance sweep is a contiguous, fully-vectorised op over
N particles, with no strided (N, 4, 4) minor dimensions.  These functions
are the reference implementation the fused kernel (pf/pallas_step.py) is
checked against.

Semantics are identical to the AoS kernels in propagate.py / weight.py
(which mirror pose_estimator.cpp:543-616 and :2385-2445); equivalence is
pinned by tests/test_soa.py.  Layout convention:

  bank16[i*4+j, n] == bank[n, i, j]          ("flat16" pose entries)
  pairs_soa[m, 0, n] = marker idx, pairs_soa[m, 1, n] = detection idx
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry.camera import Camera
from .propagate import NoiseBounds


def pack(bank: jnp.ndarray) -> jnp.ndarray:
    """(N, 4, 4) -> (16, N)."""
    n = bank.shape[0]
    return bank.reshape(n, 16).T


def unpack(bank16: jnp.ndarray) -> jnp.ndarray:
    """(16, N) -> (N, 4, 4)."""
    return bank16.T.reshape(-1, 4, 4)


def pack_single(pose: jnp.ndarray) -> jnp.ndarray:
    """(4, 4) -> (16,)."""
    return pose.reshape(16)


def identity_bank16(n: int, dtype=jnp.float32) -> jnp.ndarray:
    """(16, N) bank of identity poses."""
    return jnp.tile(jnp.eye(4, dtype=dtype).reshape(16, 1), (1, n))


def compose_const_left(a: jnp.ndarray, b16: jnp.ndarray) -> jnp.ndarray:
    """A @ B for constant A (4,4) and bank B (16,N)."""
    rows = []
    for i in range(4):
        for j in range(4):
            acc = a[i, 0] * b16[0 * 4 + j]
            for k in range(1, 4):
                acc = acc + a[i, k] * b16[k * 4 + j]
            rows.append(acc)
    return jnp.stack(rows)


def compose_const_right(a16: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """A @ B for bank A (16,N) and constant B (4,4)."""
    rows = []
    for i in range(4):
        for j in range(4):
            acc = a16[i * 4 + 0] * b[0, j]
            for k in range(1, 4):
                acc = acc + a16[i * 4 + k] * b[k, j]
            rows.append(acc)
    return jnp.stack(rows)


def _rotation_entries(angles):
    """(3, N) [a, b, c] -> 9 (N,) entries of Rz(c) @ Ry(b) @ Rx(a)
    (the reference's noise composition order, pose_estimator.cpp:567-582)."""
    a, b, c = angles[0], angles[1], angles[2]
    ca, sa = jnp.cos(a), jnp.sin(a)
    cb, sb = jnp.cos(b), jnp.sin(b)
    cc, sc = jnp.cos(c), jnp.sin(c)
    return (
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


def propagate_soa(
    key: jax.Array,
    resampled16: jnp.ndarray,
    current_pose: jnp.ndarray,
    predicted_pose: jnp.ndarray,
    prediction_matrix: jnp.ndarray,
    cam_move_inv: jnp.ndarray,
    noise: NoiseBounds,
    fac_trans: jnp.ndarray,
    fac_rot: jnp.ndarray,
    tracking: jnp.ndarray,
    apply_prediction: jnp.ndarray,
    inflation: jnp.ndarray,
) -> jnp.ndarray:
    """SoA twin of pf.propagate.propagate; resampled16: (16, N)."""
    n = resampled16.shape[1]
    dtype = resampled16.dtype
    k_rot, k_trans = jax.random.split(key)

    base_pred = compose_const_left(
        cam_move_inv, compose_const_right(resampled16, prediction_matrix)
    )
    base_nopred = compose_const_left(cam_move_inv, resampled16)
    base = jnp.where(
        tracking,
        jnp.where(apply_prediction, base_pred, base_nopred),
        resampled16,
    )

    lo_a = jnp.asarray([noise.min_angular] * 3, dtype) * fac_rot * inflation
    hi_a = jnp.asarray([noise.max_angular] * 3, dtype) * fac_rot * inflation
    angles = jax.random.uniform(k_rot, (3, n), dtype, lo_a[:, None], hi_a[:, None])
    lo_t = jnp.asarray([noise.min_translation] * 3, dtype) * fac_trans * inflation
    hi_t = jnp.asarray([noise.max_translation] * 3, dtype) * fac_trans * inflation
    dts = jax.random.uniform(k_trans, (3, n), dtype, lo_t[:, None], hi_t[:, None])

    rn = _rotation_entries(angles)  # 9 x (N,)
    out_rows = []
    for i in range(4):
        for j in range(4):
            if j == 3:
                # translation column: base translation + additive noise
                # (reference overwrites it, :585-587)
                if i < 3:
                    out_rows.append(base[i * 4 + 3] + dts[i])
                else:
                    out_rows.append(base[15])
            elif i == 3:
                out_rows.append(base[12 + j])
            else:
                acc = base[i * 4 + 0] * rn[0 * 3 + j]
                acc = acc + base[i * 4 + 1] * rn[1 * 3 + j]
                acc = acc + base[i * 4 + 2] * rn[2 * 3 + j]
                out_rows.append(acc)
    bank16 = jnp.stack(out_rows)

    cur16 = pack_single(current_pose)
    pred16 = pack_single(predicted_pose)
    bank16 = bank16.at[:, 0].set(cur16).at[:, 1].set(pred16)
    return bank16


def project_soa(camera: Camera, bank16: jnp.ndarray, markers_h: jnp.ndarray):
    """Project M markers for all N particles -> (M, 2, N) pixel coords."""
    m = markers_h.shape[0]
    x = markers_h[:, 0][:, None]  # (M,1)
    y = markers_h[:, 1][:, None]
    z = markers_h[:, 2][:, None]
    # camera-frame coordinates, (M, N) each
    xc = bank16[0][None] * x + bank16[1][None] * y + bank16[2][None] * z + bank16[3][None]
    yc = bank16[4][None] * x + bank16[5][None] * y + bank16[6][None] * z + bank16[7][None]
    zc = bank16[8][None] * x + bank16[9][None] * y + bank16[10][None] * z + bank16[11][None]
    safe_z = jnp.where(jnp.abs(zc) < 1e-12, 1e-12, zc)
    u = camera.fx * xc / safe_z + camera.cx
    v = camera.fy * yc / safe_z + camera.cy
    return jnp.stack([u, v], axis=1)  # (M, 2, N)


def weight_particles_soa(
    camera: Camera,
    bank16: jnp.ndarray,
    markers_h: jnp.ndarray,
    marker_mask: jnp.ndarray,
    det_xy: jnp.ndarray,
    det_mask: jnp.ndarray,
    tol_pf: float,
    tol_init: float,
    downgrade: jnp.ndarray,
    num_markers_score: jnp.ndarray | None = None,
):
    """SoA twin of pf.weight.weight_particles.

    Returns (weights (N,), pairs_soa (M, 2, N) int32, n_corr (N,)).
    """
    m = markers_h.shape[0]
    k_cap = det_xy.shape[0]
    n = bank16.shape[1]
    dtype = bank16.dtype
    big = jnp.asarray(jnp.finfo(dtype).max / 4, dtype)

    if num_markers_score is None:
        num_markers_score = jnp.sum(marker_mask.astype(dtype))

    uv = project_soa(camera, bank16, markers_h)  # (M, 2, N)
    du = det_xy[:, 0][:, None, None] - uv[None, :, 0, :]  # (K, M, N)
    dv = det_xy[:, 1][:, None, None] - uv[None, :, 1, :]
    dist2 = du * du + dv * dv  # (K, M, N)
    invalid = (~det_mask)[:, None, None] | (~marker_mask)[None, :, None]
    dist2 = jnp.where(invalid, big, dist2)

    tol_pf = jnp.asarray(tol_pf, dtype)
    tol_init = jnp.asarray(tol_init, dtype)

    weights = jnp.zeros((n,), dtype)
    pairs = jnp.full((m, 2, n), -1, jnp.int32)
    n_corr = jnp.zeros((n,), jnp.int32)
    used_det = jnp.zeros((k_cap, n), jnp.int32)
    n_self_occ = jnp.ones((n,), dtype)
    done = jnp.zeros((n,), bool)

    km = k_cap * m
    for step in range(m):
        flat = dist2.reshape(km, n)
        idx = jnp.argmin(flat, axis=0)  # (N,) over K*M
        min_val = jnp.min(flat, axis=0)
        d = jnp.sqrt(jnp.maximum(min_val, 0.0))
        row = idx // m  # detection index
        col = idx - row * m  # marker index

        ok = (d <= tol_pf) & ~done
        done = done | ~ok

        score = num_markers_score + ((tol_init - d) / tol_init) ** 2
        row_onehot = jnp.arange(k_cap)[:, None] == row[None, :]  # (K, N)
        reused = jnp.sum(jnp.where(row_onehot, used_det, 0), axis=0) > 0
        penal_occ = jnp.where(ok & reused, 3.0 * n_self_occ, 0.0)
        n_self_occ = n_self_occ + (ok & reused).astype(dtype)
        downg = downgrade[col]
        penal_down = jnp.where(ok & downg, 2.0, 0.0)
        weights = weights + jnp.where(ok, score, 0.0) - penal_occ - penal_down

        pairs = pairs.at[step, 0, :].set(jnp.where(ok, col.astype(jnp.int32), -1))
        pairs = pairs.at[step, 1, :].set(jnp.where(ok, row.astype(jnp.int32), -1))
        n_corr = n_corr + ok.astype(jnp.int32)

        used_det = used_det + (row_onehot & ok[None, :]).astype(jnp.int32)
        retire = (jnp.arange(m)[None, :, None] == col[None, None, :]) & ok[None, None, :]
        dist2 = jnp.where(retire, big, dist2)

    return weights, pairs, n_corr


def gather_soa(bank16: jnp.ndarray, indices: jnp.ndarray) -> jnp.ndarray:
    """Resampling gather in SoA layout: (16, N)[:, idx]."""
    return jnp.take(bank16, indices, axis=1)


def pick_lane(arr: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """arr[..., idx] for a single traced index via a one-hot dot.

    A dynamic-slice at a traced index on a lane-sharded array makes
    GSPMD all-gather the whole operand; the one-hot contraction lowers
    to a shard-local partial dot + scalar psum instead (same result,
    collective cost O(output) not O(N)).  A dot rather than a masked
    `where`+`reduce_sum` keeps XLA's default layout for the (16, N)
    bank operand.  Bit-exact: the one-hot row has a
    single nonzero, so the contraction reproduces arr[..., idx] with no
    rounding.  Used for every "pick one particle" (best/most-resampled)
    access on bank-shaped arrays.
    """
    n = arr.shape[-1]
    onehot = (jnp.arange(n) == idx).astype(arr.dtype)
    return jax.lax.dot_general(
        arr, onehot, (((arr.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )


def _uniform_at(key: jax.Array, idx: jnp.ndarray, n: int) -> jnp.ndarray:
    """Evaluate `jax.random.uniform(key, (n,), float32)[idx]` WITHOUT the
    gather: recompute the threefry-2x32 counter stream at the probe
    indices directly.

    Why: the threefry block function is pure counter hashing, so `u[k]`
    is an elementwise function of `k`: ~100 int32 ops per probe, no
    data movement and no gather — and a shard (or a kernel block) can
    evaluate exactly its slice of a global draw stream.

    Replicates jax's exact pipeline (the `threefry_partitionable`
    default: jax._src.prng._threefry_random_bits_partitionable +
    jax._src.random._uniform, f32): the element at flat position k is
    hashed from the 64-bit counter k split into two 32-bit words
    (hi=0 for n < 2^32, lo=k), bits = o1 ^ o2, and bits map to floats
    via `(bits >> 9) | 0x3f800000` bitcast minus 1.  Bit-equality with
    the gather form is pinned by tests/test_soa.py (a jax upgrade that
    changes the counter layout would be caught there).
    """
    from jax._src.prng import threefry2x32_p

    del n  # the partitionable counter stream is shape-independent per element
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        kd = jax.random.key_data(key)
    else:
        kd = key  # raw uint32[2] threefry key
    hi = jnp.zeros_like(idx, jnp.uint32)
    lo = idx.astype(jnp.uint32)
    o1, o2 = threefry2x32_p.bind(
        kd[0].astype(jnp.uint32), kd[1].astype(jnp.uint32), hi, lo
    )
    bits = o1 ^ o2
    fb = jax.lax.shift_right_logical(bits, jnp.uint32(9)) | jnp.uint32(0x3F800000)
    return jax.lax.bitcast_convert_type(fb, jnp.float32) - jnp.float32(1.0)


def hillis_steele(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive cumsum along the last axis with a FIXED association
    tree (x[i] += x[i-k], k doubling): the result depends only on the
    last-axis length, never on how XLA decomposes a scan — the
    width-independence anchor of the chunked resampling CDF (shared by
    this module and parallel.resample._resample_shard).  Monotone non-decreasing for
    non-negative inputs (each step adds monotone non-negative terms)."""
    c = x.shape[-1]
    k = 1
    while k < c:
        shifted = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(k, 0)])[..., :c]
        x = x + shifted
        k *= 2
    return x


def default_cdf_chunk(n: int) -> int:
    """Canonical CDF summation chunk — a function of N alone, NEVER of
    the mesh width, so the single-device sort path and the distributed
    shard_map path build bit-identical fixed-association CDFs.  Rule: largest divisor of N//8 (of N itself
    when 8 does not divide N) that is <= 512 — such a chunk divides the
    shard size N/P for every power-of-two width P <= 8 (and for
    power-of-two N, every width up to N/512), which is what cross-width
    and cross-path bit-reproducibility need.  N=100k -> 500 at every
    width in {1,2,4,8}; N=2^k (k>=12) -> 512."""
    base = n // 8 if n % 8 == 0 and n >= 8 else n
    for d in range(min(512, base), 0, -1):
        if base % d == 0:
            return d
    return 1


def chunked_cdf_norm(weights: jnp.ndarray, chunk: int) -> jnp.ndarray:
    """Normalised global CDF of `weights` by the fixed-association
    chunked scheme: Hillis-Steele within fixed-size chunks, a
    Hillis-Steele prefix over the chunk sums, entries rebuilt as
    fl(chunk_prefix) + fl(within-chunk prefix), then ONE division by the
    global total (the last chunk-prefix entry).  Because every FLOP's
    association is fixed by (n, chunk) alone, the result is
    bit-identical to parallel.resample._resample_shard step 1 at any
    mesh width using the same chunk — the anchor that makes
    single-device and mesh-sharded resampling agree slot-for-slot
    (tests/test_distributed_resample.py asserts exact equality).

    Degenerate weights (total <= 0) switch to the CLOSED FORM of the
    uniform CDF (j+1)/n, which is bit-identical to running the chunked
    summation over all-ones weights ((j+1) is exact in f32 under the
    fixed tree and the final /n is the same op) — the same fallback the
    distributed shard body uses.

    Monotone within chunks by construction; only chunk-prefix seams can
    carry 1-ulp pockets (the sort-based consumers repair them by value
    ordering, the probe-based ones by a boundary prefix-max)."""
    n = weights.shape[0]
    dtype = weights.dtype
    assert n % chunk == 0, f"chunk={chunk} must divide n={n}"
    within = hillis_steele(weights.reshape(n // chunk, chunk))
    chunk_sums = within[:, -1]
    prefix_incl = hillis_steele(chunk_sums)
    total = prefix_incl[-1]
    prefix_excl = jnp.concatenate([jnp.zeros((1,), dtype), prefix_incl[:-1]])
    cdf = (prefix_excl[:, None] + within).reshape(n)
    ok = total > 0
    return jnp.where(
        ok,
        cdf / jnp.where(ok, total, 1.0),
        (jnp.arange(1, n + 1, dtype=dtype)) / jnp.asarray(n, dtype),
    )


def stratified_resample_closed(key: jax.Array, weights: jnp.ndarray):
    """Sort-free stratified resampling: the two 2N-element sorts of
    `stratified_resample_soa` become a cumsum, six elementwise threefry
    probe evaluations and one scatter-max.

    Same draws, same assignment rule; NOT bit-identical to the sort
    path: XLA lowers `cumsum` as a parallel scan whose per-element
    association can leave 1-ulp NON-monotone pockets in the CDF.  The
    sort path implicitly repairs them by value-sorting the CDF; this
    path repairs them with an explicit `cummax`.  The two repairs
    attribute the (measure-zero) draws landing inside a pocket to one
    or the other of two ulp-separated particles — slot-level agreement
    everywhere else (pinned with tolerance by tests/test_soa.py).

    Closed form: the draws u_i = (i + eps_i)/n are a jittered uniform
    grid, so `rank_j = #{i : u_i <= cdf_j}` — the number of draws at or
    below each CDF entry — is found by probing u at a 6-wide index
    window around k = floor(n * cdf_j):
        rank_j = (k_c - 3) + sum_{d=-3..2} [u(k_c + d) <= cdf_j],
        k_c = clip(k, 3, n - 3)
    Exact for n <= 2^22: |n*u_i - i| < 1 + O(n * 2^-23) and
    |fl(n*cdf) - n*cdf| <= (k+1)*2^-24 in f32, so every u index below
    the window satisfies u <= cdf_j and every index above exceeds it
    with a full grid unit of margin (the comparisons are the SAME f32
    `u <= cdf` predicates the merge-sort path resolves, hence
    bit-identical assignments).  The probes u(k) are recomputed from
    the PRNG counter stream (`_uniform_at`), NOT gathered.

    Inversion: `ancestors[i] = #{j : rank_j <= i}` (the conjugate of
    rank; equality ties resolve exactly like searchsorted 'left').  With
    rank non-decreasing this is one scatter-max of j+1 into rank's value
    slots followed by a cummax.  counts = first difference of rank.

    Stays opt-in (`use_closed_form_resample`): the sort path is the
    default, and the two have not been timed against each other on the
    GPU yet.
    """
    n = weights.shape[0]
    if n < 8 or n > (1 << 22):  # window-exactness bound; see docstring
        return stratified_resample_soa(key, weights)
    # repair chunk-seam ulp pockets with an explicit cummax (see docstring)
    cdf = jax.lax.cummax(chunked_cdf_norm(weights, default_cdf_chunk(n)))

    nf = jnp.asarray(n, weights.dtype)
    k = jnp.floor(cdf * nf).astype(jnp.int32)
    k_c = jnp.clip(k, 3, n - 3)
    rank = k_c - 3
    for d in (-3, -2, -1, 0, 1, 2):
        probe = k_c + d
        u_probe = (probe.astype(weights.dtype) + _uniform_at(key, probe, n)) / nf
        rank = rank + (u_probe <= cdf).astype(jnp.int32)

    iota1 = jnp.arange(1, n + 1, dtype=jnp.int32)
    bins = jnp.zeros((n + 1,), jnp.int32).at[rank].max(iota1)
    ancestors = jnp.clip(jax.lax.cummax(bins)[:n], 0, n - 1).astype(jnp.int32)
    counts = jnp.diff(rank, prepend=jnp.zeros((1,), jnp.int32)).astype(jnp.int32)
    return ancestors, counts, jnp.argmax(counts).astype(jnp.int32)


def stratified_resample_soa(key: jax.Array, weights: jnp.ndarray):
    """Stratified resampling by sorts: one merged sort plus one tag sort
    yield BOTH the ancestors and the per-particle counts — no scatter, no
    scan-lowered binary search and no 1-D gather.  Same draw semantics as
    pf.resample.stratified_resample.  The CDF is the chunked
    fixed-association scheme (chunked_cdf_norm) shared with the
    distributed resampler, so the assignment is identical across both
    paths (exact, tests/test_distributed_resample.py).

    Scheme: merge-sort [u, cdf] ascending with queries (tag 0) before
    equal cdf entries (side='left').  In merged order, the inclusive
    cumsum of tags counts cdf entries so far — its value at query q IS
    searchsorted(cdf, u_q); the complementary count at cdf entry j is
    count_draws_leq(cdf_j), whose first difference is counts[j].  A
    stable sort by tag then compacts queries (in draw order) to the
    front and cdf entries (in particle order) to the back.

    Both sorts run as single-i32-key UNSTABLE sorts: merge key =
    float_bits<<1 | tag — u/cdf are non-negative f32 so their bit
    patterns order like the floats, and the tag bit keeps queries ahead
    of bit-equal cdf entries (equal keys are then indistinguishable, so
    instability is unobservable);  partition key = tag<<B | position
    (unique), from which the pre-partition position — and with it the
    draws_leq count — is recovered bitwise instead of being carried as
    a second payload.
    """
    n = weights.shape[0]
    # fixed-association chunked CDF — the SAME values the distributed
    # resampler (parallel.resample) builds, so the resampling
    # assignment is identical across both paths and across mesh widths
    # (exact equality pinned in tests/test_distributed_resample.py)
    cdf = chunked_cdf_norm(weights, default_cdf_chunk(n))
    eps = jax.random.uniform(key, (n,), weights.dtype)
    u = (jnp.arange(n, dtype=weights.dtype) + eps) / n

    vals = jnp.concatenate([u, cdf])
    tags = jnp.concatenate(
        [jnp.zeros((n,), jnp.int32), jnp.ones((n,), jnp.int32)]
    )
    bits = jax.lax.bitcast_convert_type(vals.astype(jnp.float32), jnp.int32)
    key1 = jnp.left_shift(bits, 1) | tags
    (skey,) = jax.lax.sort((key1,), num_keys=1, is_stable=False)
    sorted_tags = skey & 1
    c_incl = jnp.cumsum(sorted_tags)  # cdf entries so far (inclusive)

    shift = max((2 * n - 1).bit_length(), 1)
    pos = jnp.arange(2 * n, dtype=jnp.int32)
    key2 = jnp.left_shift(sorted_tags, shift) | pos
    skey2, c2 = jax.lax.sort(
        (key2, c_incl.astype(jnp.int32)), num_keys=1, is_stable=False
    )
    ancestors = jnp.clip(c2[:n], 0, n - 1).astype(jnp.int32)
    pos2 = skey2[n:] & ((1 << shift) - 1)  # pre-partition positions
    draws_leq = pos2 + 1 - c2[n:]  # draws at or before cdf[j], inclusive
    counts = (draws_leq - jnp.concatenate([jnp.zeros((1,), jnp.int32), draws_leq[:-1]])).astype(jnp.int32)
    return ancestors, counts, jnp.argmax(counts).astype(jnp.int32)
