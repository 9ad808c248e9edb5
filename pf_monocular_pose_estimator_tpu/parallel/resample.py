"""Distributed stratified resampling — explicit collectives, no bank gather.

SURVEY.md §7 hard-part 4.  The mechanism runs inside a `shard_map` over
the `particles` mesh axis:

  1. **Width-independent CDF from scalar collectives.**  Each shard
     computes fixed-size-chunk partial sums of its weights with a
     Hillis-Steele (fixed-association) cumulative sum, `all_gather`s the
     n/chunk chunk sums (tiny), and rebuilds the global CDF values of
     its own particles as f32(chunk_prefix) + f32(within-chunk prefix).
     Because every FLOP's association is fixed by (n, chunk) alone —
     never by the shard width — the CDF, the draws, and hence the whole
     resampling assignment are BIT-IDENTICAL across mesh widths (the
     round-3 scheme's local-cumsum+offset rounding made widths disagree
     on ~1% of slots).  The CDF is normalised by the global total and
     is monotone within a shard by construction (non-negative
     fixed-tree adds; only chunk-prefix seams can carry ulp pockets).
  2. **Per-shard stratified draws with global positions.**  The global
     draw grid u_g = fl((g + eps_g)/n) is a pure threefry counter hash
     of the replicated key (`pf.soa._uniform_at` — no gather, no
     communication), so each shard evaluates exactly its output
     window's draws, and the closed-form grid inversion
     (`_count_leq_norm`) yields the exact copy count of each local
     particle — still with no communication.
  3. **Ancestors via a reach-limited ppermute ring + one merge.**  The
     canonical assignment (output slot g takes the first global CDF
     entry >= u_g) means output shard s draws only from input shards
     whose CDF span overlaps its output window — its ring neighbours,
     unless per-shard weight imbalance exceeds a whole shard's worth of
     draws.  Each shard ppermutes the 12 VARYING rows of its bank block
     plus its CDF block to its ring neighbours (13·S floats per
     neighbour — less than one naive 16·S bank block even at P=2), then
     resolves all S of its draws against the concatenated neighbour
     CDFs with the same two-sort merge scheme as
     `pf.soa.stratified_resample_soa` (sorts, never searchsorted) and
     gathers the ancestor columns with ONE take from the concatenated
     block.  Draws whose
     ancestor lies beyond the reach are clamped to the shard's
     most-copied particle and counted in the returned diagnostics
     (zero in any non-degenerate tracking state; `reach` is
     configurable, and bit-reproducibility across widths holds exactly
     when `clipped == 0`).

Pinned by tests/test_distributed_resample.py: EXACT slot-for-slot
agreement with the single-device resampler (since round 5 the sort path
builds the same chunked fixed-association CDF — pf.soa.chunked_cdf_norm
— so there is one resampling answer across all paths and widths), exact
cross-width agreement, skew diagnostics, and the no-bank-all-gather HLO
budget.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..pf.soa import _uniform_at, default_cdf_chunk, hillis_steele

# the fixed-association cumsum shared with the single-device resamplers
# (pf.soa) — one association tree, one CDF, every path
_hillis_steele = hillis_steele


class DistResampleOut(NamedTuple):
    # (16, N) sharded over 'particles'.  Only the 12 VARYING pose rows
    # travel the ring; rows 12-15 of every output column are the
    # re-synthesised rigid-transform bottom row (0, 0, 0, 1) — exact for
    # any bank of poses (every pose enters the bank from exp/compose/P3P
    # paths that write the constant row, and composes preserve it; see
    # tests/test_pallas_step.py), NOT a generic row passthrough.
    resampled: jnp.ndarray
    counts: jnp.ndarray  # (N,) global copy count per input particle
    most: jnp.ndarray  # replicated int32: global index of most-copied
    clipped: jnp.ndarray  # replicated int32: draws beyond the ring reach


def _count_leq_norm(cdf_n: jnp.ndarray, key, n: int) -> jnp.ndarray:
    """Number of global draws u_g = fl((g + eps_g)/n) with u_g <= cdf_n,
    for normalised CDF values cdf_n in [0, 1].  Closed-form grid
    inversion, exact for 8 <= n <= 2^22 (window-exactness bound — see
    pf.soa.stratified_resample_closed); the probes recompute the
    threefry counter stream elementwise, bit-identical to the draw
    expression used for the output slots."""
    nf = jnp.asarray(n, cdf_n.dtype)
    k = jnp.clip(jnp.floor(cdf_n * nf).astype(jnp.int32), 0, n - 1)
    k_c = jnp.clip(k, 3, n - 3)
    cnt = k_c - 3
    for d in (-3, -2, -1, 0, 1, 2):
        probe = k_c + d
        u_p = (probe.astype(cdf_n.dtype) + _uniform_at(key, probe, n)) / nf
        cnt = cnt + (u_p <= cdf_n).astype(jnp.int32)
    return jnp.clip(cnt, 0, n)


def _ring_deltas(reach: int, p: int):
    """Ring offsets [0, -1, +1, ...] deduplicated mod p (at p=2 the +1
    neighbour IS the -1 neighbour — shipping it twice is why the
    round-3 ring moved more bytes than a naive all-gather at P=2)."""
    deltas, seen = [], set()
    for d in [0] + [s * r for r in range(1, reach + 1) for s in (-1, 1)]:
        if (d % p) not in seen:
            seen.add(d % p)
            deltas.append(d)
    return deltas


def _resample_shard(
    key, w, bank16, n: int, reach: int, chunk: int, axis: str,
    window: int | None = None,
):
    """shard_map body: w (S,), bank16 (16, S) are this shard's blocks.

    window: reach-1 boundary-window payload (columns).  When set (and
    reach == 1, P >= 2), the ring ships only each block's first
    `window` columns forward-reaching draws can land in and its last
    `window` columns backward-reaching draws can land in — 26W+1 floats
    per shard instead of 13S — because a neighbour's draws only reach
    into a block as far as the per-shard weight imbalance pushes the
    CDF (a few % of S in any healthy tracking state).  Draws whose
    ancestor falls outside the received window are clamped to the
    most-copied local particle and counted in `clipped`, exactly like
    reach overflow.  The assignment is bit-identical to the full-block
    scheme whenever clipped == 0."""
    p = jax.lax.axis_size(axis)
    s = w.shape[0]
    idx = jax.lax.axis_index(axis)
    dtype = w.dtype
    s_chunks = s // chunk
    n_chunks = n // chunk
    use_window = window is not None and reach == 1 and p >= 2
    if use_window:
        window = min(int(window), s - 1)

    # -- 1. width-independent chunked CDF (normalised).  The chunk-sum
    # all_gather is the ONLY collective here: the global total is its
    # last prefix entry (no separate psum — one less collective per
    # frame), and the degenerate-total fallback switches to the CLOSED
    # FORM of the uniform CDF, which is bit-identical to running the
    # chunked summation over all-ones weights ((j+1) is exact in f32
    # under the fixed tree, and the final /n is the same op).
    within = _hillis_steele(w.reshape(s_chunks, chunk))  # (s_chunks, chunk)
    chunk_sums = within[:, -1]  # (s_chunks,) fixed-tree f32
    all_chunk_sums = jax.lax.all_gather(chunk_sums, axis).reshape(n_chunks)
    # (n_chunks,) prefix: fixed length regardless of width -> same tree
    prefix_incl = _hillis_steele(all_chunk_sums)
    total = prefix_incl[-1]
    prefix_excl = jnp.concatenate([jnp.zeros((1,), dtype), prefix_incl[:-1]])
    my_chunk_off = jax.lax.dynamic_slice(prefix_excl, (idx * s_chunks,), (s_chunks,))
    cdf = (my_chunk_off[:, None] + within).reshape(s)  # global CDF values
    ok_total = total > 0
    nf = jnp.asarray(n, dtype)
    g = idx * s + jnp.arange(s)
    cdf_n = jnp.where(
        ok_total,
        cdf / jnp.where(ok_total, total, 1.0),  # fl division is monotone
        (g + 1).astype(dtype) / nf,  # uniform-weights closed form
    )
    # shard span boundaries in the same normalised domain (bound[k] =
    # start of shard k; the last CDF entry of shard k-1 equals bound[k]
    # bit-for-bit by construction)
    bounds_n = jnp.where(
        ok_total,
        prefix_excl[:: s_chunks] / jnp.where(ok_total, total, 1.0),
        (jnp.arange(p) * s).astype(dtype) / nf,
    )
    # NOTE: prefix_excl has n_chunks entries; shard k starts at chunk
    # k*s_chunks.  bounds_n[k] = normalised mass below shard k.

    # -- 2. copy counts per local particle (closed-form, elementwise)
    cum_counts = _count_leq_norm(cdf_n, key, n)  # (S,)
    start_s = _count_leq_norm(bounds_n[idx][None], key, n)[0]
    counts = jnp.diff(cum_counts, prepend=start_s[None]).astype(jnp.int32)

    # -- 3. my output window's draws (global grid, recomputed locally)
    u = (g.astype(dtype) + _uniform_at(key, g, n)) / nf  # (S,) non-decreasing

    # -- 4. ring exchange: 12 varying bank rows + CDF per neighbour —
    # either full blocks (any reach) or reach-1 boundary windows
    top12_local = bank16[:12]
    if use_window:
        wlen = window
        # head window (first W columns) travels BACKWARD so the
        # receiver holds its FORWARD (idx+1) neighbour's head; tail
        # window travels forward.  The tail CDF carries W+1 entries
        # (one pre-window sentinel) so "ancestor before the window" is
        # detectable exactly.  Ring wrap edges are semantically dead:
        # shard 0 has no u < 0 and shard P-1 no u >= 1, so the mod-P
        # permutes never deliver a reachable draw across the seam.
        perm_bwd = [(i, (i - 1) % p) for i in range(p)]
        perm_fwd = [(i, (i + 1) % p) for i in range(p)]
        head_cdf = jax.lax.ppermute(cdf_n[:wlen], axis, perm_bwd)
        head_bank = jax.lax.ppermute(top12_local[:, :wlen], axis, perm_bwd)
        tail_cdf = jax.lax.ppermute(cdf_n[s - wlen - 1 :], axis, perm_fwd)
        tail_bank = jax.lax.ppermute(
            top12_local[:, s - wlen :], axis, perm_fwd
        )
        blocks_bank = [top12_local, head_bank, tail_bank]
        blocks_cdf = [cdf_n, head_cdf, tail_cdf]
        nsrc = 3  # merge codes: 1=own, 2=fwd head, 3=bwd tail
        srcs = None
    else:
        deltas = _ring_deltas(reach, p)
        nsrc = len(deltas)
        blocks_bank, blocks_cdf, srcs = [], [], []
        for delta in deltas:
            if delta == 0:
                nb_bank, nb_cdf = top12_local, cdf_n
            else:
                perm = [(i, (i + delta) % p) for i in range(p)]
                nb_bank = jax.lax.ppermute(top12_local, axis, perm)
                nb_cdf = jax.lax.ppermute(cdf_n, axis, perm)
            blocks_bank.append(nb_bank)
            blocks_cdf.append(nb_cdf)
            srcs.append((idx - delta) % p)

    # -- 5. per-block ancestor counts via the two-sort merge (the same
    # scheme as pf.soa.stratified_resample_soa; no searchsorted)
    lens = [b.shape[0] for b in blocks_cdf]
    vals = jnp.concatenate([u] + blocks_cdf)
    bits = jax.lax.bitcast_convert_type(vals.astype(jnp.float32), jnp.uint32)
    total_len = s + sum(lens)
    code = jnp.concatenate(
        [jnp.zeros((s,), jnp.uint32)]
        + [jnp.full((lens[i],), i + 1, jnp.uint32) for i in range(nsrc)]
    )
    if nsrc <= 3:
        # single-operand first sort: 2-bit code rides in the key (query
        # code 0 sorts before bit-equal entries -> strict '<' counting)
        key1 = (bits << jnp.uint32(2)) | code
        (skey,) = jax.lax.sort((key1,), num_keys=1, is_stable=False)
        scode = skey & jnp.uint32(3)
    else:
        key1 = (bits << jnp.uint32(1)) | (code > 0).astype(jnp.uint32)
        _, scode = jax.lax.sort((key1, code), num_keys=1, is_stable=False)
    block_counts = [
        jnp.cumsum((scode == i + 1).astype(jnp.int32)) for i in range(nsrc)
    ]
    # compact queries (draw order) to the front: positions are unique,
    # so the single-key second sort is exact
    shift = max((total_len - 1).bit_length(), 1)
    pos = jnp.arange(total_len, dtype=jnp.uint32)
    key2 = ((scode > 0).astype(jnp.uint32) << jnp.uint32(shift)) | pos
    sorted2 = jax.lax.sort(
        tuple([key2] + block_counts), num_keys=1, is_stable=False
    )
    a_blocks = [c[:s] for c in sorted2[1:]]  # per-draw: #entries of block i < u

    # -- 6. resolve each draw's source shard and local ancestor
    # true shard of u: number of interior shard starts strictly below u
    # (u exactly at a boundary belongs to the shard below — the span
    # convention (lo, hi], matching 'first CDF >= u')
    src_u = jnp.sum(
        (u[None, :] > bounds_n[1:, None]).astype(jnp.int32), axis=0
    )  # (S,) in [0, P)
    if use_window:
        # direction by u against the shard's own mass span start;
        # validity by (a) immediate-neighbour src and (b) the window
        # count actually locating an ancestor inside the window
        own_start = jnp.take(bounds_n, idx)
        a_own, a_head, a_tail = a_blocks
        own_hit = src_u == idx
        fwd_hit = (
            ~own_hit & (u >= own_start) & (src_u == (idx + 1) % p)
            & (a_head < wlen)
        )
        back_hit = (
            ~own_hit & (u < own_start) & (src_u == (idx - 1) % p)
            & (a_tail >= 1)
        )
        found = own_hit | fwd_hit | back_hit
        # positions in cat12 = [own (12,S) | head (12,W) | tail (12,W)]
        take_pos = jnp.clip(a_own, 0, s - 1)  # ulp-seam clamp, as below
        take_pos = jnp.where(fwd_hit, s + a_head, take_pos)
        take_pos = jnp.where(back_hit, s + wlen + (a_tail - 1), take_pos)
    else:
        slot_u = jnp.zeros((s,), jnp.int32)
        found = jnp.zeros((s,), bool)
        j_local = jnp.zeros((s,), jnp.int32)
        for i in range(nsrc):
            hit = src_u == srcs[i]
            slot_u = jnp.where(hit, i, slot_u)
            j_local = jnp.where(hit, a_blocks[i], j_local)
            found = found | hit
        # ulp seams at chunk boundaries can push the count to S; clamp to
        # the last particle of the block (a one-ulp misattribution, same
        # as the round-3 scheme's in-block clip)
        j_local = jnp.clip(j_local, 0, s - 1)
        take_pos = slot_u * s + j_local

    n_clipped = jnp.sum((~found).astype(jnp.int32))
    fallback = jnp.argmax(counts)

    # -- 7. ONE gather from the concatenated neighbour blocks; the
    # constant (0, 0, 0, 1) bottom row is re-synthesised
    cat12 = jnp.concatenate(blocks_bank, axis=1)
    take_pos = jnp.where(found, take_pos, fallback)
    out12 = jnp.take(cat12, take_pos, axis=1)
    out = jnp.concatenate(
        [
            out12,
            jnp.zeros((3, s), bank16.dtype),
            jnp.ones((1, s), bank16.dtype),
        ]
    )

    # -- most-copied particle + clip diagnostics, globally: ONE packed
    # all_gather of (max count, argmax, local clip count) replaces two
    # scalar all_gathers and a psum — three fewer collectives
    local_best = jnp.argmax(counts)
    local_max = counts[local_best]
    packed = jnp.stack(
        [local_max, local_best.astype(jnp.int32), n_clipped]
    )  # (3,) i32
    all_packed = jax.lax.all_gather(packed, axis)  # (P, 3) replicated
    winner = jnp.argmax(all_packed[:, 0])
    most = (winner * s + all_packed[winner, 1]).astype(jnp.int32)
    clipped_total = jnp.sum(all_packed[:, 2])

    return out, counts, most, clipped_total


def _auto_chunk(n: int, p: int) -> int:
    """The canonical width-independent chunk (pf.soa.default_cdf_chunk —
    a function of N alone, shared with the single-device sort path and
    the Pallas decode path, so all resamplers build bit-identical CDFs)
    whenever it divides this mesh's shard size; otherwise the largest
    divisor of the shard size that is <= 512 (exotic (n, P) combinations
    — then cross-path agreement needs an explicit `cdf_chunk`)."""
    s = n // p
    canonical = default_cdf_chunk(n)
    if s % canonical == 0:
        return canonical
    for d in range(min(512, s), 0, -1):
        if s % d == 0:
            return d
    return 1


def make_distributed_resampler(
    mesh: Mesh,
    n_particles: int,
    reach: int = 1,
    axis: str = "particles",
    cdf_chunk: int | None = None,
    payload_window: int | str | None = "auto",
):
    """Build `resample(key, weights, bank16) -> DistResampleOut` running
    the explicit scheme over `mesh`'s `axis`.  Call it inside or outside
    jit; weights (N,) and bank16 (16, N) should be sharded over `axis`.

    cdf_chunk: the fixed CDF summation chunk (must divide the shard
    size).  Two resamplers agree bit-for-bit across mesh widths iff
    they use the same chunk (and no draw exceeds the reach).

    payload_window: reach-1 ring payload in columns — "auto" = S // 4
    (covers up to 25% per-shard weight imbalance: 26W+1 floats per
    shard instead of 13S), an int for explicit
    control, None for full blocks (exact under any skew the reach
    covers).  Ignored unless reach == 1 and P >= 2.  Window overflow is
    clamped + counted in `clipped`, identically to reach overflow."""
    p = mesh.shape[axis]
    if cdf_chunk is None:
        cdf_chunk = _auto_chunk(n_particles, p)
    s = n_particles // p
    assert s % cdf_chunk == 0, (
        f"cdf_chunk={cdf_chunk} must divide the shard size {s}"
    )
    assert 8 <= n_particles <= (1 << 22), (
        "closed-form grid inversion is exact only for 8 <= N <= 2^22"
    )
    if payload_window == "auto":
        payload_window = max(s // 4, 1)
    body = partial(
        _resample_shard, n=n_particles, reach=reach, chunk=cdf_chunk,
        axis=axis, window=payload_window,
    )
    spec_w = P(axis)
    spec_b = P(None, axis)

    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), spec_w, spec_b),
        out_specs=(spec_b, spec_w, P(), P()),
        # `most`/`clipped` are replicated by construction (all_gather/psum
        # over the particles axis); varying-axis inference can't see that
        check_vma=False,
    )

    def resample(key, weights, bank16):
        out, counts, most, clipped = mapped(key, weights, bank16)
        return DistResampleOut(out, counts, most, clipped)

    return resample
