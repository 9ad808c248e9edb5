"""Smoke test of the tracker on one NVIDIA GPU, through its normal entry
points, at the flagship width (752x480 frames, a 100k-particle bank, the
demo 5-LED constellation, bench.py's config).

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the mesh path only

Phases (one card), each failing the run on the first failed check:
  1. device   — JAX's first device must be a GPU (else exit 1, no result);
                prints the card's name and power limit;
  2. compile  — compiles the tracker step at 100k and at 2^20 particles,
                printing compile seconds and memory_analysis();
  3. parity   — the fused PF kernel against propagate_soa +
                weight_particles_soa at 100k and 2^20 particles, and
                detection and GN refinement on the card against the same
                functions on the CPU backend;
  4. main     — the CLI (io/cli.py) on the synthetic 60-frame orbit at
                100k particles (tracked fraction >= 0.95, ATE <= 10 mm),
                and frame 0's brute-force initialisation on card vs CPU;
  5. multi    — make_multi_tracker, 4 targets x 25k particles, 20 frames;
  6. timing   — fused kernel vs XLA (per call, 100k and 2^20) and the
                480-frame 100k scan with each; information only.

--multi (four cards): make_sharded_tracker on a (1, 4) mesh at 2^20
particles and make_sharded_multi_tracker on a (2, 2) mesh with 4
targets, each against the single-card run of the same sequence; one
distributed resample against stratified_resample_soa; the collectives
in the compiled HLO.

The last line of stdout is the result:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
--rehearse runs the same phases on the CPU at tiny sizes, with the kernel
in the Pallas interpreter, and prints no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import sys
import time

FULL = dict(
    n=100_000, n_big=1 << 20, frames=60, multi_n=25_000, multi_frames=20,
    scan_frames=480, reps=5, iters=50, mesh_n=1 << 20, mesh_multi_n=25_000,
)
TINY = dict(
    n=2048, n_big=4096, frames=12, multi_n=512, multi_frames=6,
    scan_frames=8, reps=2, iters=2, mesh_n=2048, mesh_multi_n=512,
)


def log(*a):
    print(*a, flush=True)


def check(label, value, limit, ok):
    """Print a measured error beside its limit; fail the run at once."""
    log(f"  {label}: {value} (limit {limit}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {label}")


@contextlib.contextmanager
def phase(name):
    log(f"== {name}")
    t0 = time.perf_counter()
    yield
    log(f"   ({name}: {time.perf_counter() - t0:.1f} s)")


class Ctx:
    """Everything the phases share: sizes, devices, the flagship scene."""

    def __init__(self, sizes, rehearse):
        import jax
        import jax.numpy as jnp

        from pf_monocular_pose_estimator_tpu.io.synthetic import (
            default_camera,
            demo_markers,
            make_orbit_sequence,
        )

        self.s = sizes
        self.rehearse = rehearse
        self.interpret = rehearse
        self.devices = jax.devices()
        self.card = self.devices[0]
        self.cpu = jax.devices("cpu")[0]
        self.camera = default_camera()
        self.markers = demo_markers()
        self.mask = jnp.ones((self.markers.shape[0],), bool)
        self.seq = make_orbit_sequence(
            self.camera, self.markers, num_frames=sizes["frames"], fps=50.0
        )
        self.label = "CPU rehearsal (not a device number)"
        if not rehearse:
            from pf_monocular_pose_estimator_tpu.utils.backend import card_label

            self.label = card_label().splitlines()[0]

    def on(self, device, *xs):
        """The arrays committed to `device` (jit then runs there)."""
        import jax

        return [jax.device_put(x, device) for x in xs]

    def config(self, n):
        from pf_monocular_pose_estimator_tpu.utils import TrackerConfig

        return TrackerConfig(
            n_particles=n, min_blob_area=8.0, pf_max_retries=8,
            roi_particle_subsample=128,
        )

    def xla_pf(self):
        """The plain XLA propagate+weight, in the tracker's pf_fn form."""
        from pf_monocular_pose_estimator_tpu.pf.soa import (
            propagate_soa,
            weight_particles_soa,
        )

        camera = self.camera

        def pf(k, res16, cur, pred, prediction, cmi, noise, fac_t, fac_r,
               tracking, apply_pred, infl, markers, mask, det_xy, det_mask,
               tol_pf, tol_init, downgrade, nms):
            bank = propagate_soa(k, res16, cur, pred, prediction, cmi, noise,
                                 fac_t, fac_r, tracking, apply_pred, infl)
            w = weight_particles_soa(camera, bank, markers, mask, det_xy,
                                     det_mask, tol_pf, tol_init, downgrade, nms)
            return bank, w[0]

        return pf

    def kernel_pf(self):
        from pf_monocular_pose_estimator_tpu.pf.pallas_step import (
            fused_propagate_weight_pallas,
        )

        camera, interpret = self.camera, self.interpret

        def pf(*a):
            return fused_propagate_weight_pallas(
                *a[:12], camera, *a[12:], interpret=interpret
            )

        return pf


def rot_angle(a, b):
    """Rotation angle (rad) between the rotation parts of (..., 4, 4)
    poses, from the skew part of a @ b.T (accurate at small angles)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    r = np.einsum("...ij,...kj->...ik", a[..., :3, :3], b[..., :3, :3])
    v = np.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                  r[..., 1, 0] - r[..., 0, 1]], -1)
    return np.arcsin(np.clip(np.linalg.norm(v, axis=-1) / 2, 0.0, 1.0))


def pf_scene(ctx, n, seed=0):
    """PF operands around a known pose: a bank of perturbed poses,
    detections = projected markers + noise + one near-clone."""
    import jax
    import jax.numpy as jnp

    from pf_monocular_pose_estimator_tpu.geometry import exp_se3, project
    from pf_monocular_pose_estimator_tpu.pf.propagate import NoiseBounds

    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 6)
    gt = exp_se3(jnp.asarray([0.02, -0.01, 1.4, 0.2, -0.15, 0.1], jnp.float32))
    tw = jax.random.normal(ks[0], (n, 6), jnp.float32) * 0.02
    bank16 = jax.vmap(lambda t: exp_se3(t) @ gt)(tw).reshape(n, 16).T
    uv = project(ctx.camera, gt, ctx.markers)
    uv = uv + 0.5 * jax.random.normal(ks[1], uv.shape)
    det_xy = jnp.zeros((16, 2), jnp.float32).at[:5].set(uv).at[5].set(uv[0] + 2.0)
    det_mask = jnp.zeros((16,), bool).at[:6].set(True)
    small = lambda k: exp_se3(0.005 * jax.random.normal(k, (6,)))  # noqa: E731
    three = jnp.ones((3,), jnp.float32)
    args = (
        ks[2], bank16, gt, small(ks[3]) @ gt, small(ks[4]), small(ks[5]),
        NoiseBounds(-0.025, 0.025, -0.02, 0.02), 1.3 * three, 0.9 * three,
        jnp.asarray(True), jnp.asarray(True), jnp.float32(1.1),
        ctx.markers, ctx.mask, det_xy, det_mask, jnp.float32(10.0),
        jnp.float32(5.0), jnp.asarray([False, True, False, False, False]),
        jnp.float32(5.0),
    )
    return args


def run_device(ctx):
    import jax

    d = ctx.devices[0]
    log(f"  devices: {len(ctx.devices)} x {d.platform} / {d.device_kind}")
    if not ctx.rehearse:
        from pf_monocular_pose_estimator_tpu.utils.backend import card_label

        log(card_label())
    log(f"  jax {jax.__version__}, matmul precision "
        f"{jax.config.jax_default_matmul_precision}")


def run_compile(ctx):
    import jax

    from pf_monocular_pose_estimator_tpu.tracker import TargetState, make_tracker

    for n in (ctx.s["n"], ctx.s["n_big"]):
        step = make_tracker(ctx.camera, ctx.markers, ctx.mask, ctx.config(n))
        state = TargetState.create(n, jax.random.PRNGKey(0))
        t0 = time.perf_counter()
        compiled = step.lower(state, ctx.seq.frames[0], ctx.seq.times[0]).compile()
        log(f"  tracker_step N={n}: compile {time.perf_counter() - t0:.1f} s")
        log(f"    memory_analysis: {compiled.memory_analysis()}")


def run_parity(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pf_monocular_pose_estimator_tpu.geometry import exp_se3, project
    from pf_monocular_pose_estimator_tpu.ops.blob import find_leds
    from pf_monocular_pose_estimator_tpu.pf.refine import gauss_newton_refine

    kernel, xla = jax.jit(ctx.kernel_pf()), jax.jit(ctx.xla_pf())
    for n in (ctx.s["n"], ctx.s["n_big"]):
        args = pf_scene(ctx, n)
        bk, wk = kernel(*args)
        bx, wx = xla(*args)
        bank_err = float(jnp.max(jnp.abs(bk - bx)))
        werr = np.abs(np.asarray(wk) - np.asarray(wx))
        frac = float(np.mean(werr <= 1e-4))
        log(f"  PF kernel vs XLA, N={n}: {float(np.mean(np.asarray(wx) > 0)):.3f} "
            f"of lanes weighted > 0, max weight err {werr.max():.3g}")
        check(f"bank max abs diff N={n}", f"{bank_err:.3g}", 1e-5, bank_err <= 1e-5)
        check(f"weight lanes within 1e-4 N={n}", f"{frac:.6f}", ">= 0.9999",
              frac >= 0.9999)

    # detection: full frame (init path) and the tracking crop
    frame = ctx.seq.frames[0]
    params = ctx.config(ctx.s["n"]).blob_params()
    uv = project(ctx.camera, jnp.asarray(ctx.seq.poses[0]), ctx.markers)
    lo, hi = jnp.min(uv, 0) - 15, jnp.max(uv, 0) + 15
    rois = {
        "full": jnp.asarray([0, 0, 752, 480], jnp.float32),
        "crop": jnp.concatenate([lo, hi - lo]).astype(jnp.float32),
    }
    detect = jax.jit(lambda im, roi: find_leds(im, roi, params, ctx.camera))
    for name, roi in rois.items():
        dg = detect(*ctx.on(ctx.card, frame, roi))
        dc = detect(*ctx.on(ctx.cpu, frame, roi))
        same = bool(np.array_equal(np.asarray(dg.mask), np.asarray(dc.mask)))
        check(f"detection {name}: valid mask equal", same, "equal", same)
        m = np.asarray(dc.mask)
        err = float(np.max(np.abs(np.asarray(dg.xy)[m] - np.asarray(dc.xy)[m])))
        check(f"detection {name}: xy max diff px ({int(m.sum())} blobs)",
              f"{err:.3g}", 1e-3, err <= 1e-3)

    # GN refinement: 11 hypotheses from identical perturbed poses
    det = dc
    m_cap = ctx.markers.shape[0]
    pose_gt = jnp.asarray(ctx.seq.poses[0])
    tw = 0.02 * jax.random.normal(jax.random.PRNGKey(3), (11, 6))
    poses0 = jax.vmap(lambda t: exp_se3(t) @ pose_gt)(tw)
    pairs = jnp.stack([jnp.arange(m_cap), jnp.arange(m_cap)], -1)
    uv_det = np.asarray(det.xy)
    # bind each marker to its nearest detection (frame 0 is clean)
    d2 = ((np.asarray(uv)[:, None] - uv_det[None]) ** 2).sum(-1)
    d2[:, ~np.asarray(det.mask)] = np.inf
    pairs = pairs.at[:, 1].set(jnp.asarray(d2.argmin(1), jnp.int32))
    gn = jax.jit(jax.vmap(
        lambda p, xy: gauss_newton_refine(
            ctx.camera, p, ctx.markers, xy, pairs, ctx.mask, 25, 1e-4
        ), in_axes=(0, None),
    ))
    rg = gn(*ctx.on(ctx.card, poses0, det.xy))
    rc = gn(*ctx.on(ctx.cpu, poses0, det.xy))
    pg, pc = np.asarray(rg.pose, np.float64), np.asarray(rc.pose, np.float64)
    t_err = float(np.max(np.linalg.norm(pg[:, :3, 3] - pc[:, :3, 3], axis=-1)))
    r_err = float(np.max(rot_angle(pg, pc)))
    check("GN refined pose, card vs CPU: translation m", f"{t_err:.3g}", 1e-4,
          t_err <= 1e-4)
    check("GN refined pose, card vs CPU: rotation rad", f"{r_err:.3g}", 1e-4,
          r_err <= 1e-4)


def run_main(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pf_monocular_pose_estimator_tpu.io.cli import main as cli_main
    from pf_monocular_pose_estimator_tpu.ops.blob import find_leds
    from pf_monocular_pose_estimator_tpu.pf.refine import gauss_newton_refine
    from pf_monocular_pose_estimator_tpu.tracker import TargetState
    from pf_monocular_pose_estimator_tpu.tracker.initialise import initialise
    from pf_monocular_pose_estimator_tpu.tracker.step import _corr_from_det_for_marker

    n = ctx.s["n"]
    argv = ["--synthetic", "--frames", str(ctx.s["frames"]), "--particles", str(n),
            "--pf-retries", "8", "--seed", "0", "--json"]
    if ctx.rehearse:
        argv += ["--device", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    check("CLI exit code", rc, 0, rc == 0)
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    tracked = summary["tracked_frames"] / summary["frames"]
    log(f"  CLI: {summary['frames']} frames, {summary['fps']} fps with a host "
        f"sync per frame, median step {summary['time_pose_est_ms_median']} ms "
        f"[{ctx.label}]")
    check("CLI tracked fraction", f"{tracked:.3f}", ">= 0.95", tracked >= 0.95)
    ate_mm = summary["ate_m"] * 1e3
    check("CLI ATE mm", f"{ate_mm:.3f}", "<= 10", ate_mm <= 10.0)

    # frame 0's brute-force initialisation, card vs CPU
    config = ctx.config(n)
    params = config.blob_params()
    full = jnp.asarray([0, 0, 752, 480], jnp.float32)

    def init(frame, bank):
        det = find_leds(frame, full, params, ctx.camera)
        res = initialise(ctx.camera, det, ctx.markers, ctx.mask, bank, config)
        corr, cm = _corr_from_det_for_marker(res.det_for_marker, ctx.mask)
        gn = gauss_newton_refine(ctx.camera, res.pose, ctx.markers, det.xy, corr,
                                 cm, config.gn_max_iterations,
                                 config.gn_convergence_tol)
        return res.success, res.pose, gn.pose

    init = jax.jit(init)
    bank = TargetState.create(n, jax.random.PRNGKey(0)).bank
    frame = ctx.seq.frames[0]
    og = init(*ctx.on(ctx.card, frame, bank))
    oc = init(*ctx.on(ctx.cpu, frame, bank))
    ok = bool(og[0]) and bool(oc[0])
    check("init success on card and CPU", ok, True, ok)
    for name, a, b in (("init pose", og[1], oc[1]), ("refined init pose", og[2], oc[2])):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        t_mm = float(np.linalg.norm(a[:3, 3] - b[:3, 3])) * 1e3
        r_deg = math.degrees(float(rot_angle(a, b)))
        check(f"{name}, card vs CPU: mm", f"{t_mm:.4f}", 1.0, t_mm <= 1.0)
        check(f"{name}, card vs CPU: deg", f"{r_deg:.4f}", 0.1, r_deg <= 0.1)


def run_multi(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pf_monocular_pose_estimator_tpu.io.metrics import absolute_trajectory_error
    from pf_monocular_pose_estimator_tpu.tracker.multi import create_states, make_multi_tracker

    t_n, n, frames = 4, ctx.s["multi_n"], ctx.s["multi_frames"]
    markers_t = jnp.broadcast_to(ctx.markers, (t_n,) + ctx.markers.shape)
    masks_t = jnp.ones((t_n, ctx.markers.shape[0]), bool)
    step = make_multi_tracker(ctx.camera, markers_t, masks_t, ctx.config(n))
    states = create_states(t_n, n)
    upd, est = [], []
    for i in range(frames):
        states, res = step(states, ctx.seq.frames[i], ctx.seq.times[i])
        upd.append(np.asarray(res.pose_updated))
        est.append(np.asarray(res.pose))
    upd, est = np.stack(upd), np.stack(est)
    gt = np.asarray(ctx.seq.poses[:frames])
    for k in range(t_n):
        frac = float(upd[:, k].mean())
        ate = absolute_trajectory_error(est[:, k], gt, upd[:, k]) * 1e3
        check(f"target {k}: tracked fraction", f"{frac:.3f}", ">= 0.9", frac >= 0.9)
        check(f"target {k}: ATE mm", f"{ate:.3f}", "<= 10", ate <= 10.0)


def timed(pf, args, reps, iters):
    """Median seconds per call of a pf function, from `iters` calls
    chained in one jitted fori_loop (each call's bank feeds the next, so
    none is hoisted), fenced with block_until_ready: one dispatch per
    sample, so the host's per-call overhead does not enter the time."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(args):
        def body(_, carry):
            bank, acc = carry
            bank, w = pf(args[0], bank, *args[2:])
            return bank, acc + w[0]

        return jax.lax.fori_loop(0, iters, body, (args[1], jnp.float32(0)))

    jax.block_until_ready(loop(args))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(args))
        samples.append((time.perf_counter() - t0) / iters)
    return sorted(samples)[len(samples) // 2]


def run_timing(ctx):
    import jax
    import numpy as np

    from pf_monocular_pose_estimator_tpu.tracker import TargetState, tracker_step

    reps, iters = ctx.s["reps"], ctx.s["iters"]
    for n in (ctx.s["n"], ctx.s["n_big"]):
        args = pf_scene(ctx, n)
        tk = timed(ctx.kernel_pf(), args, reps, iters)
        tx = timed(ctx.xla_pf(), args, reps, iters)
        log(f"  propagate+weight N={n}: fused kernel {tk * 1e6:.1f} us, "
            f"XLA {tx * 1e6:.1f} us per call, ratio {tx / tk:.2f} [{ctx.label}]")

    from pf_monocular_pose_estimator_tpu.pf.pallas_step import (
        fused_propagate_weight_pallas,
    )

    args = pf_scene(ctx, ctx.s["n"])
    for block, warps in ((64, 2), (128, 4), (256, 4), (256, 8)):
        def f(*a, b=block, w=warps):
            return fused_propagate_weight_pallas(
                *a[:12], ctx.camera, *a[12:], block=b, num_warps=w,
                interpret=ctx.interpret)
        log(f"  fused kernel N={ctx.s['n']} block={block} warps={warps}: "
            f"{timed(f, args, reps, iters) * 1e6:.1f} us [{ctx.label}]")

    from pf_monocular_pose_estimator_tpu.io.synthetic import make_orbit_sequence

    n, frames = ctx.s["n"], ctx.s["scan_frames"]
    config = ctx.config(n)
    seq = make_orbit_sequence(ctx.camera, ctx.markers, num_frames=frames, fps=50.0)
    fr, ts = jax.device_put(seq.frames), jax.device_put(seq.times)
    state0 = TargetState.create(n, jax.random.PRNGKey(0))

    def scan_with(pf_fn):
        @jax.jit
        def run(state, frames, times):
            def body(state, xs):
                state, res = tracker_step(state, xs[0], xs[1], ctx.camera,
                                          ctx.markers, ctx.mask, config,
                                          pf_fn=pf_fn)
                return state, res.pose_updated
            return jax.lax.scan(body, state, (frames, times))
        return run

    runs = {"fused kernel": scan_with(ctx.kernel_pf()), "XLA": scan_with(ctx.xla_pf())}
    best = {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        _, upd = jax.block_until_ready(run(state0, fr, ts))
        log(f"  scan[{name}]: compile+first run {time.perf_counter() - t0:.1f} s, "
            f"tracked {float(np.mean(np.asarray(upd))):.3f}")
        best[name] = float("inf")
    for _ in range(2):  # alternate: kernel, XLA, kernel, XLA
        for name, run in runs.items():
            t0 = time.perf_counter()
            jax.block_until_ready(run(state0, fr, ts))
            best[name] = min(best[name], time.perf_counter() - t0)
    for name, sec in best.items():
        log(f"  {frames}-frame scan N={n} [{name}]: {frames / sec:.1f} fps "
            f"({sec / frames * 1e3:.3f} ms/frame) [{ctx.label}]")


def run_mesh(ctx):
    """--multi: the four-card mesh path against the single-card runs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pf_monocular_pose_estimator_tpu.io.metrics import absolute_trajectory_error
    from pf_monocular_pose_estimator_tpu.parallel.mesh import (
        make_mesh,
        make_sharded_multi_tracker,
        make_sharded_tracker,
        shard_target_state,
    )
    from pf_monocular_pose_estimator_tpu.parallel.resample import make_distributed_resampler
    from pf_monocular_pose_estimator_tpu.pf.soa import stratified_resample_soa
    from pf_monocular_pose_estimator_tpu.tracker import TargetState, make_tracker
    from pf_monocular_pose_estimator_tpu.tracker.multi import create_states, make_multi_tracker

    frames = ctx.s["multi_frames"]
    gt = np.asarray(ctx.seq.poses[:frames])
    interp = ctx.interpret

    def track(step, state):
        upd, est = [], []
        for i in range(frames):
            state, res = step(state, ctx.seq.frames[i], ctx.seq.times[i])
            upd.append(np.asarray(res.pose_updated))
            est.append(np.asarray(res.pose))
        return np.stack(upd), np.stack(est)

    def collectives(step, state):
        hlo = step.lower(state, ctx.seq.frames[0], ctx.seq.times[0]).compile().as_text()
        ops = re.findall(
            r"\b(all-reduce|all-gather|collective-permute|reduce-scatter|all-to-all)"
            r"(?:-start)?\(", hlo)
        return {op: ops.count(op) for op in sorted(set(ops))}

    def compare(name, u1, e1, u4, e4):
        f1, f4 = float(u1.mean()), float(u4.mean())
        a1 = absolute_trajectory_error(e1, gt, u1) * 1e3
        a4 = absolute_trajectory_error(e4, gt, u4) * 1e3
        log(f"  {name}: tracked 1 card {f1:.3f} / 4 cards {f4:.3f}; "
            f"ATE 1 card {a1:.3f} mm / 4 cards {a4:.3f} mm")
        # summation order differs between the partitioned and the
        # single-card reductions, so one marginal frame may flip
        check(f"{name}: tracked fraction difference", f"{abs(f4 - f1):.3f}",
              f"<= one frame ({1 / frames:.3f})", abs(f4 - f1) <= 1 / frames + 1e-9)
        check(f"{name}: ATE difference mm", f"{abs(a4 - a1):.4f}", 1.0,
              abs(a4 - a1) <= 1.0)

    # one target, bank sharded over 4 cards
    n = ctx.s["mesh_n"]
    config = ctx.config(n)
    mesh = make_mesh(particle_devices=4, target_devices=1, devices=ctx.devices[:4])
    sharded = make_sharded_tracker(ctx.camera, ctx.markers, ctx.mask, config, mesh,
                                   interpret=interp)
    s4 = shard_target_state(TargetState.create(n, jax.random.PRNGKey(0)), mesh)
    log(f"  sharded step (1 x 4 mesh, N={n}) collectives: {collectives(sharded, s4)}")
    u4, e4 = track(sharded, s4)
    single = make_tracker(ctx.camera, ctx.markers, ctx.mask, config)
    u1, e1 = track(single, TargetState.create(n, jax.random.PRNGKey(0)))
    compare(f"one target, N={n}", u1, e1, u4, e4)

    # four targets on a (2, 2) mesh
    n = ctx.s["mesh_multi_n"]
    config = ctx.config(n)
    markers_t = jnp.broadcast_to(ctx.markers, (4,) + ctx.markers.shape)
    masks_t = jnp.ones((4, ctx.markers.shape[0]), bool)
    mesh = make_mesh(particle_devices=2, target_devices=2, devices=ctx.devices[:4])
    sharded = make_sharded_multi_tracker(ctx.camera, markers_t, masks_t, config, mesh,
                                         interpret=interp)
    s4 = shard_target_state(create_states(4, n), mesh, batched=True)
    log(f"  sharded multi step (2 x 2 mesh, 4 x {n}) collectives: "
        f"{collectives(sharded, s4)}")
    u4, e4 = track(sharded, s4)
    single = make_multi_tracker(ctx.camera, markers_t, masks_t, config)
    u1, e1 = track(single, create_states(4, n))
    for k in range(4):
        compare(f"target {k} of 4", u1[:, k], e1[:, k], u4[:, k], e4[:, k])

    # one distributed resample against the single-device resampler
    n = ctx.s["mesh_n"]
    mesh = make_mesh(particle_devices=4, target_devices=1, devices=ctx.devices[:4])
    key = jax.random.PRNGKey(5)
    w = jax.random.uniform(jax.random.PRNGKey(6), (n,)) ** 4
    w = w / jnp.sum(w)
    lane = jnp.arange(n, dtype=jnp.float32)
    bank = jnp.zeros((16, n), jnp.float32).at[0].set(lane).at[15].set(1.0)
    out = make_distributed_resampler(mesh, n)(key, w, bank)
    anc_mesh = np.asarray(out.resampled[0]).astype(np.int64)
    anc, _, _ = stratified_resample_soa(key, w)
    diff = int(np.sum(anc_mesh != np.asarray(anc)))
    clipped = int(out.clipped)
    check("distributed resample: ancestors differing (<= clipped slots)",
          f"{diff} (clipped {clipped})", "<= clipped", diff <= clipped)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the four-card mesh path and its comparison only")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at tiny sizes; prints no result line")
    args = ap.parse_args(argv)

    if args.rehearse:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
        ).strip()
    import jax

    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
    devices = jax.devices()
    if not args.rehearse and devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform}); "
              "this check runs on the card only", file=sys.stderr)
        return 1
    if args.multi and len(devices) < 4:
        print(f"chip_smoke: --multi needs 4 devices, found {len(devices)}",
              file=sys.stderr)
        return 1

    from pf_monocular_pose_estimator_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    ctx = Ctx(TINY if args.rehearse else FULL, args.rehearse)
    t_start = time.perf_counter()
    with phase("device"):
        run_device(ctx)
    if args.multi:
        with phase("mesh (4 devices)"):
            run_mesh(ctx)
        count = 4
    else:
        for name, run in (("compile", run_compile), ("parity", run_parity),
                          ("main", run_main), ("multi", run_multi),
                          ("timing", run_timing)):
            with phase(name):
                run(ctx)
        count = len(devices)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s [{ctx.label}]")
    if args.rehearse:
        log("rehearsal finished (CPU, tiny sizes): no result line")
        return 0
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
