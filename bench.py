"""Benchmark: end-to-end tracking throughput on one GPU.

Headline metric (BASELINE.md targets): frames/sec at 752x480 with a
100k-particle bank, full pipeline per frame (blob detection -> PF
propagate/weight -> stratified resample -> Gauss-Newton refine).
`vs_baseline` is against the >50 fps real-time bar (the reference repo
publishes no numbers; "real-time" at 752x480 with N=100 particles is its
only throughput claim — we run 1000x the particles).

The frame loop runs on the device as one `lax.scan` over pre-staged
frames, fenced with `jax.block_until_ready`.  The output line names the
device and the card's power limit; without a GPU the script exits 1.

  python bench.py [--particles N] [--targets T] [--frames F] [--sharded]
"""

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--targets", type=int, default=1)
    ap.add_argument("--frames", type=int, default=480)
    # sharded run over every visible card: the same tracker through the
    # mesh program (shard_map'd PF kernel + explicit distributed
    # resampler)
    ap.add_argument("--sharded", action="store_true")
    # override the ESS resampling gate (None = TrackerConfig default
    # 0.15; 0.0 = resample every accepted frame, reference semantics)
    ap.add_argument("--ess-tau", type=float, default=None)
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the persistent XLA compilation cache")
    args = ap.parse_args()
    if args.sharded and args.targets > 1:
        ap.error("--sharded and --targets are mutually exclusive "
                 "(the multi-target mesh path is chip_smoke.py --multi)")

    import jax

    from pf_monocular_pose_estimator_tpu.utils.backend import card_label, require_gpu

    devices = require_gpu()
    if not args.no_cache:
        from pf_monocular_pose_estimator_tpu.utils.compile_cache import (
            enable_persistent_cache,
        )

        enable_persistent_cache()
    import jax.numpy as jnp

    from pf_monocular_pose_estimator_tpu.io.synthetic import (
        default_camera,
        demo_markers,
        make_orbit_sequence,
    )
    from pf_monocular_pose_estimator_tpu.tracker import TargetState, tracker_step
    from pf_monocular_pose_estimator_tpu.utils import TrackerConfig

    n_particles = args.particles
    num_frames = args.frames
    camera = default_camera()
    markers = demo_markers()
    marker_mask = jnp.ones((markers.shape[0],), bool)
    cfg_kw = dict(
        n_particles=n_particles,
        min_blob_area=8.0,
        pf_max_retries=8,
        roi_particle_subsample=128,
    )
    if args.ess_tau is not None:
        cfg_kw["resample_min_ess"] = args.ess_tau
    config = TrackerConfig(**cfg_kw)

    seq = make_orbit_sequence(camera, markers, num_frames=num_frames, fps=50.0)
    frames = jax.device_put(seq.frames)
    times = jax.device_put(seq.times)

    if args.targets > 1:
        markers_t = jnp.broadcast_to(markers, (args.targets, markers.shape[0], 4))
        masks_t = jnp.ones((args.targets, markers.shape[0]), bool)

        def one(packed, frame, t):
            state, mk, mask = packed
            return tracker_step(state, frame, t, camera, mk, mask, config)

        @jax.jit
        def run_sequence(states, frames, times):
            def body(states, inputs):
                frame, t = inputs
                new_states, res = jax.lax.map(
                    lambda p: one(p, frame, t), (states, markers_t, masks_t)
                )
                return new_states, (res.fail_flag[0], res.pose_updated.all(), res.pose[0])

            return jax.lax.scan(body, states, (frames, times))

        state0 = jax.vmap(lambda k: TargetState.create(n_particles, k))(
            jax.random.split(jax.random.PRNGKey(0), args.targets)
        )
    elif args.sharded:
        from pf_monocular_pose_estimator_tpu.parallel.mesh import (
            make_mesh,
            make_sharded_tracker,
            shard_target_state,
        )

        mesh = make_mesh(particle_devices=len(devices))
        sharded_step = make_sharded_tracker(
            camera, markers, marker_mask, config, mesh
        )

        @jax.jit
        def run_sequence(state, frames, times):
            def body(state, inputs):
                frame, t = inputs
                state, res = sharded_step(state, frame, t)
                return state, (res.fail_flag, res.pose_updated, res.pose)

            return jax.lax.scan(body, state, (frames, times))

        state0 = shard_target_state(
            TargetState.create(n_particles, jax.random.PRNGKey(0)), mesh
        )
    else:

        @jax.jit
        def run_sequence(state, frames, times):
            def body(state, inputs):
                frame, t = inputs
                state, res = tracker_step(
                    state, frame, t, camera, markers, marker_mask, config
                )
                return state, (res.fail_flag, res.pose_updated, res.pose)

            return jax.lax.scan(body, state, (frames, times))

        state0 = TargetState.create(n_particles, jax.random.PRNGKey(0))
    state0 = jax.device_put(state0)

    # Warm-up / compile
    t0 = time.perf_counter()
    jax.block_until_ready(run_sequence(state0, frames, times))
    compile_s = time.perf_counter() - t0

    # Timed runs
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        state, (flags, updated, poses) = jax.block_until_ready(
            run_sequence(state0, frames, times)
        )
        best = min(best, time.perf_counter() - t0)

    fps = num_frames / best
    updated_frac = float(np.asarray(updated).mean())
    # particle-weighting throughput: >=1 PF sweep per tracked frame
    particles_per_s = fps * n_particles * args.targets

    label = f"tracking_fps_752x480_{n_particles//1000}k_particles" + (
        f"_{args.targets}targets" if args.targets > 1 else ""
    ) + ("_sharded_mesh" if args.sharded else "") + (
        f"_ess{args.ess_tau}" if args.ess_tau is not None else ""
    )
    print(
        json.dumps(
            {
                "metric": label,
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / 50.0, 3),
                "particles_weighted_per_s": round(particles_per_s),
                "updated_frames_fraction": round(updated_frac, 3),
                "compile_s": round(compile_s, 1),
                "platform": devices[0].platform,
                "device_kind": devices[0].device_kind,
                "device_count": len(devices),
                "card": card_label(),
            }
        )
    )


if __name__ == "__main__":
    main()
