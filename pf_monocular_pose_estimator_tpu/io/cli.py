"""run_tracker CLI — the launch-file replacement.

Functional parity target: the reference's 14 launch files + MPENode entry
points (pf_mpe/launch/*, pf_mpe/src/node.cpp): one command that loads a
camera calibration + marker YAML (or synthesises a sequence), runs the
tracker over the frames, and reports per-frame status, timings and — when
ground truth exists — ATE / orientation error.

Usage:
  python -m pf_monocular_pose_estimator_tpu.io.cli --synthetic \
      --frames 60 --particles 1000 [--device cpu|gpu] [--save-video out.npz]
  python -m pf_monocular_pose_estimator_tpu.io.cli \
      --camera cam.yaml --markers markers.yaml --sequence frames.npz
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description="LED-marker 6-DoF pose tracker")
    p.add_argument(
        "--config",
        type=str,
        help="experiment YAML (io/experiment.py — the launch-file tier); "
        "explicit CLI flags override file values",
    )
    p.add_argument("--synthetic", action="store_true", help="run on a synthetic orbit sequence")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--fps", type=float, default=None)
    p.add_argument("--particles", type=int, default=None)
    p.add_argument("--camera", type=str, help="camera calibration YAML")
    p.add_argument("--markers", type=str, help="marker positions YAML (reference schema)")
    p.add_argument("--markers-per-object", type=int, nargs="*", help="numberOfMarkersUAVk split")
    p.add_argument(
        "--sequence", type=str,
        help="npz with frames (T,H,W) and times (T,), or a recorded .pfsq container",
    )
    p.add_argument(
        "--record", type=str,
        help="record the input sequence to this .pfsq container (rosbag-record analogue)",
    )
    p.add_argument(
        "--device", type=str, default=None, choices=["cpu", "gpu"],
        help="platform to run on (default: JAX's default); gpu without a "
        "GPU is an error",
    )
    p.add_argument("--no-cache", action="store_true",
                   help="disable the persistent XLA compilation cache")
    p.add_argument("--occlusions", type=int, default=None)
    p.add_argument("--false-detections", type=int, default=None)
    p.add_argument("--pf-retries", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--save-video", type=str, help="write annotated frames to .npz (single-target runs)")
    p.add_argument("--checkpoint", type=str, help="save final tracker state here")
    p.add_argument("--json", action="store_true", help="machine-readable summary only")
    p.add_argument(
        "--exposure-control",
        action="store_true",
        help="run the online exposure state machine (reports exposure_us)",
    )
    p.add_argument("--expose-time-base", type=float, default=None)
    p.add_argument(
        "--num-targets",
        type=int,
        default=None,
        help="track multiple objects (markers split via --markers-per-object, "
        "or the same marker set replicated)",
    )
    p.add_argument("--profile", type=str, help="capture a jax.profiler trace to this dir")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    exp = {"tracker": {}, "run": {}}
    if args.config:
        from ..io.experiment import load_experiment

        exp = load_experiment(args.config)
        run = exp["run"]
        # file fills anything the CLI left unset
        if args.camera is None:
            args.camera = exp["camera"]
        if args.markers is None:
            args.markers = exp["markers"]
        if args.markers_per_object is None:
            args.markers_per_object = exp["markers_per_object"]
        if args.num_targets is None:
            args.num_targets = exp["num_targets"]
        if args.sequence is None:
            args.sequence = run.get("sequence")
        if not args.synthetic:
            args.synthetic = bool(run.get("synthetic", False))
        for name in ("frames", "fps", "seed"):
            if getattr(args, name) is None and name in run:
                setattr(args, name, run[name])

    # tracker-field precedence: explicit CLI flag > experiment file >
    # built-in (mirrors roslaunch arg > launch value > param default)
    cli_tracker = {}
    if args.particles is not None:
        cli_tracker["n_particles"] = args.particles
    if args.pf_retries is not None:
        cli_tracker["pf_max_retries"] = args.pf_retries
    if args.occlusions is not None:
        cli_tracker["number_of_occlusions"] = args.occlusions
    if args.false_detections is not None:
        cli_tracker["number_of_false_detections"] = args.false_detections
    if args.exposure_control:
        cli_tracker["use_online_exposure_control"] = True
    if args.expose_time_base is not None:
        cli_tracker["expose_time_base"] = args.expose_time_base
    tracker_overrides = {**exp["tracker"], **cli_tracker}

    # built-in defaults for anything still unset
    for name, default in (
        ("frames", 60), ("fps", 50.0), ("seed", 0), ("num_targets", 1),
    ):
        if getattr(args, name) is None:
            setattr(args, name, default)

    import jax

    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif args.device == "gpu" and jax.default_backend() != "gpu":
        print(
            f"error: --device gpu, but JAX found no GPU "
            f"(default backend: {jax.default_backend()})",
            file=sys.stderr,
        )
        return 2
    if not args.no_cache:
        # persistent compilation cache: the reference node starts
        # instantly (node.cpp:28-37); warm CLI starts skip the cold XLA
        # compile (utils/compile_cache.py)
        from ..utils.compile_cache import enable_persistent_cache

        enable_persistent_cache()
    import jax.numpy as jnp
    import numpy as np

    from ..io.markers import load_camera_calibration, load_marker_positions
    from ..io.metrics import absolute_trajectory_error, orientation_error_deg
    from ..io.synthetic import default_camera, demo_markers, make_orbit_sequence
    from ..tracker import TargetState, make_tracker
    from ..utils import TrackerConfig
    from ..utils.checkpoint import save_state

    if args.camera:
        camera = load_camera_calibration(args.camera)
    else:
        camera = default_camera()

    if args.markers:
        marker_sets = load_marker_positions(args.markers, args.markers_per_object)
        markers = jnp.asarray(marker_sets[0])
    else:
        markers = demo_markers()

    gt_poses = None
    if args.sequence:
        if args.sequence.endswith(".pfsq"):
            # recorded-sequence container (native mmap replay; the
            # rosbag-play analogue — see io/seqio.py)
            from ..io.seqio import SequenceReader

            with SequenceReader(args.sequence) as reader:
                f_np, t_np = reader.arrays()
            frames = jnp.asarray(f_np, jnp.float32)
            times = jnp.asarray(t_np, jnp.float32)
        else:
            data = np.load(args.sequence)
            frames = jnp.asarray(data["frames"], jnp.float32)
            times = jnp.asarray(
                data["times"] if "times" in data else np.arange(frames.shape[0]) / args.fps,
                jnp.float32,
            )
            if "poses" in data:
                gt_poses = np.asarray(data["poses"])
    elif args.synthetic:
        seq = make_orbit_sequence(
            camera, markers, num_frames=args.frames, fps=args.fps, seed=args.seed
        )
        frames, times, gt_poses = seq.frames, seq.times, np.asarray(seq.poses)
    else:
        print("error: provide --synthetic or --sequence", file=sys.stderr)
        return 2

    if args.record:
        from ..io.seqio import record_sequence

        record_sequence(
            args.record,
            np.clip(np.asarray(frames), 0, 255).astype(np.uint8),
            np.asarray(times),
        )
        if not args.json:
            print(f"recorded {frames.shape[0]} frames -> {args.record}")

    config = TrackerConfig(
        **{
            "n_particles": 1000,
            "min_blob_area": 8.0,
            "pf_max_retries": 20,
            **tracker_overrides,
        }
    )
    multi = args.num_targets > 1
    if multi:
        from ..tracker.multi import create_states, make_multi_tracker, pad_marker_sets

        if args.markers and args.markers_per_object:
            marker_sets = load_marker_positions(args.markers, args.markers_per_object)
            markers_t, masks_t = pad_marker_sets(marker_sets)
        else:
            markers_t = jnp.broadcast_to(
                markers, (args.num_targets, markers.shape[0], 4)
            )
            masks_t = jnp.ones((args.num_targets, markers.shape[0]), bool)
        step = make_multi_tracker(camera, markers_t, masks_t, config)
        state = create_states(
            args.num_targets, config.n_particles, args.seed, (camera.width, camera.height)
        )
    else:
        step = make_tracker(camera, markers, jnp.ones((markers.shape[0],), bool), config)
        state = TargetState.create(config.n_particles, jax.random.PRNGKey(args.seed))

    profile_ctx = None
    if args.profile:
        profile_ctx = jax.profiler.trace(args.profile)
        profile_ctx.__enter__()


    est, upd, flags, annotated = [], [], [], []
    # Per-frame latency parity with the reference's timePoseEst /
    # timeInitEst topics (monocular_pose_estimator.cpp:466-472):
    # timePoseEst = whole-step wall time; timeInitEst = the same frame's
    # time when the brute-force initialiser ran (the reference measures
    # init duration inside the engine, pose_estimator.cpp:133,212-213).
    time_pose_est_ms, time_init_est_ms = [], []
    t_start = time.perf_counter()
    for i in range(frames.shape[0]):
        t0 = time.perf_counter()
        state, res = step(state, frames[i], times[i])
        jax.block_until_ready(res.pose)
        dt_ms = (time.perf_counter() - t0) * 1e3
        time_pose_est_ms.append(round(dt_ms, 3))
        time_init_est_ms.append(
            round(dt_ms, 3) if bool(np.any(np.asarray(res.used_brute_force))) else 0.0
        )
        est.append(np.asarray(res.pose))
        if multi:
            upd.append(np.asarray(res.pose_updated))
            flags.append(np.asarray(res.fail_flag).tolist())
        else:
            upd.append(bool(res.pose_updated))
            flags.append(int(res.fail_flag))
        if args.save_video and not multi:
            from ..io.viz import render_overlay
            from ..pf.soa import unpack

            annotated.append(
                render_overlay(frames[i], camera, res, np.asarray(unpack(state.bank)), np.asarray(state.weights))
            )
        if not args.json:
            tag = "TRACK" if np.all(upd[-1]) else "----"
            print(
                f"frame {i:4d}  t={float(times[i]):7.3f}s  [{tag}] "
                f"flag={flags[-1]}  t_pose={dt_ms:7.2f}ms"
            )
    wall = time.perf_counter() - t_start
    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)

    est = np.stack(est)
    upd_arr = np.asarray(upd)
    summary = {
        "frames": int(frames.shape[0]),
        "tracked_frames": int(np.all(upd_arr.reshape(len(upd), -1), axis=-1).sum()),
        "wall_s": round(wall, 3),
        "fps": round(frames.shape[0] / wall, 2),
        "flags": flags,
        "time_pose_est_ms": time_pose_est_ms,
        "time_init_est_ms": time_init_est_ms,
        # steady-state latency: median over post-warmup frames
        "time_pose_est_ms_median": round(
            float(np.median(time_pose_est_ms[1:] or time_pose_est_ms)), 3
        ),
    }
    if gt_poses is not None and not multi:
        summary["ate_m"] = absolute_trajectory_error(est, gt_poses, upd_arr)
        summary["orientation_err_deg"] = orientation_error_deg(est, gt_poses, upd_arr)
    elif gt_poses is not None:
        # gt_poses may be (T, 4, 4) — every target tracks the same object
        # — or (T, K, 4, 4) with one trajectory per target (the two-UAV
        # bag analogue, README.md:417-451)
        gt_k = (
            (lambda k: gt_poses[:, k]) if gt_poses.ndim == 4 else (lambda k: gt_poses)
        )
        summary["ate_m_per_target"] = [
            absolute_trajectory_error(est[:, k], gt_k(k), upd_arr[:, k])
            for k in range(args.num_targets)
        ]
        summary["tracked_fraction_per_target"] = [
            round(float(upd_arr[:, k].mean()), 4) for k in range(args.num_targets)
        ]

    if config.use_online_exposure_control:
        summary["exposure_us"] = float(np.asarray(res.exposure_us).reshape(-1)[0])
    if args.save_video and annotated:
        np.savez_compressed(args.save_video, frames=np.stack(annotated))
        summary["video"] = args.save_video
    if args.checkpoint:
        save_state(args.checkpoint, state)
        summary["checkpoint"] = args.checkpoint

    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
