"""Adversarial A/B: reference CPU pipeline vs engine on the realistic golden
and on the outlier config.

The reference's operative validation is real-bag replay
(pf_mpe/launch/UAV_Target.launch:63-64); in this environment the honest
substitute is the committed recorded-footage-style golden
(tests/golden/realistic_sequence.npz: clutter, hot patches, streaks,
moving LED-like distractors, motion blur, flicker) — replayed through
BOTH the test-only CPU reference port with genuine OpenCV detection
(tests/oracle/ref_pipeline.py) and the engine, at matched settings, so
the BASELINE "<= reference ATE" claim is graded exactly where the
detection front-end is stressed the way led_detector.cpp:98-102 exists
for.

Also re-runs the outlier-config A/B (1 occlusion + 2 spurious
blobs/frame, the reference's own fault-injection mechanism) at matched
particle counts, 5 seeds per side.

Prints the A/B rows as JSON.  Usage:
    python benchmarks/realistic_ab.py [--particles 500] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np


def _ate_mm(poses, gt, upd):
    if not upd.any():
        return None
    err = np.linalg.norm(poses[upd][:, :3, 3] - gt[upd][:, :3, 3], axis=-1)
    return round(float(err.mean()) * 1000, 2)


def _ori_deg(poses, gt, upd):
    if not upd.any():
        return None
    r_rel = np.einsum("tij,tkj->tik", poses[upd][:, :3, :3], gt[upd][:, :3, :3])
    tr = np.clip((np.trace(r_rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    return round(float(np.degrees(np.arccos(tr)).mean()), 3)


def run_engine(camera, markers4, config, frames, times, seed=0):
    import jax
    import jax.numpy as jnp

    from pf_monocular_pose_estimator_tpu.tracker import TargetState, make_tracker

    step = make_tracker(
        camera, jnp.asarray(markers4), jnp.ones((len(markers4),), bool), config
    )
    state = TargetState.create(config.n_particles, jax.random.PRNGKey(seed))
    poses, upd = [], []
    fr = jnp.asarray(frames, jnp.float32)
    for i in range(len(frames)):
        state, res = step(state, fr[i], jnp.asarray(float(times[i]), jnp.float32))
        poses.append(np.asarray(res.pose))
        upd.append(bool(res.pose_updated))
    return np.stack(poses), np.asarray(upd)


def realistic_ab(n_particles: int):
    from oracle.ref_pipeline import run_sequence

    from pf_monocular_pose_estimator_tpu.io.synthetic import default_camera
    from pf_monocular_pose_estimator_tpu.utils import TrackerConfig

    g = np.load(os.path.join(ROOT, "tests", "golden", "realistic_sequence.npz"))
    camera = default_camera()
    markers4 = np.concatenate([g["markers"], np.ones((len(g["markers"]), 1))], 1)
    gt = g["poses"]
    cam = dict(
        fx=float(camera.fx), fy=float(camera.fy),
        cx=float(camera.cx), cy=float(camera.cy),
        dist=np.asarray(camera.dist, np.float64),
    )
    # matched detection front-end settings (the realistic_golden.yaml
    # deployment tune: threshold above the ambient clutter)
    det = dict(threshold_value=180.0, min_blob_area=8.0, max_blob_area=160.0)

    t0 = time.time()
    poses_o, upd_o, _ = run_sequence(
        g["frames"], g["times"], markers4.astype(np.float64), cam,
        n_particles=n_particles, seed=0, **det,
    )
    oracle_s = round(time.time() - t0, 1)

    config = TrackerConfig(
        n_particles=n_particles,
        pf_max_retries=20,
        init_cluster_radius=120.0,
        init_cluster_min=5,
        **det,
    )
    poses_e, upd_e = run_engine(camera, markers4, config, g["frames"], g["times"])

    return {
        "sequence": "tests/golden/realistic_sequence.npz (120 frames, clutter + distractors + blur + flicker)",
        "matched_settings": {**det, "n_particles": n_particles},
        "oracle": {
            "tracked": round(float(upd_o.mean()), 3),
            "ate_mm": _ate_mm(poses_o, gt, upd_o),
            "ori_deg": _ori_deg(poses_o, gt, upd_o),
            "wall_s": oracle_s,
        },
        "engine": {
            "tracked": round(float(upd_e.mean()), 3),
            "ate_mm": _ate_mm(poses_e, gt, upd_e),
            "ori_deg": _ori_deg(poses_e, gt, upd_e),
        },
    }


def outlier_ab(n_particles: int, n_seeds: int = 5):
    from oracle.ref_pipeline import run_sequence

    from pf_monocular_pose_estimator_tpu.io.synthetic import (
        default_camera,
        demo_markers,
        make_orbit_sequence,
    )
    from pf_monocular_pose_estimator_tpu.utils import TrackerConfig

    camera = default_camera()
    markers = np.asarray(demo_markers())
    seq = make_orbit_sequence(camera, markers, num_frames=40, fps=50.0)
    gt = np.asarray(seq.poses)
    frames_u8 = np.clip(np.asarray(seq.frames), 0, 255).astype(np.uint8)
    cam = dict(
        fx=float(camera.fx), fy=float(camera.fy),
        cx=float(camera.cx), cy=float(camera.cy),
        dist=np.asarray(camera.dist, np.float64),
    )

    rows_o, rows_e = [], []
    for seed in range(n_seeds):
        poses_o, upd_o, _ = run_sequence(
            frames_u8, np.asarray(seq.times), markers.astype(np.float64), cam,
            n_particles=n_particles, seed=seed, min_blob_area=8.0,
            num_occlusions=1, num_false_detections=2,
        )
        rows_o.append(
            {"tracked": round(float(upd_o.mean()), 3),
             "ate_mm": _ate_mm(poses_o, gt, upd_o),
             "ori_deg": _ori_deg(poses_o, gt, upd_o)}
        )
        cfg = TrackerConfig(
            n_particles=n_particles, min_blob_area=8.0, pf_max_retries=8,
            number_of_occlusions=1, number_of_false_detections=2,
        )
        poses_e, upd_e = run_engine(
            camera, markers, cfg, np.asarray(seq.frames), np.asarray(seq.times),
            seed=seed,
        )
        rows_e.append(
            {"tracked": round(float(upd_e.mean()), 3),
             "ate_mm": _ate_mm(poses_e, gt, upd_e),
             "ori_deg": _ori_deg(poses_e, gt, upd_e)}
        )
        print(f"seed {seed}: oracle {rows_o[-1]} engine {rows_e[-1]}", flush=True)

    def agg(rows, key):
        vals = [r[key] for r in rows if r[key] is not None]
        return round(float(np.mean(vals)), 3) if vals else None

    return {
        "sequence": "40-frame orbit, 1 occlusion + 2 near-clone spurious blobs/frame",
        "matched_settings": {"n_particles": n_particles, "seeds": n_seeds},
        "oracle": {"per_seed": rows_o, "tracked_mean": agg(rows_o, "tracked"),
                   "ate_mm_mean": agg(rows_o, "ate_mm"), "ori_deg_mean": agg(rows_o, "ori_deg")},
        "engine": {"per_seed": rows_e, "tracked_mean": agg(rows_e, "tracked"),
                   "ate_mm_mean": agg(rows_e, "ate_mm"), "ori_deg_mean": agg(rows_e, "ori_deg")},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=500)
    ap.add_argument("--outlier-particles", type=int, default=1000)
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-outlier", action="store_true")
    args = ap.parse_args()

    out = {"realistic_golden_ab": realistic_ab(args.particles)}
    print(json.dumps(out["realistic_golden_ab"], indent=1), flush=True)
    if not args.skip_outlier:
        out["outlier_ab"] = outlier_ab(args.outlier_particles, args.seeds)
        print(json.dumps(out["outlier_ab"], indent=1), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
