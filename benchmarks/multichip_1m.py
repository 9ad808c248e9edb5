"""BASELINE configs[4] at its stated size: an end-to-end ~1M-lane
sharded run.

Runs the FULL sharded tracker step — mesh-sharded bank, shard_map'd PF,
explicit distributed resampler — at 2^20 = 1,048,576 particles on the
virtual 8-device CPU mesh (slow is fine; a handful of frames), asserting
per-frame flags and state finiteness, and records the per-device
collective bytes of the compiled program at the real size.

With --write, also writes MULTICHIP_1M.json at the repo root.
    python benchmarks/multichip_1m.py [--frames 4] [--particles 1048576]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--particles", type=int, default=1 << 20)
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from benchmarks.collective_volume import parse_collectives
    from pf_monocular_pose_estimator_tpu.geometry.se3 import exp_se3
    from pf_monocular_pose_estimator_tpu.io.synthetic import (
        default_camera,
        demo_markers,
        render_frame,
    )
    from pf_monocular_pose_estimator_tpu.parallel.mesh import (
        make_mesh,
        make_sharded_tracker,
        shard_target_state,
    )
    from pf_monocular_pose_estimator_tpu.tracker import TargetState
    from pf_monocular_pose_estimator_tpu.utils import TrackerConfig

    n = args.particles
    devices = 8
    camera = default_camera()
    markers = demo_markers()
    mask = jnp.ones((markers.shape[0],), bool)
    config = TrackerConfig(
        n_particles=n, min_blob_area=8.0, pf_max_retries=4,
        roi_particle_subsample=128,
    )
    mesh = make_mesh(particle_devices=devices)
    step = make_sharded_tracker(camera, markers, mask, config, mesh)

    pose = np.array(exp_se3(jnp.asarray([0, 0, 0, 0.1, -0.1, 0.05], jnp.float32)))
    pose[2, 3] += 1.0
    img = render_frame(camera, jnp.asarray(pose), markers, blob_sigma=1.5)
    state = shard_target_state(
        TargetState.create(n, jax.random.PRNGKey(0)), mesh
    )

    t0 = time.time()
    lowered = step.lower(state, img, jnp.asarray(0.02, jnp.float32))
    compiled = lowered.compile()
    compile_s = round(time.time() - t0, 1)
    acc = parse_collectives(compiled.as_text())

    rows = []
    t0 = time.time()
    for i in range(args.frames):
        t = jnp.asarray(0.02 * (i + 1), jnp.float32)
        state, res = step(state, img, t)
        rows.append({
            "frame": i,
            "fail_flag": int(res.fail_flag),
            "pose_updated": bool(res.pose_updated),
            "num_detections": int(res.num_detections),
            "resample_clipped": int(res.resample_clipped),
            "pose_err_mm": round(float(np.linalg.norm(
                np.asarray(res.pose)[:3, 3] - pose[:3, 3])) * 1000, 2),
        })
        print(rows[-1], flush=True)
    run_s = round(time.time() - t0, 1)

    bank = np.asarray(state.bank)
    weights = np.asarray(state.weights)
    ok = (
        all(r["pose_updated"] for r in rows[1:])
        and all(np.isfinite(bank).all() for _ in [0])
        and np.isfinite(weights).all()
        and rows[-1]["pose_err_mm"] < 50.0
        and all(r["resample_clipped"] == 0 for r in rows)
    )

    s = n // devices
    out = {
        "note": (
            "End-to-end sharded run at BASELINE configs[4]'s stated bank "
            "size: full tracker step (shard_map'd PF + explicit "
            "distributed resampler) over an 8-device virtual CPU mesh "
            "at 2^20 particles; flags, finiteness, clip diagnostics and "
            "pose error asserted; per-device collective bytes recorded "
            "from the compiled HLO at the real size."
        ),
        "particles": n,
        "devices": devices,
        "shard_particles": s,
        "frames": rows,
        "ok": bool(ok),
        "compile_s": compile_s,
        "run_s_total": run_s,
        "bank_bytes_total": int(16 * n * 4),
        "collectives_per_device": {
            k: {"count": v["count"], "bytes": v["bytes"]}
            for k, v in acc.items() if v["count"]
        },
        "ring_design_bytes_per_device": int(2 * (12 * (s // 4) + (s // 4) + 1) * 4),
        "naive_bank_all_gather_bytes": int((devices - 1) * 16 * s * 4),
    }
    print(json.dumps({k: v for k, v in out.items() if k != "frames"}, indent=1))
    if args.write:
        path = os.path.join(ROOT, "MULTICHIP_1M.json")
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {path}")


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
