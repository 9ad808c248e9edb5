"""Parameter-sweep harness — the test1/2/3.launch analogue.

The reference ships 14 launch files whose sweep variants rerun the same
bag with different noise bounds / particle counts / tolerances
(/root/reference/pf_mpe/launch/test1.launch and siblings).  This driver
does the same against the synthetic orbit: a YAML grid file declares a
base tracker config and a set of axes; every cell of the cartesian
product runs end-to-end and the results are published as one JSON
artifact plus a markdown matrix.

Grid YAML schema (configs/sweeps/*.yaml):
    base:   {tracker-config overrides common to all cells}
    axes:   {field: [values, ...], ...}     # cartesian product
    run:    {frames: 40, fps: 50.0, seeds: 1}
Symmetric noise shorthand: setting `max_translation_noise` /
`max_angular_noise` as an axis also sets the matching `min_*` to the
negated value (the reference's launch files sweep them in pairs).

Usage:
    python benchmarks/sweep.py configs/sweeps/reference_grid.yaml \
        [--out sweep.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_SYMMETRIC = {
    "max_translation_noise": "min_translation_noise",
    "max_angular_noise": "min_angular_noise",
}


def run_cell(camera, markers, config, seq, seeds):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pf_monocular_pose_estimator_tpu.io.metrics import (
        absolute_trajectory_error,
        orientation_error_deg,
    )
    from pf_monocular_pose_estimator_tpu.tracker import TargetState, make_tracker

    step = make_tracker(camera, markers, jnp.ones(markers.shape[0], bool), config)
    gt = np.asarray(seq.poses)
    tracked, ates, oris = [], [], []
    for seed in range(seeds):
        state = TargetState.create(config.n_particles, jax.random.PRNGKey(seed))
        est, upd = [], []
        for i in range(seq.frames.shape[0]):
            state, res = step(state, seq.frames[i], seq.times[i])
            est.append(np.asarray(res.pose))
            upd.append(bool(res.pose_updated))
        est, upd = np.stack(est), np.asarray(upd)
        tracked.append(float(upd.mean()))
        ates.append(
            round(absolute_trajectory_error(est, gt, upd) * 1000, 2)
            if upd.any() else None
        )
        oris.append(
            round(orientation_error_deg(est, gt, upd), 2) if upd.any() else None
        )
    return {
        "tracked": round(float(sum(tracked) / len(tracked)), 3),
        "ate_mm": ates if seeds > 1 else ates[0],
        "ori_deg": oris if seeds > 1 else oris[0],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("grid", help="sweep grid YAML")
    ap.add_argument("--out", default=None, help="output JSON path")
    ap.add_argument("--md", default=None, help="output markdown path")
    ap.add_argument("--device", default=None, choices=[None, "cpu"])
    args = ap.parse_args()

    import yaml

    with open(args.grid) as f:
        grid = yaml.safe_load(f)

    import jax

    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from pf_monocular_pose_estimator_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    enable_persistent_cache()

    from pf_monocular_pose_estimator_tpu.io.synthetic import (
        default_camera,
        demo_markers,
        make_orbit_sequence,
    )
    from pf_monocular_pose_estimator_tpu.utils import TrackerConfig

    camera = default_camera()
    markers = demo_markers()
    run = grid.get("run", {})
    seq = make_orbit_sequence(
        camera, markers,
        num_frames=int(run.get("frames", 40)),
        fps=float(run.get("fps", 50.0)),
    )
    seeds = int(run.get("seeds", 1))

    axes = grid.get("axes", {})
    names = list(axes.keys())
    cells = []
    t_all = time.time()
    for values in itertools.product(*(axes[k] for k in names)):
        overrides = dict(grid.get("base", {}))
        for k, v in zip(names, values):
            overrides[k] = v
            if k in _SYMMETRIC:
                overrides[_SYMMETRIC[k]] = -v
        config = TrackerConfig(**overrides)
        t0 = time.time()
        res = run_cell(camera, markers, config, seq, seeds)
        cell = {
            "params": dict(zip(names, values)),
            **res,
            "wall_s": round(time.time() - t0, 1),
        }
        cells.append(cell)
        print(json.dumps(cell), flush=True)

    out = {
        "note": (
            "Parameter-sweep matrix (the reference's test1/2/3.launch "
            "analogue): cartesian grid over the axes below, each cell a "
            f"full end-to-end run on the {seq.frames.shape[0]}-frame "
            f"synthetic orbit, {seeds} seed(s)/cell."
        ),
        "grid_file": os.path.relpath(args.grid, ROOT),
        "base": grid.get("base", {}),
        "axes": axes,
        "seeds": seeds,
        "device": str(jax.devices()[0]),
        "cells": cells,
        "wall_s_total": round(time.time() - t_all, 1),
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")

    if args.md:
        lines = [
            "# Sweep matrix — " + os.path.basename(args.grid),
            "",
            out["note"], "",
            "| " + " | ".join(names) + " | tracked | ATE (mm) | orientation (deg) |",
            "|" + "---|" * (len(names) + 3),
        ]
        for c in cells:
            lines.append(
                "| " + " | ".join(str(c["params"][k]) for k in names)
                + f" | {c['tracked']} | {c['ate_mm']} | {c['ori_deg']} |"
            )
        with open(args.md, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {args.md}")


if __name__ == "__main__":
    main()
