"""The mesh-sharded step runs the fused PF kernel per shard.

GSPMD cannot partition a pallas_call, so parallel/pf_kernels.py runs the
fused propagate+weight kernel PER SHARD inside a shard_map, with the
uniform draws and the lane-0/1 pins taken at GLOBAL lane indices.  These
tests pin, with the kernel in the Pallas interpreter:

  * kernel level — concatenated per-shard calls (lane_offset/n_total)
    are BIT-identical to the full-bank call;
  * step level — the sharded tracker with interpret=True tracks
    identically (flags) and numerically (float-rounding tolerance, as
    in tests/test_pallas_step.py) to the unsharded XLA one over several
    frames, through init, PF and resampling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera
from pf_monocular_pose_estimator_tpu.geometry.se3 import exp_se3
from pf_monocular_pose_estimator_tpu.io.synthetic import demo_markers, render_frame
from pf_monocular_pose_estimator_tpu.parallel.mesh import (
    make_mesh,
    make_sharded_tracker,
    shard_target_state,
)
from pf_monocular_pose_estimator_tpu.pf.pallas_step import (
    fused_propagate_weight_pallas,
)
from pf_monocular_pose_estimator_tpu.pf.propagate import NoiseBounds
from pf_monocular_pose_estimator_tpu.tracker import TargetState, make_tracker
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig

N_PART = 256


@pytest.fixture(scope="module")
def camera():
    return Camera.create(fx=150.0, fy=150.0, cx=80.0, cy=48.0, width=160, height=96)


@pytest.fixture(scope="module")
def markers():
    return demo_markers()


def test_lane_offset_shards_bit_identical():
    """Per-shard kernel calls with lane_offset/n_total concatenate to
    exactly the full-bank result (draws and pins are global)."""
    key = jax.random.PRNGKey(0)
    n = 2048
    markers = jnp.concatenate(
        [jax.random.normal(key, (5, 3)) * 0.08, jnp.ones((5, 1))], axis=1
    ).astype(jnp.float32)
    mask = jnp.array([True] * 4 + [False])
    cam = Camera.create(fx=150.0, fy=150.0, cx=80.0, cy=48.0, width=160, height=96)
    det_xy = jax.random.uniform(key, (16, 2), jnp.float32, 10, 150)
    det_mask = jnp.zeros((16,), bool).at[:4].set(True)
    bank = (
        jnp.tile(jnp.eye(4, dtype=jnp.float32).reshape(16, 1), (1, n))
        .at[3, :].set(jnp.linspace(0, 0.1, n))
        .at[11, :].set(1.2)
    )
    cur = jnp.eye(4, dtype=jnp.float32).at[2, 3].set(1.2)
    eye = jnp.eye(4, dtype=jnp.float32)
    common = dict(
        noise=NoiseBounds(-0.01, 0.01, -0.02, 0.02),
        fac_trans=jnp.float32(1.0), fac_rot=jnp.float32(1.0),
        tracking=jnp.asarray(True), apply_prediction=jnp.asarray(True),
        inflation=jnp.float32(1.0), camera=cam, markers_h=markers,
        marker_mask=mask, det_xy=det_xy, det_mask=det_mask,
        tol_pf=jnp.float32(18.0), tol_init=jnp.float32(6.0),
        downgrade=jnp.zeros((5,), bool),
    )
    b_full, w_full = fused_propagate_weight_pallas(
        key, bank, cur, cur, eye, eye, **common, interpret=True,
    )
    shards = 4
    s = n // shards
    banks, ws = [], []
    for i in range(shards):
        b_i, w_i = fused_propagate_weight_pallas(
            key, bank[:, i * s : (i + 1) * s], cur, cur, eye, eye, **common,
            interpret=True, lane_offset=jnp.int32(i * s), n_total=n,
        )
        banks.append(b_i)
        ws.append(w_i)
    np.testing.assert_array_equal(
        np.asarray(jnp.concatenate(banks, axis=1)), np.asarray(b_full)
    )
    np.testing.assert_array_equal(
        np.asarray(jnp.concatenate(ws)), np.asarray(w_full)
    )


def test_sharded_step_with_pallas_matches_unsharded(camera, markers):
    config = TrackerConfig(
        n_particles=N_PART,
        threshold_value=150.0,
        min_blob_area=3.0,
        pf_max_retries=4,
        max_detections=12,
        max_correspondence_candidates=8,
        roi_particle_subsample=16,
    )
    pose = np.array(exp_se3(jnp.asarray([0.0, 0.0, 0.0, 0.1, -0.1, 0.05], jnp.float32)))
    pose[2, 3] += 1.0
    img = render_frame(camera, jnp.asarray(pose), markers, blob_sigma=1.5)
    state = TargetState.create(N_PART, jax.random.PRNGKey(3), (camera.width, camera.height))

    plain = make_tracker(camera, markers, jnp.ones(5, bool), config)
    mesh = make_mesh(particle_devices=4, target_devices=2)
    sharded = make_sharded_tracker(
        camera, markers, jnp.ones(5, bool), config, mesh, interpret=True
    )

    s1, s2 = state, shard_target_state(state, mesh)
    for i in range(5):
        t = jnp.asarray(0.02 * (i + 1), jnp.float32)
        s1, r1 = plain(s1, img, t)
        s2, r2 = sharded(s2, img, t)
        assert int(r1.fail_flag) == int(r2.fail_flag), f"frame {i}"
        np.testing.assert_allclose(
            np.asarray(r1.pose), np.asarray(r2.pose), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(s1.bank), np.asarray(s2.bank), atol=1e-4
        )
        # distributed-resampler clip diagnostic (FrameResult.resample_clipped):
        # healthy tracking never exceeds the auto payload window
        assert int(r2.resample_clipped) == 0, f"frame {i}"
