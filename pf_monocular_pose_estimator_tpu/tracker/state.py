"""Tracker state as an explicit pytree.

Replaces the reference's mutable per-object `_Vec` members and hidden
function-static variables (pose_estimator.h:65-118; SURVEY.md §5 notes the
static-variable cross-instance hazard this design removes): every frame is
`state -> (state', result)`, deterministic given the PRNG key, trivially
checkpointable, and vmappable over targets.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.exposure import ExposureState


class TargetState(NamedTuple):
    """Per-target tracker state (one reference `objectNumber`)."""

    key: jax.Array  # PRNG state (replaces rand()/random_device)
    current_pose: jnp.ndarray  # (4,4) object->camera, last optimised
    previous_pose: jnp.ndarray  # (4,4)
    predicted_pose: jnp.ndarray  # (4,4)
    covariance: jnp.ndarray  # (6,6)
    # Particle banks live in SoA (16, N) layout — 16 row-major pose
    # entries, particles along the minor (contiguous) axis (see
    # pf/soa.py): every per-particle row op reads one contiguous row,
    # and keeping state natively SoA avoids AoS<->SoA relayouts.
    bank: jnp.ndarray  # (16, N) PoseParticle
    resampled: jnp.ndarray  # (16, N) newPoseEstimation
    weights: jnp.ndarray  # (N,) normalised particle weights
    it_since_initialized: jnp.ndarray  # int32, capped at 2
    uncertainty: jnp.ndarray  # int32 consecutive-failure counter
    # consecutive accepted frames whose best particle explains fewer
    # than all markers — a sustained run indicates a wrong-but-self-
    # consistent pose lock (engine extension; see TrackerConfig.
    # degraded_reinit_frames)
    degraded_frames: jnp.ndarray  # int32
    # consecutive coasted (rejected-but-kept) frames on a mature track
    # (engine extension; see TrackerConfig.pf_coast_frames)
    coast_frames: jnp.ndarray  # int32
    # cumulative count of resampling draws the distributed resampler
    # clamped because their ancestor lay beyond the ring reach / payload
    # window (parallel.resample.DistResampleOut.clipped) — nonzero means
    # per-shard weight skew exceeded the configured ring payload and the
    # overflow draws were replaced by the most-copied local particle;
    # always 0 on the unsharded path.  Surfaced per frame in
    # FrameResult.resample_clipped so skew-induced degradation is
    # observable (round-4 advisor finding).
    resample_clipped: jnp.ndarray  # int32
    roi: jnp.ndarray  # (4,) [x0,y0,w,h]
    time_current: jnp.ndarray  # f32
    time_previous: jnp.ndarray  # f32
    fail_flag: jnp.ndarray  # int32 (FailFlag, x10 codes)
    pose_updated: jnp.ndarray  # bool
    num_gn_iterations: jnp.ndarray  # int32 (PubData.numIter)
    # Observer-camera ego-motion compensation (bUseCamPos, :239-396)
    obs_cam_old: jnp.ndarray  # (4,4)
    change_cam_pose: jnp.ndarray  # (4,4)
    time_obs_act: jnp.ndarray  # f32
    cam_time_shift: jnp.ndarray  # f32
    # online exposure control (led_detector.cpp:124-165, 490-512),
    # threaded through the step so library/multi-target users get the
    # recommendation in FrameResult.exposure_us (round-1 weak #7)
    exposure: ExposureState

    @classmethod
    def create(cls, n_particles: int, key=None, image_size=(752, 480), dtype=jnp.float32):
        if key is None:
            key = jax.random.PRNGKey(0)

        # Each leaf gets its own buffer (`eye + 0` forces materialisation):
        # aliased leaves break argument donation in the sharded step.
        def eye():
            return jnp.eye(4, dtype=dtype) + 0.0

        return cls(
            key=key,
            current_pose=eye(),
            previous_pose=eye(),
            predicted_pose=eye(),
            covariance=jnp.eye(6, dtype=dtype),
            # distinct materialised buffers (not aliased broadcasts) so the
            # sharded step can donate the whole state
            bank=jnp.tile(eye().reshape(16, 1), (1, n_particles)),
            resampled=jnp.tile(eye().reshape(16, 1), (1, n_particles)),
            weights=jnp.full((n_particles,), 1.0 / n_particles, dtype),
            it_since_initialized=jnp.zeros((), jnp.int32),
            uncertainty=jnp.zeros((), jnp.int32),
            degraded_frames=jnp.zeros((), jnp.int32),
            coast_frames=jnp.zeros((), jnp.int32),
            resample_clipped=jnp.zeros((), jnp.int32),
            roi=jnp.asarray([0, 0, image_size[0], image_size[1]], dtype),
            time_current=jnp.zeros((), dtype),
            time_previous=jnp.asarray(-1.0, dtype),
            fail_flag=jnp.asarray(-10, jnp.int32),
            pose_updated=jnp.asarray(False),
            num_gn_iterations=jnp.zeros((), jnp.int32),
            obs_cam_old=eye(),
            change_cam_pose=eye(),
            time_obs_act=jnp.zeros((), dtype),
            cam_time_shift=jnp.asarray(1.0, dtype),
            exposure=ExposureState.create(),
        )


class FrameResult(NamedTuple):
    """Per-frame outputs (the reference's publisher payload:
    pose + covariance, FailFlag, timings, detections, diagnostics —
    monocular_pose_estimator.cpp:59-72, SURVEY.md §5)."""

    pose: jnp.ndarray  # (4,4) object->camera
    pose_inverse: jnp.ndarray  # (4,4) camera->object (the published one)
    covariance: jnp.ndarray  # (6,6)
    pose_updated: jnp.ndarray  # bool — pose valid this frame
    fail_flag: jnp.ndarray  # int32
    num_detections: jnp.ndarray  # int32
    num_gn_iterations: jnp.ndarray  # int32
    used_brute_force: jnp.ndarray  # bool (PubData.bPred == 0)
    detections_xy: jnp.ndarray  # (K,2) undistorted
    detections_mask: jnp.ndarray  # (K,)
    # fault-injection provenance for colour-coded diagnostics
    # (visualization.cpp:260-275: true=green, fake=yellow, occluded=red)
    detections_occluded: jnp.ndarray  # (K,) coordinates stay in detections_xy
    detections_injected: jnp.ndarray  # (K,)
    roi: jnp.ndarray  # (4,)
    best_weight: jnp.ndarray  # highest un-normalised particle weight
    blob_area_sum: jnp.ndarray  # total detected blob area (exposure ctrl)
    exposure_us: jnp.ndarray  # current exposure recommendation
    # cumulative distributed-resampler clip counter (see
    # TargetState.resample_clipped); 0 unless a mesh-sharded run hit
    # per-shard weight skew beyond the ring payload
    resample_clipped: jnp.ndarray  # int32
