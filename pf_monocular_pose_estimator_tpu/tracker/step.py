"""The per-frame tracking state machine, fully jittable.

Functional parity target: PoseEstimator::estimateBodyPose — the PF branch
(pf_mpe_lib/src/pose_estimator.cpp:69-737), i.e. the whole of SURVEY.md
§3.2/§3.3 as one compiled program:

  init needed?  ──yes──► grow ROI by uncertainty ─► detect ─► brute-force
      │                   initialise ─► GN refine ─► update     (stack 3.3)
      no
      ▼
  predict (const-velocity ∘ observer ego-motion) ─► ROI from predicted
  particle pixels ─► detect (adaptive blob areas, retry with grown ROI)
  ─► fault injection ─► PF retry loop (propagate → weight, keep best)
  ─► gates ─► [marginal: short-P3P / forced re-init ladder]
  ─► stratified resample ─► GN refine most-resampled ─► update  (stack 3.2)

The reference's data-dependent control flow (init vs track, retry-until-
good-weight, recovery ladder) maps to `lax.cond` / `lax.while_loop` with
fixed-shape carries — no host round-trip per frame.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.camera import Camera, project
from ..geometry.se3 import exp_se3, inverse, log_se3, predict_constant_velocity
from ..ops.blob import Detections, determine_roi, find_leds, grow_roi
from ..ops.exposure import exposure_control
from ..ops.faults import inject_faults
from ..pf.propagate import NoiseBounds, propagation_noise_factors
from ..pf.refine import gauss_newton_refine
from ..pf.pallas_step import fused_propagate_weight_pallas
from ..pf.weight import weight_particles
from ..pf.soa import (
    gather_soa,
    pick_lane,
    propagate_soa,
    stratified_resample_closed,
    stratified_resample_soa,
    unpack,
    weight_particles_soa,
)
from ..utils.backend import pf_route
from ..utils.config import TrackerConfig
from ..utils.dynamic import DynamicParams
from ..utils.flags import FailFlag
from .initialise import initialise
from .short_p3p import short_p3p
from .state import FrameResult, TargetState

# Hard-coded observer-camera mounting rotation (pose_estimator.cpp:260-263).
# Kept as a numpy constant: a module-level jnp.asarray would initialise the
# XLA backend at import time, which breaks jax.distributed.initialize for
# any multi-host user importing the tracker first.
_ROT_CAM = np.asarray(
    [[0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0], [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]]
)


def _adaptive_blob_areas(config: TrackerConfig, dyn, pred_dist: jnp.ndarray):
    """Distance-adaptive blob-area bounds (pose_estimator.cpp:435-439).
    The base bounds are the traced dynamic tier (cfg:14-15 are
    live-tunable in the reference); the schedule constants stay static."""
    slope = config.blob_area_distance_slope
    base_min = dyn.min_blob_area
    base_max = dyn.max_blob_area
    min_a = jnp.maximum(
        config.abs_min_blob_area,
        jnp.minimum(base_min, base_min - slope * (pred_dist - 1.0)),
    )
    max_a = jnp.maximum(
        config.abs_max_blob_area,
        jnp.minimum(base_max, base_max - slope * (pred_dist - 1.0)),
    )
    return min_a, max_a


def _corr_from_det_for_marker(det_for_marker: jnp.ndarray, marker_mask: jnp.ndarray):
    m = det_for_marker.shape[0]
    corr = jnp.stack([jnp.arange(m, dtype=jnp.int32), det_for_marker], axis=-1)
    mask = (det_for_marker >= 0) & marker_mask
    return corr, mask


def _update_pose_times(state: TargetState, t: jnp.ndarray, new_current: jnp.ndarray):
    """updatePose (pose_estimator.cpp:2011-2021): shift pose history and
    advance the clock only if >1 ms passed (multi-UAV guard)."""
    advance = ((t - state.time_current) > 0.001) | (t < state.time_current)
    return state._replace(
        previous_pose=state.current_pose,
        current_pose=new_current,
        time_previous=jnp.where(advance, state.time_current, state.time_previous),
        time_current=jnp.where(advance, t, state.time_current),
    )


def _ego_motion(state: TargetState, t, obs_pose, obs_time, config: TrackerConfig):
    """Observer-camera ego-motion extrapolation (pose_estimator.cpp:244-396).

    Returns (cam_move_inv, updated state fields)."""
    if not config.use_cam_pos:
        eye = jnp.eye(4, dtype=state.current_pose.dtype)
        return eye, state

    obs_cam = jnp.where(
        jnp.abs(jnp.linalg.det(obs_pose)) < 1e-9, jnp.eye(4, dtype=obs_pose.dtype), obs_pose
    ) @ jnp.asarray(_ROT_CAM, obs_pose.dtype)

    new_avail = obs_time > state.time_obs_act
    change = jnp.where(new_avail, inverse(state.obs_cam_old) @ obs_cam, state.change_cam_pose)
    obs_cam_old = jnp.where(new_avail, obs_cam, state.obs_cam_old)
    shift = jnp.where(new_avail, obs_time - state.time_obs_act, state.cam_time_shift)
    time_obs_act = jnp.where(new_avail, obs_time, state.time_obs_act)

    ratio = (t - state.time_current) / jnp.maximum(shift, 1e-6)
    delta = log_se3(change)
    cam_move = exp_se3(delta * ratio)
    # t <= obs_time -> no extrapolation (:292-293)
    cam_move = jnp.where(t <= obs_time, jnp.eye(4, dtype=cam_move.dtype), cam_move)
    state = state._replace(
        obs_cam_old=obs_cam_old,
        change_cam_pose=change,
        time_obs_act=time_obs_act,
        cam_time_shift=shift,
    )
    return inverse(cam_move), state


def _resample_and_refine(
    state: TargetState,
    key,
    camera,
    markers_h,
    marker_mask,
    det: Detections,
    bank16,
    weights_norm,
    downgrade,
    config: TrackerConfig,
    dyn: DynamicParams,
    t,
    predicted,
    pred_trustworthy,
    resample_fn=None,
    ess_frac=None,
    argmax_idx=None,
):
    """Resampling + GN refinement of the most-resampled particle
    (pose_estimator.cpp:668-703) + optimiseAndUpdatePose.

    bank16: (16, N) SoA bank (may contain short-P3P seeds); the
    most-resampled particle's greedy pairs are recomputed for its single
    pose (pf.weight.weight_particles) rather than being carried as an
    (M, 2, N) volume out of the PF loop.
    resample_fn: optional explicit resampler `(key, weights, bank16) ->
    (resampled16, most)`-like (parallel.resample.DistResampleOut) — the
    mesh-sharded step plugs the distributed collective scheme in here.
    ess_frac / argmax_idx: optionally precomputed ESS fraction and
    argmax(weights) from the caller — on the mesh path each saves a
    collective per frame (the caller already paid for the raw weight
    moments and the argmax)."""
    zero_clip = jnp.zeros((), jnp.int32)
    if "resample" in config.debug_skip:
        most = jnp.argmax(weights_norm)
        resampled16 = bank16
        clipped = zero_clip
    else:

        def do_resample(_):
            if resample_fn is not None:
                # mesh-sharded step: the explicit distributed scheme
                # (collectives inside this cond are safe — the ESS
                # predicate below is replicated, so every device takes
                # the same branch)
                out = resample_fn(key, weights_norm, bank16)
                return out.resampled, out.most, out.clipped.astype(jnp.int32)
            if config.use_closed_form_resample:
                anc, counts, most = stratified_resample_closed(key, weights_norm)
            else:
                anc, counts, most = stratified_resample_soa(key, weights_norm)
            return gather_soa(bank16, anc), most, zero_clip

        if config.resample_min_ess > 0.0:
            # ESS-gated resampling (see TrackerConfig.resample_min_ess):
            # skip the sorts + bank gather (or the distributed ring)
            # while the weight spread is healthy; the refine seed is
            # then the argmax-weight lane (identical to the
            # most-resampled lane in expectation).  Under GSPMD the sum
            # lowers to a psum and the predicate is replicated.
            if ess_frac is None:
                ess_frac = 1.0 / (
                    jnp.sum(weights_norm * weights_norm)
                    * jnp.asarray(weights_norm.shape[0], weights_norm.dtype)
                )
            skip_most = (
                jnp.argmax(weights_norm) if argmax_idx is None else argmax_idx
            )
            resampled16, most, clipped = jax.lax.cond(
                ess_frac < config.resample_min_ess,
                do_resample,
                lambda _: (
                    bank16,
                    skip_most.astype(jnp.int32),
                    zero_clip,
                ),
                None,
            )
        else:
            resampled16, most, clipped = do_resample(None)

    dtype = bank16.dtype
    pre_gn = pick_lane(bank16, most).reshape(4, 4)
    _, pairs_1, _ = weight_particles(
        camera,
        pre_gn[None],
        markers_h,
        marker_mask,
        det.xy,
        det.mask,
        dyn.back_projection_pixel_tolerance_pf.astype(dtype),
        dyn.back_projection_pixel_tolerance.astype(dtype),
        downgrade,
    )
    base_pairs = pairs_1[0]  # (M,2) greedy (marker, det)
    m_cap = markers_h.shape[0]
    # per-marker detection map from the greedy pair list
    marker_ids = jnp.arange(m_cap)
    dfm_base = jnp.max(
        jnp.where(base_pairs[:, 0][None, :] == marker_ids[:, None], base_pairs[:, 1][None, :], -1),
        axis=1,
    )  # (M,) detection per marker, -1 unbound

    if config.gn_hypotheses <= 1:
        dfm_h = dfm_base[None]  # (1, M)
    else:
        # BINDING variants of the best particle: spurious blobs are
        # injected within a few px of real ones, so a slightly-off pose
        # greedily binds a marker to the clone and GN then converges onto
        # it — a self-reinforcing bias the reference shares.  The true
        # binding has a lower converged residual, so refine (a) the
        # greedy set, (b) one variant per marker swapped to its
        # second-nearest in-tolerance detection, (c) one variant per
        # marker with the pair dropped, and keep the best per-pair
        # residual.  Clean frames: the greedy set wins unchanged.
        uv0 = project(camera, pre_gn, markers_h)  # (M,2)
        d2m = jnp.sum((det.xy[None, :, :] - uv0[:, None, :]) ** 2, -1)  # (M,K)
        big = jnp.asarray(1e12, dtype)
        d2m = jnp.where(det.mask[None, :], d2m, big)
        tol2 = (dyn.back_projection_pixel_tolerance_pf.astype(dtype)) ** 2
        # second-nearest: mask out the currently bound detection
        bound = jnp.clip(dfm_base, 0, det.xy.shape[0] - 1)
        d2_alt = jnp.where(
            jnp.arange(det.xy.shape[0])[None, :] == bound[:, None], big, d2m
        )
        alt = jnp.argmin(d2_alt, axis=1).astype(jnp.int32)  # (M,)
        alt_ok = (jnp.min(d2_alt, axis=1) <= tol2) & (dfm_base >= 0)
        alt = jnp.where(alt_ok, alt, dfm_base)

        eye_m = jnp.eye(m_cap, dtype=bool)
        swap_h = jnp.where(eye_m, alt[None, :], dfm_base[None, :])  # (M, M)
        drop_h = jnp.where(eye_m, -1, dfm_base[None, :])  # (M, M)
        dfm_h = jnp.concatenate([dfm_base[None], swap_h, drop_h], axis=0)

    corr_masks = (dfm_h >= 0) & marker_mask[None, :]  # (H, M)
    corrs = jnp.concatenate(
        [
            jnp.broadcast_to(marker_ids[None, :, None], (*dfm_h.shape, 1)),
            dfm_h[..., None],
        ],
        axis=-1,
    ).astype(jnp.int32)  # (H, M, 2)
    res = jax.vmap(
        lambda c, cm: gauss_newton_refine(
            camera, pre_gn, markers_h, det.xy, c, cm,
            config.gn_max_iterations, config.gn_convergence_tol,
        )
    )(corrs, corr_masks)
    # selection: a hypothesis is FEASIBLE when every pair's converged
    # residual is below the gate (true bindings land sub-pixel; a
    # clone/wrong binding leaves one pair at 2-5 px).  Among feasible
    # hypotheses the one with the most pairs wins, ties to the greedy
    # base (index 0); if none is feasible, keep the base — exactly the
    # reference's behaviour on frames where nothing can be told apart.
    n_pairs = jnp.sum(corr_masks, -1).astype(dtype)  # (H,)
    # GN polishes the winning particle locally; a hypothesis whose
    # converged pose left the particle's neighbourhood found a different
    # (coincidental) basin and is discarded — on healthy frames GN moves
    # millimetres
    local = jnp.linalg.norm(res.pose[:, :3, 3] - pre_gn[:3, 3][None], axis=-1) <= (
        config.gn_step_radius
    )
    feasible = (
        (res.max_residual <= config.gn_residual_gate) & (n_pairs > 0) & local
    )
    n_h = corr_masks.shape[0]
    pref = n_pairs - 1e-3 * jnp.arange(n_h, dtype=dtype)  # ties -> earlier
    pref = jnp.where(feasible, pref, -jnp.inf)
    best_h = jnp.where(jnp.any(feasible), jnp.argmax(pref), 0)
    res = jax.tree_util.tree_map(lambda x: x[best_h], res)
    # no feasible hypothesis at all -> even the base GN is suspect; keep
    # the particle's pose (the PF accepted it) rather than a wild fit
    res = res._replace(
        pose=jnp.where(jnp.any(feasible), res.pose, pre_gn)
    )
    # jump detection (:692-701)
    jump = (
        jnp.max(jnp.abs(res.pose[:3, :3] - pre_gn[:3, :3]))
        >= dyn.jump_threshold.astype(res.pose.dtype)
    )
    final_pose = res.pose
    if config.jump_translation_radius > 0.0:
        # translation-teleport rejection (engine extension; the rotation
        # flag above is reference semantics and advisory-only there).
        # Only while the prediction itself is trustworthy — right after a
        # re-init the const-velocity extrapolation can be arbitrarily
        # wrong, and clamping to it would anchor the track to garbage.
        teleport = pred_trustworthy & (
            jnp.linalg.norm(res.pose[:3, 3] - predicted[:3, 3])
            > config.jump_translation_radius
        )
        final_pose = jnp.where(teleport, predicted, res.pose)
        jump = jump | teleport

    state = state._replace(
        predicted_pose=final_pose,
        covariance=res.covariance,
        it_since_initialized=jnp.minimum(state.it_since_initialized + 1, 2),
        pose_updated=jnp.asarray(True),
        num_gn_iterations=res.num_iterations,
        resampled=resampled16,
        weights=weights_norm,
        bank=bank16,
        resample_clipped=state.resample_clipped + clipped,
    )
    state = _update_pose_times(state, t, final_pose)
    return state, jump


def tracker_step(
    state: TargetState,
    image: jnp.ndarray,
    t: jnp.ndarray,
    camera: Camera,
    markers_h: jnp.ndarray,
    marker_mask: jnp.ndarray,
    config: TrackerConfig,
    obs_pose: jnp.ndarray | None = None,
    obs_time: jnp.ndarray | None = None,
    dyn: DynamicParams | None = None,
    resample_fn=None,
    pf_fn=None,
):
    """Advance one target by one frame.  Returns (state', FrameResult).

    `dyn` carries the runtime-tunable parameter tier as traced operands —
    pass a modified DynamicParams to retune tolerances/noise/gates
    between frames with NO recompilation (the dynamic_reconfigure
    analogue); None bakes the config values in as constants.

    SPMD hooks (all None for the single-device tracker; set by the
    sharded constructors in parallel/mesh.py):
      resample_fn — explicit distributed resampler (parallel.resample);
      pf_fn — shard_map'd fused propagate+weight over the particles
        mesh axis (parallel.pf_kernels.make_sharded_pf_fn), replacing
        the in-line kernel/XLA dispatch in pf_compute."""
    if dyn is None:
        dyn = DynamicParams.from_config(config)
    dtype = state.current_pose.dtype
    t = jnp.asarray(t, dtype)
    if obs_pose is None:
        obs_pose = jnp.eye(4, dtype=dtype)
    if obs_time is None:
        obs_time = jnp.zeros((), dtype)

    n_markers = jnp.sum(marker_mask.astype(jnp.int32))
    # effective marker count required to attempt PF init (see
    # TrackerConfig.pf_init_min_markers; 0 = reference parity)
    if config.use_particle_filter and config.pf_init_min_markers > 0:
        init_needed = jnp.minimum(n_markers, config.pf_init_min_markers)
    else:
        init_needed = n_markers
    params = config.blob_params()
    noise = NoiseBounds(
        dyn.min_translation_noise.astype(dtype),
        dyn.max_translation_noise.astype(dtype),
        dyn.min_angular_noise.astype(dtype),
        dyn.max_angular_noise.astype(dtype),
    )
    downgrade = jnp.asarray(
        list(config.marker_downgrade) + [False] * (markers_h.shape[0] - len(config.marker_downgrade)),
        bool,
    )[: markers_h.shape[0]]

    def detect(image_, roi_, min_a_, max_a_, thr_):
        return find_leds(
            image_, roi_, params, camera, min_a_, max_a_, threshold=thr_,
            wh_distortion=dyn.max_width_height_distortion,
            circ_distortion=dyn.max_circular_distortion,
        )

    # ------------------------------------------------------------- INIT
    def init_branch(state: TargetState):
        key, k_faults = jax.random.split(state.key)
        state = state._replace(key=key)

        growth = config.roi_uncertainty_growth * (
            1.0 + jnp.floor(state.uncertainty.astype(dtype) / 3.0)
        )
        roi = grow_roi(state.roi, growth, growth, camera)

        det = detect(image, roi, None, None, dyn.threshold_value)
        # second pass with PF-adaptive areas if too few (:154-159)
        pred_dist = jnp.linalg.norm(state.current_pose[:3, 3])
        min_a, max_a = _adaptive_blob_areas(config, dyn, pred_dist)

        def second_pass(_):
            return detect(image, roi, min_a, max_a, dyn.threshold_value)

        # second pass only when a previous track left a usable pose
        # (reference gate :154-159 tests "was previously tracking"; a
        # nonzero translation is the functional equivalent here)
        need_second = (det.count < init_needed) & (
            jnp.linalg.norm(state.current_pose[:3, 3]) > 1e-6
        )
        det = jax.lax.cond(need_second, second_pass, lambda _: det, None)
        det = inject_faults(
            k_faults, det, config.number_of_occlusions, config.number_of_false_detections
        )

        enough = det.count >= init_needed

        def do_init(_):
            # prefer a validated candidate consistent with the recently
            # tracked pose (see initialise's prefer_near) — same context
            # as the temporal gate below
            prev_t = state.current_pose[:3, 3]
            gate_active = (
                (jnp.linalg.norm(prev_t) > 1e-6)
                & (state.uncertainty < config.init_consistency_uncertainty_cap)
            )
            # [t (3), active (1), remembered R row-major (9)] — the
            # rotation rows feed prefer_near's rotation-consistency leg
            prefer = jnp.concatenate(
                [
                    prev_t,
                    gate_active.astype(dtype)[None],
                    state.current_pose[:3, :3].reshape(9),
                ]
            )
            return initialise(
                camera, det, markers_h, marker_mask, state.bank, config, dyn,
                prefer_near=prefer,
            )

        def no_init(_):
            from .initialise import InitResult

            return InitResult(
                success=jnp.asarray(False),
                pose=jnp.eye(4, dtype=dtype),
                det_for_marker=jnp.full((markers_h.shape[0],), -1, jnp.int32),
                bank=state.bank,
                flag=jnp.asarray(int(FailFlag.TOO_FEW_LEDS_INIT), jnp.int32),
            )

        init_res = jax.lax.cond(enough, do_init, no_init, None)

        def on_success(state: TargetState):
            corr, corr_mask = _corr_from_det_for_marker(init_res.det_for_marker, marker_mask)
            res = gauss_newton_refine(
                camera,
                init_res.pose,
                markers_h,
                det.xy,
                corr,
                corr_mask,
                config.gn_max_iterations,
                config.gn_convergence_tol,
            )
            state = state._replace(
                # the init "hack" (:180): current := un-optimised init pose
                current_pose=init_res.pose,
                predicted_pose=res.pose,
                covariance=res.covariance,
                bank=init_res.bank,
                resampled=init_res.bank,
                it_since_initialized=jnp.asarray(1, jnp.int32),
                pose_updated=jnp.asarray(True),
                num_gn_iterations=res.num_iterations,
                fail_flag=jnp.asarray(int(FailFlag.INIT_SUCCESS), jnp.int32),
            )
            return _update_pose_times(state, t, res.pose)

        def on_failure(state: TargetState):
            bump = jnp.where(enough, 1, 2)  # (:201 vs :209)
            # a validated init rejected by the consistency gate is strong
            # evidence the remembered pose is stale: bump hard so the
            # gate unlatches after ~cap/reject_bump rejections instead of
            # latching shut for tens of frames
            bump = jnp.where(
                init_res.flag == int(FailFlag.INIT_INCONSISTENT),
                bump + config.init_consistency_reject_bump,
                bump,
            )
            return state._replace(
                uncertainty=state.uncertainty + bump,
                pose_updated=jnp.asarray(False),
                fail_flag=init_res.flag,
            )

        # temporal-consistency gate: while recently tracking, a validated
        # init that teleports the pose is a wrong-but-self-consistent
        # correspondence set — reject it and keep searching
        if config.init_consistency_radius > 0.0:
            prev_t = state.current_pose[:3, 3]
            had_track = jnp.linalg.norm(prev_t) > 1e-6
            recently = state.uncertainty < config.init_consistency_uncertainty_cap
            far = (
                jnp.linalg.norm(init_res.pose[:3, 3] - prev_t)
                > config.init_consistency_radius
            )
            if config.init_consistency_rotation_deg > 0.0:
                # rotation leg: a wrong landing can sit translationally
                # near the remembered pose but heavily rotated (the
                # flipped-mode solutions; see the config docstring)
                r_rel = init_res.pose[:3, :3] @ state.current_pose[:3, :3].T
                cos_a = jnp.clip((jnp.trace(r_rel) - 1.0) / 2.0, -1.0, 1.0)
                far = far | (
                    cos_a
                    < jnp.cos(
                        jnp.deg2rad(
                            jnp.asarray(
                                config.init_consistency_rotation_deg, dtype
                            )
                        )
                    )
                )
            inconsistent = init_res.success & had_track & recently & far
            init_res = init_res._replace(
                success=init_res.success & ~inconsistent,
                flag=jnp.where(
                    inconsistent,
                    jnp.asarray(int(FailFlag.INIT_INCONSISTENT), jnp.int32),
                    init_res.flag,
                ),
            )

        state = state._replace(roi=roi)
        state = jax.lax.cond(init_res.success, on_success, on_failure, state)
        return state, det, jnp.asarray(0.0, dtype), jnp.asarray(True)

    # ------------------------------------------------------------ TRACK
    def track_branch(state: TargetState):
        key, k_faults, k_resample = jax.random.split(state.key, 3)
        state = state._replace(key=key)

        dt_past = state.time_current - state.time_previous
        prediction = predict_constant_velocity(
            state.previous_pose, state.current_pose, dt_past, t - state.time_current
        )
        predicted = state.current_pose @ prediction
        cam_move_inv, state = _ego_motion(state, t, obs_pose, obs_time, config)
        predicted = cam_move_inv @ predicted

        # --- ROI from predicted particle pixels (:396-432) ---
        s_cap = min(config.roi_particle_subsample, state.resampled.shape[1])
        sub = cam_move_inv @ unpack(state.resampled[:, :s_cap]) @ prediction
        pix_particles = project(camera, sub, markers_h).reshape(-1, 2)
        pix_pred = project(camera, predicted, markers_h)
        pix = jnp.concatenate([pix_particles, pix_pred], axis=0)
        pix_mask = jnp.concatenate(
            [
                jnp.broadcast_to(marker_mask[None, :], (s_cap, marker_mask.shape[0])).reshape(-1),
                marker_mask,
            ]
        )
        roi = determine_roi(pix, pix_mask, camera, config.roi_border_thickness)
        dist_val = jnp.clip(config.roi_distance_gain / jnp.maximum(state.current_pose[2, 3], 0.1), 0.0, 100.0)
        roi = grow_roi(roi, dist_val, dist_val, camera)

        pred_dist = jnp.linalg.norm(predicted[:3, 3])
        min_a, max_a = _adaptive_blob_areas(config, dyn, pred_dist)
        det = detect(image, roi, min_a, max_a, dyn.threshold_value)

        # not enough LEDs -> grow ROI and retry once (:452-463)
        def retry(_):
            roi2 = grow_roi(roi, config.roi_retry_growth, config.roi_retry_growth, camera)
            return detect(image, roi2, min_a, max_a, dyn.threshold_value), roi2

        det, roi = jax.lax.cond(
            det.count < config.min_num_leds_detected, retry, lambda _: (det, roi), None
        )
        det = inject_faults(
            k_faults, det, config.number_of_occlusions, config.number_of_false_detections
        )
        num_led = det.count

        # --- PF retry loop (:535-616) ---
        tracking = state.it_since_initialized > 1
        # the const-velocity prediction is trustworthy only on a mature
        # track whose extrapolated step is itself small (used by the
        # teleport guard in _resample_and_refine)
        pred_trustworthy = tracking & (
            jnp.linalg.norm(prediction[:3, 3]) < 0.5 * config.jump_translation_radius
            if config.jump_translation_radius > 0.0
            else tracking
        )
        fresh = state.it_since_initialized == 1
        fac_t, fac_r = propagation_noise_factors(
            fresh, prediction, jnp.maximum(t - state.time_current, 1e-6)
        )
        m_f = n_markers.astype(dtype)
        num_led_f = num_led.astype(dtype)
        exit_gate = m_f * jnp.minimum(dyn.pf_exit_gate_factor.astype(dtype), num_led_f)
        accept_gate = m_f * jnp.minimum(dyn.pf_accept_gate_factor.astype(dtype), num_led_f)

        n = state.bank.shape[1]
        m_cap = markers_h.shape[0]
        resampled16 = state.resampled  # state banks are natively SoA

        # the platform's route (utils/backend.py); the stage skips of
        # debug_skip bisect the XLA path only
        use_kernel = (
            pf_route() == "triton"
            and "propagate" not in config.debug_skip
            and "weight" not in config.debug_skip
        )

        def pf_compute(it, k):
            """One propagate+weight pass (no best-tracking selects)."""
            inflation = (
                1.0 + dyn.noise_inflation_per_10_iters * jnp.floor(it / 10.0)
            ).astype(dtype)
            apply_pred = tracking & ((it % 10) != 0)
            args = (
                k,
                resampled16,
                state.current_pose,
                predicted,
                prediction,
                cam_move_inv,
                noise,
                fac_t,
                fac_r,
                tracking,
                apply_pred,
                inflation,
            )
            det_args = (
                markers_h,
                marker_mask,
                det.xy,
                det.mask,
                dyn.back_projection_pixel_tolerance_pf.astype(dtype),
                dyn.back_projection_pixel_tolerance.astype(dtype),
                downgrade,
                m_f,
            )
            if pf_fn is not None:
                # sharded step: shard_map'd fused kernel, each shard on
                # its local bank block with global draws/pins
                return pf_fn(*args, *det_args)
            if use_kernel:
                return fused_propagate_weight_pallas(*args, camera, *det_args)
            if "propagate" in config.debug_skip:
                bank16 = resampled16 * (1.0 + 1e-12 * inflation)
            else:
                bank16 = propagate_soa(*args)
            if "weight" in config.debug_skip:
                w = jnp.abs(bank16[0]) + 30.0
            else:
                # pairs/ncorr are NOT materialised on the hot path: only
                # one or two lanes are consumed downstream, recomputed
                # per-pose via pf.weight.weight_particles instead of
                # carrying (M, 2, N) through the retry loop
                w = weight_particles_soa(camera, bank16, *det_args)[0]
            return bank16, w

        def pf_body(carry):
            it, key, best_w, best_bank16, highest = carry
            key, k = jax.random.split(key)
            bank16, w = pf_compute(it, k)
            new_high = jnp.max(w)
            better = new_high > highest
            best_w = jnp.where(better, w, best_w)
            best_bank16 = jnp.where(better, bank16, best_bank16)
            highest = jnp.maximum(highest, new_high)
            return it + 1, key, best_w, best_bank16, highest

        def pf_cond(carry):
            it, _, _, _, highest = carry
            return (it < config.pf_max_retries) & (highest < exit_gate)

        key, k_loop = jax.random.split(state.key)
        state = state._replace(key=key)
        # First iteration inlined WITHOUT the best-tracking selects:
        # with highest=-inf they are always-taken identities, yet cost
        # ~18 N-lane select rows per frame on the common
        # single-iteration path.  Key split order matches pf_body so
        # trajectories are bit-identical to the do-while formulation.
        k_rest, k0 = jax.random.split(k_loop)
        bank0, w0 = pf_compute(jnp.zeros((), jnp.int32), k0)
        init_carry = (
            jnp.ones((), jnp.int32),
            k_rest,
            w0,
            bank0,
            jnp.max(w0),
        )
        _, _, best_w, bank16, highest = jax.lax.while_loop(
            pf_cond, pf_body, init_carry
        )

        if config.motion_prior_radius > 0.0:
            # Motion-consistency prior (see utils/config.py): posterior
            # = likelihood x soft prior on distance from the predicted
            # pose.  Downstream consumers (accept gate, degraded-lock
            # detector, resampler, best-particle pick) all see the
            # posterior, so a wrong-mode lock reads as degraded and the
            # recovery ladder breaks it.
            trans = bank16[jnp.asarray([3, 7, 11])]  # SoA rows = T[0:3, 3]
            d = jnp.linalg.norm(trans - predicted[:3, 3][:, None], axis=0)
            excess = jnp.maximum(d - config.motion_prior_radius, 0.0) / (
                config.motion_prior_falloff
            )
            prior = jnp.exp(-0.5 * excess * excess).astype(dtype)
            small_step = (
                jnp.linalg.norm(prediction[:3, 3]) < config.motion_prior_radius
            )
            engage = tracking & small_step
            best_w = jnp.where(engage, best_w * prior, best_w)
            highest = jnp.max(best_w)

        # both weight moments in ONE fused reduce (one all-reduce under
        # GSPMD instead of two); the ESS
        # fraction 1/(N*sum(wn^2)) is computed from the raw moments as
        # s1^2/(N*s2), identical in exact arithmetic
        moments = jnp.sum(jnp.stack([best_w, best_w * best_w]), axis=1)
        w_sum, w_sum2 = moments[0], moments[1]
        weights_norm = jnp.where(w_sum > 0, best_w / jnp.maximum(w_sum, 1e-12), best_w)
        best_idx = jnp.argmax(best_w)
        ess_frac_raw = (w_sum * w_sum) / (
            jnp.maximum(w_sum2, jnp.asarray(1e-30, dtype))
            * jnp.asarray(best_w.shape[0], dtype)
        )

        accepted = (w_sum > 0) & (highest > accept_gate)
        marginal = highest < accept_gate + dyn.marginal_margin_factor.astype(dtype) * num_led_f

        # --- recovery ladder (:633-719) ---
        def on_accept(state: TargetState):
            def marginal_path(state: TargetState):
                def under_cap(state: TargetState):
                    state = state._replace(uncertainty=state.uncertainty + 1)
                    # greedy pairs of the best particle, recomputed for
                    # its single pose (the PF loop no longer materialises
                    # the (M, 2, N) per-particle pair volume)
                    pose_b = pick_lane(bank16, best_idx).reshape(4, 4)
                    _, p_b, nc_b = weight_particles(
                        camera,
                        pose_b[None],
                        markers_h,
                        marker_mask,
                        det.xy,
                        det.mask,
                        dyn.back_projection_pixel_tolerance_pf.astype(dtype),
                        dyn.back_projection_pixel_tolerance.astype(dtype),
                        downgrade,
                        m_f,
                    )

                    def do_short(state: TargetState):
                        p = p_b[0]  # (M,2) (marker, det)
                        valid = p[:, 0] >= 0
                        order = jnp.argsort(~valid)
                        three = p[order][:3]
                        res = short_p3p(
                            camera, det, markers_h, marker_mask, three, bank16, config, dyn
                        )
                        state = state._replace(
                            bank=jnp.where(res.success, res.bank, state.bank),
                            fail_flag=jnp.where(
                                res.success,
                                jnp.asarray(int(FailFlag.SHORT_P3P_SUCCESS), jnp.int32),
                                state.fail_flag,
                            ),
                            it_since_initialized=jnp.where(
                                res.success, state.it_since_initialized, 0
                            ),
                        )
                        return state

                    has3 = nc_b[0] == 3
                    return jax.lax.cond(has3, do_short, lambda s: s, state)

                def over_cap(state: TargetState):
                    return state._replace(
                        it_since_initialized=jnp.asarray(0, jnp.int32),
                        uncertainty=jnp.asarray(1, jnp.int32),
                        fail_flag=jnp.asarray(int(FailFlag.UNCERTAINTY_REINIT), jnp.int32),
                    )

                return jax.lax.cond(
                    state.uncertainty < config.uncertainty_cap, under_cap, over_cap, state
                )

            state = state._replace(
                fail_flag=jnp.asarray(int(FailFlag.PF_SUCCESS), jnp.int32),
                pose_updated=jnp.asarray(False),
                coast_frames=jnp.zeros((), jnp.int32),
            )
            state = jax.lax.cond(
                marginal, marginal_path, lambda s: s._replace(uncertainty=jnp.asarray(1, jnp.int32)), state
            )

            # Degraded-lock detection (engine extension): a wrong-but-
            # self-consistent pose explains only a subset of the markers
            # EVERY frame, while healthy tracking drops below a full
            # explanation only on occluded frames.  A sustained run
            # forces a re-init with the consistency gate disengaged (the
            # gate would otherwise anchor to the wrong pose).
            if config.degraded_reinit_frames > 0:
                # full-quality frame: all M markers matched at close
                # range scores ~ M*(M+0.8); a wrong lock (or an occluded
                # frame) sits a whole match lower.  Occlusions are
                # coin-flipped per frame, so only a LOCK sustains the run.
                strong = m_f * (m_f + jnp.asarray(config.degraded_weight_offset, dtype))
                degraded = highest < strong
                # a strong frame DECAYS the counter instead of zeroing
                # it (degraded_reset_decay): a wrong lock's occasional
                # pseudo-strong frame (clone completing the
                # constellation just over the bar) must not grant the
                # lock another full degraded_reinit_frames of life
                deg = jnp.where(
                    degraded,
                    state.degraded_frames + 1,
                    jnp.maximum(
                        state.degraded_frames - config.degraded_reset_decay, 0
                    )
                    if config.degraded_reset_decay > 0
                    else 0,
                ).astype(jnp.int32)
                force_reinit = deg >= config.degraded_reinit_frames
                # Degraded re-init keeps a WEAK consistency veto (round
                # 5): uncertainty lands one reject-bump below the gate
                # cap rather than at it.  A degraded lock is wrong in
                # ORIENTATION/binding but translationally near the
                # truth (measured 30-60 mm), while the classic wrong
                # LANDING of an unconstrained re-init is the
                # 180-flipped solution ~0.3-0.7 m away (measured
                # 433 mm ATE seeds) — the still-engaged gate vetoes it
                # once or twice (each veto bumps uncertainty by
                # init_consistency_reject_bump, so the gate fully
                # unlatches within ~2 frames if only far candidates
                # exist), and prefer_near picks a translationally
                # consistent candidate when one validates.
                reinit_unc = jnp.asarray(
                    max(
                        config.init_consistency_uncertainty_cap
                        - config.init_consistency_reject_bump
                        - 1,
                        0,
                    ),
                    jnp.int32,
                )
                state = state._replace(
                    degraded_frames=jnp.where(force_reinit, 0, deg),
                    it_since_initialized=jnp.where(
                        force_reinit, 0, state.it_since_initialized
                    ),
                    uncertainty=jnp.where(
                        force_reinit, reinit_unc, state.uncertainty
                    ),
                    fail_flag=jnp.where(
                        force_reinit,
                        jnp.asarray(int(FailFlag.UNCERTAINTY_REINIT), jnp.int32),
                        state.fail_flag,
                    ),
                )

            def refine_path(state: TargetState):
                # state.bank may contain short-P3P seeds; the reference
                # resamples the refilled bank under the pre-refill weights
                # (:668-681 after :645).
                state, jump = _resample_and_refine(
                    state,
                    k_resample,
                    camera,
                    markers_h,
                    marker_mask,
                    det,
                    state.bank,
                    weights_norm,
                    downgrade,
                    config,
                    dyn,
                    t,
                    predicted,
                    pred_trustworthy,
                    resample_fn,
                    ess_frac=ess_frac_raw,
                    argmax_idx=best_idx,
                )
                state = state._replace(
                    fail_flag=jnp.where(
                        jump, jnp.asarray(int(FailFlag.PF_JUMP), jnp.int32), state.fail_flag
                    )
                )
                return state

            return jax.lax.cond(
                state.it_since_initialized > 0, refine_path, lambda s: s, state
            )

        def on_reject(state: TargetState):
            # Coast extension (TrackerConfig.pf_coast_frames): a mature
            # track survives isolated rejected frames with its bank
            # intact instead of paying the reference's immediate full
            # reset (:707-719) + multi-frame re-init cascade.
            if config.pf_coast_frames > 0:
                coast = (state.it_since_initialized >= 2) & (
                    state.coast_frames < config.pf_coast_frames
                )
            else:
                coast = jnp.asarray(False)
            return state._replace(
                uncertainty=state.uncertainty + 1,
                it_since_initialized=jnp.where(
                    coast, state.it_since_initialized, 0
                ).astype(jnp.int32),
                coast_frames=jnp.where(coast, state.coast_frames + 1, 0).astype(
                    jnp.int32
                ),
                fail_flag=jnp.asarray(int(FailFlag.PF_NO_REASONABLE_PARTICLE), jnp.int32),
                predicted_pose=pick_lane(bank16, best_idx).reshape(4, 4),
                pose_updated=jnp.asarray(False),
                weights=weights_norm,
            )

        state = state._replace(bank=bank16, roi=roi)
        state = jax.lax.cond(accepted, on_accept, on_reject, state)
        return state, det, highest, jnp.asarray(False)

    # -------------------------------------------------- IPE (legacy) TRACK
    def ipe_track_branch(state: TargetState):
        """The non-PF branch (pose_estimator.cpp:813-879): NN-gated
        correspondences from the predicted pose + P3P consensus check,
        falling back to brute-force initialisation."""
        key, k_faults = jax.random.split(state.key)
        state = state._replace(key=key)

        pred_dist = jnp.linalg.norm(state.predicted_pose[:3, 3])
        min_a, _ = _adaptive_blob_areas(config, dyn, pred_dist)

        # predictWithROI (:2037-2054): const-velocity prediction when the
        # track is mature, otherwise reuse the current pose.
        dt_past = state.time_current - state.time_previous
        prediction = predict_constant_velocity(
            state.previous_pose, state.current_pose, dt_past, t - state.time_current
        )
        predicted = jnp.where(
            state.it_since_initialized >= 2, state.current_pose @ prediction, state.predicted_pose
        )
        state = state._replace(predicted_pose=predicted)
        pix = project(camera, predicted, markers_h)
        roi = determine_roi(pix, marker_mask, camera, config.roi_border_thickness)

        det = detect(image, roi, min_a, None, dyn.threshold_value)

        # too few -> search the whole image once (:850-868)
        def full_image(_):
            full = jnp.asarray([0, 0, camera.width, camera.height], dtype)
            return detect(image, full, min_a, None, dyn.threshold_value), full

        det, roi = jax.lax.cond(
            det.count < config.min_num_leds_detected, full_image, lambda _: (det, roi), None
        )
        det = inject_faults(
            k_faults, det, config.number_of_occlusions, config.number_of_false_detections
        )
        enough = det.count >= config.min_num_leds_detected

        def with_detections(state: TargetState):
            # findCorrespondences (:1290-1310): per predicted marker pixel,
            # nearest detection within nearest_neighbour_pixel_tolerance_.
            d2 = jnp.sum((pix[:, None, :] - det.xy[None, :, :]) ** 2, -1)  # (M,K)
            d2 = jnp.where(det.mask[None, :], d2, jnp.asarray(jnp.inf, dtype))
            nearest = jnp.argmin(d2, axis=-1)
            min_d = jnp.sqrt(jnp.min(d2, axis=-1))
            det_for_marker = jnp.where(
                (min_d <= dyn.nearest_neighbour_pixel_tolerance.astype(dtype))
                & marker_mask,
                nearest.astype(jnp.int32),
                -1,
            )

            from .check import check_correspondences

            chk = check_correspondences(
                camera,
                det.xy,
                det.mask,
                markers_h,
                marker_mask,
                det_for_marker,
                jnp.asarray(config.min_num_leds_detected, jnp.int32),
                config,
                dyn,
            )

            def corr_ok(state: TargetState):
                corr, corr_mask = _corr_from_det_for_marker(det_for_marker, marker_mask)
                res = gauss_newton_refine(
                    camera, chk.pose, markers_h, det.xy, corr, corr_mask,
                    config.gn_max_iterations, config.gn_convergence_tol,
                )
                state = state._replace(
                    predicted_pose=res.pose,
                    covariance=res.covariance,
                    it_since_initialized=jnp.minimum(state.it_since_initialized + 1, 2),
                    pose_updated=jnp.asarray(True),
                    num_gn_iterations=res.num_iterations,
                    fail_flag=jnp.asarray(int(FailFlag.PF_SUCCESS), jnp.int32),
                )
                return _update_pose_times(state, t, res.pose)

            def corr_fail(state: TargetState):
                # fall back to brute-force initialisation (:2069)
                init_res = initialise(
                    camera, det, markers_h, marker_mask, state.bank, config, dyn
                )

                def init_ok(state: TargetState):
                    corr, corr_mask = _corr_from_det_for_marker(
                        init_res.det_for_marker, marker_mask
                    )
                    res = gauss_newton_refine(
                        camera, init_res.pose, markers_h, det.xy, corr, corr_mask,
                        config.gn_max_iterations, config.gn_convergence_tol,
                    )
                    state = state._replace(
                        current_pose=init_res.pose,
                        predicted_pose=res.pose,
                        covariance=res.covariance,
                        it_since_initialized=jnp.minimum(state.it_since_initialized + 1, 2),
                        pose_updated=jnp.asarray(True),
                        num_gn_iterations=res.num_iterations,
                        fail_flag=jnp.asarray(int(FailFlag.INIT_SUCCESS), jnp.int32),
                    )
                    return _update_pose_times(state, t, res.pose)

                def init_bad(state: TargetState):
                    return state._replace(
                        it_since_initialized=jnp.asarray(0, jnp.int32),
                        fail_flag=init_res.flag,
                    )

                return jax.lax.cond(init_res.success, init_ok, init_bad, state)

            return jax.lax.cond(chk.success, corr_ok, corr_fail, state)

        def no_detections(state: TargetState):
            return state._replace(
                fail_flag=jnp.asarray(int(FailFlag.TOO_FEW_MARKERS_DETECTED), jnp.int32),
                pose_updated=jnp.asarray(False),
            )

        state = state._replace(roi=roi)
        state = jax.lax.cond(enough, with_detections, no_detections, state)
        return state, det, jnp.asarray(0.0, dtype), jnp.asarray(False)

    needs_init = state.it_since_initialized < 1
    state = state._replace(
        fail_flag=jnp.asarray(-10, jnp.int32), pose_updated=jnp.asarray(False)
    )
    track_impl = track_branch if config.use_particle_filter else ipe_track_branch
    state, det, best_weight, used_bf = jax.lax.cond(needs_init, init_branch, track_impl, state)

    # online exposure state machine (led_detector.cpp:124-165): pure
    # state-in/state-out; the host applies result.exposure_us to its
    # camera transport if it owns one
    if config.use_online_exposure_control:
        state = state._replace(
            exposure=exposure_control(
                state.exposure,
                jnp.sum(det.area),
                state.roi[2] * state.roi[3],
                config.expose_time_base,
                det.count > 0,
            )
        )

    result = FrameResult(
        pose=state.current_pose,
        pose_inverse=inverse(state.current_pose),
        covariance=state.covariance,
        pose_updated=state.pose_updated,
        fail_flag=state.fail_flag,
        num_detections=det.count,
        num_gn_iterations=state.num_gn_iterations,
        used_brute_force=used_bf,
        detections_xy=det.xy,
        detections_mask=det.mask,
        detections_occluded=det.occluded,
        detections_injected=det.injected,
        roi=state.roi,
        best_weight=best_weight,
        blob_area_sum=jnp.sum(det.area),
        exposure_us=state.exposure.exposure_us,
        resample_clipped=state.resample_clipped,
    )
    return state, result


def make_tracker(camera: Camera, markers_h, marker_mask, config: TrackerConfig):
    """Build a jitted `step(state, image, t) -> (state', FrameResult)`."""
    markers_h = jnp.asarray(markers_h)
    marker_mask = jnp.asarray(marker_mask, bool)

    @jax.jit
    def step(state, image, t, obs_pose=None, obs_time=None, dyn=None):
        return tracker_step(
            state, image, t, camera, markers_h, marker_mask, config,
            obs_pose, obs_time, dyn,
        )

    return step
