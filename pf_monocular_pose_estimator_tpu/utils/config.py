"""Tracker configuration.

Covers all three config tiers of the reference (SURVEY.md §5):
  1. the 23 dynamic_reconfigure params (pf_mpe/cfg/
     PFMonocularPoseEstimator.cfg:12-40) with their defaults;
  2. the static launch params (noise bounds, numUAV handled by the
     multi-target wrapper);
  3. the hard-coded constants promoted to config, as SURVEY.md §5
     mandates: PF retry cap and exit gates (pose_estimator.cpp:616,633),
     noise inflation 0.025 (:563-565), uncertainty cap 200 (:639), GN
     budget (:1809-1810), jump threshold 0.3 (:693-695),
     min_num_leds_detected 4 (pose_estimator.h:104).

The config is a frozen, hashable dataclass so it can ride into `jit` as a
static argument — changing a value recompiles, exactly like the
reference's dynamic_reconfigure push re-tuning the engine.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..ops.blob import BlobParams


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    # --- detection (cfg:12-17, 22) ---
    threshold_value: float = 240.0
    gaussian_sigma: float = 0.6
    min_blob_area: float = 20.0
    max_blob_area: float = 160.0
    max_width_height_distortion: float = 0.7
    max_circular_distortion: float = 0.7
    roi_border_thickness: float = 10.0
    active_markers: bool = True
    max_detections: int = 16  # fixed detection-bank capacity
    cc_sweeps: int = 12
    roi_crop: Tuple[int, int] | None = (192, 256)  # fixed detect crop (h, w)
    # merged-blob splitting (engine extension, ops/blob.py BlobParams):
    # oversized+elongated components become two detections instead of
    # being dropped by the area filter (False = reference parity)
    split_merged_blobs: bool = True
    split_max_factor: float = 2.5
    split_min_elongation: float = 1.5
    # bimodality gate: split only when the centroid intensity dips below
    # this ratio of the dimmer child peak (rejects motion-blur streaks
    # that share a merged pair's covariance footprint; ops/blob.py)
    split_dip_ratio: float = 0.75

    # --- tolerances / thresholds (cfg:18-21, 32) ---
    back_projection_pixel_tolerance: float = 5.0
    back_projection_pixel_tolerance_pf: float = 10.0
    nearest_neighbour_pixel_tolerance: float = 7.0
    certainty_threshold: float = 1.0
    valid_correspondence_threshold: float = 0.5

    # --- fault injection (cfg:23-24) ---
    number_of_occlusions: int = 0
    number_of_false_detections: int = 0

    # --- particle filter (cfg:25-31, 33-37) ---
    use_particle_filter: bool = True
    n_particles: int = 1000
    min_translation_noise: float = -0.025
    max_translation_noise: float = 0.025
    min_angular_noise: float = -0.02
    max_angular_noise: float = 0.02
    marker_downgrade: Tuple[bool, ...] = (False, False, False, False, False)
    use_cam_pos: bool = False
    # sort-free stratified resampling (pf/soa.py::
    # stratified_resample_closed): replaces the two 2N-element resample
    # sorts with a cumsum + six gathers + one scatter-max.  Same draws
    # and assignment rule; slot-level differences vs the sort path only
    # inside 1-ulp non-monotone pockets of XLA's parallel-scan cumsum
    # (~1e-4 of slots; see the function docstring and tests/test_soa.py).
    # OFF by default: the sort path is the reference-exact default; the
    # speed of the two on the GPU is not measured yet.
    use_closed_form_resample: bool = False
    # ESS-gated resampling (engine extension; 0.0 = reference parity =
    # resample every accepted frame).  When > 0, the stratified resample
    # + bank gather (two 2N-element sorts and a bank-wide gather) run
    # only when the effective sample size fraction
    # ESS/N = 1/(N*sum(w_norm^2)) of the CURRENT frame's weights falls
    # below this threshold; otherwise the bank passes through unchanged
    # and the refinement seed is the argmax-weight particle.  Standard
    # particle-filter practice (adaptive/ESS-triggered resampling);
    # self-regulating here because skipped resampling lets the cloud
    # diffuse, which drives ESS down until a resample fires.  Weights
    # are per-frame scores (as in the reference), not accumulated.
    # Default 0.15, chosen by a tau x degraded_weight_offset x 5-seed
    # accuracy sweep on the outlier config: tau=0.15 tracked it best;
    # tau=0.20 degraded it (one seed lost the track) and tau=0.10 was
    # equivalent.  Its firing rate depends on the bank size; its speed
    # gain on the GPU is not measured yet.  reference_parity() keeps 0.0.
    resample_min_ess: float = 0.15
    # online exposure control (useOnlineExposeTimeControl / expose_time_base)
    use_online_exposure_control: bool = False
    expose_time_base: float = 2000.0

    # --- promoted constants (reference hard-codes, SURVEY.md §5) ---
    pf_max_retries: int = 80  # pose_estimator.cpp:616
    pf_exit_gate_factor: int = 5  # weight > M*min(5, numLED) (:616)
    pf_accept_gate_factor: int = 3  # weight > M*min(3, numLED) (:633)
    # The reference writes `+2/3*numLED` at :637 with *integer* division,
    # so the marginal branch never fires there; 0.0 reproduces that
    # behaviour (default — enabling it causes spurious short-P3P re-inits
    # on marginal frames), 2/3 enables the intended recovery path.
    marginal_margin_factor: float = 0.0
    # PF initialisation demands every marker visible (pose_estimator.cpp:
    # 1507) — under per-frame occlusions this blocks re-init ~50% of
    # frames.  The default 4 (the IPE minimum the reference itself uses
    # on its other path, :1740) lets PF init from partial constellations,
    # validated by benchmarks/accuracy.py config2 (occlusion robustness).
    # 0 = reference-parity (all markers required).
    pf_init_min_markers: int = 4
    noise_inflation_per_10_iters: float = 0.025  # :563-565
    uncertainty_cap: int = 200  # :639
    jump_threshold: float = 0.3  # :693-695
    min_num_leds_detected: int = 4  # pose_estimator.h:104
    # GN reaches the f32 noise floor in ~5 iterations; in f32 the step
    # rarely falls below ~1e-4 (solve jitter), so budget beats tolerance.
    # <=32 iterations fully unrolls (pf/refine.py); typical convergence
    # is 4-10 iterations, masked past convergence.
    # 25 (not 12): under outlier-heavy frames the extra polish iterations
    # measurably raise the tracked fraction (tests/test_robustness.py)
    gn_max_iterations: int = 25
    gn_convergence_tol: float = 1e-4  # ~0.1 mm/0.1 mrad step; f32 floors above 1e-6 (ref: 1e-13 in f64)
    # Refine the pair sets of the top-H particles (vmapped GN) and keep
    # the hypothesis with the lowest per-pair residual.  The reference
    # refines only the most-resampled particle (:684-690) — equivalent to
    # H=1 — but under injected/shifted outlier detections (its own fault-
    # injection mechanism) the single greedy pair set can bind a marker
    # to a spurious blob; residual-based selection across hypotheses
    # rejects those bindings.  On clean frames all hypotheses converge to
    # the same optimum, so H>1 is behaviour-preserving there.
    gn_hypotheses: int = 4
    # feasibility gate for hypothesis selection: max per-pair converged
    # residual (px) below which a binding is considered clean
    gn_residual_gate: float = 1.5
    # GN may move the winning particle at most this far (m); farther
    # means it converged into a coincidental distant basin
    gn_step_radius: float = 0.08
    # Temporal-consistency gate on fresh initialisations: while the
    # tracker was recently tracking (uncertainty below the cap), reject
    # an init pose farther than this radius (m) from the last tracked
    # pose — wrong-but-self-consistent correspondence sets pass the
    # certainty checks but teleport the pose.  0.0 disables (reference
    # parity: the reference accepts any validated init).
    init_consistency_radius: float = 0.08
    # rotation leg of the temporal-consistency gate (round 5): a wrong
    # re-init can land translationally NEAR the remembered pose but
    # heavily rotated (measured: a 70 mm / 69 deg flipped-mode landing
    # sailed through the translation-only gate and locked for the rest
    # of the window).  While recently tracking, also veto validated
    # inits rotated more than this many degrees from the remembered
    # orientation; a degraded lock's remembered orientation is itself
    # only ~10-20 deg off, so genuine re-acquires pass and each veto
    # still bumps uncertainty toward the unlatch.  0 disables.
    init_consistency_rotation_deg: float = 35.0
    init_consistency_uncertainty_cap: int = 60
    # Each rejected-as-inconsistent init bumps uncertainty by this much
    # (on top of the ordinary failure bump): a VALIDATED init the gate
    # refuses is itself evidence the remembered pose is stale, so the
    # gate must unlatch after a few consecutive rejections rather than
    # block every re-init until the slow 1-2/frame bumps cross the cap.
    init_consistency_reject_bump: int = 20
    # Also validate drop-one-pair variants of the top-K ranked init
    # candidates (tracker/initialise.py): under an occlusion + spurious
    # blobs every full candidate can carry exactly one wrong pair, which
    # the reference's all-or-nothing validation rejects wholesale.
    # 0 disables (reference parity).
    init_drop_one_variants: int = 6
    # Force a (gate-free) re-initialisation after this many CONSECUTIVE
    # accepted frames whose best particle explains fewer than all
    # markers: a wrong-but-self-consistent pose lock explains only a
    # subset of the detections every frame, while healthy tracking drops
    # below full explanation only on occluded frames (non-consecutive).
    # 0 disables (reference parity: the reference can lock onto such
    # poses indefinitely — its uncertainty ladder never fires above the
    # accept gate).
    degraded_reinit_frames: int = 12
    # Strong-frame handling for the degraded counter (round 5): with
    # decay > 0 a strong frame DECAYS the counter by this amount
    # instead of zeroing it, so a wrong lock's occasional pseudo-strong
    # frame (a clone completing the constellation just over the
    # M*(M+offset) bar — measured 27.7 vs 27.5) cannot grant the lock
    # another full degraded_reinit_frames of life.  MEASURED NEGATIVE
    # as a default (80-frame outlier config, 50k, 5 seeds): decay=2
    # fires 1-3 re-inits/seed and each re-init under clone-corrupted
    # detections is a fresh chance to land in a wrong basin — tracked
    # 0.875 / mean orientation 29 deg vs 0.923 / 17 deg with the hard
    # reset; the re-init LANDING quality, not lock detection, is the
    # bottleneck.  Default 0 (hard reset, the round-4 behaviour); the
    # knob remains for deployments where unbounded lock duration is
    # worse than re-init churn (the rotation-consistency gate,
    # init_consistency_rotation_deg, blocks the worst flipped-mode
    # landings either way).
    degraded_reset_decay: int = 0
    # Coast through isolated PF rejections (engine extension; 0 =
    # reference parity).  The reference resets the whole track the
    # moment no particle clears the accept gate (:707-719) — on an
    # outlier-heavy frame (occlusion + spurious blobs) that throws away
    # a still-good particle bank and pays a 3-5 frame brute-force
    # re-init cascade.  With coast > 0, a MATURE track (it_since_
    # initialized == 2) survives up to this many consecutive rejected
    # frames: the pose is not updated (pose_updated=False, flag 40 as
    # in the reference) but the bank and prediction persist, so the
    # next frame's PF re-acquires from the surviving particles.
    pf_coast_frames: int = 2
    # a frame counts as degraded when the best weight is below
    # M * (M + offset) — i.e. not all markers matched at close range
    degraded_weight_offset: float = 0.5
    # Reject single-frame pose teleports: when the refined pose lands
    # farther than this radius (m) from the constant-velocity prediction,
    # keep the prediction for this frame (the bank retains both basins;
    # the true one re-wins next frame).  The reference only FLAGS jumps
    # (flag 1.5, rotation entries only, :692-701) and publishes the
    # jumped pose anyway; 0.0 restores that behaviour (the default:
    # with the PF's own recovery, clamping also suppresses genuine
    # post-re-init corrections and measured net-worse on the outlier
    # benchmark — the knob remains for static-scene deployments).
    jump_translation_radius: float = 0.0
    # Motion-consistency prior (engine extension): the PF weight is a
    # pure reprojection likelihood, so a clone-fed distant mode that
    # ties the likelihood flips the argmax frame-to-frame.  Multiplying
    # the weights by a soft prior on distance from the predicted pose —
    # exp(-((d - radius)/falloff)^2 / 2) beyond the radius — makes the
    # posterior prefer the temporally continuous mode.  Engaged only on
    # a mature track whose extrapolated step is itself below the radius
    # (after a mode flip the const-velocity prediction is garbage and
    # the prior disengages, letting the track snap back).  A sustained
    # wrong lock then scores below the degraded threshold every frame
    # and the degraded_reinit ladder breaks it.  0.0 disables
    # (reference parity).
    motion_prior_radius: float = 0.05
    motion_prior_falloff: float = 0.012
    # Adaptive blob-area schedule (:435-439)
    abs_min_blob_area: float = 5.0
    abs_max_blob_area: float = 20.0
    blob_area_distance_slope: float = 10.0
    # ROI growth (:139-143, 425-432, 454-457)
    roi_uncertainty_growth: float = 7.0
    roi_distance_gain: float = 20.0
    roi_retry_growth: float = 20.0

    # --- fixed capacities (new; fixed-shape equivalents of dynamic sizes) ---
    max_candidates_per_led: int = 4  # histogram cartesian-product cap
    # The reference walks the full ranked candidate list (:1733); with
    # outliers the true assignment can rank ~10-30th, so the fixed-shape
    # budget must be generous (each check is only a C(M,3)-sized batch).
    max_correspondence_candidates: int = 32
    max_p3p_seeds: int = 32  # P3P poses harvested into the bank
    roi_particle_subsample: int = 128  # particles used for ROI prediction

    # Init gating heuristics (:1557-1581); reference values disable the
    # pair-distance gate (1000 px) and require a 5-cluster.
    init_pair_distance_gate: float = 1000.0
    init_cluster_radius: float = 1000.0
    init_cluster_min: int = 5

    # Development-only stage skips for performance bisection; never set in
    # production configs.  Recognised: "propagate", "weight", "resample".
    debug_skip: Tuple[str, ...] = ()

    @classmethod
    def reference_parity(cls, **overrides) -> "TrackerConfig":
        """A config with every engine-only robustness extension disabled,
        matching the reference's exact behaviour (used by the oracle
        parity tests; production defaults enable the extensions)."""
        base = dict(
            pf_init_min_markers=0,
            init_drop_one_variants=0,
            init_consistency_radius=0.0,
            degraded_reinit_frames=0,
            gn_hypotheses=1,
            jump_translation_radius=0.0,
            motion_prior_radius=0.0,
            marginal_margin_factor=0.0,
            split_merged_blobs=False,
            resample_min_ess=0.0,
            pf_coast_frames=0,
        )
        base.update(overrides)
        return cls(**base)

    def blob_params(self, adaptive: bool = False) -> BlobParams:
        return BlobParams(
            threshold=self.threshold_value,
            gaussian_sigma=self.gaussian_sigma,
            min_blob_area=self.min_blob_area,
            max_blob_area=self.max_blob_area,
            max_width_height_distortion=self.max_width_height_distortion,
            max_circular_distortion=self.max_circular_distortion,
            active_markers=self.active_markers,
            max_detections=self.max_detections,
            cc_sweeps=self.cc_sweeps,
            roi_crop=self.roi_crop,
            split_merged=self.split_merged_blobs,
            split_max_factor=self.split_max_factor,
            split_min_elongation=self.split_min_elongation,
            split_dip_ratio=self.split_dip_ratio,
        )
