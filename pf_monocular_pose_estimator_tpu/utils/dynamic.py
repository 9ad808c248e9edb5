"""Runtime-tunable parameters as a traced pytree.

The reference retunes 23 parameters live via dynamic_reconfigure
(cfg/PFMonocularPoseEstimator.cfg:12-40) without rebuilding anything.
Making every parameter a static jit argument would make each change a
full recompile of the tracker step.  This module splits out the
*hot-tunable* subset — pixel tolerances, motion-noise bounds, gate
factors, recovery thresholds — as a `DynamicParams` pytree of scalar
arrays that rides into the compiled step as a traced operand: changing a
value is a zero-cost host->device transfer, exactly like a
dynamic_reconfigure push.

Parameters that shape the program itself (particle count, capacities,
blur sigma — it sets the static tap count — capacity-like blob params)
stay static in TrackerConfig, as they do in the reference's
launch-file tier; the detection threshold is a plain compare operand,
so it is traced too.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import jax.numpy as jnp

if TYPE_CHECKING:  # pragma: no cover
    from .config import TrackerConfig


class DynamicParams(NamedTuple):
    """Traced runtime-tunable parameters (dynamic_reconfigure tier).

    All leaves are float32 scalars; integer-valued gates are carried as
    floats and compared with traced arithmetic.
    """

    # pixel tolerances (cfg:18-19, 32)
    back_projection_pixel_tolerance: jnp.ndarray  # init/scoring tolerance
    back_projection_pixel_tolerance_pf: jnp.ndarray  # PF match gate
    nearest_neighbour_pixel_tolerance: jnp.ndarray  # IPE NN gate
    # validation thresholds (cfg:20-21)
    certainty_threshold: jnp.ndarray
    valid_correspondence_threshold: jnp.ndarray
    # motion-noise bounds (cfg:28-31 / launch tier)
    min_translation_noise: jnp.ndarray
    max_translation_noise: jnp.ndarray
    min_angular_noise: jnp.ndarray
    max_angular_noise: jnp.ndarray
    # PF gates + recovery ladder (promoted constants)
    pf_exit_gate_factor: jnp.ndarray  # weight > M*min(f, numLED)
    pf_accept_gate_factor: jnp.ndarray
    marginal_margin_factor: jnp.ndarray
    noise_inflation_per_10_iters: jnp.ndarray
    jump_threshold: jnp.ndarray
    # init gating heuristics (pose_estimator.cpp:1557-1581)
    init_pair_distance_gate: jnp.ndarray
    init_cluster_radius: jnp.ndarray
    # detection binarisation threshold (cfg:12) — a traced compare
    # operand of the detection front-end
    threshold_value: jnp.ndarray
    # detection blob-area bounds + the two shape-distortion ratios
    # (cfg:13-17, minus gaussian_sigma which legitimately stays static —
    # it sets the blur kernel's tap count): all four are plain compare
    # operands in the filter stage, so they retune with no recompile
    min_blob_area: jnp.ndarray
    max_blob_area: jnp.ndarray
    max_width_height_distortion: jnp.ndarray
    max_circular_distortion: jnp.ndarray

    @classmethod
    def from_config(cls, config: "TrackerConfig") -> "DynamicParams":
        f = lambda v: jnp.asarray(v, jnp.float32)
        return cls(
            back_projection_pixel_tolerance=f(config.back_projection_pixel_tolerance),
            back_projection_pixel_tolerance_pf=f(
                config.back_projection_pixel_tolerance_pf
            ),
            nearest_neighbour_pixel_tolerance=f(
                config.nearest_neighbour_pixel_tolerance
            ),
            certainty_threshold=f(config.certainty_threshold),
            valid_correspondence_threshold=f(config.valid_correspondence_threshold),
            min_translation_noise=f(config.min_translation_noise),
            max_translation_noise=f(config.max_translation_noise),
            min_angular_noise=f(config.min_angular_noise),
            max_angular_noise=f(config.max_angular_noise),
            pf_exit_gate_factor=f(config.pf_exit_gate_factor),
            pf_accept_gate_factor=f(config.pf_accept_gate_factor),
            marginal_margin_factor=f(config.marginal_margin_factor),
            noise_inflation_per_10_iters=f(config.noise_inflation_per_10_iters),
            jump_threshold=f(config.jump_threshold),
            init_pair_distance_gate=f(config.init_pair_distance_gate),
            init_cluster_radius=f(config.init_cluster_radius),
            threshold_value=f(config.threshold_value),
            min_blob_area=f(config.min_blob_area),
            max_blob_area=f(config.max_blob_area),
            max_width_height_distortion=f(config.max_width_height_distortion),
            max_circular_distortion=f(config.max_circular_distortion),
        )
