"""Online exposure-time control as a pure state machine.

Functional parity target: LEDDetector::ExposeTimeControl and its trigger
logic (pf_mpe_lib/src/led_detector.cpp:124-165, 490-512).  The reference
tracks the blob-area / ROI-area fraction across frames in function-static
counters and, after 500 consecutive low/high frames, shells out to the
camera driver via `system("rosrun dynamic_reconfigure dynparam set ...")`.

Functional redesign: the hidden static counters become an explicit `ExposureState`
pytree threaded through the tracker, and the side effect becomes a returned
recommendation (`exposure_us`) the host I/O layer may apply to whatever
camera transport it owns.  Same thresholds (0.013 / 0.037), same 500-frame
hysteresis, same +-20% step around `expose_time_base`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


LOW_FRACTION = 0.013
HIGH_FRACTION = 0.037
HYSTERESIS_FRAMES = 500
STEP_FRACTION = 0.2


class ExposureState(NamedTuple):
    counter_increase: jnp.ndarray  # int32
    counter_decrease: jnp.ndarray  # int32
    exposure_us: jnp.ndarray  # float32, current recommendation

    @classmethod
    def create(cls, expose_time_base: float = 2000.0):
        return cls(
            counter_increase=jnp.zeros((), jnp.int32),
            counter_decrease=jnp.zeros((), jnp.int32),
            exposure_us=jnp.asarray(expose_time_base, jnp.float32),
        )


def exposure_control(
    state: ExposureState,
    blob_area_sum: jnp.ndarray,
    roi_area: jnp.ndarray,
    expose_time_base: float,
    any_detections: jnp.ndarray,
) -> ExposureState:
    """Advance the exposure state machine by one frame."""
    frac = blob_area_sum / jnp.maximum(roi_area, 1.0)
    low = any_detections & (frac < LOW_FRACTION)
    high = any_detections & (frac > HIGH_FRACTION)

    inc_ctr = jnp.where(low, state.counter_increase + 1, state.counter_increase)
    dec_ctr = jnp.where(high, state.counter_decrease + 1, state.counter_decrease)

    fire_inc = inc_ctr > HYSTERESIS_FRAMES
    fire_dec = dec_ctr > HYSTERESIS_FRAMES
    step = STEP_FRACTION * expose_time_base
    exposure = jnp.where(
        fire_inc,
        state.exposure_us + step,
        jnp.where(fire_dec, state.exposure_us - step, state.exposure_us),
    )
    reset = fire_inc | fire_dec
    return ExposureState(
        counter_increase=jnp.where(reset, 0, inc_ctr),
        counter_decrease=jnp.where(reset, 0, dec_ctr),
        exposure_us=exposure,
    )
