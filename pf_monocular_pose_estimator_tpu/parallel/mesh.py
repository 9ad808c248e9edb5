"""Mesh sharding of the particle bank and multi-target tracks.

The reference is a single-threaded estimator (SURVEY.md §2: no DP/TP/PP,
no comm backend); the scale axes here come from BASELINE.json's north
star: shard the particle bank over a `particles` mesh axis and the
per-target banks over a `targets` axis, with weight normalisation / ESS /
resampling done by collectives (psum / all_gather / ppermute, which XLA
hands to NCCL on GPUs), and the camera frame replicated to all devices.

Design notes:
  * The whole tracker step is one jit; `NamedSharding` annotations on the
    bank-shaped leaves are enough for GSPMD to partition propagation,
    projection and weighting (embarrassingly parallel over particles) and
    to insert the psum of the weight moments.  Resampling runs the
    explicit distributed scheme of parallel/resample.py.
  * The cards of one host are joined all to all by NVLink, so every card
    reaches every other at the same rate: the mesh shape follows the
    algorithm (targets x particles), not a topology.  One process drives
    all of them; several hosts run the same program under
    `jax.distributed.initialize` (parallel/distributed.py).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry.camera import Camera
from ..ops.exposure import ExposureState
from ..tracker.state import TargetState
from ..tracker.step import tracker_step
from ..utils.backend import pf_route
from ..utils.config import TrackerConfig
from .pf_kernels import make_sharded_pf_fn


def make_mesh(
    particle_devices: Optional[int] = None,
    target_devices: int = 1,
    devices=None,
) -> Mesh:
    """Build a ('targets', 'particles') mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if particle_devices is None:
        particle_devices = len(devices) // target_devices
    n = target_devices * particle_devices
    import numpy as np

    grid = np.array(devices[:n]).reshape(target_devices, particle_devices)
    return Mesh(grid, ("targets", "particles"))


def _state_shardings(mesh: Mesh, batched: bool = False):
    """PartitionSpec pytree for a TargetState: bank-shaped leaves are
    sharded over 'particles' (and 'targets' when batched); small leaves
    replicated."""
    lead = ("targets",) if batched else ()
    bank_spec = P(*lead, None, "particles")  # (16, N) SoA: shard lanes
    weights_spec = P(*lead, "particles")
    small = P(*lead) if batched else P()
    return TargetState(
        key=small,
        current_pose=small,
        previous_pose=small,
        predicted_pose=small,
        covariance=small,
        bank=bank_spec,
        resampled=bank_spec,
        weights=weights_spec,
        it_since_initialized=small,
        uncertainty=small,
        degraded_frames=small,
        coast_frames=small,
        resample_clipped=small,
        roi=small,
        time_current=small,
        time_previous=small,
        fail_flag=small,
        pose_updated=small,
        num_gn_iterations=small,
        obs_cam_old=small,
        change_cam_pose=small,
        time_obs_act=small,
        cam_time_shift=small,
        exposure=ExposureState(small, small, small),
    )


def shard_target_state(state: TargetState, mesh: Mesh, batched: bool = False) -> TargetState:
    """Place a TargetState onto the mesh with the canonical shardings."""
    specs = _state_shardings(mesh, batched)
    return jax.tree_util.tree_map(
        lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)), state, specs
    )


def _pf_hook(camera, config, mesh, interpret):
    """The sharded step's PF hook: the shard_map'd fused kernel when the
    platform's route is the kernel (utils/backend.py) or the caller asks
    for the kernel in interpret mode (CPU tests); otherwise None, and
    GSPMD partitions the XLA SoA path."""
    if interpret or pf_route() == "triton":
        return make_sharded_pf_fn(mesh, camera, config, interpret=interpret)
    return None


def make_sharded_tracker(
    camera: Camera,
    markers_h,
    marker_mask,
    config: TrackerConfig,
    mesh: Mesh,
    resample_reach: int = 1,
    payload_window: int | str | None = "auto",
    cdf_chunk: int | None = None,
    interpret: bool = False,
):
    """Jitted single-target step with the bank sharded over 'particles'.

    Returns `step(state, image, t) -> (state', FrameResult)`; state must
    be placed with `shard_target_state` first (or anywhere — GSPMD will
    reshard to the declared in_shardings).

    Resampling goes through the EXPLICIT distributed scheme
    (`parallel.resample`): scalar-only global collectives + a
    reach-limited ppermute ring — never an all-gather of the (16, N)
    bank (pinned by tests/test_distributed_resample.py's HLO check).
    Where the platform's PF route is the fused kernel, it runs PER SHARD
    via shard_map (`parallel.pf_kernels`); interpret=True forces it in
    the Pallas interpreter (CPU tests).

    payload_window / cdf_chunk pass straight through to
    `make_distributed_resampler`: the window bounds the ring payload
    (None = full blocks, exact under any skew the reach covers); when
    per-shard weight skew exceeds it, the overflow draws are clamped and
    COUNTED — watch `FrameResult.resample_clipped` (cumulative) to see
    skew-induced degradation, and widen the window / use None if it
    fires (round-4 advisor finding: the default window used to be
    neither tunable nor observable from here).
    """
    from .resample import make_distributed_resampler

    markers_h = jnp.asarray(markers_h)
    marker_mask = jnp.asarray(marker_mask, bool)
    pf_fn = _pf_hook(camera, config, mesh, interpret)
    specs = _state_shardings(mesh)
    state_shardings = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), specs)
    repl = NamedSharding(mesh, P())
    resampler = make_distributed_resampler(
        mesh, config.n_particles, reach=resample_reach,
        payload_window=payload_window, cdf_chunk=cdf_chunk,
    )

    def _step(state, image, t):
        return tracker_step(
            state, image, t, camera, markers_h, marker_mask, config,
            resample_fn=resampler, pf_fn=pf_fn,
        )

    return jax.jit(
        _step,
        in_shardings=(state_shardings, repl, repl),
        out_shardings=(state_shardings, repl),
        donate_argnums=(0,),
    )


def make_sharded_multi_tracker(
    camera: Camera,
    markers_h,  # (T, M, 4)
    marker_masks,  # (T, M)
    config: TrackerConfig,
    mesh: Mesh,
    resample_reach: int = 1,
    payload_window: int | str | None = "auto",
    cdf_chunk: int | None = None,
    interpret: bool = False,
):
    """Multi-target step: targets vmapped and sharded over 'targets',
    each target's bank sharded over 'particles'.

    Multi-target parity target: the reference's per-object `_Vec` loop
    (pose_estimator.cpp:89-736, SURVEY.md §2 #20) — here the targets are
    a batch axis over the mesh instead of a serial host loop.
    resample_reach / payload_window / cdf_chunk: see
    `make_sharded_tracker` (per-target clip diagnostics surface in
    FrameResult.resample_clipped) and interpret: see
    `make_sharded_tracker`.
    """
    markers_h = jnp.asarray(markers_h)
    marker_masks = jnp.asarray(marker_masks, bool)
    # the pf_fn hook takes the marker set as a traced operand, so one
    # hook serves every target under the vmap
    pf_fn = _pf_hook(camera, config, mesh, interpret)
    specs = _state_shardings(mesh, batched=True)
    state_shardings = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), specs)
    repl = NamedSharding(mesh, P())

    from .resample import make_distributed_resampler

    resampler = make_distributed_resampler(
        mesh, config.n_particles, reach=resample_reach,
        payload_window=payload_window, cdf_chunk=cdf_chunk,
    )

    def _one(state, image, t, markers, mask):
        return tracker_step(
            state, image, t, camera, markers, mask, config,
            resample_fn=resampler, pf_fn=pf_fn,
        )

    def _step(states, image, t):
        return jax.vmap(_one, in_axes=(0, None, None, 0, 0))(
            states, image, t, markers_h, marker_masks
        )

    return jax.jit(
        _step,
        in_shardings=(state_shardings, repl, repl),
        out_shardings=(state_shardings, None),
        donate_argnums=(0,),
    )
