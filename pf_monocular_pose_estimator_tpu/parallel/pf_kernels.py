"""shard_map wrapper that runs the fused PF kernel under mesh sharding.

GSPMD cannot auto-partition a `pallas_call` whose operands are sharded
over the lane axis.  Propagate+weight is embarrassingly parallel over
the particle axis, so each shard runs the fused kernel
(pf/pallas_step.py) on its local (16, N/P) block inside a `shard_map`.
Two ingredients make the sharded program compute what the unsharded one
computes (pinned by tests/test_sharded_pallas.py):

  * the uniform draws are a pure counter hash of the GLOBAL particle
    index, so each shard passes `lane_offset = axis_index * S` and
    `n_total = N` and recomputes exactly its slice of the global draw
    stream (zero communication);
  * the candidate lanes 0/1 (current/predicted pose pins,
    pose_estimator.cpp:545-551) are pinned by global lane index, so
    only shard 0 writes them.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ..geometry.camera import Camera
from ..pf.pallas_step import fused_propagate_weight_pallas
from ..utils.config import TrackerConfig


def make_sharded_pf_fn(
    mesh: Mesh,
    camera: Camera,
    config: TrackerConfig,
    axis: str = "particles",
    interpret: bool = False,
):
    """Build the tracker's `pf_fn` hook: one fused propagate+weight pass
    over the bank, each shard running the kernel on its local block.
    Signature matches tracker/step.py::pf_compute's hook call:

        pf_fn(key, resampled16, current_pose, predicted, prediction,
              cam_move_inv, noise, fac_t, fac_r, tracking, apply_pred,
              inflation, markers_h, marker_mask, det_xy, det_mask,
              tol_pf, tol_init, downgrade, num_markers_score)
          -> (bank16, weights)

    with bank16 (16, N) sharded P(None, axis) and weights (N,) P(axis).
    The marker set rides as a traced operand (only its capacity M is
    baked in), so one hook serves every target of a vmapped
    multi-target step.  interpret=True runs the kernel in the Pallas
    interpreter (CPU tests).
    """
    n = config.n_particles
    p = mesh.shape[axis]
    assert n % p == 0, f"n_particles={n} must divide the {axis} axis ({p})"
    local = n // p

    def body(k, resampled16, current_pose, predicted, prediction,
             cam_move_inv, noise, fac_t, fac_r, tracking, apply_pred,
             inflation, markers_h, marker_mask, det_xy, det_mask,
             tol_pf, tol_init, downgrade, num_markers_score):
        off = jax.lax.axis_index(axis) * local
        return fused_propagate_weight_pallas(
            k, resampled16, current_pose, predicted, prediction,
            cam_move_inv, noise, fac_t, fac_r, tracking, apply_pred,
            inflation, camera, markers_h, marker_mask, det_xy, det_mask,
            tol_pf, tol_init, downgrade, num_markers_score,
            interpret=interpret, lane_offset=off, n_total=n,
        )

    repl = P()
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(repl, P(None, axis)) + (repl,) * 18,
        out_specs=(P(None, axis), P(axis)),
        check_vma=False,
    )
