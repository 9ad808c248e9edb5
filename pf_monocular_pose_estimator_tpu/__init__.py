"""pf_monocular_pose_estimator_tpu — LED-marker 6-DoF pose tracking in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
ObiRobotics/pf_monocular_pose_estimator (PF-MPE): LED blob detection,
combinatorial P3P initialisation, particle-filter tracking and Gauss-Newton
pose refinement — expressed as fixed-shape, functionally-pure, batched array
programs that run on a GPU and shard the particle bank across a device mesh.

Layer map (cf. SURVEY.md §7):
  geometry/  SE(3) exp/log, pinhole camera + plumb-bob distortion, Umeyama
  solvers/   batched Ferrari quartic + Kneip P3P, combinatoric index tables
  ops/       image programs: threshold+blur, connected components, moments
  pf/        particle filter: propagate, weight, resample, refine; the
             fused propagate+weight GPU kernel (pallas_step.py)
  tracker/   per-frame state machine: init / track / recover, multi-target
  parallel/  mesh sharding of the particle bank, distributed resampling
  io/        marker YAML, camera calib, synthetic sequences, metrics, viz
  utils/     config, platform routes, fail-flag taxonomy, checkpointing
"""

__version__ = "0.1.0"

# On the GPU, XLA may run float32 matmuls in TF32, which keeps about three
# decimal digits.  The geometry pipeline's 4x4 pose composes, marker
# projections, blob-moment matmuls, blur convolutions and Gauss-Newton
# normal equations are small matmuls whose rounding lands directly in the
# pixel residuals, so the library asks for full float32 ("highest") for
# the whole process.  Its cost in speed and accuracy on the card is not
# measured yet.  Opt out (e.g. to A/B the effect) with
# PFMPE_DEFAULT_MATMUL_PRECISION=default.
import os as _os

if _os.environ.get("PFMPE_DEFAULT_MATMUL_PRECISION", "").lower() != "default":
    import jax as _jax

    _jax.config.update("jax_default_matmul_precision", "highest")
