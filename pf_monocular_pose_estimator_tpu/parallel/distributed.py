"""Multi-process entry: jax.distributed initialisation + frame broadcast.

The reference is a single process (SURVEY.md §1: "no scheduler, no
distributed communication layer"); scaling across devices comes from
BASELINE.json configs[4] — a 1M-particle bank sharded over a mesh.  On
one host a single process drives every card (the cards are joined all to
all by NVLink and `make_sharded_tracker` needs nothing from this
module).  This module is the launcher tier for jobs of several
processes:

  * `initialize_distributed` wires `jax.distributed.initialize` (the
    coordinator address, process count and id are always explicit);
  * `make_job_mesh` builds the ('targets', 'particles') mesh over ALL
    devices in the job — the same axis names the single-process path
    uses, so `make_sharded_tracker` / `make_sharded_multi_tracker` run
    unchanged;
  * `broadcast_frame` turns each process's local camera frame into a
    fully-replicated global array via
    `jax.make_array_from_process_local_data`;
  * `run_multihost` is the per-process main: every process executes the
    same program; the collectives (the scalar all-gathers + ppermute ring
    of parallel/resample.py, the psum weight normalisation) go to NCCL.

Usage (one command per process):

    python -m pf_monocular_pose_estimator_tpu.parallel.distributed \
        --coordinator localhost:8476 --num-processes 2 --process-id $ID \
        --particles 1000000

The wiring is tested single-process by
tests/test_parallel.py::test_multihost_entry_single_process and the
virtual-mesh dry run (`__graft_entry__.dryrun_multichip`).
"""

from __future__ import annotations

import argparse
from typing import Optional

import jax
import numpy as np


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialise the JAX distributed runtime.  No-op for a single
    process (num_processes in (None, 1)).  Returns the process id."""
    if num_processes is None or num_processes <= 1:
        return 0
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_index()


def make_job_mesh(target_devices: int = 1):
    """('targets', 'particles') mesh over every device in the job
    (all processes).  Mirrors parallel.mesh.make_mesh but over the
    global device list, laid out so the particles axis stays contiguous
    within each process."""
    from jax.sharding import Mesh

    devices = jax.devices()  # global across processes
    n = len(devices)
    particle_devices = n // target_devices
    grid = np.array(devices[: target_devices * particle_devices]).reshape(
        target_devices, particle_devices
    )
    return Mesh(grid, ("targets", "particles"))


def broadcast_frame(frame: np.ndarray, mesh) -> jax.Array:
    """Host-local (H, W) frame -> globally-replicated device array.

    Every process passes its local copy of the SAME frame (one camera
    feeds all hosts); the result is one global array replicated over the
    mesh, assembled without routing every byte through host 0.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P())  # replicated
    if jax.process_count() == 1:
        return jax.device_put(frame, sharding)
    return jax.make_array_from_process_local_data(sharding, np.asarray(frame))


def run_multihost(argv=None):
    ap = argparse.ArgumentParser(description="multi-host PF tracker")
    ap.add_argument("--coordinator", type=str, default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--targets", type=int, default=1)
    args = ap.parse_args(argv)

    pid = initialize_distributed(args.coordinator, args.num_processes, args.process_id)

    import jax.numpy as jnp

    from ..io.synthetic import default_camera, demo_markers, make_orbit_sequence
    from ..tracker import TargetState
    from ..utils import TrackerConfig
    from .mesh import make_sharded_tracker, shard_target_state

    camera = default_camera()
    markers = demo_markers()
    config = TrackerConfig(
        n_particles=args.particles, min_blob_area=8.0, pf_max_retries=8
    )
    mesh = make_job_mesh(target_devices=args.targets)
    step = make_sharded_tracker(
        camera, markers, jnp.ones((markers.shape[0],), bool), config, mesh
    )
    state = shard_target_state(
        TargetState.create(config.n_particles, jax.random.PRNGKey(0)), mesh
    )
    seq = make_orbit_sequence(camera, markers, num_frames=args.frames, fps=50.0)

    import time

    tracked = 0
    t0 = time.perf_counter()
    for i in range(args.frames):
        frame = broadcast_frame(np.asarray(seq.frames[i]), mesh)
        state, res = step(state, frame, seq.times[i])
        tracked += int(np.asarray(res.pose_updated))
    jax.block_until_ready(state)
    wall = time.perf_counter() - t0
    if pid == 0:
        import json

        print(
            json.dumps(
                {
                    "processes": jax.process_count(),
                    "devices": jax.device_count(),
                    "particles": args.particles,
                    "frames": args.frames,
                    "tracked": tracked,
                    "fps": round(args.frames / wall, 2),
                }
            )
        )


if __name__ == "__main__":
    run_multihost()
