"""Mesh sharding tests on the virtual 8-device CPU mesh (SURVEY.md §7
layer 6): sharded-vs-single equivalence and multi-target sharding."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from pf_monocular_pose_estimator_tpu.geometry import Camera, exp_se3
from pf_monocular_pose_estimator_tpu.io.synthetic import demo_markers, render_frame
from pf_monocular_pose_estimator_tpu.parallel.mesh import (
    make_mesh,
    make_sharded_multi_tracker,
    make_sharded_tracker,
    shard_target_state,
)
from pf_monocular_pose_estimator_tpu.pf import stratified_resample, weight_particles
from pf_monocular_pose_estimator_tpu.tracker import TargetState, make_tracker
from pf_monocular_pose_estimator_tpu.tracker.multi import create_states, make_multi_tracker
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig

N_PART = 256


@pytest.fixture(scope="module")
def camera():
    return Camera.create(fx=150.0, fy=150.0, cx=80.0, cy=48.0, width=160, height=96)


@pytest.fixture(scope="module")
def markers():
    return demo_markers()


@pytest.fixture(scope="module")
def config():
    return TrackerConfig(
        n_particles=N_PART,
        threshold_value=150.0,
        min_blob_area=3.0,
        pf_max_retries=4,
        max_detections=12,
        max_correspondence_candidates=8,
        roi_particle_subsample=16,
    )


@pytest.fixture(scope="module")
def frame(camera, markers):
    pose = np.array(exp_se3(jnp.asarray([0.0, 0.0, 0.0, 0.1, -0.1, 0.05], jnp.float32)))
    pose[2, 3] += 1.0
    return render_frame(camera, jnp.asarray(pose), markers, blob_sigma=1.5), jnp.asarray(pose)


def test_eight_devices_available():
    assert len(jax.devices()) >= 8


def test_sharded_weighting_matches_single(camera, markers):
    bank = jax.vmap(lambda k: exp_se3(jax.random.normal(k, (6,)) * 0.1))(
        jax.random.split(jax.random.PRNGKey(0), N_PART)
    )
    bank = bank.at[:, 2, 3].add(1.0)
    det = jnp.asarray(np.random.default_rng(0).uniform(0, 150, (12, 2)), jnp.float32)
    det_mask = jnp.ones((12,), bool)
    args = (markers, jnp.ones(5, bool), det, det_mask, 10.0, 5.0, jnp.zeros(5, bool))

    w_single, _, _ = weight_particles(camera, bank, *args)

    mesh = make_mesh(particle_devices=8)
    from jax.sharding import NamedSharding, PartitionSpec as P

    bank_sharded = jax.device_put(bank, NamedSharding(mesh, P("particles")))
    w_sharded, _, _ = jax.jit(lambda b: weight_particles(camera, b, *args))(bank_sharded)
    np.testing.assert_allclose(np.asarray(w_single), np.asarray(w_sharded), rtol=1e-5)


def test_sharded_tracker_step_matches_unsharded(camera, markers, config, frame):
    img, _ = frame
    state = TargetState.create(N_PART, jax.random.PRNGKey(3), (camera.width, camera.height))
    t = jnp.asarray(0.02, jnp.float32)

    plain = make_tracker(camera, markers, jnp.ones(5, bool), config)
    s1, r1 = plain(state, img, t)

    mesh = make_mesh(particle_devices=4, target_devices=2)
    sharded_step = make_sharded_tracker(camera, markers, jnp.ones(5, bool), config, mesh)
    s2, r2 = sharded_step(shard_target_state(state, mesh), img, t)

    assert int(r1.fail_flag) == int(r2.fail_flag)
    np.testing.assert_allclose(np.asarray(r1.pose), np.asarray(r2.pose), atol=1e-4)
    np.testing.assert_allclose(np.asarray(s1.bank), np.asarray(s2.bank), atol=1e-4)


def test_sharded_multi_target_step(camera, markers, config, frame):
    img, _ = frame
    mesh = make_mesh(particle_devices=4, target_devices=2)
    n_targets = 4
    markers_t = jnp.broadcast_to(markers, (n_targets, 5, 4))
    masks_t = jnp.ones((n_targets, 5), bool)

    states = create_states(n_targets, N_PART, seed=0, image_size=(camera.width, camera.height))
    states = shard_target_state(states, mesh, batched=True)
    step = make_sharded_multi_tracker(camera, markers_t, masks_t, config, mesh)
    states, results = step(states, img, jnp.asarray(0.02, jnp.float32))
    flags = np.asarray(results.fail_flag)
    assert flags.shape == (n_targets,)
    assert (flags == 0).all(), flags  # all targets initialise on this frame


def test_multi_tracker_unsharded(camera, markers, config, frame):
    img, _ = frame
    n_targets = 3
    markers_t = jnp.broadcast_to(markers, (n_targets, 5, 4))
    masks_t = jnp.ones((n_targets, 5), bool)
    step = make_multi_tracker(camera, markers_t, masks_t, config)
    states = create_states(n_targets, N_PART, image_size=(camera.width, camera.height))
    states, results = step(states, img, jnp.asarray(0.02, jnp.float32))
    assert np.asarray(results.pose).shape == (3, 4, 4)
    assert (np.asarray(results.fail_flag) == 0).all()


def test_resample_sharded_equivalence():
    w = jnp.asarray(np.random.default_rng(1).uniform(0, 1, 512), jnp.float32)
    anc1, counts1, most1 = stratified_resample(jax.random.PRNGKey(5), w)
    mesh = make_mesh(particle_devices=8)
    from jax.sharding import NamedSharding, PartitionSpec as P

    w_sh = jax.device_put(w, NamedSharding(mesh, P("particles")))
    anc2, counts2, most2 = jax.jit(stratified_resample)(jax.random.PRNGKey(5), w_sh)
    np.testing.assert_array_equal(np.asarray(anc1), np.asarray(anc2))
    assert int(most1) == int(most2)


def test_multihost_entry_single_process():
    """The multi-host launcher wiring (initialize_distributed no-op path,
    job mesh over all devices, frame broadcast) runs single-process on
    the virtual 8-device mesh."""
    import numpy as np
    from pf_monocular_pose_estimator_tpu.parallel.distributed import (
        broadcast_frame,
        initialize_distributed,
        make_job_mesh,
    )

    assert initialize_distributed(None, 1, None) == 0
    mesh = make_job_mesh(target_devices=1)
    assert mesh.devices.size == len(jax.devices())
    frame = np.arange(12, dtype=np.float32).reshape(3, 4)
    arr = broadcast_frame(frame, mesh)
    assert arr.shape == (3, 4)
    np.testing.assert_array_equal(np.asarray(arr), frame)
    assert arr.sharding.is_fully_replicated


@pytest.mark.slow
def test_multihost_two_real_processes(tmp_path):
    """GENUINE multi-process jax.distributed run: two OS processes, two
    virtual CPU devices each (4 global), full sharded tracker with the
    explicit distributed-resampling collectives riding the Gloo backend.
    This is the CI stand-in for a multi-host job (SURVEY §2
    'collective backend' row) — same code path as
    `python -m ...parallel.distributed` on real hosts."""
    import socket
    import subprocess
    import sys as _sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    worker = tmp_path / "worker.py"
    worker.write_text(
        "import os, sys\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "os.environ['XLA_FLAGS'] = os.environ.get('XLA_FLAGS', '') + "
        "' --xla_force_host_platform_device_count=2'\n"
        f"sys.path.insert(0, {repr(REPO_ROOT)})\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from pf_monocular_pose_estimator_tpu.parallel.distributed import run_multihost\n"
        "run_multihost(['--coordinator', '127.0.0.1:' + sys.argv[3],"
        " '--num-processes', sys.argv[2], '--process-id', sys.argv[1],"
        " '--particles', '1024', '--frames', '6'])\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    procs = [
        subprocess.Popen(
            [_sys.executable, str(worker), str(pid), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=540) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-800:] for o in outs]
    summary = json.loads(
        [line for line in outs[0][0].splitlines() if line.startswith("{")][-1]
    )
    assert summary["processes"] == 2 and summary["devices"] == 4
    assert summary["tracked"] == 6
