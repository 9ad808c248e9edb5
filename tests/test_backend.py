"""The platform routes, the compile-cache rule, and the measurement
entry points' refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from pf_monocular_pose_estimator_tpu.utils import backend, compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,route", [("cpu", "xla"), ("gpu", "triton")])
def test_pf_route_by_platform(platform, route):
    assert backend.pf_route(platform) == route


def test_pf_route_defaults_to_the_backend(monkeypatch):
    assert backend.pf_route() == "xla"  # the tests run on the CPU
    monkeypatch.setattr(backend.jax, "default_backend", lambda: "gpu")
    assert backend.pf_route() == "triton"


@pytest.mark.parametrize("platform", ["rocm", "METAL", "interpreter"])
def test_pf_route_other_platforms_raise(platform):
    with pytest.raises(ValueError, match="no implementation"):
        backend.pf_route(platform)


def test_tracker_step_takes_the_route(monkeypatch):
    """tracker_step asks the route module: on the triton route it calls
    the fused kernel, on the xla route it never does."""
    import jax.numpy as jnp

    from pf_monocular_pose_estimator_tpu.io.synthetic import (
        default_camera,
        demo_markers,
        make_orbit_sequence,
    )
    from pf_monocular_pose_estimator_tpu.tracker import TargetState, step as step_mod
    from pf_monocular_pose_estimator_tpu.utils import TrackerConfig

    calls = []

    def fake_kernel(*args, **kw):
        calls.append(1)
        return step_mod.propagate_soa(*args[:12]), jnp.zeros(args[1].shape[1])

    monkeypatch.setattr(step_mod, "fused_propagate_weight_pallas", fake_kernel)
    camera, markers = default_camera(), demo_markers()
    mask = jnp.ones((markers.shape[0],), bool)
    config = TrackerConfig(n_particles=64, min_blob_area=8.0, pf_max_retries=2)
    seq = make_orbit_sequence(camera, markers, num_frames=2)
    state = TargetState.create(64, jax.random.PRNGKey(0))
    state, _ = step_mod.tracker_step(
        state, seq.frames[0], seq.times[0], camera, markers, mask, config
    )  # frame 0 initialises: no PF step either way
    jax.make_jaxpr(
        lambda s: step_mod.tracker_step(
            s, seq.frames[1], seq.times[1], camera, markers, mask, config
        )
    )(state)
    assert calls == []
    monkeypatch.setattr(step_mod, "pf_route", lambda: "triton")
    jax.make_jaxpr(
        lambda s: step_mod.tracker_step(
            s, seq.frames[1], seq.times[1], camera, markers, mask, config
        )
    )(state)
    assert len(calls) == 2  # the inlined first iteration + the retry body


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        backend.require_gpu()


@pytest.fixture
def restore_cache_config():
    keys = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_entry_size_bytes",
        "jax_persistent_cache_min_compile_time_secs",
    )
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_uses_env_dir_and_sets_no_other(
    monkeypatch, tmp_path, restore_cache_config
):
    env_dir = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    monkeypatch.delenv("PFMPE_NO_COMPILE_CACHE", raising=False)
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    assert compile_cache.enable_persistent_cache() == env_dir
    # JAX reads the variable itself; the helper set no directory of its own
    assert jax.config.jax_compilation_cache_dir == "sentinel"
    assert not os.path.exists(env_dir)


def test_compile_cache_default_is_the_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("PFMPE_NO_COMPILE_CACHE", raising=False)
    used = compile_cache.enable_persistent_cache()
    assert used == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == used
    assert os.path.isdir(used)


def test_compile_cache_opt_out(monkeypatch, restore_cache_config):
    monkeypatch.setenv("PFMPE_NO_COMPILE_CACHE", "1")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_persistent_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def _run(args, cwd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_chip_smoke_refuses_without_a_gpu():
    out = _run(["chip_smoke.py"], REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repository it fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], str(tmp_path), {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_bench_refuses_without_a_gpu():
    out = _run(["bench.py", "--frames", "2", "--particles", "64"], REPO)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert "frames/s" not in out.stdout


def test_cli_device_gpu_without_a_gpu_is_an_error(capsys):
    from pf_monocular_pose_estimator_tpu.io.cli import main

    assert main(["--synthetic", "--frames", "1", "--device", "gpu", "--json"]) == 2
    assert "no GPU" in capsys.readouterr().err
