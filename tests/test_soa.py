"""SoA hot-path kernels must match the AoS reference kernels exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pf_monocular_pose_estimator_tpu.geometry import exp_se3, project
from pf_monocular_pose_estimator_tpu.io.synthetic import default_camera, demo_markers
from pf_monocular_pose_estimator_tpu.pf import (
    NoiseBounds,
    propagate,
    stratified_resample,
    weight_particles,
)
from pf_monocular_pose_estimator_tpu.pf.soa import (
    compose_const_left,
    compose_const_right,
    gather_soa,
    pack,
    project_soa,
    propagate_soa,
    stratified_resample_soa,
    unpack,
    weight_particles_soa,
)

N = 257  # deliberately non-multiple of lanes


@pytest.fixture(scope="module")
def camera():
    return default_camera()


@pytest.fixture(scope="module")
def markers():
    return demo_markers()


@pytest.fixture(scope="module")
def bank():
    tw = jnp.asarray(np.random.default_rng(7).normal(size=(N, 6)) * 0.1, jnp.float32)
    b = jax.vmap(exp_se3)(tw)
    return b.at[:, 2, 3].add(1.5)


def test_pack_unpack_roundtrip(bank):
    np.testing.assert_array_equal(np.asarray(unpack(pack(bank))), np.asarray(bank))


def test_compose_const(bank):
    a = np.asarray(exp_se3(jnp.asarray([0.1, 0.2, -0.1, 0.3, 0.1, -0.2], jnp.float32)))
    left = unpack(compose_const_left(jnp.asarray(a), pack(bank)))
    np.testing.assert_allclose(np.asarray(left), np.asarray(jnp.asarray(a) @ bank), atol=1e-5)
    right = unpack(compose_const_right(pack(bank), jnp.asarray(a)))
    np.testing.assert_allclose(np.asarray(right), np.asarray(bank @ jnp.asarray(a)), atol=1e-5)


def test_project_soa_matches(camera, markers, bank):
    uv_aos = np.asarray(project(camera, bank, markers))  # (N, M, 2)
    uv_soa = np.asarray(project_soa(camera, pack(bank), markers))  # (M, 2, N)
    np.testing.assert_allclose(uv_soa.transpose(2, 0, 1), uv_aos, rtol=1e-5, atol=1e-3)


def test_propagate_soa_zero_noise_matches(camera, bank):
    cur = np.asarray(bank[5])
    pred = np.asarray(bank[7])
    pm = np.asarray(exp_se3(jnp.asarray([0.01, 0, 0, 0, 0, 0.02], jnp.float32)))
    cmi = np.asarray(exp_se3(jnp.asarray([0, 0.01, 0, 0.01, 0, 0], jnp.float32)))
    nb = NoiseBounds(0.0, 0.0, 0.0, 0.0)
    args = (
        jnp.asarray(cur),
        jnp.asarray(pred),
        jnp.asarray(pm),
        jnp.asarray(cmi),
        nb,
        jnp.ones(3),
        jnp.ones(3),
        jnp.asarray(True),
        jnp.asarray(True),
        jnp.asarray(1.0),
    )
    key = jax.random.PRNGKey(0)
    aos = propagate(key, bank, *args)
    soa = unpack(propagate_soa(key, pack(bank), *args))
    np.testing.assert_allclose(np.asarray(soa), np.asarray(aos), atol=1e-5)


def test_propagate_soa_noise_statistics(camera, bank):
    nb = NoiseBounds(-0.02, 0.02, -0.015, 0.015)
    args = (
        bank[0],
        bank[1],
        jnp.eye(4),
        jnp.eye(4),
        nb,
        jnp.ones(3),
        jnp.ones(3),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.asarray(1.0),
    )
    big = jnp.tile(jnp.eye(4), (4096, 1, 1))
    soa = unpack(propagate_soa(jax.random.PRNGKey(1), pack(big), *args))
    t = np.asarray(soa[2:, :3, 3])
    assert np.abs(t).max() <= 0.02 + 1e-6
    assert abs(t.mean()) < 2e-3  # centered uniform


def test_weight_soa_matches_aos(camera, markers, bank):
    pose = bank[3]
    uv = project(camera, pose, markers)
    k_cap = 12
    xy = jnp.zeros((k_cap, 2)).at[:5].set(uv)
    # perturb detections so distances/penalties are non-trivial
    xy = xy.at[:5].add(jnp.asarray(np.random.default_rng(3).normal(size=(5, 2)) * 2.0, jnp.float32))
    mask = jnp.zeros((k_cap,), bool).at[:5].set(True).at[2].set(False)
    downgrade = jnp.zeros(5, bool).at[1].set(True)
    args = (markers, jnp.ones(5, bool), xy, mask, 10.0, 5.0, downgrade)

    w_a, p_a, c_a = weight_particles(camera, bank, *args)
    w_s, p_s, c_s = weight_particles_soa(camera, pack(bank), *args)

    np.testing.assert_allclose(np.asarray(w_s), np.asarray(w_a), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(c_s), np.asarray(c_a))
    np.testing.assert_array_equal(
        np.asarray(p_s).transpose(2, 0, 1), np.asarray(p_a)
    )


def test_stratified_resample_soa_matches(bank):
    w = jnp.asarray(np.random.default_rng(5).uniform(0, 1, N) ** 2, jnp.float32)
    key = jax.random.PRNGKey(9)
    a1, c1, m1 = stratified_resample(key, w)
    a2, c2, m2 = stratified_resample_soa(key, w)
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    assert int(m1) == int(m2)


def test_gather_soa(bank):
    idx = jnp.asarray(np.random.default_rng(2).integers(0, N, N), jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(unpack(gather_soa(pack(bank), idx))), np.asarray(bank[idx])
    )


def test_stratified_resample_closed_matches_sort_path():
    """Sort-free resampler (pf/soa.py::stratified_resample_closed): same
    draws and assignment rule as the sort path; slot differences only
    inside 1-ulp non-monotone pockets of XLA's parallel-scan cumsum
    (repaired by value-sort there, by cummax here)."""
    from pf_monocular_pose_estimator_tpu.pf.soa import stratified_resample_closed

    rng = np.random.default_rng(11)
    for n, make in [
        (257, lambda: rng.uniform(0, 1, 257)),
        (8192, lambda: rng.exponential(1.0, 8192) * (rng.uniform(size=8192) > 0.5)),
        (8192, lambda: np.zeros(8192)),
        (8192, lambda: np.ones(8192)),
        (100_000, lambda: rng.uniform(0, 1, 100_000) ** 4),
    ]:
        w = jnp.asarray(make(), jnp.float32)
        key = jax.random.PRNGKey(n)
        a1, c1, m1 = jax.jit(stratified_resample_soa)(key, w)
        a2, c2, m2 = jax.jit(stratified_resample_closed)(key, w)
        mismatch = float(np.mean(np.asarray(a1) != np.asarray(a2)))
        assert mismatch <= 2e-3, mismatch
        # the most-resampled pick must be (near-)identical: equal index,
        # or an index whose copy count ties the max within 1
        if int(m1) != int(m2):
            assert abs(int(c1[int(m1)]) - int(c1[int(m2)])) <= 1
        # counts are a valid copy profile: non-negative, sums to <= n
        assert int(np.min(np.asarray(c2))) >= 0
        assert int(np.sum(np.asarray(c2))) <= n
        # ancestors monotone (canonical stratified assignment)
        assert bool(np.all(np.diff(np.asarray(a2)) >= 0))


def _weight_profile(kind, n, rng):
    if kind == "uniform":
        return np.ones(n)
    if kind == "spiked":  # a few dominant particles over a small floor
        w = np.full(n, 1e-3)
        w[rng.choice(n, 5, replace=False)] = rng.uniform(50, 100, 5)
        return w
    if kind == "forty_pct_zero":  # the tolerance gate's steady-state shape
        return rng.exponential(1.0, n) * (rng.uniform(size=n) > 0.4)
    raise ValueError(kind)


@pytest.mark.parametrize("n", [1001, 4099])
@pytest.mark.parametrize("kind", ["uniform", "spiked", "forty_pct_zero"])
def test_stratified_resamplers_match_numpy_reference(kind, n):
    """Sort path and closed form against a float64 numpy stratified
    resampler on the same draws: ancestors agree except where a draw
    sits within float32 rounding of a CDF boundary; counts are the
    ancestors' histogram; the most-resampled index has the top count."""
    from pf_monocular_pose_estimator_tpu.pf.soa import stratified_resample_closed

    rng = np.random.default_rng(n)
    w = _weight_profile(kind, n, rng)
    key = jax.random.PRNGKey(n)
    eps = np.asarray(jax.random.uniform(key, (n,), jnp.float32), np.float64)
    u = (np.arange(n) + eps) / n
    cdf = np.cumsum(w) / w.sum()
    anc_ref = np.minimum(np.searchsorted(cdf, u, side="left"), n - 1)

    w32 = jnp.asarray(w / w.sum(), jnp.float32)
    for fn in (stratified_resample_soa, stratified_resample_closed):
        anc, counts, most = (np.asarray(x) for x in jax.jit(fn)(key, w32))
        assert np.mean(anc != anc_ref) <= 2e-3, fn.__name__
        assert np.all(np.diff(anc) >= 0), fn.__name__
        np.testing.assert_array_equal(counts, np.bincount(anc, minlength=n))
        assert counts[most] == counts.max()
        if kind != "uniform":  # zero-weight particles are never drawn
            assert np.all(w[anc] > 0), fn.__name__
