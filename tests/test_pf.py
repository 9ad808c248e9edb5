"""Particle-filter kernel tests (SURVEY.md §7 layer 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pf_monocular_pose_estimator_tpu.geometry import exp_se3, project
from pf_monocular_pose_estimator_tpu.io.synthetic import default_camera, demo_markers
from pf_monocular_pose_estimator_tpu.pf import (
    NoiseBounds,
    gauss_newton_refine,
    propagate,
    propagation_noise_factors,
    stratified_resample,
    weight_particles,
)
from pf_monocular_pose_estimator_tpu.pf.resample import effective_sample_size


@pytest.fixture(scope="module")
def camera():
    return default_camera()


@pytest.fixture(scope="module")
def markers():
    return demo_markers()


def true_pose():
    p = np.array(exp_se3(jnp.asarray([0.03, -0.01, 0.0, 0.2, -0.15, 0.1], jnp.float32)))
    p[2, 3] += 1.4
    return jnp.asarray(p)


def detections_for(camera, pose, markers):
    uv = project(camera, pose, markers)
    k_cap = 8
    xy = jnp.zeros((k_cap, 2)).at[: markers.shape[0]].set(uv)
    mask = jnp.zeros((k_cap,), bool).at[: markers.shape[0]].set(True)
    return xy, mask


# ---------------------------------------------------------------- propagate


def test_propagate_pins_particles_0_and_1(camera):
    n = 64
    key = jax.random.PRNGKey(0)
    bank = jnp.broadcast_to(jnp.eye(4), (n, 4, 4))
    cur = np.eye(4, dtype=np.float32)
    cur[0, 3] = 5.0
    pred = np.eye(4, dtype=np.float32)
    pred[1, 3] = -3.0
    out = propagate(
        key,
        bank,
        jnp.asarray(cur),
        jnp.asarray(pred),
        jnp.eye(4),
        jnp.eye(4),
        NoiseBounds(-0.05, 0.05, -0.05, 0.05),
        jnp.ones(3),
        jnp.ones(3),
        tracking=jnp.asarray(True),
        apply_prediction=jnp.asarray(True),
        inflation=jnp.asarray(1.0),
    )
    np.testing.assert_allclose(np.asarray(out[0]), cur, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out[1]), pred, atol=1e-6)


def test_propagate_noise_bounds_and_rigidity():
    n = 512
    bank = jnp.broadcast_to(jnp.eye(4), (n, 4, 4))
    out = propagate(
        jax.random.PRNGKey(1),
        bank,
        jnp.eye(4),
        jnp.eye(4),
        jnp.eye(4),
        jnp.eye(4),
        NoiseBounds(-0.02, 0.02, -0.015, 0.015),
        jnp.ones(3),
        jnp.ones(3),
        tracking=jnp.asarray(False),
        apply_prediction=jnp.asarray(False),
        inflation=jnp.asarray(1.0),
    )
    t = np.asarray(out[2:, :3, 3])
    assert np.abs(t).max() <= 0.02 + 1e-6
    assert np.abs(t).max() > 0.005  # noise actually applied
    r = np.asarray(out[2:, :3, :3])
    np.testing.assert_allclose(
        np.einsum("nij,nkj->nik", r, r), np.broadcast_to(np.eye(3), r.shape), atol=1e-5
    )


def test_propagate_applies_prediction():
    n = 4
    bank = jnp.broadcast_to(jnp.eye(4), (n, 4, 4))
    pred_mat = np.eye(4, dtype=np.float32)
    pred_mat[0, 3] = 0.5
    out = propagate(
        jax.random.PRNGKey(2),
        bank,
        jnp.eye(4),
        jnp.eye(4),
        jnp.asarray(pred_mat),
        jnp.eye(4),
        NoiseBounds(0.0, 0.0, 0.0, 0.0),
        jnp.ones(3),
        jnp.ones(3),
        tracking=jnp.asarray(True),
        apply_prediction=jnp.asarray(True),
        inflation=jnp.asarray(1.0),
    )
    np.testing.assert_allclose(np.asarray(out[3, 0, 3]), 0.5, atol=1e-6)


def test_noise_factors():
    pred = jnp.eye(4).at[0, 3].set(0.4)
    ft, fr = propagation_noise_factors(jnp.asarray(False), pred, jnp.asarray(1.0))
    np.testing.assert_allclose(np.asarray(ft), 0.1, atol=1e-6)  # clip(0.4,0.2,1)/4
    np.testing.assert_allclose(np.asarray(fr), 0.2, atol=1e-6)
    ft, fr = propagation_noise_factors(jnp.asarray(True), pred, jnp.asarray(1.0))
    np.testing.assert_allclose(np.asarray(ft), 1.0, atol=1e-6)


# ------------------------------------------------------------------ weight


def test_weight_perfect_pose_scores_max(camera, markers):
    pose = true_pose()
    xy, mask = detections_for(camera, pose, markers)
    bank = jnp.stack([pose, jnp.asarray(np.eye(4, dtype=np.float32))])
    w, pairs, n_corr = weight_particles(
        camera, bank, markers, jnp.ones(5, bool), xy, mask, 10.0, 5.0, jnp.zeros(5, bool)
    )
    m = markers.shape[0]
    # perfect pose: all 5 markers matched at d=0 -> weight = 5*(5+1) = 30
    np.testing.assert_allclose(float(w[0]), m * (m + 1), atol=1e-3)
    assert float(w[0]) > float(w[1])
    assert int(n_corr[0]) == m
    # pairs must be the identity correspondence
    p = np.asarray(pairs[0])
    got = {tuple(r) for r in p if r[0] >= 0}
    assert got == {(i, i) for i in range(m)}


def test_weight_respects_tolerance(camera, markers):
    pose = true_pose()
    xy, mask = detections_for(camera, pose, markers)
    # shift all detections by 12px > tol_pf=10 -> no matches
    xy_far = xy + 12.0 * jnp.asarray([1.0, 0.0])
    w, _, n_corr = weight_particles(
        camera, pose[None], markers, jnp.ones(5, bool), xy_far, mask, 10.0, 5.0, jnp.zeros(5, bool)
    )
    assert float(w[0]) == 0.0
    assert int(n_corr[0]) == 0


def test_weight_self_occlusion_penalty():
    # Hand-built scene with exact arithmetic: fx=fy=100, cx=cy=0.
    from pf_monocular_pose_estimator_tpu.geometry import Camera

    cam = Camera.create(fx=100.0, fy=100.0, cx=0.0, cy=0.0)
    # Two markers projecting to (0,0) and (3,0); one detection at (0,0).
    mk = jnp.asarray([[0.0, 0.0, 1.0, 1.0], [0.03, 0.0, 1.0, 1.0]], jnp.float32)
    xy = jnp.zeros((4, 2))
    mask = jnp.zeros((4,), bool).at[0].set(True)
    w, pairs, n_corr = weight_particles(
        cam, jnp.eye(4)[None], mk, jnp.ones(2, bool), xy, mask, 10.0, 5.0, jnp.zeros(2, bool)
    )
    # marker0: d=0 -> 2 + 1 = 3;  marker1: d=3 -> 2 + ((5-3)/5)^2 = 2.16,
    # reusing the detection -> -3 (first self-occlusion).  Total 2.16.
    assert int(n_corr[0]) == 2
    np.testing.assert_allclose(float(w[0]), 3.0 + 2.16 - 3.0, atol=1e-3)


def test_weight_downgrade_penalty(camera, markers):
    pose = true_pose()
    xy, mask = detections_for(camera, pose, markers)
    base, _, _ = weight_particles(
        camera, pose[None], markers, jnp.ones(5, bool), xy, mask, 10.0, 5.0, jnp.zeros(5, bool)
    )
    down, _, _ = weight_particles(
        camera,
        pose[None],
        markers,
        jnp.ones(5, bool),
        xy,
        mask,
        10.0,
        5.0,
        jnp.zeros(5, bool).at[2].set(True),
    )
    np.testing.assert_allclose(float(base[0]) - float(down[0]), 2.0, atol=1e-3)


def test_weight_ignores_masked_detections(camera, markers):
    pose = true_pose()
    xy, mask = detections_for(camera, pose, markers)
    # invalidate detection 0 -> marker 0 unmatched
    mask2 = mask.at[0].set(False)
    w, _, n_corr = weight_particles(
        camera, pose[None], markers, jnp.ones(5, bool), xy, mask2, 10.0, 5.0, jnp.zeros(5, bool)
    )
    assert int(n_corr[0]) == 4


def test_weight_large_bank_shapes(camera, markers):
    bank = jnp.broadcast_to(true_pose(), (1024, 4, 4))
    xy, mask = detections_for(camera, true_pose(), markers)
    w, pairs, n_corr = weight_particles(
        camera, bank, markers, jnp.ones(5, bool), xy, mask, 10.0, 5.0, jnp.zeros(5, bool)
    )
    assert w.shape == (1024,)
    assert pairs.shape == (1024, 5, 2)


# ---------------------------------------------------------------- resample


def test_resample_concentrates_on_heavy_particle():
    n = 256
    w = jnp.zeros((n,)).at[17].set(1.0)
    anc, counts, most = stratified_resample(jax.random.PRNGKey(0), w)
    assert int(most) == 17
    assert int(counts[17]) == n
    assert np.all(np.asarray(anc) == 17)


def test_resample_uniform_is_spread():
    n = 512
    anc, counts, _ = stratified_resample(jax.random.PRNGKey(1), jnp.ones((n,)))
    # stratified resampling of uniform weights picks each particle ~once
    assert int(np.max(np.asarray(counts))) <= 2
    assert abs(int(np.sum(np.asarray(counts))) - n) == 0


def test_resample_proportional(rng):
    n = 4096
    w = jnp.asarray(rng.uniform(0, 1, n) ** 3, jnp.float32)
    _, counts, _ = stratified_resample(jax.random.PRNGKey(2), w)
    freq = np.asarray(counts, np.float64) / n
    expect = np.asarray(w, np.float64) / float(jnp.sum(w))
    assert np.abs(freq - expect).max() < 2.0 / n  # stratified bound


def test_resample_zero_weights_uniform_fallback():
    n = 64
    anc, counts, _ = stratified_resample(jax.random.PRNGKey(3), jnp.zeros((n,)))
    assert int(np.max(np.asarray(counts))) <= 2


def test_effective_sample_size():
    assert float(effective_sample_size(jnp.ones(100))) == pytest.approx(100.0)
    assert float(effective_sample_size(jnp.zeros(100).at[0].set(1.0))) == pytest.approx(1.0)


# ------------------------------------------------------------------ refine


def test_gauss_newton_converges_from_perturbed_pose(camera, markers):
    pose_gt = true_pose()
    xy, mask = detections_for(camera, pose_gt, markers)
    corr = jnp.asarray([[i, i] for i in range(5)], jnp.int32)
    corr_mask = jnp.ones((5,), bool)
    pert = exp_se3(jnp.asarray([0.03, -0.02, 0.04, 0.03, -0.02, 0.03], jnp.float32)) @ pose_gt
    res = gauss_newton_refine(camera, pert, markers, xy, corr, corr_mask)
    np.testing.assert_allclose(np.asarray(res.pose), np.asarray(pose_gt), atol=2e-3)
    assert float(res.final_error) < 1e-2
    assert float(res.final_error) <= float(res.initial_error)


def test_gauss_newton_masked_correspondences(camera, markers):
    pose_gt = true_pose()
    xy, mask = detections_for(camera, pose_gt, markers)
    # only 4 valid pairs; 5th slot poisoned but masked
    corr = jnp.asarray([[0, 0], [1, 1], [2, 2], [3, 3], [4, 0]], jnp.int32)
    corr_mask = jnp.asarray([True, True, True, True, False])
    pert = exp_se3(jnp.asarray([0.02, 0.01, -0.02, 0.02, 0.02, -0.01], jnp.float32)) @ pose_gt
    res = gauss_newton_refine(camera, pert, markers, xy, corr, corr_mask)
    np.testing.assert_allclose(np.asarray(res.pose), np.asarray(pose_gt), atol=5e-3)


def test_gauss_newton_divergence_guard(camera, markers):
    pose_gt = true_pose()
    xy, _ = detections_for(camera, pose_gt, markers)
    # Degenerate: a single correspondence cannot constrain the pose; the
    # guard must never return something worse than the input.
    corr = jnp.asarray([[0, 0]] * 5, jnp.int32)
    corr_mask = jnp.zeros((5,), bool).at[0].set(True)
    pert = exp_se3(jnp.asarray([0.05, 0.0, 0.0, 0.0, 0.0, 0.0], jnp.float32)) @ pose_gt
    res = gauss_newton_refine(camera, pert, markers, xy, corr, corr_mask)
    assert float(res.final_error) <= float(res.initial_error) + 1e-6


def test_gauss_newton_covariance_shape_and_spd(camera, markers):
    pose_gt = true_pose()
    xy, _ = detections_for(camera, pose_gt, markers)
    corr = jnp.asarray([[i, i] for i in range(5)], jnp.int32)
    res = gauss_newton_refine(camera, pose_gt, markers, xy, corr, jnp.ones(5, bool))
    cov = np.asarray(res.covariance)
    assert cov.shape == (6, 6)
    ev = np.linalg.eigvalsh(0.5 * (cov + cov.T))
    assert (ev > 0).all()


def test_gauss_newton_vmappable(camera, markers):
    pose_gt = true_pose()
    xy, _ = detections_for(camera, pose_gt, markers)
    corr = jnp.asarray([[i, i] for i in range(5)], jnp.int32)
    perturbs = jnp.asarray(
        np.random.default_rng(0).normal(size=(8, 6)) * 0.02, jnp.float32
    )
    bank = jax.vmap(lambda t: exp_se3(t) @ pose_gt)(perturbs)
    fn = jax.vmap(
        lambda p: gauss_newton_refine(camera, p, markers, xy, corr, jnp.ones(5, bool)).pose
    )
    out = fn(bank)
    np.testing.assert_allclose(
        np.asarray(out), np.broadcast_to(np.asarray(pose_gt), (8, 4, 4)), atol=5e-3
    )


def test_solve6_spd_matches_f64_lu():
    """Closed-form blocked-Schur 6x6 solve vs numpy's f64 LU on
    realistically-conditioned GN normal matrices."""
    from pf_monocular_pose_estimator_tpu.pf.refine import inv6_spd, solve6_spd

    rng = np.random.default_rng(7)
    mats, vecs = [], []
    for _ in range(64):
        c = int(rng.integers(4, 9))
        jac = rng.normal(0, 1, (c, 2, 6))
        jac[..., 0:3] *= 420.0 / rng.uniform(0.5, 3.0)
        jac[..., 3:6] *= 420.0
        mats.append(np.einsum("cri,crj->ij", jac, jac) + 1e-8 * np.eye(6))
        vecs.append(rng.normal(0, 420.0, 6))
    a = jnp.asarray(np.stack(mats), jnp.float32)
    b = jnp.asarray(np.stack(vecs), jnp.float32)
    x = np.asarray(jax.vmap(solve6_spd)(a, b))
    x_ref = np.stack(
        [np.linalg.solve(m.astype(np.float64), v) for m, v in zip(mats, vecs)]
    )
    rel = np.linalg.norm(x - x_ref, axis=-1) / np.linalg.norm(x_ref, axis=-1)
    assert rel.max() < 1e-3, rel.max()

    inv = np.asarray(jax.vmap(inv6_spd)(a))
    inv_ref = np.stack([np.linalg.inv(m.astype(np.float64)) for m in mats])
    rel_i = np.abs(inv - inv_ref).max(axis=(-2, -1)) / np.abs(inv_ref).max(axis=(-2, -1))
    assert rel_i.max() < 1e-3, rel_i.max()


@pytest.mark.parametrize("seed,noise", [(3, 0.3), (8, 0.0), (21, 0.8)])
def test_batched_gn_matches_float64_oracle(camera, markers, seed, noise):
    """The tracker's batched GN refinement (vmap over H hypotheses, the
    plain XLA path) against the float64 transliteration of optimisePose
    (tests/oracle): every hypothesis, including one with a dropped pair,
    lands on the oracle's pose and covariance up to float32 rounding."""
    from oracle import ref_oracle as ref

    rng = np.random.default_rng(seed)
    pose_gt = exp_se3(jnp.asarray([0.02, -0.01, 1.5, 0.1, -0.05, 0.3], jnp.float32))
    det = np.asarray(project(camera, pose_gt, markers)) + rng.normal(
        0, noise, (markers.shape[0], 2)
    )
    det = det.astype(np.float32)
    b, m = 4, markers.shape[0]
    perturbs = jnp.asarray(rng.normal(size=(b, 6)) * 0.02, jnp.float32)
    poses0 = jax.vmap(lambda t: exp_se3(t) @ pose_gt)(perturbs)
    dfm = np.broadcast_to(np.arange(m, dtype=np.int32)[None], (b, m)).copy()
    dfm[3, 2] = -1  # one dropped pair
    corrs = jnp.asarray(np.stack([np.broadcast_to(np.arange(m), (b, m)), dfm], -1), jnp.int32)
    out = jax.vmap(
        lambda p, c, cm: gauss_newton_refine(
            camera, p, markers, jnp.asarray(det), c, cm, 50, 1e-6
        )
    )(poses0, corrs, jnp.asarray(dfm >= 0))

    for h in range(b):
        corr_ref = np.stack([np.arange(m) + 1, np.where(dfm[h] >= 0, dfm[h] + 1, 0)], -1)
        pose_ref, cov_ref, _ = ref.optimise_pose(
            np.asarray(poses0[h], np.float64), corr_ref, det.astype(np.float64),
            np.asarray(markers, np.float64), float(camera.fx), float(camera.fy),
            float(camera.cx), float(camera.cy),
        )
        got = np.asarray(out.pose[h], np.float64)
        t_err = np.linalg.norm(got[:3, 3] - pose_ref[:3, 3])
        r_err = np.linalg.norm(ref.logarithm_map(np.linalg.inv(pose_ref) @ got)[3:])
        assert t_err < 1e-3, (h, t_err)
        assert r_err < 2e-3, (h, r_err)
        np.testing.assert_allclose(
            np.asarray(out.covariance[h]), cov_ref, rtol=0.05, atol=1e-9
        )
