"""The fused propagate+weight kernel (pf/pallas_step.py, Pallas through
Triton) in the Pallas interpreter against the XLA pipeline
`propagate_soa` + `weight_particles_soa` — same keys, same draws.  The
card itself runs the same comparison as a phase of chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pf_monocular_pose_estimator_tpu.io.synthetic import default_camera
from pf_monocular_pose_estimator_tpu.pf.propagate import NoiseBounds
from pf_monocular_pose_estimator_tpu.pf.soa import (
    propagate_soa,
    weight_particles_soa,
)
from pf_monocular_pose_estimator_tpu.pf.pallas_step import (
    fused_propagate_weight_pallas,
)

CAM = default_camera()
NOISE = NoiseBounds(
    min_translation=-0.01,
    max_translation=0.01,
    min_angular=-0.02,
    max_angular=0.02,
)


def _random_pose(key, scale=0.3):
    ka, kt = jax.random.split(key)
    w = jax.random.normal(ka, (3,)) * 0.4
    th = jnp.linalg.norm(w) + 1e-9
    ax = w / th
    K = jnp.array(
        [[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]]
    )
    R = jnp.eye(3) + jnp.sin(th) * K + (1 - jnp.cos(th)) * (K @ K)
    t = jax.random.normal(kt, (3,)) * scale + jnp.array([0.0, 0.0, 1.2])
    return (
        jnp.eye(4).at[:3, :3].set(R).at[:3, 3].set(t).astype(jnp.float32)
    )


def _small(key, scale):
    from pf_monocular_pose_estimator_tpu.geometry.se3 import exp_se3

    return exp_se3(jax.random.normal(key, (6,)) * scale)


def _setup(seed, n, tracking, apply_pred, k_cap=16):
    """A bank of poses scattered around a ground truth, detections at the
    truth's projected markers (4 of 5 valid, one marker masked), so a
    real share of the lanes gets a positive weight."""
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 8)
    markers = jnp.concatenate(
        [jax.random.normal(ks[0], (5, 3)) * 0.08, jnp.ones((5, 1))], axis=1
    ).astype(jnp.float32)
    marker_mask = jnp.array([True, True, True, True, False])
    gt = _random_pose(ks[1])
    pts = (gt @ markers.T)[:3]
    uv = jnp.stack(
        [
            CAM.fx * pts[0] / pts[2] + CAM.cx,
            CAM.fy * pts[1] / pts[2] + CAM.cy,
        ],
        axis=1,
    )
    det_xy = jnp.zeros((k_cap, 2), jnp.float32).at[:5].set(uv)
    det_mask = jnp.zeros((k_cap,), bool).at[:4].set(True)

    bank = jax.vmap(lambda k: _small(k, 0.01) @ gt)(jax.random.split(ks[2], n))
    bank16 = bank.reshape(n, 16).T
    return dict(
        key=ks[7],
        bank16=bank16,
        cur=_small(ks[3], 0.01) @ gt,
        pred=_small(ks[4], 0.01) @ gt,
        predm=_small(ks[5], 0.003),
        cmi=_small(ks[6], 0.003),
        markers=markers,
        marker_mask=marker_mask,
        det_xy=det_xy,
        det_mask=det_mask,
        downgrade=jnp.array([False, True, False, False, False]),
        tracking=jnp.asarray(tracking),
        apply_pred=jnp.asarray(apply_pred),
    )


FAC_T = jnp.float32(1.3) * jnp.ones((3,), jnp.float32)
FAC_R = jnp.float32(0.9) * jnp.ones((3,), jnp.float32)
INFL = jnp.float32(1.1)
TOL_PF = jnp.float32(10.0)
TOL_INIT = jnp.float32(5.0)


def _prop_args(s):
    return (
        s["key"], s["bank16"], s["cur"], s["pred"], s["predm"], s["cmi"],
        NOISE, FAC_T, FAC_R, s["tracking"], s["apply_pred"], INFL,
    )


def _det_args(s):
    return (
        s["markers"], s["marker_mask"], s["det_xy"], s["det_mask"],
        TOL_PF, TOL_INIT, s["downgrade"],
    )


def _reference(s):
    bank = propagate_soa(*_prop_args(s))
    w = weight_particles_soa(CAM, bank, *_det_args(s))[0]
    return bank, w


def _kernel(s, **kw):
    return fused_propagate_weight_pallas(
        *_prop_args(s), CAM, *_det_args(s), interpret=True, **kw
    )


def _assert_matches(bank, w, ref_bank, ref_w):
    # identical draws => identical propagation up to float rounding
    np.testing.assert_allclose(
        np.asarray(bank), np.asarray(ref_bank), rtol=0, atol=1e-6
    )
    # pinned candidate lanes are exact
    np.testing.assert_array_equal(
        np.asarray(bank[:, :2]), np.asarray(ref_bank[:, :2])
    )
    np.testing.assert_allclose(
        np.asarray(w), np.asarray(ref_w), rtol=1e-5, atol=1e-4
    )


@pytest.mark.parametrize(
    "tracking,apply_pred", [(True, True), (True, False), (False, False)]
)
@pytest.mark.parametrize("seed,n", [(0, 511), (3, 1024), (5, 4097)])
def test_fused_matches_xla_pipeline(seed, n, tracking, apply_pred):
    s = _setup(seed, n, tracking, apply_pred)
    ref_bank, ref_w = _reference(s)
    bank, w = _kernel(s)
    assert bank.shape == (16, n) and w.shape == (n,)
    _assert_matches(bank, w, ref_bank, ref_w)
    assert (np.asarray(ref_w) > 0).mean() > 0.1  # the scene exercises matching


@pytest.mark.parametrize("seed,n", [(1, 511), (2, 1024), (4, 4097)])
def test_fused_masks_penalties_and_clones(seed, n):
    """Masked marker + masked detections + spurious clone + downgrade —
    every penalty branch and both mask paths in one scene."""
    s = _setup(seed, n, True, True)
    _, plain_w = _reference(s)
    det_xy = s["det_xy"].at[5].set(s["det_xy"][0] + jnp.asarray([2.0, 1.0]))
    s["det_xy"] = det_xy.at[6].set(s["det_xy"][1] + jnp.asarray([-1.5, 0.5]))
    s["det_mask"] = s["det_mask"].at[5].set(True).at[6].set(True).at[2].set(False)
    ref_bank, ref_w = _reference(s)
    bank, w = _kernel(s)
    _assert_matches(bank, w, ref_bank, ref_w)
    # the clones and the dropped detection change the matching
    assert not np.allclose(np.asarray(ref_w), np.asarray(plain_w))


def test_fused_no_detections():
    s = _setup(6, 511, True, True)
    s["det_mask"] = jnp.zeros_like(s["det_mask"])
    ref_bank, _ = _reference(s)
    bank, w = _kernel(s)
    assert (np.asarray(w) == 0).all()
    np.testing.assert_allclose(np.asarray(bank), np.asarray(ref_bank), atol=1e-6)


def test_fused_traced_tolerances_no_recompile():
    """Tolerances are traced operands: two different values reuse one
    compiled executable (the dynamic-params tier, cfg:12-40)."""
    s = _setup(7, 256, True, True, k_cap=8)
    calls = []

    @jax.jit
    def run(tol_pf, tol_init):
        calls.append(1)
        det = list(_det_args(s))
        det[4], det[5] = tol_pf, tol_init
        return fused_propagate_weight_pallas(
            *_prop_args(s), CAM, *det, interpret=True
        )[1]

    w_a = run(jnp.float32(10.0), jnp.float32(5.0))
    w_b = run(jnp.float32(3.0), jnp.float32(5.0))
    assert len(calls) == 1  # one trace, two tolerance values
    assert not np.allclose(w_a, w_b)  # and the tolerance actually bites


@pytest.mark.parametrize("block", [64, 128, 512])
def test_fused_block_size_is_tiling_only(block):
    """The block size changes only how lanes are tiled into programs (and
    the masked tail of the last one): results equal the default block's
    bit for bit."""
    s = _setup(8, 777, True, True, k_cap=8)
    bank0, w0 = _kernel(s)
    bank, w = _kernel(s, block=block)
    np.testing.assert_array_equal(np.asarray(bank), np.asarray(bank0))
    np.testing.assert_array_equal(np.asarray(w), np.asarray(w0))


def test_fused_rejects_non_power_of_two_block():
    s = _setup(8, 256, True, True, k_cap=8)
    with pytest.raises(AssertionError, match="power of two"):
        _kernel(s, block=96)


def test_fused_vmaps_over_targets():
    """Under vmap (the multi-target tracker) each target's slice equals
    its own call: marker sets and detections differ per target."""
    a = _setup(9, 256, True, True, k_cap=8)
    b = _setup(10, 256, True, False, k_cap=8)
    stack = lambda k: jnp.stack([a[k], b[k]])  # noqa: E731
    keys = ("key", "bank16", "cur", "pred", "predm", "cmi", "tracking",
            "apply_pred", "markers", "marker_mask", "det_xy", "det_mask",
            "downgrade")
    batched = {k: stack(k) for k in keys}

    def one(d):
        return fused_propagate_weight_pallas(
            *_prop_args(d), CAM, *_det_args(d), interpret=True
        )

    bank_v, w_v = jax.vmap(one)(batched)
    for i, s in enumerate((a, b)):
        bank, w = one(s)
        np.testing.assert_array_equal(np.asarray(bank_v[i]), np.asarray(bank))
        np.testing.assert_array_equal(np.asarray(w_v[i]), np.asarray(w))


@pytest.mark.gpu
def test_fused_on_card_matches_xla(gpu_device):
    """On the card: the compiled Triton kernel against the XLA pipeline."""
    s = jax.device_put(_setup(0, 100_000, True, True), gpu_device)
    ref_bank, ref_w = _reference(s)
    bank, w = fused_propagate_weight_pallas(*_prop_args(s), CAM, *_det_args(s))
    assert float(jnp.max(jnp.abs(bank - ref_bank))) <= 1e-5
    assert float(jnp.mean(jnp.abs(w - ref_w) <= 1e-4)) >= 0.9999


def test_tracker_bank_bottom_row_invariant():
    """Every pose lane in the tracker's banks keeps the exact rigid
    bottom row — the invariant the distributed resampler's 12-row ring
    payload relies on (parallel/resample.py)."""
    from pf_monocular_pose_estimator_tpu.io.synthetic import (
        demo_markers,
        make_orbit_sequence,
    )
    from pf_monocular_pose_estimator_tpu.tracker import TargetState, make_tracker
    from pf_monocular_pose_estimator_tpu.utils import TrackerConfig

    markers = demo_markers()
    mask = jnp.ones((markers.shape[0],), bool)
    config = TrackerConfig(n_particles=512, min_blob_area=8.0, pf_max_retries=4)
    seq = make_orbit_sequence(CAM, markers, num_frames=6, fps=50.0)
    step = make_tracker(CAM, markers, mask, config)
    state = TargetState.create(config.n_particles, jax.random.PRNGKey(0))
    const = np.tile(np.array([0.0, 0.0, 0.0, 1.0], np.float32)[:, None], (1, 512))
    for i in range(6):
        state, _ = step(state, seq.frames[i], seq.times[i])
        np.testing.assert_array_equal(np.asarray(state.bank[12:]), const)
        np.testing.assert_array_equal(np.asarray(state.resampled[12:]), const)


@pytest.mark.parametrize("block,num_warps,batched", [
    (128, 4, False), (256, 8, False), (64, 2, True),
])
def test_fused_kernel_lowers_to_valid_triton_ir(monkeypatch, block, num_warps, batched):
    """Lower the kernel for CUDA on the CPU (jax.export) and run the MLIR
    verifier on the Triton module it generates: type errors that the
    interpreter cannot see fail here instead of on the card."""
    from jax._src.pallas.triton import lowering, pallas_call_registration

    verified = []
    lower = lowering.lower_jaxpr_to_triton_module

    def lower_and_verify(*args, **kw):
        result = lower(*args, **kw)
        verified.append(result.module.operation.verify())
        return result

    monkeypatch.setattr(
        pallas_call_registration.lowering, "lower_jaxpr_to_triton_module",
        lower_and_verify,
    )
    s = _setup(0, 1000, True, True)

    def call(d):
        return fused_propagate_weight_pallas(
            *_prop_args(d), CAM, *_det_args(d), block=block, num_warps=num_warps
        )

    fn = jax.vmap(call) if batched else call
    arg = jax.tree.map(lambda x: jnp.stack([x, x]), s) if batched else s
    jax.export.export(
        jax.jit(fn), platforms=("cuda",),
        disabled_checks=[
            jax.export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(arg)
    assert verified == [True]
