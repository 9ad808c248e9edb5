"""Detection-kernel tests (SURVEY.md §7 layer 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pf_monocular_pose_estimator_tpu.geometry import distort_pixels, exp_se3, project
from pf_monocular_pose_estimator_tpu.io.synthetic import default_camera, demo_markers, render_frame
from pf_monocular_pose_estimator_tpu.ops import (
    BlobParams,
    ExposureState,
    determine_roi,
    exposure_control,
    find_leds,
    inject_faults,
)


@pytest.fixture(scope="module")
def camera():
    return default_camera()


@pytest.fixture(scope="module")
def markers():
    return demo_markers()


@pytest.fixture(scope="module")
def pose():
    p = np.array(exp_se3(jnp.asarray([0.05, -0.02, 0.0, 0.15, -0.1, 0.2], jnp.float32)))
    p[2, 3] += 1.2
    return jnp.asarray(p)


@pytest.fixture(scope="module")
def params():
    return BlobParams(min_blob_area=8.0, max_blob_area=200.0)


def full_roi(camera):
    return jnp.asarray([0, 0, camera.width, camera.height], jnp.float32)


@pytest.fixture(scope="module")
def frame(camera, markers, pose):
    return render_frame(camera, pose, markers)


def test_find_leds_counts_and_positions(camera, markers, pose, frame, params):
    det = find_leds(frame, full_roi(camera), params, camera)
    n = int(det.count)
    assert n == markers.shape[0], f"expected {markers.shape[0]} detections, got {n}"

    expected_uv = np.asarray(project(camera, pose, markers))
    got = np.asarray(det.xy)[np.asarray(det.mask)]
    # match each expected marker to nearest detection
    for uv in expected_uv:
        d = np.linalg.norm(got - uv, axis=-1).min()
        assert d < 0.7, f"centroid error {d:.2f}px for marker at {uv}"


def test_find_leds_respects_roi(camera, markers, pose, frame, params):
    expected_uv = np.asarray(project(camera, pose, markers))
    dist_uv = np.asarray(distort_pixels(camera, jnp.asarray(expected_uv)))
    # ROI covering only the left-most blob
    left = dist_uv[np.argmin(dist_uv[:, 0])]
    roi = jnp.asarray([left[0] - 12, left[1] - 12, 24, 24], jnp.float32)
    det = find_leds(frame, roi, params, camera)
    assert int(det.count) == 1


def test_find_leds_area_filter_rejects_big_blob(camera, markers, pose, params):
    # At threshold 240, a sigma splat keeps ~pi*(0.348*sigma)^2 px above
    # threshold; sigma=24 -> ~220 px^2 > max_blob_area=200.
    big = render_frame(camera, pose, markers[:1], blob_sigma=24.0)
    # reference parity: oversized contour dropped (led_detector.cpp:98)
    det = find_leds(big, full_roi(camera), params._replace(split_merged=False), camera)
    assert int(det.count) == 0  # giant blob exceeds max area
    # engine default: oversized+elongated blobs split into two children
    # (a merged-LED rescue; spurious children from glare are absorbed by
    # the tracker's outlier machinery) — a *hugely* oversized blob
    # (> split_max_factor * max) is still dropped
    det2 = find_leds(big, full_roi(camera), params, camera)
    assert int(det2.count) in (0, 2)
    # a giant blob (diameter beyond cc_sweeps) fragments into
    # unconverged partial components; with splitting on that can emit a
    # couple of spurious detections (absorbed downstream like injected
    # false blobs), in parity mode it emits none
    huge = _disc_image([(400, 240)], r=15)
    det3 = find_leds(huge, full_roi(camera), params, camera)
    assert int(det3.count) <= 2
    det4 = find_leds(huge, full_roi(camera), params._replace(split_merged=False), camera)
    assert int(det4.count) == 0


def test_find_leds_threshold(camera, markers, pose, params):
    dim = render_frame(camera, pose, markers, intensity=180.0)  # below 240 threshold
    det = find_leds(dim, full_roi(camera), params, camera)
    assert int(det.count) == 0


def test_find_leds_passive_markers(camera, markers, pose, params):
    # Dark blobs on a bright background, BINARY_INV path.
    bright = 255.0 - render_frame(camera, pose, markers)
    p = params._replace(active_markers=False, threshold=60.0)
    det = find_leds(bright, full_roi(camera), p, camera)
    assert int(det.count) == markers.shape[0]


def test_find_leds_jit(camera, markers, pose, frame, params):
    fn = jax.jit(lambda im, roi: find_leds(im, roi, params, camera))
    det = fn(frame, full_roi(camera))
    assert int(det.count) == markers.shape[0]


def test_determine_roi_covers_predictions(camera, markers, pose):
    uv = project(camera, pose, markers)
    mask = jnp.ones((markers.shape[0],), bool)
    roi = determine_roi(uv, mask, camera, border=10.0)
    uv_d = np.asarray(distort_pixels(camera, uv))
    r = np.asarray(roi)
    assert (uv_d[:, 0] >= r[0]).all() and (uv_d[:, 0] <= r[0] + r[2]).all()
    assert (uv_d[:, 1] >= r[1]).all() and (uv_d[:, 1] <= r[1] + r[3]).all()
    assert r[2] < camera.width  # tighter than the full frame


def test_determine_roi_degenerate_falls_back(camera):
    uv = jnp.zeros((5, 2), jnp.float32)
    mask = jnp.zeros((5,), bool)
    roi = np.asarray(determine_roi(uv, mask, camera, border=10.0))
    assert roi.tolist() == [0, 0, camera.width, camera.height]


def test_inject_faults_occlusion(camera, markers, pose, frame, params):
    det = find_leds(frame, full_roi(camera), params, camera)
    key = jax.random.PRNGKey(3)
    faulty = inject_faults(key, det, num_occlusions=5, num_false_detections=0)
    # coin flips mean 0..5 occlusions; occluded flags must match mask drop
    dropped = int(det.count) - int(faulty.count)
    assert dropped == int(jnp.sum(faulty.occluded))
    assert 0 <= dropped <= 5


def test_inject_faults_false_detections(camera, markers, pose, frame, params):
    det = find_leds(frame, full_roi(camera), params, camera)
    faulty = inject_faults(jax.random.PRNGKey(4), det, 0, 3)
    assert int(faulty.count) == int(det.count) + 3
    assert int(jnp.sum(faulty.injected)) == 3
    # injected points are within 5px (+-) of some real detection
    real = np.asarray(det.xy)[np.asarray(det.mask)]
    inj = np.asarray(faulty.xy)[np.asarray(faulty.injected)]
    for p in inj:
        assert np.abs(real - p).max(axis=-1).min() <= 5.0 + 1e-3


def test_inject_faults_deterministic(camera, frame, params):
    det = find_leds(frame, full_roi(camera), params, camera)
    a = inject_faults(jax.random.PRNGKey(7), det, 2, 2)
    b = inject_faults(jax.random.PRNGKey(7), det, 2, 2)
    np.testing.assert_array_equal(np.asarray(a.xy), np.asarray(b.xy))
    np.testing.assert_array_equal(np.asarray(a.mask), np.asarray(b.mask))


def test_exposure_control_hysteresis():
    st = ExposureState.create(2000.0)
    # 501 consecutive too-dim frames -> one +20% step
    for _ in range(501):
        st = exposure_control(st, jnp.asarray(10.0), jnp.asarray(100000.0), 2000.0, jnp.asarray(True))
    assert float(st.exposure_us) == pytest.approx(2400.0)
    assert int(st.counter_increase) == 0  # reset after firing


def test_exposure_control_no_detections_no_count():
    st = ExposureState.create(2000.0)
    st2 = exposure_control(st, jnp.asarray(0.0), jnp.asarray(1000.0), 2000.0, jnp.asarray(False))
    assert int(st2.counter_increase) == 0
    assert float(st2.exposure_us) == 2000.0


def _disc_image(centers, r, h=480, w=752):
    img = np.zeros((h, w), np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for cx, cy in centers:
        img[((xs - cx) ** 2 + (ys - cy) ** 2) <= r * r] = 255.0
    return jnp.asarray(img)


def test_merged_blob_split_recovers_two_leds(camera):
    """Two LEDs merging into one oversized elongated component are split
    into two detections near the true centres (engine extension; the
    reference's area filter drops the merged contour, led_detector.cpp:98).
    A clean round blob is unaffected; split_merged=False restores the
    reference's drop-it behaviour."""
    from pf_monocular_pose_estimator_tpu.ops.blob import BlobParams, find_leds

    img = _disc_image([(300, 200), (308, 200), (500, 300)], r=4)
    p = BlobParams(roi_crop=None)
    roi = jnp.asarray([0, 0, 752, 480], jnp.float32)
    det = find_leds(img, roi, p, camera)
    xy = np.asarray(det.xy)[np.asarray(det.mask)]
    assert xy.shape[0] == 3, xy
    # the two children straddle the true centres
    pair = xy[np.argsort(xy[:, 0])][:2]
    assert abs(pair[0, 0] - 300) < 3 and abs(pair[1, 0] - 308) < 3, pair
    assert np.all(np.abs(pair[:, 1] - 200) < 2), pair
    # single clean blob present and un-split
    assert np.any(np.linalg.norm(xy - np.array([500.0, 300.0]), axis=-1) < 2)

    det_off = find_leds(img, roi, p._replace(split_merged=False), camera)
    xy_off = np.asarray(det_off.xy)[np.asarray(det_off.mask)]
    assert xy_off.shape[0] == 1  # merged pair dropped, clean blob kept


def _scene_image(kind, camera, markers, pose):
    """(image, roi, params) for the crop-vs-full-frame parity cases."""
    p = BlobParams(min_blob_area=8.0, max_blob_area=200.0)
    uv = np.asarray(distort_pixels(camera, project(camera, pose, markers)))
    lo, hi = uv.min(0) - 15, uv.max(0) + 15
    roi = jnp.asarray([lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1]], jnp.float32)
    if kind == "active":
        return render_frame(camera, pose, markers), roi, p
    if kind == "passive":
        img = 255.0 - render_frame(camera, pose, markers)
        return img, roi, p._replace(active_markers=False, threshold=60.0)
    if kind == "roi_masks_one":
        # an ROI that cuts the left-most blob(s) out: both paths drop them
        left = uv[:, 0].min()
        roi = roi.at[0].set(left + 6).at[2].set(hi[0] - left - 6)
        return render_frame(camera, pose, markers), roi, p
    if kind == "merged_pair":
        img = _disc_image([(300, 200), (308, 200), (340, 230)], r=4)
        return img, jnp.asarray([280, 180, 90, 70], jnp.float32), BlobParams()
    if kind == "frame_corner":
        # ROI at the frame corner: the crop window clamps to the frame
        img = _disc_image([(12, 10), (40, 30), (25, 50)], r=3)
        return img, jnp.asarray([0, 0, 70, 70], jnp.float32), BlobParams(
            min_blob_area=8.0
        )
    raise ValueError(kind)


@pytest.mark.parametrize(
    "kind", ["active", "passive", "roi_masks_one", "merged_pair", "frame_corner"]
)
def test_detect_crop_matches_full_frame(camera, markers, pose, kind):
    """The XLA detection path on the fixed-size tracking crop (roi_crop)
    finds exactly what the full-frame pass finds inside the same ROI:
    same valid mask and order, centroids within 1e-3 px."""
    img, roi, p = _scene_image(kind, camera, markers, pose)
    crop = find_leds(img, roi, p._replace(roi_crop=(192, 256)), camera)
    full = find_leds(img, roi, p._replace(roi_crop=None), camera)
    np.testing.assert_array_equal(np.asarray(crop.mask), np.asarray(full.mask))
    m = np.asarray(full.mask)
    assert m.sum() >= 2, kind
    np.testing.assert_allclose(
        np.asarray(crop.xy)[m], np.asarray(full.xy)[m], atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(crop.area)[m], np.asarray(full.area)[m], atol=1e-3
    )
    if kind == "roi_masks_one":
        assert m.sum() < markers.shape[0]  # the cut blob is gone in both
    if kind == "merged_pair":
        assert m.sum() == 3  # the merged pair split in both paths
