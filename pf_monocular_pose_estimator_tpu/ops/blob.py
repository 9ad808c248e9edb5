"""LED blob detection as fixed-shape array programs.

Functional parity target: LEDDetector::findLeds
(pf_mpe_lib/src/led_detector.cpp:46-215) and determineROI (:217-369).

Reference pipeline (OpenCV, dynamic shapes):
  threshold (TOZERO active / BINARY_INV passive) -> Gaussian blur ->
  findContours -> per-contour area/aspect/circularity filters ->
  centroid via moments -> undistortPoints.

Accelerator redesign (static shapes, no host round-trips):
  * ROI becomes a mask over the full frame (no dynamic crop).
  * Contour extraction becomes iterative connected-component labelling:
    seed each foreground pixel with its flat index, then max-propagate
    labels through a 3x3 window for a fixed number of sweeps.  LED blobs
    are <= ~20 px across, so a small static sweep count converges.
  * Per-component statistics become one matmul: a (K, H*W) component
    -membership matrix against a (H*W, 4) feature matrix [w, wx, wy, 1],
    yielding area and first moments for the top-K components at once.
  * The result is a fixed-capacity `Detections` bank with a validity
    mask — downstream stages never see a dynamic detection count.

Documented deltas vs. the reference (gated by tests):
  * Blob area is the pixel count of the post-blur support, not OpenCV's
    Green-theorem contour area; for the small round blobs this engine
    filters for, both lie within a few pixels of each other and the
    min/max area thresholds carry the same meaning.
  * Centroids are binary-mask moments (optionally intensity-weighted),
    not contour-polygon moments.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.camera import Camera, distort_pixels, undistort_pixels


class BlobParams(NamedTuple):
    """Static detection parameters (recompile on change, like the
    reference's dynamic_reconfigure push at cfg:12-17)."""

    threshold: float = 240.0
    gaussian_sigma: float = 0.6
    min_blob_area: float = 20.0
    max_blob_area: float = 160.0
    max_width_height_distortion: float = 0.7
    max_circular_distortion: float = 0.7
    active_markers: bool = True
    max_detections: int = 16
    cc_sweeps: int = 12
    intensity_weighted_centroids: bool = False
    # When the ROI fits, detection runs on a fixed-size crop around it
    # instead of the full frame (the reference detects only inside the
    # ROI, led_detector.cpp:58 image(ROI)); (h, w) or None to disable.
    roi_crop: tuple | None = (192, 256)
    # Merged-blob splitting (engine extension; the reference drops
    # oversized contours entirely, led_detector.cpp:98): when two LEDs
    # merge into one component the area filter would reject it and the
    # tracker starves of detections exactly on the close-projection
    # frames where it needs them.  A component that is oversized
    # (area > max_blob_area, up to split_max_factor x) AND elongated
    # (principal/secondary variance >= split_min_elongation) is emitted
    # as TWO detections at the centroid +- the principal axis scaled by
    # sqrt(lambda_max - lambda_min) (the half-separation of two merged
    # discs).  Round oversized glare is still rejected.
    split_merged: bool = True
    split_max_factor: float = 2.5
    split_min_elongation: float = 1.5
    # Bimodality gate on the split (round 5): a component splits only if
    # the raw-image intensity at its centroid is <= this ratio of the
    # dimmer child-centroid intensity — a genuinely merged pair has an
    # intensity SADDLE between two peaks (measured 0.13-0.40 on the
    # merged-LED scenario) while a motion-blur streak is a monotone
    # ridge (measured 0.95-1.15 on the realistic golden, where splitting
    # created phantom detections 3-12 px off the true centroid that
    # captured greedy PF bindings).  >= 1e6 disables the gate.
    split_dip_ratio: float = 0.75


class Detections(NamedTuple):
    """Fixed-capacity detection bank.

    xy           : (K, 2) undistorted pixel centroids
    xy_distorted : (K, 2) raw (distorted) centroids, for visualisation
    mask         : (K,) validity
    area         : (K,) blob pixel areas
    occluded     : (K,) true where fault injection removed this detection
                   (kept for visualisation parity with the reference's
                   negated-coordinate convention, led_detector.cpp:438)
    injected     : (K,) true where fault injection fabricated this one
    """

    xy: jnp.ndarray
    xy_distorted: jnp.ndarray
    mask: jnp.ndarray
    area: jnp.ndarray
    occluded: jnp.ndarray
    injected: jnp.ndarray

    @property
    def count(self) -> jnp.ndarray:
        return jnp.sum(self.mask.astype(jnp.int32))


def _gaussian_kernel_1d(sigma: float) -> np.ndarray:
    """OpenCV-compatible odd kernel from sigma (getGaussianKernel with
    ksize derived as in cv::GaussianBlur for 8-bit: 2*round(3*sigma)+1)."""
    if sigma <= 0:
        return np.array([1.0], dtype=np.float32)
    ksize = int(round(sigma * 3.0)) * 2 + 1
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _blur(image: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur with reflect-101 padding (BORDER_DEFAULT)."""
    k = _gaussian_kernel_1d(sigma)
    if k.size == 1:
        return image
    half = k.size // 2
    kern = jnp.asarray(k, image.dtype)
    padded = jnp.pad(image, ((half, half), (0, 0)), mode="reflect")
    rows = jax.lax.conv_general_dilated(
        padded[None, None], kern[None, None, :, None], (1, 1), "VALID"
    )[0, 0]
    padded = jnp.pad(rows, ((0, 0), (half, half)), mode="reflect")
    cols = jax.lax.conv_general_dilated(
        padded[None, None], kern[None, None, None, :], (1, 1), "VALID"
    )[0, 0]
    return cols


def _max_pool_3x3(labels: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.reduce_window(
        labels,
        jnp.asarray(0, labels.dtype),
        jax.lax.max,
        window_dimensions=(3, 3),
        window_strides=(1, 1),
        padding="SAME",
    )


def connected_components(fg: jnp.ndarray, sweeps: int) -> jnp.ndarray:
    """Label foreground pixels by max-propagating flat indices.

    Returns an int32 (H, W) label image; background = 0, each component
    carries the 1-based flat index of its maximal pixel.  `sweeps` is
    static; each sweep extends a label by one pixel of 8-connected reach,
    so sweeps >= blob diameter guarantees convergence for LED-scale blobs.
    """
    h, w = fg.shape
    flat = (jnp.arange(h * w, dtype=jnp.int32) + 1).reshape(h, w)
    labels = jnp.where(fg, flat, 0)

    def body(_, lab):
        return jnp.where(fg, _max_pool_3x3(lab), 0)

    return jax.lax.fori_loop(0, sweeps, body, labels)


def _split_and_compact(
    params: BlobParams,
    comp_ids,
    cx,
    cy,
    area,
    valid,
    var_xx,
    var_yy,
    var_xy,
    min_area,
    max_area,
    img=None,
):
    """Shared tail of both detection paths: optionally split oversized
    elongated components into two child detections (see BlobParams.
    split_merged), then compact valid detections to the front in
    component-id (scan) order.

    img: the raw frame in the SAME pixel coordinates as cx/cy, used for
    the intensity-dip bimodality gate (see below); None disables it."""
    imax = jnp.iinfo(jnp.int32).max
    if not params.split_merged:
        order_key = jnp.where(valid, comp_ids, imax)
        perm = jnp.argsort(order_key)
        xy_d = jnp.stack([cx, cy], axis=-1)[perm]
        mask = valid[perm]
        return xy_d, mask, jnp.where(mask, area[perm], 0.0)

    # principal axes of the per-component pixel covariance
    tr = var_xx + var_yy
    diff = var_xx - var_yy
    disc = jnp.sqrt(jnp.maximum(diff * diff + 4.0 * var_xy * var_xy, 0.0))
    lam_max = 0.5 * (tr + disc)
    lam_min = jnp.maximum(0.5 * (tr - disc), 1e-6)
    half = area * 0.5
    split_ok = (
        (comp_ids > 0)
        & (area > max_area)
        & (area <= params.split_max_factor * max_area)
        & (lam_max / lam_min >= params.split_min_elongation)
        & (half >= min_area)
        & (half <= max_area)
    )
    # eigenvector of lam_max: (v_xy, lam_max - v_xx); axis-aligned fallback
    degen = jnp.abs(var_xy) <= 1e-9
    ux = jnp.where(degen, jnp.where(diff >= 0, 1.0, 0.0), var_xy)
    uy = jnp.where(degen, jnp.where(diff >= 0, 0.0, 1.0), lam_max - var_xx)
    norm = jnp.sqrt(jnp.maximum(ux * ux + uy * uy, 1e-12))
    off = jnp.sqrt(jnp.maximum(lam_max - lam_min, 0.0))  # half-separation
    ox = ux / norm * off
    oy = uy / norm * off

    if img is not None and params.split_dip_ratio < 1e6:
        # Bimodality gate (round 5): second moments alone cannot
        # distinguish a genuinely MERGED pair of LEDs from a single
        # motion-blur STREAK with the same covariance footprint.  On
        # the realistic golden the streaks were being split into
        # phantom detections 3-12 px from the true centroid, which
        # captured greedy PF bindings and inflated depth error ~1.5x
        # (measured: 3.12 mm -> 2.14 mm ATE at 500 particles with the
        # phantoms removed).  Two complementary single-pixel-probe
        # tests, split when EITHER fires:
        #   (a) intensity saddle on the principal axis: the centre is
        #       dimmer than split_dip_ratio x the dimmer child peak
        #       (Gaussian-falloff pairs; measured margins 0.13-0.40 on
        #       merged pairs vs 0.95-1.15 on streaks);
        #   (b) waist thinness, for SATURATED pairs whose saddle clips
        #       at full scale: probing one perpendicular step k ~
        #       sqrt(lam_min) off the axis, a dumbbell's waist is
        #       empty while its lobes are wide; a streak has the same
        #       width everywhere (and a thread-thin streak fails the
        #       lobes-wide check).
        # Passive (BINARY_INV) mode inverts the frame first — markers
        # are dark there, so the saddle is BRIGHTER between dark peaks.
        h_i, w_i = img.shape
        sample_img = img if params.active_markers else 255.0 - img

        def _sample(x, y):
            xi = jnp.clip(jnp.round(x).astype(jnp.int32), 0, w_i - 1)
            yi = jnp.clip(jnp.round(y).astype(jnp.int32), 0, h_i - 1)
            return sample_img[yi, xi]

        i_c = _sample(cx, cy)
        i_1 = _sample(cx + ox, cy + oy)
        i_2 = _sample(cx - ox, cy - oy)
        ratio = params.split_dip_ratio
        dip_axis = i_c <= ratio * jnp.minimum(i_1, i_2)

        # probe one perpendicular step off the axis: ~0.8 sigma of the
        # minor-axis spread (lam_min is measured on the blur-EXPANDED
        # foreground support, so a full sigma step lands outside the
        # raw lobes of small blobs)
        perp_k = jnp.sqrt(jnp.maximum(lam_min, 1.0)) * 0.8 + 0.5
        px_ = -(uy / norm) * perp_k
        py_ = (ux / norm) * perp_k

        def _perp_min(xc, yc):
            return jnp.minimum(
                _sample(xc + px_, yc + py_), _sample(xc - px_, yc - py_)
            )

        w_c = _perp_min(cx, cy)
        w_lobe = jnp.minimum(_perp_min(cx + ox, cy + oy), _perp_min(cx - ox, cy - oy))
        lobes_wide = w_lobe >= 0.5 * jnp.minimum(i_1, i_2)
        thin_waist = w_c <= ratio * w_lobe
        split_ok = split_ok & (dip_axis | (lobes_wide & thin_waist))

    p_valid = valid | split_ok
    p_x = jnp.where(split_ok, cx + ox, cx)
    p_y = jnp.where(split_ok, cy + oy, cy)
    p_area = jnp.where(split_ok, half, area)
    keys = jnp.concatenate(
        [
            jnp.where(p_valid, comp_ids * 2, imax),
            jnp.where(split_ok, comp_ids * 2 + 1, imax),
        ]
    )
    xs_all = jnp.concatenate([p_x, cx - ox])
    ys_all = jnp.concatenate([p_y, cy - oy])
    areas_all = jnp.concatenate([p_area, half])
    valid_all = jnp.concatenate([p_valid, split_ok])
    perm = jnp.argsort(keys)[: comp_ids.shape[0]]
    xy_d = jnp.stack([xs_all[perm], ys_all[perm]], axis=-1)
    mask = valid_all[perm]
    return xy_d, mask, jnp.where(mask, areas_all[perm], 0.0)


def _detect_blobs(
    img: jnp.ndarray,
    roi: jnp.ndarray,
    params: BlobParams,
    min_area: jnp.ndarray,
    max_area: jnp.ndarray,
    threshold: jnp.ndarray | None = None,
    wh_distortion: jnp.ndarray | None = None,
    circ_distortion: jnp.ndarray | None = None,
):
    """Core blob extraction on one (H, W) float image.

    Returns compacted (xy_distorted (K,2), mask (K,), area (K,)) in this
    image's pixel coordinates (no undistortion yet).
    """
    h, w = img.shape
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    roi = roi.astype(jnp.float32)

    thr = jnp.asarray(params.threshold if threshold is None else threshold, jnp.float32)
    in_roi = (
        (xs >= roi[0]) & (xs < roi[0] + roi[2]) & (ys >= roi[1]) & (ys < roi[1] + roi[3])
    )
    if params.active_markers:
        # THRESH_TOZERO (led_detector.cpp:58)
        tz = jnp.where(img > thr, img, 0.0)
    else:
        # THRESH_BINARY_INV (led_detector.cpp:60)
        tz = jnp.where(img > thr, 0.0, 255.0)
    tz = jnp.where(in_roi, tz, 0.0)
    blurred = _blur(tz, params.gaussian_sigma)
    fg = blurred > 1e-3

    labels = connected_components(fg, params.cc_sweeps)

    # Top-K component ids: each component's maximal pixel sees its own
    # flat index as its label.  Slots are contended, so rank components
    # by in-range area first — spurious specks and giant glare regions
    # only get slots after every plausible LED blob has one.  The area
    # used for *ranking* is a windowed foreground count (two separable
    # cumsum box filters) — exact for blobs up to the window size, with
    # no per-label bincount scatter; the exact
    # area used for *filtering* comes from the component moments below.
    k_cap = params.max_detections
    flat = (jnp.arange(h * w, dtype=jnp.int32) + 1).reshape(h, w)
    is_root = fg & (labels == flat)
    box_r = 2 * params.cc_sweeps  # window safely covers mergeable blobs

    def _box_sum(x, axis, r):
        # box[i] = c[min(i+r, L-1)] - (c[i-r-1] if i>r else 0)
        c = jnp.cumsum(x, axis=axis)
        length = x.shape[axis]
        pad_hi = [(0, 0), (0, 0)]
        pad_hi[axis] = (0, r)
        upper = jax.lax.slice_in_dim(jnp.pad(c, pad_hi, mode="edge"), r, r + length, axis=axis)
        pad_lo = [(0, 0), (0, 0)]
        pad_lo[axis] = (r + 1, 0)
        lower = jax.lax.slice_in_dim(jnp.pad(c, pad_lo), 0, length, axis=axis)
        return upper - lower

    mass = _box_sum(_box_sum(fg.astype(jnp.float32), 0, box_r), 1, box_r)
    root_area = jnp.where(is_root, mass, 0.0).reshape(-1)
    in_range = (root_area >= min_area) & (root_area <= max_area) & (root_area > 0)
    score = jnp.where(in_range, root_area + jnp.float32(1e6), root_area)
    _, top_idx = jax.lax.top_k(score, k_cap)
    comp_ids = jnp.where(root_area[top_idx] > 0, top_idx.astype(jnp.int32) + 1, 0)  # (K,)

    # Component membership (K, H*W) against features (H*W, F) as a matmul.
    lab_flat = labels.reshape(-1)
    member = (lab_flat[None, :] == comp_ids[:, None]) & (comp_ids[:, None] > 0)
    member_f = member.astype(jnp.float32)

    if params.intensity_weighted_centroids:
        weight = blurred.reshape(-1)
    else:
        weight = jnp.ones((h * w,), jnp.float32)
    xs_f = jnp.broadcast_to(xs, (h, w)).reshape(-1)
    ys_f = jnp.broadcast_to(ys, (h, w)).reshape(-1)
    feats = jnp.stack([weight, weight * xs_f, weight * ys_f, jnp.ones_like(weight)], axis=-1)
    moments = jnp.dot(member_f, feats, preferred_element_type=jnp.float32)  # (K, 4)
    wsum = jnp.maximum(moments[:, 0], 1e-9)
    cx = moments[:, 1] / wsum
    cy = moments[:, 2] / wsum
    area = moments[:, 3]  # unweighted pixel count
    # centred second moments for the splitter: E[x^2]-cx^2 in f32 loses
    # ~5 px^2 of precision at image-scale coordinates (phantom
    # elongation); a centred second pass is exact at blob scale
    wm = member_f * weight[None, :]
    dxs = xs_f[None, :] - cx[:, None]
    dys = ys_f[None, :] - cy[:, None]
    var_xx = jnp.sum(wm * dxs * dxs, axis=-1) / wsum
    var_yy = jnp.sum(wm * dys * dys, axis=-1) / wsum
    var_xy = jnp.sum(wm * dxs * dys, axis=-1) / wsum

    big = jnp.float32(1e9)
    x_min = jnp.min(jnp.where(member, xs_f[None, :], big), axis=-1)
    x_max = jnp.max(jnp.where(member, xs_f[None, :], -big), axis=-1)
    y_min = jnp.min(jnp.where(member, ys_f[None, :], big), axis=-1)
    y_max = jnp.max(jnp.where(member, ys_f[None, :], -big), axis=-1)
    bb_w = x_max - x_min + 1.0
    bb_h = y_max - y_min + 1.0

    # Shape filters (led_detector.cpp:98-102)
    ratio = jnp.minimum(bb_w / bb_h, bb_h / bb_w)
    circ_w = jnp.abs(1.0 - area / (math.pi * (bb_w / 2.0) ** 2))
    circ_h = jnp.abs(1.0 - area / (math.pi * (bb_h / 2.0) ** 2))
    wh_tol = jnp.asarray(
        params.max_width_height_distortion if wh_distortion is None else wh_distortion,
        jnp.float32,
    )
    circ_tol = jnp.asarray(
        params.max_circular_distortion if circ_distortion is None else circ_distortion,
        jnp.float32,
    )
    valid = (
        (comp_ids > 0)
        & (area >= min_area)
        & (area <= max_area)
        & (jnp.abs(1.0 - ratio) <= wh_tol)
        & (circ_w <= circ_tol)
        & (circ_h <= circ_tol)
    )

    # Compact valid detections to the front, ordered by image scan position
    # (approximates the reference's contour ordering); split merged blobs.
    return _split_and_compact(
        params, comp_ids, cx, cy, area, valid, var_xx, var_yy, var_xy,
        min_area, max_area, img=img,
    )


def find_leds(
    image: jnp.ndarray,
    roi: jnp.ndarray,
    params: BlobParams,
    camera: Camera,
    min_area: jnp.ndarray | None = None,
    max_area: jnp.ndarray | None = None,
    threshold: jnp.ndarray | None = None,
    wh_distortion: jnp.ndarray | None = None,
    circ_distortion: jnp.ndarray | None = None,
) -> Detections:
    """Detect LED blobs in a frame.

    image : (H, W) uint8/float grayscale (the red channel upstream,
            cf. pf_mpe/src/monocular_pose_estimator.cpp:267-268)
    roi   : (4,) [x0, y0, width, height] in pixels (dynamic values)
    min_area/max_area : optional *traced* overrides of the blob-area
            bounds, for the tracker's distance-adaptive thresholds
            (pose_estimator.cpp:435-439) without recompilation.
    threshold : optional *traced* override of the binarisation threshold
            (the reference's live-tunable threshold_value, cfg:12) —
            retuning it costs no recompile.
    wh_distortion/circ_distortion : optional *traced* overrides of the
            two shape-distortion ratios (cfg:16-17) — like the blob-area
            bounds, these are plain compare operands, so live retuning
            costs no recompile either.

    When `params.roi_crop` is set and the ROI fits, the whole pipeline
    runs on a fixed-size crop around the ROI centre (~7x less pixel work
    at 752x480 while tracking) — the equivalent of the reference's
    `image(ROI)` view; otherwise the full frame is processed with the
    ROI as a mask.
    """
    h, w = image.shape
    img = image.astype(jnp.float32)
    min_area = jnp.asarray(params.min_blob_area if min_area is None else min_area, jnp.float32)
    max_area = jnp.asarray(params.max_blob_area if max_area is None else max_area, jnp.float32)
    roi = roi.astype(jnp.float32)

    crop = params.roi_crop
    use_crop = crop is not None and crop[0] + 8 <= h and crop[1] + 8 <= w
    if use_crop:
        ch, cw = int(crop[0]), int(crop[1])
        # blur halo margin so crop-edge clipping can't alter blobs
        fits = (roi[2] <= cw - 8) & (roi[3] <= ch - 8)

        def cropped(_):
            cx0 = jnp.clip(
                jnp.round(roi[0] + roi[2] / 2 - cw / 2), 0, w - cw
            ).astype(jnp.int32)
            cy0 = jnp.clip(
                jnp.round(roi[1] + roi[3] / 2 - ch / 2), 0, h - ch
            ).astype(jnp.int32)
            img_c = jax.lax.dynamic_slice(img, (cy0, cx0), (ch, cw))
            offset = jnp.stack([cx0, cy0]).astype(jnp.float32)
            roi_local = jnp.concatenate([roi[:2] - offset, roi[2:]])
            xy_d, mask, area = _detect_blobs(
                img_c, roi_local, params, min_area, max_area, threshold=threshold,
                wh_distortion=wh_distortion, circ_distortion=circ_distortion,
            )
            return xy_d + offset[None, :], mask, area

        def full(_):
            return _detect_blobs(
                img, roi, params, min_area, max_area, threshold=threshold,
                wh_distortion=wh_distortion, circ_distortion=circ_distortion,
            )

        xy_d, mask, area_s = jax.lax.cond(fits, cropped, full, None)
    else:
        xy_d, mask, area_s = _detect_blobs(
            img, roi, params, min_area, max_area, threshold=threshold,
            wh_distortion=wh_distortion, circ_distortion=circ_distortion,
        )

    xy_u = undistort_pixels(camera, xy_d)
    zeros = jnp.zeros_like(mask)
    return Detections(
        xy=jnp.where(mask[:, None], xy_u, 0.0),
        xy_distorted=jnp.where(mask[:, None], xy_d, 0.0),
        mask=mask,
        area=jnp.where(mask, area_s, 0.0),
        occluded=zeros,
        injected=zeros,
    )


def determine_roi(
    predicted_pixels: jnp.ndarray,
    pixel_mask: jnp.ndarray,
    camera: Camera,
    border: float,
) -> jnp.ndarray:
    """Bounding ROI of predicted (undistorted) pixel positions.

    Mirrors LEDDetector::determineROI (led_detector.cpp:217-369): distort
    the bbox corners back to raw-image coordinates, pad by `border`, clamp
    to the frame, and fall back to the full frame when degenerate.

    predicted_pixels: (P, 2); pixel_mask: (P,) validity.
    Returns (4,) [x0, y0, width, height].
    """
    big = jnp.float32(1e9)
    m = pixel_mask[:, None]
    x_min = jnp.min(jnp.where(m, predicted_pixels, big)[:, 0])
    y_min = jnp.min(jnp.where(m, predicted_pixels, big)[:, 1])
    x_max = jnp.max(jnp.where(m, predicted_pixels, -big)[:, 0])
    y_max = jnp.max(jnp.where(m, predicted_pixels, -big)[:, 1])

    corners = jnp.stack([jnp.stack([x_min, y_min]), jnp.stack([x_max, y_max])])
    dist = distort_pixels(camera, corners)

    wf = jnp.float32(camera.width)
    hf = jnp.float32(camera.height)
    x0 = jnp.clip(dist[0, 0] - border, 0.0, wf)
    x1 = jnp.clip(dist[1, 0] + border, 0.0, wf)
    y0 = jnp.clip(dist[0, 1] - border, 0.0, hf)
    y1 = jnp.clip(dist[1, 1] + border, 0.0, hf)

    degenerate = ((x1 - x0) < 1.0) | ((y1 - y0) < 1.0) | ~jnp.any(pixel_mask)
    full = jnp.stack([jnp.float32(0), jnp.float32(0), wf, hf])
    box = jnp.stack([x0, y0, x1 - x0, y1 - y0])
    return jnp.where(degenerate, full, box)


def grow_roi(roi: jnp.ndarray, dx: jnp.ndarray, dy: jnp.ndarray, camera: Camera) -> jnp.ndarray:
    """Symmetrically grow an ROI by (dx, dy) with frame clamping.

    Implements the recurring grow-and-clamp idiom of the reference
    (pose_estimator.cpp:139-143, 429-432, 454-457).
    """
    wf = jnp.float32(camera.width)
    hf = jnp.float32(camera.height)
    x0 = jnp.maximum(roi[0] - dx, 0.0)
    y0 = jnp.maximum(roi[1] - dy, 0.0)
    w = jnp.minimum(roi[2] + 2.0 * dx, wf - x0)
    h = jnp.minimum(roi[3] + 2.0 * dy, hf - y0)
    return jnp.stack([x0, y0, w, h])
