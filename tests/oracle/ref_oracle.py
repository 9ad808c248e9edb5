"""Reference oracle: faithful float64 numpy transliterations of the
load-bearing functions of /root/reference/pf_mpe_lib/src (test-only).

This module exists so the engine can be graded against the *reference's*
algorithms rather than against itself (round-1 verdict: "the entire
accuracy story rests on the code grading itself").  Each function is a
line-faithful port of the cited C++ — scalar loops, early exits, 1-based
pair indices and all — deliberately NOT the batched array style used in the
package.  It is never imported by the engine.

Ported functions (all from pf_mpe_lib/src/pose_estimator.cpp unless
noted):
  exponential_map / logarithm_map / skew        :2194-2303
  project2d                                     :1017-1034
  calculate_image_vectors                       :1072-1085
  compute_jacobian (Eade A.14)                  :2163-2192
  calculate_min_distances_and_pairs             :2093-2137
  calculate_estimation_probability (PF weight)  :2385-2445
  check_ambiguity                               :2447-2458
  correspondences_from_histogram                :1134-1288
  init_histogram (voting sweep of initialise)   :1503-1716
  optimise_pose (Gauss-Newton)                  :1805-2009
  compute_transformation (Umeyama)              :2139-2161
  p3p_compute_poses / solve_quartic             p3p.cpp:65-292
"""

from __future__ import annotations

import numpy as np


# --------------------------------------------------------------- SE(3)
def skew(w):
    return np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]], dtype=np.float64
    )


def exponential_map(twist):
    """pose_estimator.cpp:2194-2226 (twist = [translation, rotation])."""
    upsilon = np.asarray(twist[:3], np.float64)
    omega = np.asarray(twist[3:], np.float64)
    theta = np.linalg.norm(omega)
    omega_hat = skew(omega)
    omega_hat2 = omega_hat @ omega_hat
    if theta == 0:
        rotation = np.eye(3)
        v_mat = np.eye(3)
    else:
        theta2 = theta * theta
        rotation = (
            np.eye(3)
            + omega_hat / theta * np.sin(theta)
            + omega_hat2 / theta2 * (1 - np.cos(theta))
        )
        v_mat = (
            np.eye(3)
            + (1 - np.cos(theta)) / theta2 * omega_hat
            + (theta - np.sin(theta)) / (theta2 * theta) * omega_hat2
        )
    transform = np.eye(4)
    transform[:3, :3] = rotation
    transform[:3, 3] = v_mat @ upsilon
    return transform


def logarithm_map(trans):
    """pose_estimator.cpp:2228-2296."""
    r_mat = np.asarray(trans[:3, :3], np.float64)
    t = np.asarray(trans[:3, 3], np.float64)
    if np.allclose(r_mat, np.eye(3), atol=1e-10):
        w_hat = np.zeros((3, 3))
    else:
        temp = np.clip((np.trace(r_mat) - 1) / 2, -1.0, 1.0)
        phi = np.arccos(temp)
        if phi == 0:
            w_hat = np.zeros((3, 3))
        else:
            w_hat = (r_mat - r_mat.T) / (2 * np.sin(phi)) * phi
    w = np.array([w_hat[2, 1], w_hat[0, 2], w_hat[1, 0]])
    w_norm = np.linalg.norm(w)
    if np.allclose(t, 0, atol=1e-10):
        a_inv = np.zeros((3, 3))
    elif w_norm == 0 or np.sin(w_norm) == 0:
        a_inv = np.eye(3)
    else:
        a_inv = (
            np.eye(3)
            - w_hat / 2
            + (2 * np.sin(w_norm) - w_norm * (1 + np.cos(w_norm)))
            / (2 * w_norm * w_norm * np.sin(w_norm))
            * (w_hat @ w_hat)
        )
    return np.concatenate([a_inv @ t, w])


# --------------------------------------------------------------- camera
def project2d(point4, transform, fx, fy, cx, cy):
    """pose_estimator.cpp:1017-1034 (pinhole K @ T @ X, undistorted)."""
    k_mat = np.array(
        [[fx, 0.0, cx, 0.0], [0.0, fy, cy, 0.0], [0.0, 0.0, 1.0, 0.0]], np.float64
    )
    temp = k_mat @ (np.asarray(transform, np.float64) @ np.asarray(point4, np.float64))
    return temp[:2] / temp[2]


def calculate_image_vectors(image_points, fx, fy, cx, cy):
    """pose_estimator.cpp:1072-1085: pixel -> unit bearing ray."""
    vecs = []
    for p in image_points:
        v = np.array([(p[0] - cx) / fx, (p[1] - cy) / fy, 1.0])
        vecs.append(v / np.linalg.norm(v))
    return np.stack(vecs)


def compute_jacobian(t_c_o, world_point4, fx, fy):
    """pose_estimator.cpp:2163-2192 (Eade A.14)."""
    pc = np.asarray(t_c_o, np.float64) @ np.asarray(world_point4, np.float64)
    x, y, z = pc[0], pc[1], pc[2]
    z2 = z * z
    jac = np.zeros((2, 6))
    jac[0] = [fx / z, 0, -x / z2 * fx, -x * y / z2 * fx, (1 + x * x / z2) * fx, -y / z * fx]
    jac[1] = [0, fy / z, -y / z2 * fy, -(1 + y * y / z2) * fy, x * y / z2 * fy, x / z * fy]
    return jac


# ------------------------------------------------------------- matching
def calculate_min_distances_and_pairs(points_a, points_b):
    """pose_estimator.cpp:2093-2137: per-a independent nearest-b pairing.

    Returns (pairs (A,2) 1-based [a_idx, b_idx], min_distances (A,))."""
    num_a = len(points_a)
    pairs = np.zeros((num_a, 2), np.int64)
    pairs[:, 0] = np.arange(1, num_a + 1)
    min_d = np.zeros(num_a)
    for i in range(num_a):
        best = np.inf
        for j in range(len(points_b)):
            d2 = float(np.sum((points_a[i] - points_b[j]) ** 2))
            if d2 < best:
                best = d2
                pairs[i, 1] = j + 1
        min_d[i] = np.sqrt(best)
    return pairs, min_d


# ------------------------------------------------------------ PF weight
def calculate_estimation_probability(
    image_pts,
    object_pts,
    tol_pf,
    tol_init,
    num_markers_total,
    marker_downgrade=None,
):
    """pose_estimator.cpp:2385-2445 — the particle weight.

    image_pts: (K,2) detections; object_pts: (M,2) projected markers for
    one particle; num_markers_total = object_points_.size() (the score
    increment uses the FULL marker count, :2416).  Returns
    (probability, pairs (C,2) 1-based [led, detection])."""
    image_pts = np.asarray(image_pts, np.float64)
    object_pts = np.asarray(object_pts, np.float64)
    k_n, m_n = len(image_pts), len(object_pts)
    if marker_downgrade is None:
        marker_downgrade = np.zeros(m_n, bool)
    distances = np.sum(
        (image_pts[:, None, :] - object_pts[None, :, :]) ** 2, axis=-1
    )  # (K, M) squared
    probability = 0.0
    pairs = []
    used_detections = []
    num_self_occlusion = 1
    for _ in range(min(k_n, m_n)):
        flat = np.argmin(distances)
        row_idx, col_idx = np.unravel_index(flat, distances.shape)
        min_value = np.sqrt(distances[row_idx, col_idx])
        if min_value <= tol_pf:
            probability += num_markers_total + ((tol_init - min_value) / tol_init) ** 2
            pairs.append((col_idx + 1, row_idx + 1))
            if row_idx in used_detections:
                probability -= num_self_occlusion * 3
                num_self_occlusion += 1
            used_detections.append(row_idx)
            if marker_downgrade[col_idx]:
                probability -= 2
            distances[:, col_idx] = np.inf  # only the marker is retired
        else:
            break
    return probability, np.asarray(pairs, np.int64).reshape(-1, 2)


def check_ambiguity(corresponding_detections):
    """pose_estimator.cpp:2447-2458 (duplicate nonzero detection)."""
    c = [d for d in corresponding_detections if d != 0]
    return len(set(c)) != len(c)


# ----------------------------------------------------- histogram -> corr
def correspondences_from_histogram(histogram, b_initialisation):
    """pose_estimator.cpp:1134-1288.

    histogram: (numRows=detections, numCols=LEDs) ints.  Returns a list of
    (C,2) 1-based [led, detection] arrays, most likely first."""
    histogram = np.asarray(histogram, np.int64)
    num_rows, num_cols = histogram.shape
    prob_threshold = 1.3 / (num_rows * num_cols)
    hist_prob = histogram.astype(np.float64)
    for cols in range(num_cols):
        col_sum = histogram[:, cols].sum()
        if col_sum == 0:
            continue
        for rows in range(num_rows):
            row_sum = histogram[rows, :].sum()
            hist_prob[rows, cols] = max(
                0.0, hist_prob[rows, cols] ** 2 / (col_sum * row_sum)
            )
            if hist_prob[rows, cols] < prob_threshold:
                hist_prob[rows, cols] = 0.0

    u_prob, u_num = [], []
    for a in range(num_cols):
        v_prob = [hist_prob[b, a] for b in range(num_rows) if hist_prob[b, a] != 0]
        v_num = [b + 1 for b in range(num_rows) if hist_prob[b, a] != 0]
        u_prob.append(v_prob)
        u_num.append(v_num)

    n_total = 1
    n_v = []
    for k in range(len(u_prob)):
        n_total *= max(1, len(u_prob[k]))
        n_v.append(len(u_num[k]))

    v_comb, v_prob_comb = [], []
    for i in range(n_total):
        prob = 1.0
        n = 1
        comb = []
        for idx_led in range(len(u_prob) - 1, -1, -1):
            if n_v[idx_led] > 0:
                idx_det = (i // n) % n_v[idx_led]
                prob *= u_prob[idx_led][idx_det]
                comb.append(u_num[idx_led][idx_det])
                n *= max(1, n_v[idx_led])
            else:
                comb.append(0)
        v_prob_comb.append(prob)
        v_comb.append(list(reversed(comb)))

    total = sum(v_prob_comb)
    if total > 0:
        v_prob_comb = [p / total for p in v_prob_comb]

    out = []
    probs = list(v_prob_comb)
    for _ in range(len(probs)):
        row_idx = int(np.argmax(probs))
        probs[row_idx] = 0.0
        corresponding = v_comb[row_idx]
        if b_initialisation and check_ambiguity(corresponding):
            continue
        pairs = [
            (led + 1, corresponding[led])
            for led in range(num_cols)
            if corresponding[led] != 0
        ]
        out.append(np.asarray(pairs, np.int64).reshape(-1, 2))
    return out


# ----------------------------------------------------------------- P3P
def solve_quartic(factors):
    """p3p.cpp:238-292 (Ferrari, complex arithmetic, real parts)."""
    a, b, c, d, e = [float(f) for f in factors]
    a2, b2 = a * a, b * b
    a3, b3 = a2 * a, b2 * b
    a4, b4 = a3 * a, b3 * b
    alpha = -3 * b2 / (8 * a2) + c / a
    beta = b3 / (8 * a3) - b * c / (2 * a2) + d / a
    gamma = -3 * b4 / (256 * a4) + b2 * c / (16 * a3) - b * d / (4 * a2) + e / a
    p_c = complex(-alpha * alpha / 12 - gamma)
    q_c = complex(-alpha**3 / 108 + alpha * gamma / 3 - beta**2 / 8)
    r_c = -q_c / 2.0 + np.sqrt(q_c**2 / 4.0 + p_c**3 / 27.0 + 0j)
    u_c = r_c ** (1.0 / 3.0)
    if u_c.real == 0:
        y = -5.0 * alpha / 6.0 - q_c ** (1.0 / 3.0)
    else:
        y = -5.0 * alpha / 6.0 - p_c / (3.0 * u_c) + u_c
    w = np.sqrt(alpha + 2.0 * y + 0j)
    roots = np.zeros(4)
    roots[0] = (-b / (4 * a) + 0.5 * (w + np.sqrt(-(3 * alpha + 2 * y + 2 * beta / w)))).real
    roots[1] = (-b / (4 * a) + 0.5 * (w - np.sqrt(-(3 * alpha + 2 * y + 2 * beta / w)))).real
    roots[2] = (-b / (4 * a) + 0.5 * (-w + np.sqrt(-(3 * alpha + 2 * y - 2 * beta / w)))).real
    roots[3] = (-b / (4 * a) + 0.5 * (-w - np.sqrt(-(3 * alpha + 2 * y - 2 * beta / w)))).real
    return roots


def p3p_compute_poses(feature_vectors, world_points):
    """p3p.cpp:65-236 (Kneip 2011).  feature_vectors/world_points: (3,3)
    with COLUMNS as vectors (Eigen layout).  Returns (solutions (4,3,4)
    [R|C] camera-in-object, ok)."""
    fv = np.asarray(feature_vectors, np.float64)
    wp = np.asarray(world_points, np.float64)
    p1, p2, p3 = wp[:, 0].copy(), wp[:, 1].copy(), wp[:, 2].copy()
    if np.linalg.norm(np.cross(p2 - p1, p3 - p1)) == 0:
        return np.zeros((4, 3, 4)), False
    f1, f2, f3 = fv[:, 0].copy(), fv[:, 1].copy(), fv[:, 2].copy()

    e1 = f1
    e3 = np.cross(f1, f2)
    e3 = e3 / np.linalg.norm(e3)
    e2 = np.cross(e3, e1)
    t_mat = np.stack([e1, e2, e3])
    f3t = t_mat @ f3
    if f3t[2] > 0:
        f1, f2 = fv[:, 1].copy(), fv[:, 0].copy()
        f3 = fv[:, 2].copy()
        e1 = f1
        e3 = np.cross(f1, f2)
        e3 = e3 / np.linalg.norm(e3)
        e2 = np.cross(e3, e1)
        t_mat = np.stack([e1, e2, e3])
        f3t = t_mat @ f3
        p1, p2 = wp[:, 1].copy(), wp[:, 0].copy()
        p3 = wp[:, 2].copy()

    n1 = p2 - p1
    n1 = n1 / np.linalg.norm(n1)
    n3 = np.cross(n1, p3 - p1)
    n3 = n3 / np.linalg.norm(n3)
    n2 = np.cross(n3, n1)
    n_mat = np.stack([n1, n2, n3])
    p3n = n_mat @ (p3 - p1)

    d_12 = np.linalg.norm(p2 - p1)
    f_1 = f3t[0] / f3t[2]
    f_2 = f3t[1] / f3t[2]
    p_1, p_2 = p3n[0], p3n[1]
    cos_beta = float(f1 @ f2)
    b = 1 / (1 - cos_beta**2) - 1
    b = -np.sqrt(b) if cos_beta < 0 else np.sqrt(b)

    f_1_2, f_2_2 = f_1**2, f_2**2
    p_1_2, p_1_3, p_1_4 = p_1**2, p_1**3, p_1**4
    p_2_2, p_2_3, p_2_4 = p_2**2, p_2**3, p_2**4
    d_12_2, b_2 = d_12**2, b**2

    factors = np.array(
        [
            -f_2_2 * p_2_4 - p_2_4 * f_1_2 - p_2_4,
            2 * p_2_3 * d_12 * b + 2 * f_2_2 * p_2_3 * d_12 * b - 2 * f_2 * p_2_3 * f_1 * d_12,
            -f_2_2 * p_2_2 * p_1_2
            - f_2_2 * p_2_2 * d_12_2 * b_2
            - f_2_2 * p_2_2 * d_12_2
            + f_2_2 * p_2_4
            + p_2_4 * f_1_2
            + 2 * p_1 * p_2_2 * d_12
            + 2 * f_1 * f_2 * p_1 * p_2_2 * d_12 * b
            - p_2_2 * p_1_2 * f_1_2
            + 2 * p_1 * p_2_2 * f_2_2 * d_12
            - p_2_2 * d_12_2 * b_2
            - 2 * p_1_2 * p_2_2,
            2 * p_1_2 * p_2 * d_12 * b
            + 2 * f_2 * p_2_3 * f_1 * d_12
            - 2 * f_2_2 * p_2_3 * d_12 * b
            - 2 * p_1 * p_2 * d_12_2 * b,
            -2 * f_2 * p_2_2 * f_1 * p_1 * d_12 * b
            + f_2_2 * p_2_2 * d_12_2
            + 2 * p_1_3 * d_12
            - p_1_2 * d_12_2
            + f_2_2 * p_2_2 * p_1_2
            - p_1_4
            - 2 * f_2_2 * p_2_2 * p_1 * d_12
            + p_2_2 * f_1_2 * p_1_2
            + f_2_2 * p_2_2 * d_12_2 * b_2,
        ]
    )
    real_roots = solve_quartic(factors)

    solutions = np.zeros((4, 3, 4))
    with np.errstate(invalid="ignore", divide="ignore"):
        for i in range(4):
            cot_alpha = (-f_1 * p_1 / f_2 - real_roots[i] * p_2 + d_12 * b) / (
                -f_1 * real_roots[i] * p_2 / f_2 + p_1 - d_12
            )
            cos_theta = real_roots[i]
            sin_theta = np.sqrt(max(1 - real_roots[i] ** 2, 0.0))
            sin_alpha = np.sqrt(1 / (cot_alpha**2 + 1))
            cos_alpha = np.sqrt(max(1 - sin_alpha**2, 0.0))
            if cot_alpha < 0:
                cos_alpha = -cos_alpha
            c_vec = np.array(
                [
                    d_12 * cos_alpha * (sin_alpha * b + cos_alpha),
                    cos_theta * d_12 * sin_alpha * (sin_alpha * b + cos_alpha),
                    sin_theta * d_12 * sin_alpha * (sin_alpha * b + cos_alpha),
                ]
            )
            c_vec = p1 + n_mat.T @ c_vec
            r_loc = np.array(
                [
                    [-cos_alpha, -sin_alpha * cos_theta, -sin_alpha * sin_theta],
                    [sin_alpha, -cos_alpha * cos_theta, -cos_alpha * sin_theta],
                    [0.0, -sin_theta, cos_theta],
                ]
            )
            r_mat = n_mat.T @ r_loc.T @ t_mat
            solutions[i, :, :3] = r_mat
            solutions[i, :, 3] = c_vec
    return solutions, True


# --------------------------------------------------- init histogram vote
def init_histogram(
    image_points,
    object_points4,
    fx,
    fy,
    cx,
    cy,
    back_projection_pixel_tolerance,
    pair_distance_gate=1000.0,
    cluster_radius=1000.0,
    cluster_min=5,
):
    """The voting sweep of PoseEstimator::initialise
    (pose_estimator.cpp:1529-1716): every C(K,3) detection combination x
    P(M,3) marker permutation -> P3P -> back-project unused markers ->
    vote into the (K, M) histogram.  Scalar loops, faithful.

    image_points: (K,2) undistorted pixels; object_points4: (M,4)."""
    from itertools import combinations, permutations

    image_points = np.asarray(image_points, np.float64)
    object_points4 = np.asarray(object_points4, np.float64)
    k_n = len(image_points)
    m_n = len(object_points4)
    image_vectors = calculate_image_vectors(image_points, fx, fy, cx, cy)
    hist = np.zeros((k_n, m_n), np.int64)
    thresh_dist = pair_distance_gate**2
    thresh_dist2 = cluster_radius**2

    for combo in combinations(range(k_n), 3):
        d1, d2, d3 = (image_points[c] for c in combo)
        if np.sum((d1 - d2) ** 2) > thresh_dist:
            continue
        if np.sum((d1 - d3) ** 2) > thresh_dist:
            continue
        if np.sum((d2 - d3) ** 2) > thresh_dist:
            continue
        dm = (d1 + d2 + d3) / 3
        in_cluster = [
            kk
            for kk in range(k_n)
            if np.sum((dm - image_points[kk]) ** 2) < thresh_dist2
        ]
        if len(in_cluster) < cluster_min:
            continue
        unused_im_idx = [kk for kk in in_cluster if kk not in combo][: k_n - 3]

        fv = np.stack([image_vectors[c] for c in combo], axis=-1)  # columns
        for perm in permutations(range(m_n), 3):
            wp = np.stack(
                [object_points4[p][:3] for p in perm], axis=-1
            )  # columns
            sols, ok = p3p_compute_poses(fv, wp)
            if not ok:
                continue
            unused_obj_idx = [ll for ll in range(m_n) if ll not in perm]
            for k in range(4):
                if k > 0 and np.all(sols[k] == sols[k - 1]):
                    continue
                h_o_c = np.eye(4)
                h_o_c[:3, :] = sols[k]
                if not np.all(np.isfinite(h_o_c)):
                    continue
                t_c_o = np.linalg.inv(h_o_c)
                back_proj = [
                    project2d(object_points4[m], t_c_o, fx, fy, cx, cy)
                    for m in unused_obj_idx
                ]
                unused_im = [image_points[i] for i in unused_im_idx]
                if not unused_im or not back_proj:
                    continue
                pairs, min_d = calculate_min_distances_and_pairs(unused_im, back_proj)
                within = min_d < back_projection_pixel_tolerance
                if np.count_nonzero(within) > 0:
                    for mm in range(3):
                        hist[combo[mm], perm[mm]] += 1
                    for nn in range(len(min_d)):
                        if within[nn]:
                            hist[
                                unused_im_idx[pairs[nn, 0] - 1],
                                unused_obj_idx[pairs[nn, 1] - 1],
                            ] += 1
    return hist


# ------------------------------------------------------------------- GN
def optimise_pose(
    predicted_pose,
    correspondences,
    image_points,
    object_points4,
    fx,
    fy,
    cx,
    cy,
    max_itr=500,
    converged=1e-13,
):
    """pose_estimator.cpp:1805-2009 — Gauss-Newton on SE(3).

    correspondences: (C,2) 1-based [led, detection] (detection 0 = skip).
    Returns (pose, covariance, num_iterations).  Faithful, including the
    divergence guard comparing single residual norms via the `e_init =+`
    typo (which makes the guard compare only the LAST residual of the
    first/final iterations)."""
    pose = np.asarray(predicted_pose, np.float64).copy()
    pose_init = pose.copy()
    correspondences = np.asarray(correspondences, np.int64).reshape(-1, 2)
    e_init = 0.0
    e_end = 0.0
    a_mat = np.zeros((6, 6))
    num_iter = max_itr
    for i in range(max_itr):
        a_mat = np.zeros((6, 6))
        b_vec = np.zeros(6)
        for j in range(len(correspondences)):
            if correspondences[j, 1] == 0:
                continue
            obj = object_points4[correspondences[j, 0] - 1]
            p_img = project2d(obj, pose, fx, fy, cx, cy)
            e = image_points[correspondences[j, 1] - 1] - p_img
            if i == 0:
                e_init = np.linalg.norm(e)  # `e_init =+` typo: assignment
            elif i + 1 == max_itr:
                e_end = np.linalg.norm(e)
            jac = compute_jacobian(pose, obj, fx, fy)
            a_mat += jac.T @ jac
            b_vec += jac.T @ e
        # Eigen ldlt().solve() does not throw on a rank-deficient A
        # (< 3 pairs); lstsq reproduces a non-crashing minimum-norm step
        d_t = np.linalg.lstsq(a_mat, b_vec, rcond=None)[0]
        pose = exponential_map(d_t) @ pose
        if np.max(np.abs(d_t)) <= converged:
            num_iter = i
            break
        if i + 1 == max_itr and e_init < e_end:
            pose = pose_init
    # The reference computes A.inverse() via Eigen (pose_estimator.cpp:
    # 2004), which does NOT throw on a singular A — it returns a
    # garbage/inf matrix and the node carries on.  numpy's inv raises;
    # use pinv on the singular path so the port keeps the reference's
    # keep-running behaviour (hit under fault injection when a frame's
    # correspondences collapse to a degenerate geometry).
    try:
        covariance = np.linalg.inv(a_mat)
    except np.linalg.LinAlgError:
        covariance = np.linalg.pinv(a_mat)
    return pose, covariance, num_iter


def calculate_squared_reprojection_error_and_certainty(
    image_pts, object_pts, back_projection_pixel_tolerance
):
    """pose_estimator.cpp:1087-1132: per-index distances, greedy removal,
    certainty = matched / min(sizes).  Returns (squared_error, certainty)."""
    image_pts = np.asarray(image_pts, np.float64)
    object_pts = np.asarray(object_pts, np.float64)
    distances = np.sum((image_pts - object_pts) ** 2, axis=-1).astype(np.float64)
    tol2 = back_projection_pixel_tolerance**2
    squared_error = 0.0
    num_corr = 0
    for _ in range(min(len(image_pts), len(object_pts))):
        row = int(np.argmin(distances))
        if distances[row] <= tol2:
            squared_error += distances[row]
            num_corr += 1
            distances[row] = np.inf
        else:
            break
    certainty = num_corr / max(min(len(image_pts), len(object_pts)), 1)
    return squared_error, certainty


def check_correspondences(
    correspondences,
    image_points,
    object_points4,
    fx,
    fy,
    cx,
    cy,
    back_projection_pixel_tolerance,
    certainty_threshold=1.0,
    valid_correspondence_threshold=0.5,
    min_num_corr=4,
):
    """pose_estimator.cpp:1312-1501: sub-triple P3P consensus.

    correspondences: (C,2) 1-based [led, detection].  Returns
    (valid, pose, seeds) where seeds are the per-combination best P3P
    camera poses harvested for the particle bank (:1429-1437)."""
    from itertools import combinations as it_combinations

    correspondences = np.asarray(correspondences, np.int64).reshape(-1, 2)
    n_corr = len(correspondences)
    m_n = len(object_points4)
    if n_corr < min_num_corr:
        return False, np.eye(4), []
    image_vectors = calculate_image_vectors(image_points, fx, fy, cx, cy)
    mean_reproj = np.zeros((4, m_n))
    combos = list(it_combinations(range(n_corr), 3))
    num_valid = 0
    seeds = []
    for combo in combos:
        wp = np.stack(
            [object_points4[correspondences[c, 0] - 1][:3] for c in combo], axis=-1
        )
        fv = np.stack(
            [image_vectors[correspondences[c, 1] - 1] for c in combo], axis=-1
        )
        unused = [l for l in range(n_corr) if l not in combo]
        unused_obj = [object_points4[correspondences[l, 0] - 1] for l in unused]
        unused_im = [image_points[correspondences[l, 1] - 1] for l in unused]
        sols, ok = p3p_compute_poses(fv, wp)
        if not ok:
            continue
        min_sq = np.inf
        best_idx = -1
        found = False
        for j in range(4):
            h_o_c = np.eye(4)
            h_o_c[:3, :] = sols[j]
            if not np.all(np.isfinite(h_o_c)):
                continue
            t_c_o = np.linalg.inv(h_o_c)
            back = [project2d(p, t_c_o, fx, fy, cx, cy) for p in unused_obj]
            sq, certainty = calculate_squared_reprojection_error_and_certainty(
                unused_im, back, back_projection_pixel_tolerance
            )
            if certainty >= certainty_threshold:
                found = True
                if sq < min_sq:
                    min_sq = sq
                    best_idx = j
        if found:
            num_valid += 1
            h_best = np.eye(4)
            h_best[:3, :] = sols[best_idx]
            t_best = np.linalg.inv(h_best)
            seeds.append(t_best)
            for jj in range(m_n):
                mean_reproj[:, jj] += t_best @ object_points4[jj]
    if num_valid / max(len(combos), 1) >= valid_correspondence_threshold:
        mean_reproj = mean_reproj / num_valid
        obj_mat = np.stack([p[:3] for p in object_points4], axis=-1)
        pose = compute_transformation(obj_mat, mean_reproj[:3])
        return True, pose, seeds
    return False, np.eye(4), seeds


def initialise(
    image_points,
    object_points4,
    fx,
    fy,
    cx,
    cy,
    back_projection_pixel_tolerance,
    certainty_threshold=1.0,
    valid_correspondence_threshold=0.5,
    pair_distance_gate=1000.0,
    cluster_radius=1000.0,
    cluster_min=5,
):
    """Full init path (pose_estimator.cpp:1503-1786): histogram ->
    ranked candidates -> checkCorrespondences down the list.  Returns
    (success, pose, correspondences or None, seeds)."""
    if len(image_points) < len(object_points4):
        return False, np.eye(4), None, []
    hist = init_histogram(
        image_points,
        object_points4,
        fx,
        fy,
        cx,
        cy,
        back_projection_pixel_tolerance,
        pair_distance_gate,
        cluster_radius,
        cluster_min,
    )
    if not hist.any():
        return False, np.eye(4), None, []
    candidates = correspondences_from_histogram(hist, b_initialisation=True)
    all_seeds = []
    for corr in candidates:
        valid, pose, seeds = check_correspondences(
            corr,
            image_points,
            object_points4,
            fx,
            fy,
            cx,
            cy,
            back_projection_pixel_tolerance,
            certainty_threshold,
            valid_correspondence_threshold,
        )
        all_seeds.extend(seeds)
        if valid:
            return True, pose, corr, all_seeds
    return False, np.eye(4), None, all_seeds


def compute_transformation(object_points, reprojected_points):
    """pose_estimator.cpp:2139-2161 (SVD point-cloud alignment; both
    arguments are (3, N) with points as columns)."""
    obj = np.asarray(object_points, np.float64)
    rep = np.asarray(reprojected_points, np.float64)
    mean_obj = obj.sum(axis=1) / obj.shape[1]
    mean_rep = rep.sum(axis=1) / rep.shape[1]
    obj_bar = obj - mean_obj[:, None]
    rep_bar = rep - mean_rep[:, None]
    u_mat, _, vt = np.linalg.svd(obj_bar @ rep_bar.T)
    r_mat = vt.T @ u_mat.T
    t = mean_rep - r_mat @ mean_obj
    transform = np.eye(4)
    transform[:3, :3] = r_mat
    transform[:3, 3] = t
    return transform


def p3p_short(
    correspondences_given,
    image_points,
    object_points4,
    fx,
    fy,
    cx,
    cy,
    back_projection_pixel_tolerance,
    certainty_threshold=1.0,
    valid_correspondence_threshold=0.5,
    min_num_leds_detected=4,
):
    """pose_estimator.cpp:2506-2741 — short-P3P partial re-initialisation.

    correspondences_given: (3,2) 1-based [led, detection].  Returns
    (found, pose, correspondences or None, seeds, hist).  Faithful to the
    reference's quirks: the third-point loops iterate ONE SHORT of the
    available lists (`numOfRemainingImgPts = imgIdxAvl.size()-1`,
    :2560-2561), so the LAST available detection/marker is never tried as
    the third point; and the duplicate-solution skip uses the Eigen
    `(a-b).all() == 0` idiom (skips when ANY entry coincides, :2629)."""
    from itertools import combinations as it_combinations

    corr = np.asarray(correspondences_given, np.int64).reshape(3, 2)
    k_n = len(image_points)
    m_n = len(object_points4)
    if k_n < min_num_leds_detected:
        return False, np.eye(4), None, [], None  # flag 13

    image_vectors = calculate_image_vectors(image_points, fx, fy, cx, cy)
    hist = np.zeros((k_n, m_n), np.int64)

    for keep in it_combinations(range(3), 2):  # combinationsNoReplacement(.,2)
        kept_d = [corr[keep[0], 1] - 1, corr[keep[1], 1] - 1]
        kept_m = [corr[keep[0], 0] - 1, corr[keep[1], 0] - 1]
        img_avl = [i for i in range(k_n) if i not in kept_d]
        obj_avl = [i for i in range(m_n) if i not in kept_m]

        # reference iterates size-1 (:2560-2561) — last candidate skipped
        for i in range(len(img_avl) - 1):
            third_d = img_avl[i]
            fv = np.stack(
                [image_vectors[kept_d[0]], image_vectors[kept_d[1]],
                 image_vectors[third_d]], axis=-1)
            unused_im_idx = [
                kk for kk in range(k_n)
                if kk not in kept_d and kk != third_d
            ]
            unused_im = [image_points[kk] for kk in unused_im_idx]

            for j in range(len(obj_avl) - 1):
                third_m = obj_avl[j]
                wp = np.stack(
                    [object_points4[kept_m[0]][:3], object_points4[kept_m[1]][:3],
                     object_points4[third_m][:3]], axis=-1)
                unused_obj_idx = [
                    ll for ll in range(m_n)
                    if ll not in kept_m and ll != third_m
                ]
                unused_obj = [object_points4[ll] for ll in unused_obj_idx]

                sols, ok = p3p_compute_poses(fv, wp)
                if not ok:
                    continue
                for k in range(4):
                    if k > 0 and np.any(sols[k] == sols[k - 1]):
                        continue  # Eigen (a-b).all()==0 idiom (:2629)
                    h_o_c = np.eye(4)
                    h_o_c[:3, :] = sols[k]
                    if not np.all(np.isfinite(h_o_c)):
                        continue
                    t_c_o = np.linalg.inv(h_o_c)
                    back = [project2d(p, t_c_o, fx, fy, cx, cy) for p in unused_obj]
                    pairs, min_d = calculate_min_distances_and_pairs(unused_im, back)
                    if min_d.min() < back_projection_pixel_tolerance:
                        for mm in range(3):  # the given pairs vote (:2654-2659)
                            hist[corr[mm, 1] - 1, corr[mm, 0] - 1] += 1
                        for nn in range(len(min_d)):
                            if min_d[nn] < back_projection_pixel_tolerance:
                                im_idx = unused_im_idx[pairs[nn, 0] - 1]
                                obj_idx = unused_obj_idx[pairs[nn, 1] - 1]
                                hist[im_idx, obj_idx] += 1

    if not hist.any():
        return False, np.eye(4), None, [], hist  # flag 15

    candidates = correspondences_from_histogram(hist, b_initialisation=False)
    all_seeds = []
    first = None
    found = False
    pose = np.eye(4)
    for cand in candidates:
        valid, p, seeds = check_correspondences(
            cand, image_points, object_points4, fx, fy, cx, cy,
            back_projection_pixel_tolerance, certainty_threshold,
            valid_correspondence_threshold, min_num_corr=min_num_leds_detected,
        )
        all_seeds.extend(seeds)
        if valid and first is None:  # firstMatch (:2709-2714)
            first = cand
            pose = p
            found = True
            break  # engine stops the seed walk at the first validated too
    return found, pose, first, all_seeds, hist
