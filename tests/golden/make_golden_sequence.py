"""Generate the recorded-sequence golden fixture (run once, committed).

The reference verifies by replaying recorded rosbags of a real LED-
carrying UAV (SURVEY.md §4; `pf_mpe/launch/UAV_Target.launch:63-64`
plays `UAVvsVicon011.bag`).  This script produces the equivalent
committed artifact for this engine: a pre-rendered 752x480 IR-LED
sequence with ground-truth poses and per-frame expected LED pixels —
rendered entirely OUTSIDE the engine (cv2.Rodrigues for the trajectory,
cv2.projectPoints for plumb-bob projection+distortion, numpy Gaussian
splatting), so no convention bug in `geometry/` or `io/synthetic.py`
can cancel out between rendering and detection (round-1 verdict,
"recorded-sequence benchmark" + "self-referential goldens").

Usage:  python tests/golden/make_golden_sequence.py
Output: tests/golden/golden_sequence.npz (uint8 frames, compressed)
"""

import os

import numpy as np

# mvBlueFOX calibration (reference README.md:137-143)
FX, FY, CX, CY = 621.75, 621.39, 404.95, 238.26
DIST = np.array([-0.36, 0.13, 0.0005, -0.0005, 0.0])
W, H = 752, 480

# demo 5-LED constellation (same cloud as io/synthetic.demo_markers —
# the values come from pf_mpe/marker_positions/demo_marker_positions.yaml)
MARKERS = np.array(
    [
        [0.0714, 0.0800, 0.0622],
        [0.0400, -0.0912, 0.0317],
        [-0.0647, -0.0879, 0.0830],
        [-0.0558, -0.0165, 0.0534],
        [0.0, 0.12, 0.0],
    ]
)

NUM_FRAMES = 60
FPS = 50.0
BLOB_SIGMA = 1.6
# Pre-clip peak well above 255 so the blob core saturates the 8-bit
# sensor (as real IR LEDs do) — otherwise an unlucky subpixel phase can
# put the brightest pixel under the 240 detection threshold and the
# blob vanishes.
PEAK = 1100.0


def trajectory(num_frames, fps):
    """Smooth orbit-and-spin (UAV-vs-Vicon geometry, ~1.5 m range).

    Built directly as (rvec, tvec) pairs — no SE(3) code from the
    engine.  Rotation magnitude stays under ~0.45 rad so the whole
    constellation remains camera-facing."""
    import cv2

    poses = []
    for i in range(num_frames):
        t = i / fps
        ang = 2 * np.pi * 0.14 * t + 0.9
        rvec = np.array(
            [
                0.28 * np.sin(0.8 * t + 0.3),
                0.28 * np.cos(0.7 * t),
                0.20 * np.sin(0.5 * t),
            ]
        )
        tvec = np.array(
            [
                0.22 * np.cos(ang),
                0.13 * np.sin(ang),
                1.5 + 0.12 * np.sin(0.6 * ang),
            ]
        )
        rot, _ = cv2.Rodrigues(rvec)
        pose = np.eye(4)
        pose[:3, :3] = rot
        pose[:3, 3] = tvec
        poses.append(pose)
    return np.stack(poses)


def render(pix):
    """Numpy Gaussian splats at distorted pixel positions -> uint8."""
    ys, xs = np.mgrid[0:H, 0:W]
    frame = np.zeros((H, W))
    for u, v in pix:
        x0, x1 = max(int(u) - 8, 0), min(int(u) + 9, W)
        y0, y1 = max(int(v) - 8, 0), min(int(v) + 9, H)
        dx = xs[y0:y1, x0:x1] - u
        dy = ys[y0:y1, x0:x1] - v
        frame[y0:y1, x0:x1] += PEAK * np.exp(
            -(dx * dx + dy * dy) / (2 * BLOB_SIGMA**2)
        )
    return np.clip(frame, 0, 255).round().astype(np.uint8)


def main():
    import cv2

    k_mat = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]])
    poses = trajectory(NUM_FRAMES, FPS)

    frames, led_pixels = [], []
    for pose in poses:
        rvec, _ = cv2.Rodrigues(pose[:3, :3])
        pix, _ = cv2.projectPoints(
            MARKERS.reshape(-1, 1, 3), rvec, pose[:3, 3], k_mat, DIST
        )
        pix = pix.reshape(-1, 2)
        cam_z = (pose[:3, :3] @ MARKERS.T + pose[:3, 3:4])[2]
        assert (cam_z > 0.5).all(), "marker behind/too close to camera"
        assert (pix > 12).all() and (pix[:, 0] < W - 12).all() and (
            pix[:, 1] < H - 12
        ).all(), "LED too close to the frame edge"
        frames.append(render(pix))
        led_pixels.append(pix)

    out = os.path.join(os.path.dirname(__file__), "golden_sequence.npz")
    np.savez_compressed(
        out,
        frames=np.stack(frames),
        poses=poses.astype(np.float32),
        times=(np.arange(NUM_FRAMES) / FPS).astype(np.float32),
        led_pixels=np.stack(led_pixels).astype(np.float32),
        markers=MARKERS.astype(np.float32),
        fx=FX, fy=FY, cx=CX, cy=CY, dist=DIST, width=W, height=H,
        opencv_version=np.str_(cv2.__version__),
    )
    print(f"wrote {out} ({os.path.getsize(out) / 1024:.0f} KiB)")


if __name__ == "__main__":
    main()
