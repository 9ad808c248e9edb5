"""Marker-YAML and camera-calibration loading.

Functional parity targets:
  * marker YAML schema + per-UAV splitting — pf_mpe/src/
    monocular_pose_estimator.cpp:81-127 and README.md:96-121,417-451
    (`marker_positions:` list of {x, y, z}; multi-UAV via
    `numberOfMarkersUAV1..4` splitting one flat list)
  * one-shot camera-info capture — monocular_pose_estimator.cpp:215-238
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..geometry.camera import Camera


def load_yaml(path: str):
    """Parse a YAML file.  PyYAML is an optional dependency (the
    synthetic main path needs none), imported only here."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs PyYAML (pip install pyyaml); the synthetic "
            "sequences and .npz/.pfsq inputs do not"
        ) from e
    with open(path) as f:
        return yaml.safe_load(f)


def load_marker_positions(path: str, markers_per_object: List[int] | None = None):
    """Load a reference-format marker YAML.

    Returns a list of (M_i, 4) float32 homogeneous marker arrays, one per
    tracked object.  With `markers_per_object=None` the whole list is one
    object (numUAV=1 behaviour).
    """
    data = load_yaml(path)
    pts = np.array(
        [[p["x"], p["y"], p["z"], 1.0] for p in data["marker_positions"]], dtype=np.float32
    )
    if markers_per_object is None:
        return [pts]
    out = []
    offset = 0
    for count in markers_per_object:
        out.append(pts[offset : offset + count])
        offset += count
    if offset != len(pts):
        raise ValueError(
            f"marker YAML has {len(pts)} points but markers_per_object sums to {offset}"
        )
    return out


def load_camera_calibration(path: str) -> Camera:
    """Load a camera YAML: {fx, fy, cx, cy, distortion: [k1,k2,p1,p2,k3],
    width, height} (the K/D pair of README.md:137-143)."""
    data = load_yaml(path)
    return Camera.create(
        fx=data["fx"],
        fy=data["fy"],
        cx=data["cx"],
        cy=data["cy"],
        dist=data.get("distortion", [0.0] * 5),
        width=data.get("width", 752),
        height=data.get("height", 480),
    )
