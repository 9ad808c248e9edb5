"""Experiment-config tier (io/experiment.py + CLI --config) — the
launch-file analogue (pf_mpe/launch/*.launch)."""

import glob
import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = sorted(glob.glob(os.path.join(REPO, "configs/experiments/*.yaml")))


def test_presets_exist():
    names = {os.path.basename(p) for p in EXPERIMENTS}
    assert {
        "uav_target.yaml",
        "outlier_robustness.yaml",
        "two_targets.yaml",
        "ipe_legacy.yaml",
    } <= names


@pytest.mark.parametrize("path", EXPERIMENTS, ids=os.path.basename)
def test_load_experiment_resolves_and_validates(path):
    from pf_monocular_pose_estimator_tpu.io.experiment import load_experiment
    from pf_monocular_pose_estimator_tpu.utils import TrackerConfig

    exp = load_experiment(path)
    assert os.path.isfile(exp["camera"]), exp["camera"]
    assert os.path.isfile(exp["markers"]), exp["markers"]
    # tracker overrides must construct a valid config
    TrackerConfig(**exp["tracker"])
    assert exp["run"].get("synthetic") or exp["run"].get("sequence")


def test_load_experiment_rejects_unknown_fields(tmp_path):
    from pf_monocular_pose_estimator_tpu.io.experiment import load_experiment

    bad = tmp_path / "bad.yaml"
    bad.write_text("tracker:\n  not_a_field: 3\n")
    with pytest.raises(ValueError, match="not_a_field"):
        load_experiment(str(bad))


@pytest.mark.parametrize("loader", ["load_experiment", "load_marker_positions"])
def test_yaml_input_without_pyyaml_fails_clearly(monkeypatch, loader):
    """PyYAML is optional: the loaders import it only when called, and a
    YAML input without it fails with an error that names the package."""
    import sys

    from pf_monocular_pose_estimator_tpu.io import experiment, markers

    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml -> ImportError
    load = getattr(experiment if loader == "load_experiment" else markers, loader)
    with pytest.raises(ImportError, match="PyYAML"):
        load(os.path.join(REPO, "configs/experiments/uav_target.yaml"))


def test_cli_runs_experiment_with_overrides(capsys, tmp_path):
    """CLI --config end-to-end: file supplies camera/markers/tracker,
    explicit flags override frames/particles (roslaunch-arg precedence);
    --save-video writes the annotated-frame npz (visualization path)."""
    from pf_monocular_pose_estimator_tpu.io.cli import main

    video = str(tmp_path / "video.npz")
    rc = main(
        [
            "--config",
            os.path.join(REPO, "configs/experiments/uav_target.yaml"),
            "--frames",
            "6",
            "--particles",
            "500",
            "--save-video",
            video,
            "--json",
        ]
    )
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 6  # CLI override beat the file's 60
    assert summary["tracked_frames"] >= 5
    assert summary["ate_m"] < 0.05
    import numpy as np

    frames = np.load(summary["video"])["frames"]
    assert frames.shape[0] == 6 and frames.ndim == 4  # (T, H, W, 3) overlays


def test_cli_record_and_replay_pfsq(capsys, tmp_path):
    """CLI --record writes the PFSQv1 container while running; --sequence
    on that container replays it with matching tracking (the rosbag
    record -> play loop)."""
    from pf_monocular_pose_estimator_tpu.io.cli import main

    seq_path = str(tmp_path / "run.pfsq")
    rc = main(
        ["--synthetic", "--frames", "5", "--particles", "500",
         "--record", seq_path, "--json"]
    )
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.path.getsize(seq_path) > 64  # header + frames

    rc = main(["--sequence", seq_path, "--particles", "500", "--json"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["frames"] == 5
    assert rep["tracked_frames"] >= rec["tracked_frames"] - 1
