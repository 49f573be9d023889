"""Headless map viewer (Pangolin GUI analog, io/viewer.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

from sos_slam_tpu.io.viewer import MapViewer
from sos_slam_tpu.models.full_system import FullSystem
from sos_slam_tpu.utils import synthetic
from sos_slam_tpu.utils.config import default_settings

# only the pure-host accumulate/render test is smoke; the real-pipeline
# test runs a 24-frame FullSystem with big jits



class _Shell:
    def __init__(self, i, T):
        self.id = i
        self.cam_to_world = T
        self.cam_to_world_scaled = None
        self.scale = 1.0


@pytest.mark.smoke
def test_viewer_accumulates_and_renders(tmp_path):
    v = MapViewer(out_dir=str(tmp_path), size=128)
    rng = np.random.default_rng(0)
    for i in range(5):
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, 0.0, 0.02 * i]
        v.publish_cam_pose(_Shell(i, T), None)
        rec = dict(shell=_Shell(i, T),
                   pts_uvdi=np.stack([rng.uniform(10, 300, 50),
                                      rng.uniform(10, 200, 50),
                                      rng.uniform(0.3, 2.0, 50)], -1),
                   calib=(300.0, 300.0, 160.0, 120.0), scale_error=0.5)
        v.publish_keyframes(rec, final=True)
        v.publish_keyframes(rec, final=False)   # non-final must be ignored
    assert len(v.keyframes) == 5
    assert len(v.trajectory) == 5

    v.publish_loop_edge(0, 4)
    img = v.render_array()
    assert img.shape == (128, 256, 3)
    assert (img != 16).any(), "nothing rendered"
    path = v.render()
    assert path is not None and (tmp_path / "ui_vars.txt").exists()

    # loop closure rewrites a displayed pose
    T_new = np.eye(4)
    T_new[:3, 3] = [9.0, 9.0, 9.0]
    v.modify_keyframe_pose_by_kf_id(2, T_new)
    np.testing.assert_allclose(v.keyframes[2].T_wc[:3, 3], [9, 9, 9])

    wp = v.keyframes[0].world_points()
    assert wp.shape == (50, 3) and np.isfinite(wp).all()


def test_viewer_on_real_pipeline(tmp_path):
    W, H = 256, 192
    calib = synthetic.default_calib(W, H)
    settings = default_settings(max_window_frames=8, max_points=512,
                                max_immature=1024, max_track_pts=4096,
                                desired_point_density=400.0,
                                desired_immature_density=400.0)
    fs = FullSystem(calib, settings)
    v = MapViewer(out_dir=str(tmp_path), size=96)
    fs.output_wrappers.append(v)
    imgs, _, _ = synthetic.make_sequence(
        calib, 24, jnp.array([0.05, 0.02, 0.03, 0.003, 0.006, 0.002]),
        plane_z=2.0)
    for i in range(24):
        fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)
        if fs.is_lost or fs.init_failed:
            break
    assert fs.initialized and not fs.is_lost
    # marginalized KFs produced final records -> clouds in the viewer
    assert len(v.keyframes) >= 1
    assert any(len(kf.pts_cam) > 0 for kf in v.keyframes.values())
    assert v.n_rendered >= 1
