"""Golden-value parity vs the COMPILED C++ reference.

The harnesses in golden/ compile the ROS-free reference units
(thirdparty/Sophus, src/util/Undistort.cpp, the spline IMU init in
src/FullSystem/HessianBlocks.cpp, src/FullSystem/PixelSelector2.cpp) with
g++ and print reference-computed values; these tests assert the JAX
implementations reproduce them. This substitutes for the impossible
EuRoC-vs-reference run (no datasets/ROS in this environment) and directly
de-risks the 5%-ATE parity claim.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "golden"))

import build as golden_build  # noqa: E402

pytestmark = pytest.mark.skipif(
    not golden_build.available(),
    reason="g++ / reference / Eigen headers unavailable")

REF_TESTS = "/root/reference/tests"


# ---------------------------------------------------------------------------
# Sophus SE3/Sim3 vs utils/lie.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sophus_lines():
    return golden_build.run("sophus").splitlines()


def test_se3_exp_log_adj_match_sophus(sophus_lines):
    from sos_slam_tpu.utils import lie
    rows = [list(map(float, ln.split()[1:])) for ln in sophus_lines
            if ln.startswith("se3 ")]
    assert len(rows) == 32
    for vals in rows:
        xi = np.array(vals[:6])
        M_ref = np.array(vals[6:22]).reshape(4, 4)
        log_ref = np.array(vals[22:28])
        adj_ref = np.array(vals[28:64]).reshape(6, 6)
        M = lie.np_se3_exp(xi)
        np.testing.assert_allclose(M, M_ref, atol=1e-12)
        lg = lie.np_se3_log(M_ref)
        np.testing.assert_allclose(lg, log_ref, atol=1e-9)
        # se3_adj is a jnp op (f32 without the x64 flag): f32 tolerance
        A = np.asarray(lie.se3_adj(np.asarray(M_ref, np.float64)))
        np.testing.assert_allclose(A, adj_ref, atol=1e-5)


def test_sim3_exp_log_match_sophus(sophus_lines):
    import jax.numpy as jnp

    from sos_slam_tpu.utils import lie
    rows = [list(map(float, ln.split()[1:])) for ln in sophus_lines
            if ln.startswith("sim3 ")]
    assert len(rows) == 32
    for vals in rows:
        xi = np.array(vals[:7])
        M_ref = np.array(vals[7:23]).reshape(4, 4)
        log_ref = np.array(vals[23:30])
        M = np.asarray(lie.sim3_exp(jnp.asarray(xi, jnp.float32)))
        np.testing.assert_allclose(M, M_ref, rtol=2e-5, atol=2e-5)
        lg = np.asarray(lie.sim3_log(jnp.asarray(M_ref, jnp.float32)))
        np.testing.assert_allclose(lg, log_ref, rtol=3e-4, atol=3e-5)


# ---------------------------------------------------------------------------
# Undistort: output K + remap for every reference calibration bundle
# ---------------------------------------------------------------------------

CALIBS = [
    f"{REF_TESTS}/EuRoC/camera0.txt",     # RadTan, crop
    f"{REF_TESTS}/EuRoC/camera1.txt",
    f"{REF_TESTS}/TUMVI/camera0.txt",     # EquiDistant
    f"{REF_TESTS}/KITTI/0_2/camera0.txt", # Pinhole
    f"{REF_TESTS}/Malaga/camera0.txt",
    f"{REF_TESTS}/RobotCar/camera0.txt",
]
CALIBS = [c for c in CALIBS if os.path.exists(c)]


@pytest.mark.parametrize("calib", CALIBS, ids=[
    "-".join(c.split("/")[-2:]) for c in CALIBS])
def test_undistort_K_and_remap_match_reference(calib):
    from sos_slam_tpu.io.undistort import load_undistorter
    out = golden_build.run("undistort", calib)
    K_ref = size_ref = None
    samples = []
    for ln in out.splitlines():
        if ln.startswith("K "):
            K_ref = np.array(list(map(float, ln.split()[1:])))
        elif ln.startswith("size "):
            t = ln.split()
            size_ref = (int(t[1]), int(t[2]), int(t[4]), int(t[5]))
        elif ln.startswith("m "):
            samples.append(list(map(float, ln.split()[1:])))
    assert K_ref is not None and samples

    und = load_undistorter(calib)
    assert (und.w, und.h, und.w_org, und.h_org) == size_ref
    # the reference iterates makeOptimalK_crop in float32; ours runs float64
    np.testing.assert_allclose(
        [und.K[0, 0], und.K[1, 1], und.K[0, 2], und.K[1, 2]], K_ref,
        rtol=5e-3)
    s = np.array(samples)  # columns: out_x, out_y, in_x, in_y
    ours = np.stack([und.remap_x[s[:, 1].astype(int), s[:, 0].astype(int)],
                     und.remap_y[s[:, 1].astype(int), s[:, 0].astype(int)]],
                    -1)
    # sub-pixel agreement on the remap wherever K agrees exactly; the crop-K
    # float32/float64 difference shifts the map by |dK| * normalized coord,
    # bounded well under half a pixel for these calibrations
    err = np.abs(ours - s[:, 2:4])
    assert np.nanmax(err) < 0.5, np.nanmax(err)
    # and the median error is tiny (no systematic model mismatch)
    assert np.nanmedian(err) < 0.05


# ---------------------------------------------------------------------------
# Spline IMU initialization + evaluators vs models/imu.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spline_out():
    lines = golden_build.run("spline").splitlines()
    poses = {}
    imu = {i: [] for i in range(5)}
    frames = {}
    evals = []
    scale = ok = None
    for ln in lines:
        t = ln.split()
        if ln.startswith("pose "):
            poses[int(t[1])] = (float(t[2]),
                                np.array(list(map(float, t[3:19]))).reshape(4, 4))
        elif ln.startswith("imu "):
            imu[int(t[1])].append(list(map(float, t[2:9])))
        elif ln.startswith("frame "):
            vals = list(map(float, [x for x in t[2:] if x not in
                                    ("vel", "lrot", "bias", "q", "c")]))
            frames[int(t[1])] = dict(vel=vals[0:3], lrot=vals[3:6],
                                     bias=vals[6:12], q=vals[12:18],
                                     c=vals[18:24])
        elif ln.startswith("eval "):
            vals = list(map(float, [x for x in t[1:] if x not in
                                    ("acc", "gyro", "tw", "R")]))
            evals.append(dict(t=vals[0], acc=vals[1:4], gyro=vals[4:7],
                              tw=vals[7:10], R=np.array(vals[10:19]).reshape(3, 3)))
        elif ln.startswith("scale "):
            scale = float(t[1])
        elif ln.startswith("ok "):
            ok = int(t[1])
    return poses, imu, frames, evals, scale, ok


@pytest.fixture(scope="module")
def our_init(spline_out):
    import jax.numpy as jnp

    from sos_slam_tpu.models import imu as IM
    from sos_slam_tpu.ops import ba as B
    from sos_slam_tpu.utils.config import default_settings
    from tests.test_imu import _bare_ba

    poses, imu_samples, _, _, _, _ = spline_out
    settings = default_settings(weight_imu_dso=6.0)
    F = 8
    ts = np.array([poses[i][0] for i in range(5)])
    pose_mats = jnp.stack([jnp.asarray(poses[i][1], jnp.float32)
                           for i in range(5)])
    ba, _, _, _ = _bare_ba(pose_mats, 5)

    acc = np.zeros((F, IM.N_IMU, 3), np.float32)
    gyro = np.zeros((F, IM.N_IMU, 3), np.float32)
    ts_rel = np.zeros((F, IM.N_IMU), np.float32)
    valid = np.zeros((F, IM.N_IMU), bool)
    for i in range(5):
        for k, s in enumerate(imu_samples[i]):
            ts_rel[i, k] = s[0] - ts[i]
            acc[i, k] = s[1:4]
            gyro[i, k] = s[4:7]
            valid[i, k] = True
    imu = IM.empty_imu(F)._replace(
        timestamps=jnp.asarray(np.pad(ts, (0, F - 5)), jnp.float32),
        acc=jnp.asarray(acc), gyro=jnp.asarray(gyro),
        ts=jnp.asarray(ts_rel), imu_valid=jnp.asarray(valid))
    imu2, ok = IM.initialize_imu(ba, imu, settings)
    return IM, imu2, ok


def test_spline_init_matches_reference(spline_out, our_init):
    _, _, frames_ref, _, scale_ref, ok_ref = spline_out
    IM, imu2, ok = our_init
    assert bool(ok) == bool(ok_ref)
    s_scaled = np.asarray(imu2.state * np.asarray(IM.IMU_SCALE21))
    vel = np.asarray(imu2.vel)
    for i in range(5):
        ref = frames_ref[i]
        np.testing.assert_allclose(vel[i], ref["vel"], atol=2e-4)
        np.testing.assert_allclose(s_scaled[i, 6:9], ref["lrot"], atol=2e-4)
        np.testing.assert_allclose(s_scaled[i, 3:6], ref["bias"][3:6],
                                   atol=2e-4)   # gyro bias
        np.testing.assert_allclose(s_scaled[i, 0:3], ref["bias"][0:3],
                                   atol=1e-6)   # acc bias = 0
        np.testing.assert_allclose(
            s_scaled[i, 9:15], np.asarray(ref["q"])[[0, 1, 2, 3, 4, 5]],
            atol=2e-4)
        np.testing.assert_allclose(s_scaled[i, 15:21], ref["c"], atol=2e-4)
    scale = float(imu2.scale) * IM.SCALE_SCALE
    assert abs(scale - scale_ref) < 1e-3, (scale, scale_ref)


def test_spline_evaluators_match_reference(spline_out, our_init):
    import jax.numpy as jnp

    from sos_slam_tpu.models import imu as IM_mod
    _, _, _, evals, _, _ = spline_out
    IM, imu2, _ = our_init
    base = imu2.state[4]
    vel4 = imu2.vel[4]
    for ev in evals:
        t = jnp.float32(ev["t"])
        np.testing.assert_allclose(
            np.asarray(IM_mod.spline_acc(base, t)), ev["acc"], atol=3e-4)
        np.testing.assert_allclose(
            np.asarray(IM_mod.spline_gyro(base, t)), ev["gyro"], atol=3e-4)
        np.testing.assert_allclose(
            np.asarray(IM_mod.spline_t_c2t(base, vel4, t)), ev["tw"],
            atol=3e-4)
        np.testing.assert_allclose(
            np.asarray(IM_mod.spline_rot_c_t(base, t)), ev["R"], atol=3e-4)


# ---------------------------------------------------------------------------
# Pixel-selector histogram thresholds + gradient pyramid vs ops/selector.py
# ---------------------------------------------------------------------------

def _harness_image(W=256, H=192):
    """The integer-derived test image of harness_selector.cpp — bitwise
    reproducible in numpy float32."""
    x = np.arange(W)[None, :]
    y = np.arange(H)[:, None]
    ramp = (x * 7 + y * 13) % 97
    noise = ((x * 73856093).astype(np.uint32)
             ^ (y * 19349663).astype(np.uint32)) % np.uint32(29)
    return (np.float32(0.5) * ramp.astype(np.float32)
            + noise.astype(np.float32))


@pytest.fixture(scope="module")
def selector_out():
    lines = golden_build.run("selector").splitlines()
    asg_sum = None
    asg = []
    ths = {}
    for ln in lines:
        t = ln.split()
        if ln.startswith("asg_sum "):
            asg_sum = float(t[1])
        elif ln.startswith("asg "):
            asg.append((int(t[1]), int(t[2]), float(t[3])))
        elif ln.startswith("ths "):
            ths[(int(t[1]), int(t[2]))] = (float(t[3]), float(t[4]))
    return asg_sum, asg, ths


def test_gradient_pyramid_matches_reference(selector_out):
    import jax.numpy as jnp

    from sos_slam_tpu.ops.image import build_pyramid
    asg_sum, asg, _ = selector_out
    img = _harness_image()
    _, absgrads = build_pyramid(jnp.asarray(img), 3)
    a0 = np.asarray(absgrads[0])
    for x, y, v in asg:
        assert abs(a0[y, x] - v) <= 1e-3 * max(1.0, abs(v)), (x, y, a0[y, x], v)
    ours_sum = float(a0[1:-1, 1:-1].sum())
    assert abs(ours_sum - asg_sum) / asg_sum < 1e-5


def test_selector_thresholds_match_reference(selector_out):
    import jax.numpy as jnp

    from sos_slam_tpu.ops.image import build_pyramid
    from sos_slam_tpu.ops.selector import block_thresholds
    from sos_slam_tpu.utils.config import default_settings
    _, _, ths_ref = selector_out
    s = default_settings()
    img = _harness_image()
    _, absgrads = build_pyramid(jnp.asarray(img), 3)
    sm = np.asarray(block_thresholds(absgrads[0], s.min_grad_hist_cut,
                                     s.min_grad_hist_add))
    w32, h32 = 256 // 32, 192 // 32
    ref = np.array([[ths_ref[(x, y)][1] for x in range(w32)]
                    for y in range(h32)])
    np.testing.assert_allclose(sm, ref, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# Epipolar trace (ImmaturePoint::traceOn) vs ops/trace.py
# ---------------------------------------------------------------------------

def _smooth_tex(W, H, shift=0):
    """The smooth value-noise texture of harness_trace/harness_residual —
    every op exact in float32, bitwise reproducible."""
    x = np.arange(W)[None, :] + shift
    y = np.arange(H)[:, None] + 0 * x
    x0, y0 = x >> 3, y >> 3
    fx = ((x & 7) * np.float32(0.125)).astype(np.float32)
    fy = ((y & 7) * np.float32(0.125)).astype(np.float32)

    def lat(a, b):
        return (((a * 73856093).astype(np.uint32)
                 ^ (b * 19349663).astype(np.uint32)) % np.uint32(61)
                ).astype(np.float32)

    v00, v10 = lat(x0, y0), lat(x0 + 1, y0)
    v01, v11 = lat(x0, y0 + 1), lat(x0 + 1, y0 + 1)
    a = v00 + (v10 - v00) * fx
    b = v01 + (v11 - v01) * fx
    ramp = ((x * 7 + y * 13) % 97).astype(np.float32)
    return (np.float32(0.5) * ramp + (a + (b - a) * fy)
            + np.float32(30.0)).astype(np.float32)


# C++ ImmaturePointStatus (ImmaturePoint.h:39-46) -> ops/trace.py codes
def _trace_status_map():
    from sos_slam_tpu.ops import trace as T
    return {0: T.IPS_GOOD, 1: T.IPS_OOB, 2: T.IPS_OUTLIER, 3: T.IPS_SKIPPED,
            4: T.IPS_BADCONDITION, 5: T.IPS_UNINITIALIZED}


@pytest.fixture(scope="module")
def trace_out():
    lines = golden_build.run("trace").splitlines()
    inits, rounds = [], {0: [], 1: [], 2: []}
    for ln in lines:
        t = ln.split()
        if ln.startswith("init "):
            inits.append(list(map(float, t[1:])))
        elif ln.startswith("trace "):
            rounds[int(t[1])].append(list(map(float, t[2:])))
    return inits, rounds


def test_trace_matches_reference(trace_out):
    import jax.numpy as jnp

    from sos_slam_tpu.ops import trace as T
    from sos_slam_tpu.ops.image import build_pyramid
    from sos_slam_tpu.utils.config import default_settings

    inits, rounds = trace_out
    W, H = 256, 192
    FX = 200.0
    ID_TRUE = 0.5
    s = default_settings()

    lv, _ = build_pyramid(jnp.asarray(_smooth_tex(W, H)), 1)
    dI_host = lv[0]

    u = jnp.asarray([r[0] for r in inits], jnp.float32)
    v = jnp.asarray([r[1] for r in inits], jnp.float32)
    N = u.shape[0]
    imm = T.init_immature(u, v, jnp.zeros(N, jnp.int32),
                          jnp.ones(N, jnp.int32), dI_host, s, N)

    # constructor parity: energyTH, gradH, pattern weights
    ref = np.array(inits)
    np.testing.assert_allclose(np.asarray(imm.energy_th), ref[:, 2], rtol=1e-5)
    gH = np.asarray(imm.gradH)
    np.testing.assert_allclose(gH[:, 0, 0], ref[:, 3], rtol=1e-3)
    np.testing.assert_allclose(gH[:, 0, 1], ref[:, 4], rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(gH[:, 1, 1], ref[:, 5], rtol=1e-3)
    wgt = np.asarray(imm.weights)
    np.testing.assert_allclose(wgt[:, 0], ref[:, 6], rtol=1e-4)
    np.testing.assert_allclose(wgt[:, 7], ref[:, 7], rtol=1e-4)

    smap = _trace_status_map()
    for r, D in enumerate([6, 4, 9]):
        lt, _ = build_pyramid(jnp.asarray(_smooth_tex(W, H, shift=D)), 1)
        tx = -float(D) / (FX * ID_TRUE)
        KRKi = jnp.eye(3)[None]
        Kt = jnp.asarray([[FX * tx, 0.0, 0.0]], jnp.float32)
        aff = jnp.asarray([[1.0, 0.0]], jnp.float32)
        imm = T.trace_points(imm, lt[0], KRKi, Kt, aff, W, H, s)

        rows = sorted(rounds[r], key=lambda x: x[0])
        ref_status = np.array([smap[int(x[1])] for x in rows])
        ref_min = np.array([x[2] for x in rows])
        ref_max = np.array([x[3] for x in rows])
        st = np.asarray(imm.status)
        agree = (st == ref_status)
        # the discrete sweep runs in bf16 (documented ~0.4% energy rounding):
        # borderline statuses may flip, but the bulk must match exactly
        assert agree.mean() > 0.95, (
            r, agree.mean(),
            [(i, int(st[i]), int(ref_status[i]))
             for i in np.where(~agree)[0][:8]])
        both_good = agree & (ref_status == T.IPS_GOOD)
        assert both_good.sum() > 50 or (ref_status == T.IPS_GOOD).sum() < 20
        if both_good.sum() == 0:
            continue
        dmin = np.abs(np.asarray(imm.idepth_min) - ref_min)[both_good]
        dmax = np.abs(np.asarray(imm.idepth_max) - ref_max)[both_good]
        # sub-5e-3 idepth agreement for virtually all points; a couple of
        # wide-interval (errorInPixel-clamped) points may land one bf16
        # sweep step away — bounded by the interval scale, not unbounded
        ok = (dmin < 5e-3) & (dmax < 5e-3)
        assert ok.mean() > 0.97, (r, ok.mean())
        assert np.median(dmin) < 5e-4 and np.median(dmax) < 5e-4
        assert dmin.max() < 0.1 and dmax.max() < 0.1


# ---------------------------------------------------------------------------
# BA core: PointFrameResidual::linearize + stitched top/Schur Hessians +
# vision solve (EnergyFunctional) vs ops/ba.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def residual_out():
    lines = golden_build.run("residual").splitlines()
    out = dict(frames={}, pts=[], lins=[], HA={}, bA={}, HSC={}, bSC={},
               x={}, pstep={}, dim=None)
    for ln in lines:
        t = ln.split()
        if ln.startswith("frame "):
            out["frames"][int(t[1])] = list(map(float, t[2:]))
        elif ln.startswith("pt "):
            out["pts"].append((int(t[1]), int(t[2]), int(t[3]),
                               *map(float, t[4:])))
        elif ln.startswith("lin "):
            out["lins"].append((int(t[1]), int(t[2]), int(t[3]),
                                *map(float, t[4:])))
        elif ln.startswith("dim "):
            out["dim"] = int(t[1])
        elif t and t[0] in ("HA", "HSC"):
            out[t[0]][(int(t[1]), int(t[2]))] = float(t[3])
        elif t and t[0] in ("bA", "bSC", "x", "pstep"):
            out[t[0]][int(t[1])] = float(t[2])
    return out


@pytest.fixture(scope="module")
def residual_setup(residual_out):
    """Build the identical window as a BAState + run our linearize."""
    import jax.numpy as jnp

    from sos_slam_tpu.ops import ba as B
    from sos_slam_tpu.ops import trace as T
    from sos_slam_tpu.ops.image import build_pyramid
    from sos_slam_tpu.utils.config import default_settings

    W, H = 256, 192
    DS, EXPO = [0, 4, 7], [1.0, 1.1, 0.9]
    F, P = 3, 64
    s = default_settings()
    ref = residual_out

    dI = jnp.stack([
        build_pyramid(jnp.asarray(
            _smooth_tex(W, H, shift=DS[i]) * np.float32(EXPO[i])), 1)[0][0]
        for i in range(F)
    ])  # (F,H,W,3)

    T_eval = np.zeros((F, 4, 4), np.float32)
    state = np.zeros((F, 8), np.float32)
    energy_th = np.zeros(F, np.float32)
    for i in range(F):
        vals = ref["frames"][i]
        energy_th[i] = vals[1]
        T_eval[i] = np.array(vals[2:18]).reshape(4, 4)
        state[i] = vals[18:26]

    # points exactly as the harness lays them out
    pts = ref["pts"]
    n_pts = len(pts)
    u = np.zeros(P, np.float32)
    v = np.zeros(P, np.float32)
    host = np.zeros(P, np.int32)
    idepth = np.zeros(P, np.float32)
    idepth_zero = np.zeros(P, np.float32)
    for k, (hi, uu, vv, idp, idp0, _eth) in enumerate(pts):
        u[k], v[k], host[k] = uu, vv, hi
        idepth[k], idepth_zero[k] = idp, idp0
    pt_valid = np.arange(P) < n_pts

    # colors/weights from the (host) images — the ImmaturePoint ctor path
    imm = T.init_immature(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(host),
        jnp.asarray(pt_valid, jnp.int32), dI[0], s, P)
    # re-sample per-point from the right host frame
    from sos_slam_tpu.utils.config import PATTERN_OFFSETS
    from sos_slam_tpu.ops.image import interp_bilinear_blin, interp_bilinear
    pat = jnp.asarray(PATTERN_OFFSETS)
    up = jnp.asarray(u)[:, None] + pat[None, :, 0]
    vp = jnp.asarray(v)[:, None] + pat[None, :, 1]
    ptc = jnp.stack([interp_bilinear_blin(dI[i][..., 0], up, vp)
                     for i in range(F)])          # (F,P,8,3)
    hostj = jnp.asarray(host)
    ptc_h = ptc[hostj, jnp.arange(P)]             # (P,8,3)
    color = ptc_h[..., 0]
    g2 = jnp.sum(ptc_h[..., 1:] ** 2, -1)
    weights = jnp.sqrt(s.outlier_th_sum_component
                       / (s.outlier_th_sum_component + g2))

    prior = np.zeros((F, 8), np.float32)
    prior[0, 0:3] = s.initial_trans_prior
    prior[0, 3:6] = s.initial_rot_prior
    prior[0, 6] = s.initial_aff_a_prior
    prior[0, 7] = s.initial_aff_b_prior
    prior[1:, 6] = s.affine_opt_mode_a
    prior[1:, 7] = s.affine_opt_mode_b

    res_exist = pt_valid[:, None] & (host[:, None] != np.arange(F)[None, :])

    D = 4 + 8 * F
    c = jnp.asarray([200.0, 200.0, 128.0, 96.0]) / B.CALIB_SCALE
    ba = B.BAState(
        frame_valid=jnp.ones(F, bool),
        T_cw_eval=jnp.asarray(T_eval),
        state=jnp.asarray(state),
        state_zero=jnp.zeros((F, 8), jnp.float32),
        exposure=jnp.asarray(EXPO, jnp.float32),
        energy_th=jnp.asarray(energy_th),
        prior=jnp.asarray(prior),
        c=c, c_zero=c,
        pt_valid=jnp.asarray(pt_valid),
        host=jnp.asarray(host),
        u=jnp.asarray(u), v=jnp.asarray(v),
        color=color, weight=weights,
        idepth=jnp.asarray(idepth), idepth_zero=jnp.asarray(idepth_zero),
        pt_prior=jnp.zeros(P),
        res_exist=jnp.asarray(res_exist),
        res_state=jnp.zeros((P, F), jnp.int8),
        HM=jnp.zeros((D, D)), bM=jnp.zeros(D),
    )
    pre = B.make_precalc(ba)
    lin = B.linearize(ba, pre, dI, s, W, H)
    return B, ba, pre, lin, dI, s


def test_linearize_matches_reference(residual_out, residual_setup):
    B, ba, pre, lin, dI, s = residual_setup
    ref = residual_out
    new_state = np.asarray(lin.new_state)
    e_raw = np.asarray(lin.energy_raw)
    resF = np.asarray(lin.resF)
    X = np.asarray(lin.X)
    Jpdd = np.asarray(lin.Jpdd)
    JIdx = np.asarray(lin.JIdx)
    JabF = np.asarray(lin.JabF)
    JIdx2 = np.asarray(lin.JIdx2)
    JabJIdx = np.asarray(lin.JabJIdx)

    # residual index -> (point index, target) mapping of the harness:
    # points in order, targets ti != hi ascending
    n_in = n_out = 0
    for row in ref["lins"]:
        k, hi, ti = row[0], row[1], row[2]
        p = k // 2
        e_ref, ewo_ref, st_ref = row[3], row[4], int(row[5])
        vals = row[6:]
        assert int(new_state[p, ti]) == st_ref, (k, p, ti)
        if st_ref != 0:
            n_out += 1
            continue
        n_in += 1
        np.testing.assert_allclose(e_raw[p, ti], ewo_ref, rtol=2e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(resF[p, ti], vals[0:8], rtol=2e-3,
                                   atol=5e-3)
        # Jpdxi (real units), rows x/y
        np.testing.assert_allclose(X[p, ti, 0, 4:], vals[8:14], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(X[p, ti, 1, 4:], vals[14:20], rtol=1e-4,
                                   atol=1e-4)
        # Jpdc (internal units)
        np.testing.assert_allclose(X[p, ti, 0, :4], vals[20:24], rtol=1e-3,
                                   atol=2e-3)
        np.testing.assert_allclose(X[p, ti, 1, :4], vals[24:28], rtol=1e-3,
                                   atol=2e-3)
        np.testing.assert_allclose(Jpdd[p, ti], vals[28:30], rtol=2e-4,
                                   atol=2e-2)
        np.testing.assert_allclose(JIdx[p, ti, 0], vals[30:38], rtol=2e-3,
                                   atol=5e-3)
        np.testing.assert_allclose(JIdx[p, ti, 1], vals[38:46], rtol=2e-3,
                                   atol=5e-3)
        np.testing.assert_allclose(JabF[p, ti, 0], vals[46:54], rtol=2e-3,
                                   atol=5e-3)
        np.testing.assert_allclose(JabF[p, ti, 1], vals[54:62], rtol=2e-3,
                                   atol=5e-3)
        np.testing.assert_allclose(
            JIdx2[p, ti].reshape(-1)[[0, 1, 1, 3]], vals[62:66], rtol=5e-3,
            atol=2e-2)
        np.testing.assert_allclose(
            JabJIdx[p, ti].reshape(-1), vals[66:70], rtol=5e-3, atol=2e-2)
    assert n_in >= 80 and n_out >= 5, (n_in, n_out)


def test_stitched_hessians_match_reference(residual_out, residual_setup):
    from sos_slam_tpu.utils.config import default_settings
    B, ba, pre, lin, dI, s = residual_setup
    ref = residual_out
    D = ref["dim"]
    HA_ref = np.zeros((D, D))
    bA_ref = np.zeros(D)
    HSC_ref = np.zeros((D, D))
    bSC_ref = np.zeros(D)
    for (i, j), val in ref["HA"].items():
        HA_ref[i, j] = val
    for (i, j), val in ref["HSC"].items():
        HSC_ref[i, j] = val
    for i, val in ref["bA"].items():
        bA_ref[i] = val
    for i, val in ref["bSC"].items():
        bSC_ref[i] = val

    H_top, b_top = B.accumulate_top(ba, pre, lin)
    H_top, b_top = B.add_priors(ba, H_top, b_top, s)
    scale = np.abs(HA_ref) + np.abs(HA_ref).max() * 1e-7
    rel = np.abs(np.asarray(H_top) - HA_ref) / scale
    assert rel.max() < 5e-3, rel.max()
    np.testing.assert_allclose(
        np.asarray(b_top), bA_ref,
        rtol=2e-3, atol=np.abs(bA_ref).max() * 2e-4)

    sc = B.accumulate_schur(ba, pre, lin)
    H_sc, b_sc = B.schur_Hb(sc)
    scale = np.abs(HSC_ref) + np.abs(HSC_ref).max() * 1e-7
    rel = np.abs(np.asarray(H_sc) - HSC_ref) / scale
    assert rel.max() < 5e-3, rel.max()
    np.testing.assert_allclose(
        np.asarray(b_sc), bSC_ref,
        rtol=2e-3, atol=np.abs(bSC_ref).max() * 2e-4)


def test_solve_and_resubstitution_match_reference(residual_out,
                                                  residual_setup):
    import jax.numpy as jnp

    B, ba, pre, lin, dI, s = residual_setup
    ref = residual_out
    D = ref["dim"]
    x_ref = np.array([ref["x"][i] for i in range(D)])
    pstep_ref = np.array([ref["pstep"][i] for i in range(len(ref["pstep"]))])

    H_top, b_top = B.accumulate_top(ba, pre, lin)
    H_top, b_top = B.add_priors(ba, H_top, b_top, s)
    sc = B.accumulate_schur(ba, pre, lin)
    H_sc, b_sc = B.schur_Hb(sc)
    x = np.asarray(B.solve_system(ba, H_top, b_top, H_sc, b_sc, lam=1e-5))
    xs = np.abs(x_ref).max()
    np.testing.assert_allclose(x[:D], x_ref, atol=xs * 5e-3)

    step = np.asarray(B.resubstitute(sc, jnp.asarray(x)))
    n = len(pstep_ref)
    ss = np.abs(pstep_ref).max()
    np.testing.assert_allclose(step[:n], pstep_ref, atol=ss * 5e-3)


# ---------------------------------------------------------------------------
# ScanContext: scan assembly + PCA + signature/ringkey + searches
# vs loop/scancontext.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scancontext_out():
    lines = golden_build.run("scancontext").splitlines()
    out = dict(poses={}, scans={}, tfm={}, ringkey={}, sig={}, cand={},
               match={}, usable={})
    for ln in lines:
        t = ln.split()
        if ln.startswith("pose "):
            out["poses"][int(t[1])] = np.array(
                list(map(float, t[2:]))).reshape(4, 4)
        elif ln.startswith("sp "):
            out["scans"].setdefault(int(t[1]), []).append(
                list(map(float, t[2:])))
        elif ln.startswith("tfm "):
            out["tfm"][int(t[1])] = list(map(float, t[2:]))
        elif ln.startswith("ringkey "):
            out["ringkey"][int(t[1])] = np.array(list(map(float, t[2:])))
        elif ln.startswith("sig "):
            out["sig"].setdefault(int(t[1]), {})[int(t[2])] = float(t[3])
        elif ln.startswith("cand "):
            out["cand"][int(t[1])] = list(map(int, t[2:]))
        elif ln.startswith("match "):
            out["match"][int(t[1])] = (int(t[2]), float(t[3]))
        elif ln.startswith("usable "):
            out["usable"][int(t[1])] = int(t[2])
    return out


def _sc_cloud(k):
    """harness_scancontext.cpp make_cloud in numpy (uint32-exact)."""
    i = np.arange(300, dtype=np.uint64)
    h = ((i * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)) \
        ^ np.uint64((k * 40503) & 0xFFFFFFFF)
    a = (h % np.uint64(997)).astype(np.float64) / 997.0
    b = ((h // np.uint64(997)) % np.uint64(991)).astype(np.float64) / 991.0
    c = ((h // np.uint64(7)) % np.uint64(983)).astype(np.float64) / 983.0
    z = 2.0 + 28.0 * a
    x = (b - 0.5) * 24.0
    y = np.where(i % 3 == 0, 1.5 - 0.02 * z, 0.5 - 2.5 * c)
    # unique heights (tie-free voxel keep-highest; see the harness)
    y = y + 1e-7 * ((i.astype(np.int64) + 300 * k) % 9973).astype(np.float64)
    return np.stack([x, y, z], -1)


def test_scancontext_matches_reference(scancontext_out):
    from sos_slam_tpu.loop import scancontext as SC

    ref = scancontext_out
    NKF = len(ref["poses"])
    assert NKF == 132
    accum = SC.ScanAccumulator(lidar_range=40.0, enable_imu=False)
    index = SC.RingkeyIndex(margin=100)
    sigs = []
    n_cand_frames = n_scan_checked = 0
    for k in range(NKF):
        T_wc = ref["poses"][k]
        pts_sc, T_sc_rig = accum.process(k, T_wc, _sc_cloud(k))

        # scan-point SET parity (the reference's order is unordered_map
        # iteration order); compare sorted rows
        ref_scan = np.array(ref["scans"][k])
        assert len(pts_sc) == len(ref_scan), (k, len(pts_sc), len(ref_scan))
        a = np.asarray(pts_sc)[np.lexsort(np.asarray(pts_sc).T)]
        b = ref_scan[np.lexsort(ref_scan.T)]
        np.testing.assert_allclose(a, b, atol=1e-5)
        n_scan_checked += 1

        # alignment transform parity (compare as rotation matrix + t)
        qw, qx, qy, qz, tx, ty, tz = ref["tfm"][k]
        q = np.array([qw, qx, qy, qz])
        R_ref = np.array([
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
             2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
             2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
             1 - 2 * (qx * qx + qy * qy)]])
        np.testing.assert_allclose(T_sc_rig[:3, :3], R_ref, atol=1e-6)
        # the reference's PCA center is read-before-write (`Vec3 center`,
        # ScanContext.cpp:58-61 — indeterminate but deterministic in this
        # binary); it shifts the translation by |garbage|/n. Bound it.
        np.testing.assert_allclose(T_sc_rig[:3, 3], [tx, ty, tz], atol=2e-2)

        # descriptor parity on IDENTICAL inputs: consume the reference's own
        # alignment transform so its center offset cannot leak into the
        # signature comparison
        T_ref = np.eye(4)
        T_ref[:3, :3] = R_ref
        T_ref[:3, 3] = [tx, ty, tz]
        sig, ringkey, usable = SC.generate(np.asarray(pts_sc), T_ref, 40.0)
        sigs.append(sig)
        assert usable == bool(ref["usable"][k]), k
        np.testing.assert_allclose(ringkey, ref["ringkey"][k], atol=1e-6)
        # sparse signature parity: same filled cells, same normalized values
        ref_sig = np.zeros((SC.NUM_S, SC.NUM_R))
        for flat, val in ref["sig"].get(k, {}).items():
            ref_sig[flat // SC.NUM_R, flat % SC.NUM_R] = val
        np.testing.assert_allclose(sig, ref_sig, atol=1e-5)

        cands = index.search_and_insert(ringkey)
        assert sorted(cands) == sorted(ref["cand"].get(k, [])), (
            k, cands, ref["cand"].get(k))
        if cands:
            n_cand_frames += 1
            mi, diff = SC.search_sc(sig, cands, sigs)
            mi_ref, diff_ref = ref["match"][k]
            assert mi == mi_ref, (k, mi, mi_ref)
            assert abs(diff - diff_ref) < 1e-5, (k, diff, diff_ref)
    assert n_cand_frames >= 10 and n_scan_checked == NKF


# ---------------------------------------------------------------------------
# CoarseTracker (makeCoarseDepthL0 template + trackNewestCoarse) and
# ScaleOptimizer::optimizeScale vs ops/tracker.py / ops/scale_opt.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tracker_out(residual_out):
    """The tracker/scale golden values ride the residual harness binary."""
    lines = golden_build.run("residual").splitlines()
    out = dict(pc={}, pcn={}, track={}, scale=None)
    for ln in lines:
        t = ln.split()
        if ln.startswith("pcn "):
            out["pcn"][int(t[1])] = int(t[2])
        elif ln.startswith("pc "):
            out["pc"].setdefault(int(t[1]), []).append(
                list(map(float, t[2:])))
        elif ln.startswith("track_init"):
            out["track"]["init"] = np.array(
                list(map(float, t[1:]))).reshape(4, 4)
        elif ln.startswith("track_ok"):
            out["track"]["ok"] = int(t[1])
        elif ln.startswith("track_T"):
            out["track"]["T"] = np.array(
                list(map(float, t[1:]))).reshape(4, 4)
        elif ln.startswith("track_aff"):
            out["track"]["aff"] = [float(t[1]), float(t[2])]
        elif ln.startswith("track_res"):
            out["track"]["res"] = [float(x) for x in t[1:]]
        elif ln.startswith("track_flow"):
            out["track"]["flow"] = [float(x) for x in t[1:]]
        elif ln.startswith("sres "):
            out.setdefault("sres", []).append(
                list(map(float, t[1:])))
        elif ln.startswith("scale_opt"):
            out["scale"] = (float(t[1]), float(t[2]))
    return out


@pytest.fixture(scope="module")
def template_setup(residual_setup, tracker_out):
    """Rebuild the reference's tracking template from the same window.

    The reference template projects at the FEJ point (centerProjectedTo
    from linearize: idepth_zero + PRE_RTll_0); our production builder runs
    after optimize() where FEJ == current for the newest frame, so for the
    harness window we feed it a BAState whose current state IS the FEJ."""
    import jax.numpy as jnp

    from sos_slam_tpu.models.window import build_track_template

    B, ba, pre, lin, dI, s = residual_setup
    sc = B.accumulate_schur(ba, pre, lin)
    ba_fej = ba._replace(state=jnp.zeros_like(ba.state),
                         idepth=ba.idepth_zero)
    # keep only the residuals the harness wired into lastResiduals[0]
    # (toward frame 2, state IN)
    newest = 2
    in_to_newest = np.asarray(lin.new_state)[:, newest] == 0
    res_exist = np.asarray(ba.res_exist).copy()
    res_exist[:, newest] &= in_to_newest
    ba_fej = ba_fej._replace(res_exist=jnp.asarray(res_exist))

    pyr_ref = tuple(
        _level_pyramid(dI, i) for i in range(3))
    return B, ba_fej, sc, pyr_ref, s


def _level_pyramid(dI, lvl):
    """Rebuild frame-2 pyramid levels (the reference's dIp) for the
    template/track calls."""
    import jax.numpy as jnp

    from sos_slam_tpu.ops.image import build_pyramid
    img2 = dI[2][..., 0]
    lv, _ = build_pyramid(img2, 3)
    return lv[lvl]


def test_track_template_matches_reference(template_setup, tracker_out):
    import jax.numpy as jnp

    from sos_slam_tpu.models.window import build_track_template

    B, ba_fej, sc, pyr_ref, s = template_setup
    W, H = 256, 192
    templates, pc_mask = build_track_template(
        ba_fej, sc.HdiF, pyr_ref, 3, (512, 256, 256), W, H)

    for lvl in range(3):
        ref_rows = np.array(tracker_out["pc"][lvl])
        n_ref = tracker_out["pcn"][lvl]
        t = templates[lvl]
        valid = np.asarray(t.valid)
        n_mine = int(valid.sum())
        assert n_mine == n_ref, (lvl, n_mine, n_ref)
        mine = {(int(u), int(v)): (idp, c) for u, v, idp, c in zip(
            np.asarray(t.u)[valid], np.asarray(t.v)[valid],
            np.asarray(t.idepth)[valid], np.asarray(t.color)[valid])}
        ref = {(int(r[0]), int(r[1])): (r[2], r[3]) for r in ref_rows}
        # the reference's dilate indexes the FLAT map, wrapping across row
        # edges (CoarseTracker.cpp:119-190); our roll-based dilate wraps
        # toroidally — a couple of border-adjacent fill cells may differ
        common = set(mine) & set(ref)
        assert len(common) >= 0.98 * n_ref, (lvl, len(common), n_ref)
        mi = np.array([mine[k] for k in sorted(common)])
        rf = np.array([ref[k] for k in sorted(common)])
        np.testing.assert_allclose(mi[:, 0], rf[:, 0], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(mi[:, 1], rf[:, 1], rtol=1e-4, atol=1e-3)


def test_coarse_tracker_matches_reference(template_setup, tracker_out,
                                          residual_setup):
    import jax.numpy as jnp

    from sos_slam_tpu.models.window import build_track_template
    from sos_slam_tpu.ops import tracker as TK
    from sos_slam_tpu.ops.image import build_pyramid

    B, ba_fej, sc, pyr_ref, s = template_setup
    W, H = 256, 192
    FX = 200.0
    templates, _ = build_track_template(
        ba_fej, sc.HdiF, pyr_ref, 3, (512, 256, 256), W, H)

    # the 4th frame exactly as the harness builds it
    img3 = _smooth_tex(W, H, shift=9) * np.float32(1.05)
    pyr3, _ = build_pyramid(jnp.asarray(img3), 3)

    T_init = tracker_out["track"]["init"]
    # frame-2 state: from the residual harness (current scaled affine)
    _, ba, _, _, _, _ = residual_setup
    aff2 = np.asarray(B.aff_real(ba.state))[2]
    exposures = jnp.asarray([0.9, 1.05], jnp.float32)

    from sos_slam_tpu.utils import camera
    calib = camera.make_calib_pyramid(W, H, 200.0, 200.0, 128.0, 96.0)
    intr = tuple((calib.fx[l], calib.fy[l], calib.cx[l], calib.cy[l])
                 for l in range(3))

    out = TK.track_newest_coarse(
        tuple(pyr3), templates, jnp.asarray(T_init, jnp.float32),
        jnp.zeros(2, jnp.float32), jnp.asarray(aff2, jnp.float32),
        exposures, jnp.full((6,), jnp.nan), intr, 3,
        coarse_cutoff_th=s.coarse_cutoff_th, huber=s.huber_th)

    # both solve lastToNew (ref template -> new frame)
    T_ref = tracker_out["track"]["T"]
    T_mine = np.asarray(out["T"])
    assert bool(out["good"]) == bool(tracker_out["track"]["ok"])
    np.testing.assert_allclose(T_mine[:3, 3], T_ref[:3, 3], atol=2e-3)
    np.testing.assert_allclose(T_mine[:3, :3], T_ref[:3, :3], atol=1e-3)
    aff_ref = tracker_out["track"]["aff"]
    np.testing.assert_allclose(np.asarray(out["aff"]), aff_ref, atol=2e-2)
    res_ref = tracker_out["track"]["res"]
    res_mine = np.asarray(out["residuals"])
    for lvl in range(3):
        if np.isfinite(res_ref[lvl]):
            np.testing.assert_allclose(res_mine[lvl], res_ref[lvl],
                                       rtol=0.05)


def test_scale_optimizer_matches_reference(template_setup, tracker_out):
    """Residual-function parity: calcResScale / calcGSSSEScale over a
    scale ladder at every level (the harness window's deliberate idepth
    perturbations make the full optimizeScale trajectory plateau-chaotic,
    so the golden surface is the E/H/b FUNCTION, which is what determines
    production behavior on well-posed stereo scenes)."""
    import jax.numpy as jnp

    from sos_slam_tpu.models.window import build_track_template
    from sos_slam_tpu.ops import scale_opt as SO
    from sos_slam_tpu.ops.image import build_pyramid
    from sos_slam_tpu.utils import camera

    B, ba_fej, sc, pyr_ref, s = template_setup
    W, H = 256, 192
    FX, ID_TRUE, D_R = 200.0, 0.5, 5
    BASE = D_R / (FX * ID_TRUE)
    templates, _ = build_track_template(
        ba_fej, sc.HdiF, pyr_ref, 3, (512, 256, 256), W, H)

    img_r = _smooth_tex(W, H, shift=D_R)
    pyr_r, _ = build_pyramid(jnp.asarray(img_r), 3)

    calib = camera.make_calib_pyramid(W, H, 200.0, 200.0, 128.0, 96.0)
    intr = tuple((calib.fx[l], calib.fy[l], calib.cx[l], calib.cy[l])
                 for l in range(3))
    R01 = jnp.eye(3)
    t01 = jnp.asarray([-BASE, 0.0, 0.0], jnp.float32)

    rows = tracker_out["sres"]
    assert len(rows) == 24
    n_checked = 0
    for lvl, sv, E_ref, n_ref, sat_ref, H_ref, b_ref in rows:
        r = SO.res_and_hb_scale(pyr_r[int(lvl)], templates[int(lvl)],
                                jnp.float32(sv), R01, t01, intr[int(lvl)],
                                intr[int(lvl)], jnp.float32(s.coarse_cutoff_th),
                                s.huber_th)
        assert int(r["num_in"]) == int(n_ref), (lvl, sv)
        np.testing.assert_allclose(float(r["E"]), E_ref, rtol=2e-3)
        sat_mine = float(r["num_sat"]) / max(float(r["num_in"]), 1)
        assert abs(sat_mine - sat_ref) < 2e-2, (lvl, sv)
        # H/b normalizations differ (n_active vs 4-padded n): compare the
        # actual LM step -b/H
        if abs(H_ref) > 1e-12 and float(r["H"]) > 1e-12:
            step_ref = -b_ref / H_ref
            step_mine = -float(r["b"]) / float(r["H"])
            np.testing.assert_allclose(step_mine, step_ref, rtol=5e-3,
                                       atol=1e-5)
        n_checked += 1
    assert n_checked == 24


# ---------------------------------------------------------------------------
# CoarseInitializer::calcResAndGS (joint pose+idepth LM core) vs
# models/initializer.py::calc_res_gs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def init_out():
    lines = golden_build.run("init").splitlines()
    out = dict(pts={}, npn={}, res={}, H={}, b={}, Hsc={}, bsc={})
    for ln in lines:
        t = ln.split()
        if ln.startswith("inpn "):
            out["npn"][int(t[1])] = int(t[2])
        elif ln.startswith("inp "):
            out["pts"].setdefault(int(t[1]), []).append(
                [float(t[2]), float(t[3]), float(t[4]), int(t[5])])
        elif ln.startswith("ires "):
            out["res"][(int(t[1]), int(t[2]))] = [float(x) for x in t[3:]]
        elif t and t[0] in ("iH", "iHsc"):
            out[t[0][1:]][(int(t[1]), int(t[2]))] = np.array(
                [float(x) for x in t[3:]]).reshape(8, 8)
        elif t and t[0] in ("ib", "ibsc"):
            out[t[0][1:]][(int(t[1]), int(t[2]))] = np.array(
                [float(x) for x in t[3:]])
    return out


def test_initializer_res_gs_matches_reference(init_out):
    import jax.numpy as jnp

    from sos_slam_tpu.models import initializer as I
    from sos_slam_tpu.ops.image import build_pyramid
    from sos_slam_tpu.utils import camera, lie
    from sos_slam_tpu.utils.config import default_settings

    W, H = 256, 192
    s = default_settings()
    calib = camera.make_calib_pyramid(W, H, 200.0, 200.0, 128.0, 96.0)
    lv_first, _ = build_pyramid(jnp.asarray(_smooth_tex(W, H)), 3)
    lv_new, _ = build_pyramid(jnp.asarray(_smooth_tex(W, H, shift=6)), 3)

    # InitLevels from the reference's own selected points (the level-0
    # selector RNG deviation is documented; the point set is an input here)
    levels = {}
    for lvl in range(3):
        rows = np.array(init_out["pts"][lvl])
        n = len(rows)
        assert n == init_out["npn"][lvl]
        levels[lvl] = I.InitLevel(
            u=jnp.asarray(rows[:, 0], jnp.float32),
            v=jnp.asarray(rows[:, 1], jnp.float32),
            valid=jnp.ones(n, bool),
            is_good=jnp.asarray(rows[:, 3] > 0),
            idepth=jnp.ones(n), iR=jnp.ones(n),
            energy=jnp.zeros((n, 2)), last_hessian=jnp.zeros(n),
            nn=jnp.full((n, 10), -1, jnp.int32),
            parent=jnp.full((n,), -1, jnp.int32),
        )

    states = [
        (np.zeros(3), np.zeros(3), 0.0, 0.0, False),
        (np.array([-0.03, 0.004, -0.006]), np.array([0.002, -0.0015, 0.001]),
         0.05, -1.5, False),
        (np.array([-0.06, 0.0, 0.0]), np.zeros(3), 0.0, 0.0, True),
    ]
    n_checked = 0
    for si, (t, r, a, b, snapped) in enumerate(states):
        T = np.eye(4)
        T[:3, :3] = lie.np_so3_exp(r)
        T[:3, 3] = t
        for lvl in range(3):
            res = I.calc_res_gs(
                levels[lvl], lv_first[lvl], lv_new[lvl],
                (calib.fx[lvl], calib.fy[lvl], calib.cx[lvl], calib.cy[lvl]),
                W >> lvl, H >> lvl, jnp.asarray(T, jnp.float32),
                jnp.asarray([a, b], jnp.float32), jnp.asarray(snapped), s)
            E_ref, EA_ref, _ = init_out["res"][(si, lvl)]
            np.testing.assert_allclose(float(res["E"]), E_ref, rtol=5e-4)
            np.testing.assert_allclose(float(res["E_alpha"]), EA_ref,
                                       rtol=1e-4, atol=1e-3)
            for key, mine in (("H", res["H"]), ("b", res["b"]),
                              ("Hsc", res["Hsc"]), ("bsc", res["bsc"])):
                ref = init_out[key][(si, lvl)]
                scale = np.abs(ref).max() + 1e-9
                np.testing.assert_allclose(
                    np.asarray(mine), ref, rtol=5e-3, atol=scale * 1e-4)
            n_checked += 1
    assert n_checked == 9


# ---------------------------------------------------------------------------
# Point + frame marginalization into HM/bM (marginalizePointsF +
# EnergyFunctional::marginalizeFrame) vs models/energy.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def marg_out():
    lines = golden_build.run("residual").splitlines()
    out = dict(HMp={}, bMp={}, HMm={}, bMm={}, dims={})
    for ln in lines:
        t = ln.split()
        if ln.startswith("margp_dim "):
            out["dims"]["p"] = int(t[1])
        elif ln.startswith("margf_dim "):
            out["dims"]["f"] = int(t[1])
        elif t and t[0] in ("HMp", "HMm"):
            out[t[0]][(int(t[1]), int(t[2]))] = float(t[3])
        elif t and t[0] in ("bMp", "bMm"):
            out[t[0]][int(t[1])] = float(t[2])
    return out


def test_marginalization_matches_reference(residual_setup, marg_out):
    import jax.numpy as jnp

    from sos_slam_tpu.models import energy as E

    B, ba, pre, lin, dI, s = residual_setup
    W, H = 256, 192
    dp = marg_out["dims"]["p"]
    df = marg_out["dims"]["f"]
    HMp = np.zeros((dp, dp))
    bMp = np.zeros(dp)
    for (i, j), v in marg_out["HMp"].items():
        HMp[i, j] = v
    for i, v in marg_out["bMp"].items():
        bMp[i] = v
    HMm = np.zeros((df, df))
    bMm = np.zeros(df)
    for (i, j), v in marg_out["HMm"].items():
        HMm[i, j] = v
    for i, v in marg_out["bMm"].items():
        bMm[i] = v

    # 1) marginalize all points hosted in frame 0 into HM/bM
    mark = np.asarray(ba.host) == 0
    ba2 = E.marginalize_points(ba, dI, jnp.asarray(mark), s, W, H)
    scale = np.abs(HMp).max() + 1e-9
    np.testing.assert_allclose(np.asarray(ba2.HM)[:dp, :dp], HMp,
                               rtol=5e-3, atol=scale * 2e-4)
    bscale = np.abs(bMp).max() + 1e-9
    np.testing.assert_allclose(np.asarray(ba2.bM)[:dp], bMp,
                               rtol=5e-3, atol=bscale * 2e-4)

    # 2) drop residuals targeting frame 0, then Schur it out
    res_exist = np.asarray(ba2.res_exist).copy()
    res_exist[:, 0] = False
    ba2 = ba2._replace(res_exist=jnp.asarray(res_exist))
    ba3 = E.marginalize_frame(ba2, jnp.int32(0))
    scale = np.abs(HMm).max() + 1e-9
    np.testing.assert_allclose(np.asarray(ba3.HM)[:df, :df], HMm,
                               rtol=5e-3, atol=scale * 5e-4)
    bscale = np.abs(bMm).max() + 1e-9
    np.testing.assert_allclose(np.asarray(ba3.bM)[:df], bMm,
                               rtol=5e-3, atol=bscale * 5e-4)
