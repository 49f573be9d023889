"""Benchmark: end-to-end tracked frames/sec of the odometry pipeline on a GPU.

Runs the full system (initializer -> tracker -> keyframes -> windowed BA ->
marginalization) on a synthetic 640x480 sequence (EuRoC-class resolution,
analytic multi-view-consistent scene — no dataset dependency), measures
steady-state throughput after a compile/warmup phase, and prints ONE JSON
line naming the device it ran on. It refuses to run without a GPU.

Every timed scene runs MULTIPLE times (the pipeline is deterministic, so
only timing varies): the headline value is the MEDIAN steady-window fps and
the per-run values are reported in `extra` (`fps_runs`, ...), so run-to-run
variance stays visible instead of folding into the number.

Floor: >= 2x camera rate (EuRoC = 20 fps) => vs_baseline = fps / 40.0.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

from sos_slam_tpu.utils.device import gpu_identity, require_gpu

W, H = 640, 480
N_FRAMES = 48
# warmup must cover the first frame marginalization (window fill) so all
# program variants are compiled before the timed window starts
WARMUP = 26
N_RUNS_MAIN = 5
N_RUNS_LOW = 3
N_RUNS_FULL = 2


def _run_main_scene(calib, imgs, poses, settings, verbose, profile,
                    run_idx):
    """One full main-scene run. Returns dict with fps/kf_ms/ate/path/fs."""
    from sos_slam_tpu.models.full_system import FullSystem

    fs = FullSystem(calib, settings)
    prof = None
    frame_times = []
    kf_flags = []
    t_start = time.time()
    t_steady = None
    for i in range(N_FRAMES):
        if verbose:
            print(f"[bench] run {run_idx} frame {i} "
                  f"t={time.time()-t_start:.1f}s", file=sys.stderr,
                  flush=True)
        if i == WARMUP:
            # pre-dispatch rare program variants (tracker fallbacks,
            # selector-potential rungs) so no compile / executable-cache
            # load lands inside the timed window
            fs.prewarm()
            jax.block_until_ready(fs.ba.state)
            if profile and run_idx == 0:
                import cProfile
                prof = cProfile.Profile()
                prof.enable()
            t_steady = time.time()
        n_kf_before = fs.stats["n_kf"]
        t0 = time.time()
        fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)
        frame_times.append(time.time() - t0)
        kf_flags.append(fs.stats["n_kf"] > n_kf_before)
        if fs.is_lost or fs.init_failed:
            break
    fs.finish_pending()
    jax.block_until_ready(fs.ba.state)
    t_end = time.time()
    if prof is not None:
        import pstats
        prof.disable()
        st = pstats.Stats(prof, stream=sys.stderr).sort_stats("cumulative")
        st.print_stats(45)
        sys.stderr.flush()
    if verbose:
        rep = fs.telemetry.report()
        for k, v in sorted(rep["timers_ms"].items()):
            print(f"[bench] timer {k}: n={v['n']} median={v['median']:.1f} "
                  f"mean={v['mean']:.1f} max={v['max']:.1f}",
                  file=sys.stderr, flush=True)

    ok = not (fs.is_lost or fs.init_failed) and fs.initialized
    steady = frame_times[WARMUP:]
    if ok and t_steady is not None and len(steady) >= 5:
        fps = len(steady) / (t_end - t_steady)
        kf_ms = [1000.0 * t for t, k in zip(frame_times[WARMUP:],
                                            kf_flags[WARMUP:]) if k]
        kf_ba_ms = float(np.median(kf_ms)) if kf_ms else -1.0
    else:
        fps, kf_ba_ms = 0.0, -1.0

    # trajectory sanity: scale-aligned ATE must stay small, else report 0
    ate, path = trajectory_ate(fs, poses)
    if not ate_ok(ate, path):
        fps = 0.0   # fast-but-wrong doesn't count
    return dict(fps=fps, kf_ba_ms=kf_ba_ms, ate=ate, path=path, fs=fs,
                ok=ok and fps > 0)


def trajectory_ate(fs, poses):
    """Scale-aligned absolute trajectory error of `fs` against the
    cam-to-world ground truth `poses`. Returns (ate_m, path_m)."""
    traj = fs.trajectory()
    ids = traj[:, 0].astype(int)
    est, gt = traj[:, 1:4], np.asarray(poses)[ids, :3, 3]
    en, gn = np.linalg.norm(est, axis=1), np.linalg.norm(gt, axis=1)
    nz = gn > 1e-6
    scale = np.median(en[nz] / gn[nz]) if nz.any() else 1.0
    ate = float(np.sqrt(np.mean(
        np.linalg.norm(est / max(scale, 1e-9) - gt, axis=1) ** 2)))
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    return ate, path


def ate_ok(ate: float, path: float) -> bool:
    """The correctness gate: ATE within 5% of the path length + 2 cm."""
    return bool(np.isfinite(ate)) and ate <= 0.05 * path + 0.02


def main_scene(calib):
    """The hard-cadence main sequence: constant twist over a textured plane
    (~46% keyframes). Returns (per-frame device images, cam-to-world
    poses)."""
    from sos_slam_tpu.utils import synthetic

    twist = jnp.array([0.03, 0.012, 0.02, 0.002, 0.004, 0.001])
    imgs, _, poses = synthetic.make_sequence(calib, N_FRAMES, twist,
                                             plane_z=2.0)
    # pre-slice outside the timed loop: input staging, not pipeline work
    return [jax.block_until_ready(imgs[i]) for i in range(N_FRAMES)], poses


def _run_low_cadence(calib, settings, imgs2):
    """Second scene at a realistic (~10%) keyframe cadence."""
    from sos_slam_tpu.models.full_system import FullSystem

    fs2 = FullSystem(calib, settings)
    W2 = 14   # init finishes well before; no fresh compiles expected
    n_done, t2_steady = 0, None
    for i in range(N_FRAMES):
        if i == W2:
            jax.block_until_ready(fs2.ba.state)
            t2_steady = time.time()
        fs2.add_active_frame(imgs2[i], timestamp=i * 0.05, frame_id=i)
        n_done = i + 1
        if fs2.is_lost or fs2.init_failed:
            break
    fs2.finish_pending()
    jax.block_until_ready(fs2.ba.state)
    if not (fs2.is_lost or fs2.init_failed) and n_done == N_FRAMES \
            and t2_steady is not None:
        return (N_FRAMES - W2) / (time.time() - t2_steady), \
            fs2.stats["n_kf"], fs2.stats["n_frames"]
    return -1.0, 0, 0


def main():
    from sos_slam_tpu.utils import synthetic
    from sos_slam_tpu.utils.config import default_settings

    require_gpu(jax.devices())
    card = gpu_identity()
    print(f"[bench] device {jax.devices()[0].device_kind}; nvidia-smi: "
          f"{card}", file=sys.stderr, flush=True)
    calib = synthetic.default_calib(W, H)
    imgs, poses = main_scene(calib)

    settings = default_settings()
    verbose = os.environ.get("SOS_BENCH_VERBOSE", "0") == "1"
    # SOS_BENCH_PROFILE=1: cProfile the steady window in pipelined mode
    # (blocking per frame would serialize exactly what the pipeline hides)
    profile = os.environ.get("SOS_BENCH_PROFILE", "0") == "1"
    quick = os.environ.get("SOS_BENCH_QUICK") == "1"
    n_runs = 1 if quick else N_RUNS_MAIN
    # wall-clock budget: a cold run pays every compile; shed the EXTRA
    # repeat runs rather than risk the whole bench being cut off (the first
    # run of each scene always happens, so the metric is never missing —
    # just less averaged)
    budget_s = float(os.environ.get("SOS_BENCH_BUDGET_S", "2100"))
    t_bench0 = time.time()

    runs = []
    for r in range(n_runs):
        if r > 0 and time.time() - t_bench0 > budget_s * 0.6:
            break
        runs.append(_run_main_scene(calib, imgs, poses, settings, verbose,
                                    profile, r))
        if not runs[-1]["ok"]:
            break
    ok = all(r["ok"] for r in runs)
    fps_runs = [round(r["fps"], 3) for r in runs]
    kf_runs = [round(r["kf_ba_ms"], 1) for r in runs]
    if ok:
        fps = float(np.median([r["fps"] for r in runs]))
        kf_ba_ms = float(np.median([r["kf_ba_ms"] for r in runs]))
        spread = (max(fps_runs) - min(fps_runs)) / max(fps, 1e-9)
    else:
        fps, kf_ba_ms, spread = 0.0, -1.0, -1.0
    rep = runs[-1]
    fs, ate, path = rep["fs"], rep["ate"], rep["path"]

    # second scene at a realistic (~10%) keyframe cadence: the primary
    # scene's motion forces ~46% keyframes, which over-weights the KF path;
    # real EuRoC sequences keyframe every ~10 frames. Same resolution, so
    # every compiled program is reused — only execution is measured.
    lo_runs, lo_kf, lo_frames = [], 0, 0
    if ok and fps > 0:
        twist2 = jnp.array([0.006, 0.0024, 0.004, 0.0004, 0.0008, 0.0002])
        imgs2, _, _ = synthetic.make_sequence(calib, N_FRAMES, twist2,
                                              plane_z=2.0)
        imgs2 = [jax.block_until_ready(imgs2[i]) for i in range(N_FRAMES)]
        for r in range(1 if quick else N_RUNS_LOW):
            if r > 0 and time.time() - t_bench0 > budget_s * 0.75:
                break
            f, k, n = _run_low_cadence(calib, settings, imgs2)
            if f <= 0:
                break
            lo_runs.append(round(f, 3))
            lo_kf, lo_frames = k, n
    lo_fps = float(np.median(lo_runs)) if lo_runs else -1.0

    # flagship full configuration (stereo + VIO): the fused VIO chain
    # (KKT BA + in-chain stereo scale solve) measured at the same
    # resolution. Skippable for quick runs (SOS_BENCH_SKIP_FULL=1).
    full_runs, full_kf = [], 0
    if ok and fps > 0 and os.environ.get("SOS_BENCH_SKIP_FULL") != "1" \
            and not quick:
        for r in range(N_RUNS_FULL):
            if r > 0 and time.time() - t_bench0 > budget_s:
                break
            res = _bench_full_config(W, H, verbose)
            if res["fps"] <= 0:
                break
            full_runs.append(round(res["fps"], 3))
            full_kf = res["n_kf"]
    full_fps = float(np.median(full_runs)) if full_runs else -1.0

    # loop-closure stage timings (the reference's TimeVectors,
    # LoopHandler.h:129-137): a small closed-loop drive through the real
    # LoopHandler; medians per stage in ms
    loop_stats = {}
    if ok and os.environ.get("SOS_BENCH_SKIP_LOOP") != "1":
        try:
            loop_stats = _bench_loop_closure()
        except Exception as e:
            loop_stats = {"loop_bench_error": type(e).__name__}

    # device-efficiency accounting: dispatch floor, per-frame device time,
    # and the fused per-frame program's flops and memory traffic
    util = _utilization_report(fs, fps) if ok and fps > 0 else {}

    print(json.dumps({
        "metric": "tracked_fps_synthetic_640x480_full_pipeline",
        "value": round(fps, 3),
        "unit": "frames/sec",
        "vs_baseline": round(fps / 40.0, 4),
        "extra": {
            "fps_runs": fps_runs,
            "fps_spread_frac": round(spread, 4),
            "kf_ba_ms_median": round(kf_ba_ms, 1),
            "kf_ba_ms_runs": kf_runs,
            "n_kf": fs.stats["n_kf"],
            "n_frames": fs.stats["n_frames"],
            "ate_m": round(ate, 4),
            "path_m": round(path, 3),
            "fps_low_cadence": round(lo_fps, 3),
            "fps_low_cadence_runs": lo_runs,
            "n_kf_low_cadence": lo_kf,
            "fps_full_config": round(full_fps, 3),
            "fps_full_config_runs": full_runs,
            "n_kf_full_config": full_kf,
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "device_count": len(jax.devices()),
            "nvidia_smi": card,
            **loop_stats,
            **util,
        },
    }))


def _utilization_report(fs, fps):
    """Device-time / work / dispatch accounting of the steady per-frame path.

    - rpc_floor_ms: round trip of a trivial dispatch+fetch (the floor every
      synchronous host<->device exchange pays).
    - device_ms_per_frame: measured directly by re-dispatching the steady
      per-frame fused program back-to-back (async dispatches serialize on
      the device execution queue; one block at the end) — NOT wall minus
      RPC floor, which collapses to ~0 whenever the pipeline fully overlaps
      the fetch.
    - host_ms_per_frame: wall minus device execution — dispatch/bookkeeping
      + the un-overlapped share of the readback.
    - gflops_per_frame from the compiled fused program's own cost
      analysis.
    - hbm_gb_per_frame_min: device-memory traffic lower bound from the
      executable's buffer assignment (argument + output + temp bytes).
    Ratios against device peaks are left to a table keyed by device_kind.
    """
    from sos_slam_tpu.utils.hostio import fetch
    import sos_slam_tpu.models.full_system as fsm

    out = {}
    try:
        tiny = jax.jit(lambda x: x * 1.0000001 + 1.0)
        x = jnp.float32(1.0)
        x = fetch(tiny(x))   # compile + warm
        t0 = time.time()
        reps = 5
        for _ in range(reps):
            x = fetch(tiny(jnp.float32(x)))
        out["rpc_floor_ms"] = round((time.time() - t0) / reps * 1000.0, 2)
    except Exception:
        return out

    wall_ms = 1000.0 / fps
    try:
        kind, args, kw = fs._last_dispatch
        fn = fsm._fused_frame_vio_jit if kind == "vio" \
            else fsm._fused_frame_mono_jit
        r = fn(*args, **kw)        # warm (already compiled in the run)
        jax.block_until_ready(r)
        reps = 20
        t0 = time.time()
        for _ in range(reps):
            r = fn(*args, **kw)
        jax.block_until_ready(r)
        dev_ms = (time.time() - t0) / reps * 1000.0
        out["device_ms_per_frame"] = round(dev_ms, 2)
        out["host_ms_per_frame"] = round(max(wall_ms - dev_ms, 0.0), 2)

        compiled = fn.lower(*args, **kw).compile()
        ca = compiled.cost_analysis()
        if isinstance(ca, list):   # older jax returns [dict]
            ca = ca[0]
        flops = float(ca.get("flops", 0.0))
        out["gflops_per_frame"] = round(flops / 1e9, 2)
        try:
            ma = compiled.memory_analysis()
            hbm_bytes = (float(ma.argument_size_in_bytes)
                         + float(ma.output_size_in_bytes)
                         + float(ma.temp_size_in_bytes))
            out["hbm_gb_per_frame_min"] = round(hbm_bytes / 1e9, 3)
        except Exception:
            pass
    except Exception as e:   # cost analysis unsupported on some backends
        out["cost_analysis_error"] = type(e).__name__
    return out


def _bench_loop_closure():
    """Drive the real LoopHandler through a drifted closed loop (the
    tests/test_loop_closure_e2e.py scene, shrunk) and report the stage
    TimeVector medians the way the reference collects them
    (LoopHandler.h:129-137)."""
    from sos_slam_tpu.loop.handler import LoopHandler
    from sos_slam_tpu.models.full_system import FrameShell
    from sos_slam_tpu.utils import lie
    from sos_slam_tpu.utils.config import default_settings

    LIDAR = 30.0
    settings = default_settings(
        scale_opt_thres=12.0, loop_lidar_range=LIDAR, loop_icp_thres=1.0,
        scan_context_thres=0.42)
    lh = LoopHandler(settings, intrinsics=((300.0, 300.0, 128.0, 96.0),),
                     n_levels=1, ringkey_margin=6)
    rng = np.random.RandomState(42)
    pts = []
    for _ in range(30):
        cx, cz = rng.uniform(-25, 25, 2)
        h = rng.uniform(4, 15)
        for _ in range(30):
            pts.append([cx + rng.randn() * 0.4, -rng.uniform(0, h),
                        cz + rng.randn() * 0.4])
    while len(pts) < 1500:
        pts.append([rng.uniform(-28, 28), 0.0, rng.uniform(-28, 28)])
    env = np.asarray(pts)

    n = 20
    gt = [np.eye(4)]
    seg = np.asarray(lie.se3_exp(jnp.asarray(
        [2.0, 0.0, 0.0, 0.0, 2 * np.pi / 16, 0.0], jnp.float32)))
    for _ in range(1, n):
        gt.append(gt[-1] @ seg)
    drift = np.asarray(lie.se3_exp(jnp.asarray(
        [0.06, 0.03, -0.04, 0.004, 0.006, 0.0], jnp.float32)))
    odo = [np.eye(4)]
    for i in range(1, n):
        rel = np.linalg.inv(gt[i - 1]) @ gt[i]
        odo.append(odo[-1] @ rel @ drift)

    fx, fy, cx, cy = lh.intrinsics[0]
    for i in range(n):
        shell = FrameShell(id=i, timestamp=i * 0.5,
                           cam_to_world=odo[i].copy(), aff=np.zeros(2))
        shell.cam_to_world_scaled = odo[i].copy()
        T_cw = np.linalg.inv(gt[i])
        pc = (T_cw[:3, :3] @ env.T).T + T_cw[:3, 3]
        pc = pc[np.linalg.norm(pc, axis=1) < LIDAR]
        pc = pc[rng.choice(len(pc), size=min(1000, len(pc)),
                           replace=False)]
        pc = pc[pc[:, 2] > 0.5]
        pts_uvdi = np.stack([
            pc[:, 0] / pc[:, 2] * fx + cx,
            pc[:, 1] / pc[:, 2] * fy + cy,
            1.0 / pc[:, 2]], -1)
        lh.on_keyframe(dict(shell=shell, pts_uvdi=pts_uvdi,
                            intensities=np.zeros((len(pts_uvdi), 1),
                                                 np.float32),
                            pyramid=None, dso_error=1.0, scale_error=2.0))
    lh.join()

    stats = {"loop_edges": lh.n_loop_edges}
    for stage, vals in lh.timing.items():
        if vals:
            stats[f"loop_{stage}_ms"] = round(
                float(np.median(vals)) * 1000.0, 2)
    return stats


def _bench_full_config(W, H, verbose):
    """Stereo + VIO (the flagship configuration) on a bounded sinusoidal
    trajectory with analytic IMU. Returns dict(fps, n_kf, fs, poses); fps
    is -1 on failure (lost, init failed, IMU never initialized)."""
    from sos_slam_tpu.models.full_system import FullSystem, StereoCalib
    from sos_slam_tpu.utils import lie, synthetic
    from sos_slam_tpu.utils.config import default_settings

    N_FRAMES, WARMUP = 44, 30
    FRAME_DT, IMU_HZ, PLANE_Z, BASE = 0.1, 200.0, 2.0, 0.11
    # bounded sinusoidal 6-DoF trajectory: continuous non-zero acceleration
    # (spline-VIO observability) with bounded excursion, so the camera never
    # closes on the plane (the previous cubic trajectory accelerated into
    # it and became untrackable by frame ~41)
    A = np.array([0.38, 0.28, 0.20])          # translation amplitudes (m)
    WT = np.array([0.9, 0.7, 1.1])            # translation frequencies
    B = np.array([0.05, 0.09, 0.04])          # rotation amplitudes (rad)
    WR = np.array([0.8, 1.0, 0.7])            # rotation frequencies

    def pose_at(t):
        # pure numpy: an eager jax op per IMU sample would be a device
        # dispatch and readback each
        T = np.eye(4, dtype=np.float32)
        r = B * np.sin(WR * t)
        T[:3, :3] = lie.np_so3_exp(r).astype(np.float32)
        T[:3, 3] = A * np.sin(WT * t)
        return T

    def imu_between(t0, t1):
        g_world = np.array([0.0, 0.0, -9.81])
        out, h = [], 1e-4
        for i in range(1, int(round((t1 - t0) * IMU_HZ)) + 1):
            t = t0 + i / IMU_HZ
            R = pose_at(t)[:3, :3]
            a_w = -A * WT * WT * np.sin(WT * t)
            Wx = R.T @ ((pose_at(t + h)[:3, :3]
                         - pose_at(t - h)[:3, :3]) / (2 * h))
            w_body = np.array([Wx[2, 1], Wx[0, 2], Wx[1, 0]])
            out.append((t, (R.T @ (a_w + g_world)).astype(np.float32),
                        w_body.astype(np.float32)))
        return out

    calib = synthetic.default_calib(W, H)
    T_lr_world = np.eye(4)
    T_lr_world[0, 3] = BASE
    stereo = StereoCalib(
        T_lr=np.asarray(lie.se3_inv(jnp.asarray(T_lr_world, jnp.float32))),
        calib_right=calib)
    settings = default_settings(weight_imu_dso=6.0, scale_opt_thres=12.0,
                                min_g_imu=10)
    poses = [pose_at(i * FRAME_DT) for i in range(N_FRAMES)]
    imgs_l, imgs_r = [], []
    for p in poses:
        imgs_l.append(synthetic.render_plane(
            calib, jnp.asarray(p), PLANE_Z)[0])
        imgs_r.append(synthetic.render_plane(
            calib, jnp.asarray(p @ T_lr_world, jnp.float32), PLANE_Z)[0])
    imgs_l = jax.block_until_ready(imgs_l)
    imgs_r = jax.block_until_ready(imgs_r)

    imu_blocks = []
    t_prev = -FRAME_DT
    for i in range(N_FRAMES):
        imu_blocks.append(imu_between(t_prev, i * FRAME_DT))
        t_prev = i * FRAME_DT

    fs = FullSystem(calib, settings, stereo=stereo)
    fail = dict(fps=-1.0, fs=fs, poses=poses)
    t_steady, n_done = None, 0
    for i in range(N_FRAMES):
        if verbose:
            print(f"[bench-full] frame {i}", file=sys.stderr, flush=True)
        if i == WARMUP:
            jax.block_until_ready(fs.ba.state)
            t_steady = time.time()
        t = i * FRAME_DT
        fs.add_active_frame(imgs_l[i], timestamp=t, frame_id=i,
                            image_right=imgs_r[i],
                            imu_samples=imu_blocks[i])
        n_done = i + 1
        if fs.is_lost or fs.init_failed:
            return dict(fail, n_kf=fs.stats["n_kf"])
    fs.finish_pending()
    jax.block_until_ready(fs.ba.state)
    if not fs.imu_initialized or n_done <= WARMUP or t_steady is None:
        return dict(fail, n_kf=fs.stats["n_kf"])
    return dict(fps=(n_done - WARMUP) / (time.time() - t_steady),
                n_kf=fs.stats["n_kf"], fs=fs, poses=poses)


if __name__ == "__main__":
    main()
