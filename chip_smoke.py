#!/usr/bin/env python3
"""Smoke test of the SLAM pipeline on one GPU: `python chip_smoke.py`.

Drives the main path once through the entry points a user calls, at full
VGA width with the default (preset 0) budgets, and compares every device
stage of that path with its plain reference:

  device   the default JAX device must be a GPU (never falls back to CPU);
  parity   pyramid and template dilation against float64 NumPy
           (sos_slam_tpu/utils/np_reference.py); one BA linearization +
           accumulation, the point-activation pass and the epipolar sweep,
           GPU against the same code on this process's CPU device;
  mono     preset 0 through SlamNode on bench.py's 48-frame hard-cadence
           sequence: initialised, fused keyframe path, marginalisation, ATE;
  stereo   stereo + VIO (bench.py's flagship scene): IMU initialised, scale
           solve run, ATE;
  loop     bench.py's LoopHandler drive: a loop edge accepted and the pose
           graph optimised on the GPU.

The mono and stereo + VIO phases run side by side in two threads (their
compiles overlap); their lines are printed when both have ended. Every
phase runs; any failure exits non-zero without the result line. The last
line of stdout is the JSON result
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

import json
import os
import sys
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from sos_slam_tpu.utils.device import gpu_identity, require_gpu

W, H = 640, 480


def result_line(devices) -> str:
    """The contract's last line, for a run whose phases all passed."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}})


_log = threading.local()


def say(msg: str) -> None:
    """Print a phase's line, or buffer it while the phase runs beside
    another (see `_run_group`)."""
    buf = getattr(_log, "buf", None)
    if buf is None:
        print(msg, flush=True)
    else:
        buf.append(msg)


def _rel_err(a, b) -> float:
    """max |a - b| relative to max |b| (at least 1)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


def _check(name: str, err: float, tol: float) -> None:
    say(f"  {name}: max rel err {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{name}: {err:.3e} > {tol:.0e}")


def _on(fn, device, *args):
    """Run jitted `fn` with all inputs committed to `device`."""
    import jax
    args = jax.device_put(args, device)
    return jax.tree.map(np.asarray, jax.block_until_ready(fn(*args)))


# ---------------------------------------------------------------- parity
# Tolerances. f32 paths: jax_default_matmul_precision="float32" keeps f32
# products off TF32, so GPU and CPU/NumPy differ only by f32 rounding and
# summation order: 1e-5 of the largest value for short sums, 2e-4 where a
# reduction runs over ~10^5 residual terms of widely varying magnitude
# (the BA Hessian). A photometric residual r is the difference of two
# ~128-level f32 intensities (absolute rounding ~3e-5), so energies and
# gradients built from r of a few levels agree to ~1e-4 of their scale.
# The epipolar sweep is bf16 by design (hat weights and patches rounded to
# bf16, f32 accumulate), so its energies get 2e-2, and what must agree is
# the decision it feeds: the argmin step, up to rounding-level ties.
TOL_F32 = 1e-5
TOL_F32_SUM = 2e-4
TOL_RES = 1e-4
TOL_BF16 = 2e-2


def parity_pyramid(gpu):
    import jax
    from sos_slam_tpu.ops import image as imops
    from sos_slam_tpu.utils import np_reference as ref
    from sos_slam_tpu.utils import synthetic

    n_levels = synthetic.default_calib(W, H).levels
    img = np.random.default_rng(0).uniform(0, 255, (H, W)).astype(np.float32)
    levels, asg = _on(lambda x: imops.build_pyramid(x, n_levels), gpu, img)
    lv_r, asg_r = ref.make_images(img, n_levels)
    err = max(max(_rel_err(a, b) for a, b in zip(levels, lv_r)),
              max(_rel_err(a, b) for a, b in zip(asg, asg_r)))
    _check(f"pyramid {W}x{H}, {n_levels} levels", err, TOL_F32)


def parity_template(gpu):
    import jax
    from sos_slam_tpu.models import window
    from sos_slam_tpu.utils import np_reference as ref

    rng = np.random.default_rng(1)
    occ = rng.uniform(size=(H, W)) < 0.05
    wm = np.where(occ, rng.uniform(0.1, 1.1, (H, W)), 0.0).astype(np.float32)
    idm = np.where(occ, wm * rng.uniform(0.2, 2.0, (H, W)), 0.0
                   ).astype(np.float32)
    color = rng.uniform(0, 255, (H, W)).astype(np.float32)
    for diag in (True, False):
        fn = jax.jit(lambda a, b, c: window.template_level(a, b, c, diag))
        idn, good = _on(fn, gpu, idm, wm, color)
        idn_r, good_r = ref.template_level(idm, wm, color, diag)
        if not np.array_equal(good, good_r):
            raise AssertionError(f"template good mask differs (diag={diag}):"
                                 f" {int(np.sum(good != good_r))} px")
        _check(f"template dilate+normalise diag={diag}",
               _rel_err(idn, idn_r), TOL_F32)


def parity_ba(gpu, cpu):
    import jax
    from sos_slam_tpu.models import energy as E
    from sos_slam_tpu.ops import ba as B
    from sos_slam_tpu.utils import synthetic
    from sos_slam_tpu.utils.config import default_settings

    settings = default_settings()
    P, F = settings.max_points, settings.max_window_frames
    ba, dI = synthetic.make_ba_window(W, H, F, F, P, P, pose_noise=0.003,
                                      idepth_noise=0.05, n_hosts=F - 1,
                                      seed=3)
    keys = ("Htop", "btop", "Hsc", "bsc", "HdiF", "energy_pf")

    @jax.jit
    def gn_quants(ba, dI):
        q = E._iter_quants(ba, B.make_precalc(ba), dI, settings, W, H)
        return {k: q[k] for k in keys + ("new_state_pf", "n_active")}

    g = _on(gn_quants, gpu, ba, dI)
    c = _on(gn_quants, cpu, ba, dI)
    n_diff = int(np.sum(g["new_state_pf"] != c["new_state_pf"]))
    say(f"  BA P={P} F={F} {W}x{H}: n_active {int(g['n_active'])}, "
          f"residual states differing {n_diff}")
    if n_diff:
        raise AssertionError(f"{n_diff} residual states differ GPU vs CPU")
    for k in keys:
        _check(f"BA {k}", _rel_err(g[k], c[k]), TOL_F32_SUM)


def _activation_inputs(n_pts: int):
    """A two-frame window (host 0, target 1) over the textured plane and
    immature points, as tests/test_trace.py builds it, at VGA. The idepth
    is the plane's true 0.5 perturbed by up to 10%, as a traced interval's
    midpoint would be, so residuals are a few intensity levels."""
    import jax
    import jax.numpy as jnp
    from sos_slam_tpu.ops import image as imops
    from sos_slam_tpu.ops import trace as T
    from sos_slam_tpu.utils import lie, synthetic
    from sos_slam_tpu.utils.config import PATTERN_OFFSETS, default_settings

    settings = default_settings()
    calib = synthetic.default_calib(W, H)
    fx, fy, cx, cy = calib.intrinsics(0)
    T_new = lie.se3_exp(jnp.array([0.06, 0.0, 0.0, 0.0, 0.0, 0.0]))
    img_ref, _ = synthetic.render_plane(calib, jnp.eye(4))
    img_new, _ = synthetic.render_plane(calib, T_new)
    dI_ref = imops.build_pyramid(img_ref, 1)[0][0]
    dI_new = imops.build_pyramid(img_new, 1)[0][0]
    key = jax.random.PRNGKey(0)
    u = jax.random.uniform(key, (n_pts,)) * (W - 24) + 12
    v = jax.random.uniform(jax.random.fold_in(key, 1), (n_pts,)) * (H - 24) + 12
    imm = T.init_immature(u, v, jnp.zeros(n_pts, jnp.int32),
                          jnp.ones(n_pts, jnp.int32), dI_ref, settings, n_pts)
    rel = jnp.stack([jnp.stack([jnp.eye(4), lie.se3_inv(T_new)]),
                     jnp.stack([T_new, jnp.eye(4)])])      # (F,F,4,4)
    F = 2
    host = imm.host
    pat = jnp.asarray(PATTERN_OFFSETS)
    KliP = jnp.stack([(imm.u[:, None] + pat[None, :, 0] - cx) / fx,
                      (imm.v[:, None] + pat[None, :, 1] - cy) / fy,
                      jnp.ones((n_pts, 8))], -1)
    Rp = rel[host][..., :3, :3]
    tp = rel[host][..., :3, 3]
    ap = jnp.broadcast_to(jnp.array([1.0, 0.0]), (n_pts, F, 2))
    oob_in = jax.nn.one_hot(host, F, dtype=bool)
    idepth = jnp.asarray(0.5 * (1.0 + 0.1 * np.random.default_rng(4).uniform(
        -1.0, 1.0, n_pts)), jnp.float32)
    return (imm, Rp, tp, ap, KliP, jnp.stack([dI_ref, dI_new]), idepth,
            oob_in), (fx, fy, cx, cy), settings, dI_new


def parity_activation(gpu, cpu):
    import functools
    import jax
    from sos_slam_tpu.ops import trace as T

    args, intr, settings, _ = _activation_inputs(4096)
    fn = jax.jit(functools.partial(T.activation_pass, clamp=True, intr=intr,
                                   w=W, h=H, huber_th=settings.huber_th))
    g = _on(fn, gpu, *args)
    c = _on(fn, cpu, *args)
    if not np.array_equal(g[1], c[1]):
        raise AssertionError("activation OOB masks differ GPU vs CPU")
    live = ~c[1]
    say(f"  activation N=4096 F=2: live residuals {int(live.sum())}")
    _check("activation e_res", _rel_err(g[0][live], c[0][live]), TOL_RES)
    _check("activation eN", _rel_err(g[2], c[2]), TOL_RES)
    _check("activation HN", _rel_err(g[3], c[3]), TOL_F32)
    _check("activation bN", _rel_err(g[4], c[4]), TOL_RES)


def parity_trace_sweep(gpu, cpu):
    import jax
    import jax.numpy as jnp
    from sos_slam_tpu.ops import trace as T
    from sos_slam_tpu.utils.config import PATTERN_OFFSETS

    (imm, *_), _, settings, dI_new = _activation_inputs(4096)
    n = imm.u.shape[0]
    rng = np.random.default_rng(2)
    ang = rng.uniform(0, 2 * np.pi, n)
    dxn = np.cos(ang).astype(np.float32)
    dyn = np.sin(ang).astype(np.float32)
    # segment start kept MAX_STEPS px inside the image, as the trace's
    # bounds checks guarantee
    m = T.MAX_STEPS + 8
    ptx = rng.uniform(m, W - m, n).astype(np.float32)
    pty = rng.uniform(m, H - m, n).astype(np.float32)
    rot_pat = np.broadcast_to(np.asarray(PATTERN_OFFSETS, np.float32),
                              (n, 8, 2))
    aff = np.tile(np.array([[1.0, 0.0]], np.float32), (n, 1))
    fn = jax.jit(lambda *a: T._sweep_energy_patch(*a, settings.huber_th))
    args = (dI_new[..., 0], ptx, pty, dxn, dyn, rot_pat, imm.color, aff)
    g = _on(fn, gpu, *args)
    c = _on(fn, cpu, *args)
    _check("trace sweep energies (bf16)", _rel_err(g, c), TOL_BF16)
    # the decision the sweep feeds: the step the GPU picks must cost, in
    # the CPU's energies, no more than the tolerance over the CPU's pick
    # (near-ties at bf16 rounding may flip the pick itself)
    scale = max(1.0, float(np.max(np.abs(c))))
    rows = np.arange(n)
    best_g, best_c = np.argmin(g, -1), np.argmin(c, -1)
    regret = c[rows, best_g] - c[rows, best_c]
    say(f"  trace sweep argmin equal on {np.mean(best_g == best_c):.4f} "
        f"of points")
    _check("trace sweep argmin regret", float(np.max(regret)) / scale,
           TOL_BF16)


# ---------------------------------------------------------- end to end
def phase_mono(gpu):
    import jax
    import bench
    from sos_slam_tpu.io.node import SlamNode
    from sos_slam_tpu.utils import synthetic
    from sos_slam_tpu.utils.config import default_settings

    calib = synthetic.default_calib(W, H)
    fx, fy, cx, cy = calib.intrinsics(0)
    with tempfile.TemporaryDirectory() as tmp:
        calib_file = os.path.join(tmp, "camera0.txt")
        with open(calib_file, "w") as f:
            f.write(f"Pinhole {fx} {fy} {cx} {cy} 0\n{W} {H}\nnone\n{W} {H}\n")
        settings = default_settings()
        node = SlamNode(settings, calib_file)
    imgs, poses = bench.main_scene(calib)
    say(f"  preset 0: {settings.max_points} points, "
          f"{settings.max_window_frames}-frame window, max_track_pts "
          f"{settings.max_track_pts}")
    t0 = time.time()
    t_steady = None
    for i, img in enumerate(imgs):
        if i == bench.WARMUP:
            jax.block_until_ready(node.fs.ba.state)
            t_steady = time.time()
        node.process(np.asarray(img), i * 0.05)
    fs = node.fs
    fs.finish_pending()
    jax.block_until_ready(fs.ba.state)
    t_end = time.time()
    ate, path = bench.trajectory_ate(fs, poses)
    n_marg = len(node.pose_recorder.marginalized)
    state_dev = {d.platform for d in fs.ba.state.devices()}
    say(f"  n_frames {fs.stats['n_frames']} n_kf {fs.stats['n_kf']} "
          f"marginalised {n_marg}; ATE {ate:.4f} m over {path:.3f} m; "
          f"frames 0-{bench.WARMUP - 1} {t_steady - t0:.1f} s (cold start, "
          f"compiles included); frames {bench.WARMUP}-{len(imgs) - 1} "
          f"{(len(imgs) - bench.WARMUP) / (t_end - t_steady):.2f} fps (wall, "
          f"no prewarm: late program variants compile here; run beside the "
          f"stereo + VIO phase)")
    checks = {
        "initialised": fs.initialized and node.prev_kf_size == 0,
        "not lost": not fs.is_lost,
        "fused keyframe path active": fs._fused_kf_active(),
        "frames marginalised": n_marg > 0,
        "BA state on the GPU": state_dev == {gpu.platform},
        "ATE gate": bench.ate_ok(ate, path),
    }
    _require(checks)


def phase_stereo_vio(gpu):
    import bench

    r = bench._bench_full_config(W, H, False)
    fs = r["fs"]
    ate, path = bench.trajectory_ate(fs, r["poses"])
    scale_errs = [sh.scale_error for sh in fs.shells
                  if sh.is_kf and sh.scale_error > 0]
    say(f"  n_kf {r['n_kf']}, scale solves {len(scale_errs)}, scale "
          f"{fs.current_scale:.4f}; ATE {ate:.4f} m over {path:.3f} m; "
          f"steady {r['fps']:.2f} fps (wall, run beside the mono phase)")
    _require({
        "ran to the end": r["fps"] > 0,
        "IMU initialised": fs.imu_initialized,
        "scale solve ran": len(scale_errs) > 0,
        "ATE gate": bench.ate_ok(ate, path),
        "BA state on the GPU":
            {d.platform for d in fs.ba.state.devices()} == {gpu.platform},
    })


def phase_loop(gpu):
    import jax
    import bench

    stats = bench._bench_loop_closure()
    say(f"  {stats}")
    _require({
        "loop edge accepted": stats.get("loop_edges", 0) >= 1,
        "pose graph optimised": "loop_graph_ms" in stats,
        "default device is the GPU": jax.devices()[0] == gpu,
    })


def _require(checks: dict) -> None:
    bad = [k for k, ok in checks.items() if not ok]
    say(f"  checks: {', '.join(checks)}")
    if bad:
        raise AssertionError("failed: " + ", ".join(bad))


def _run(name: str, fn) -> bool:
    """Run one phase; a failure is reported with its traceback."""
    say(f"[{name}]")
    t0 = time.time()
    try:
        fn()
        ok = True
    except Exception:
        say(traceback.format_exc().rstrip())
        ok = False
    say(f"[{name}] {'PASS' if ok else 'FAIL'} ({time.time() - t0:.1f} s)")
    return ok


def _run_group(group) -> list:
    """Run phases that share no state side by side, so that their XLA
    compiles overlap; print each phase's lines when all have ended.
    Returns the names of the phases that failed."""
    if len(group) == 1:
        return [n for n, fn in group if not _run(n, fn)]

    def run_buffered(name, fn):
        _log.buf = []
        try:
            return _run(name, fn), _log.buf
        finally:
            _log.buf = None

    with ThreadPoolExecutor(len(group)) as pool:
        futs = [pool.submit(run_buffered, n, fn) for n, fn in group]
        results = [f.result() for f in futs]
    for _, lines in results:
        for line in lines:
            print(line, flush=True)
    return [n for (n, _), (ok, _) in zip(group, results) if not ok]


def main() -> int:
    import jax

    import sos_slam_tpu  # noqa: F401  (precision + compile cache config)

    devices = jax.devices()
    require_gpu(devices)
    gpu = devices[0]
    cpu = jax.devices("cpu")[0]
    print(f"device: {gpu.device_kind} x{len(devices)}, jax {jax.__version__}",
          flush=True)
    print(f"nvidia-smi: {gpu_identity()}", flush=True)

    groups = [
        [("parity: pyramid", lambda: parity_pyramid(gpu))],
        [("parity: template", lambda: parity_template(gpu))],
        [("parity: BA", lambda: parity_ba(gpu, cpu))],
        [("parity: activation", lambda: parity_activation(gpu, cpu))],
        [("parity: trace sweep", lambda: parity_trace_sweep(gpu, cpu))],
        # the two end-to-end runs compile disjoint program sets: side by
        # side their compiles overlap, which keeps a cold run (no compile
        # cache) well inside its time budget
        [("mono preset 0 via SlamNode", lambda: phase_mono(gpu)),
         ("stereo + VIO", lambda: phase_stereo_vio(gpu))],
        [("loop closure", lambda: phase_loop(gpu))],
    ]
    n_phases = sum(len(g) for g in groups)
    t_all = time.time()
    failed = [name for g in groups for name in _run_group(g)]
    print(f"total {time.time() - t_all:.1f} s; "
          f"{n_phases - len(failed)}/{n_phases} phases passed", flush=True)
    if failed:
        print("FAILED: " + "; ".join(failed), flush=True)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
