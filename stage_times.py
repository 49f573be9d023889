"""Per-stage device time of the plain-XLA stages at preset 0, VGA, from
jax.profiler traces, each beside its HBM floor (argument + output bytes of
the compiled stage / 3.35 TB/s, the H100 SXM's published HBM bandwidth);
then a 12-frame trace of bench.py's mono scene for the frame's device busy
time and idle share.

    python stage_times.py [OUT_DIR]     # on a GPU; default OUT_DIR "."

Prints one JSON line per stage and writes OUT_DIR/stage_times.json.
Device time is the sum of the durations of every event on the GPU planes
of the trace; busy time is the union of those intervals.
"""
import functools
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import jax
import jax.numpy as jnp
import numpy as np

import bench
from sos_slam_tpu.models import energy as E
from sos_slam_tpu.models import window as WIN
from sos_slam_tpu.models.full_system import FullSystem
from sos_slam_tpu.ops import ba as B
from sos_slam_tpu.ops import image as imops
from sos_slam_tpu.ops import trace as T
from sos_slam_tpu.utils import synthetic
from sos_slam_tpu.utils.config import default_settings
from sos_slam_tpu.utils.device import gpu_identity, require_gpu

W, H = 640, 480
REPS = 20
N_TRACED_FRAMES = 12
HBM_BYTES_PER_S = 3.35e12


def gpu_events(trace_dir):
    """[(start_ns, duration_ns)] of every event on the GPU planes, and
    {plane|line: (events, ms)} per stream."""
    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    out, lines = [], {}
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = [(e.start_ns, e.duration_ns) for e in line.events]
            lines[f"{plane.name}|{line.name}"] = (
                len(evs), sum(d for _, d in evs) / 1e6)
            out += evs
    return out, lines


def busy_ms(evs) -> float:
    """Length of the union of the event intervals, in ms."""
    tot, cur_s, cur_e = 0, None, None
    for s, e in sorted((s, s + d) for s, d in evs):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                tot += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        tot += cur_e - cur_s
    return tot / 1e6


def traced(fn, reps):
    """GPU events of `reps` back-to-back calls of `fn`."""
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(reps):
                r = fn()
            jax.block_until_ready(r)
        return gpu_events(d)[0]


def measure(name, jitted, *args, **kw):
    """One stage: wall and device ms per call beside its HBM floor."""
    ma = jitted.lower(*args, **kw).compile().memory_analysis()
    floor_bytes = ma.argument_size_in_bytes + ma.output_size_in_bytes
    fn = functools.partial(jitted, *args, **kw)
    jax.block_until_ready(fn())      # compile + warm
    t0 = time.perf_counter()
    for _ in range(REPS):
        r = fn()
    jax.block_until_ready(r)
    wall = (time.perf_counter() - t0) / REPS * 1e3
    evs = traced(fn, REPS)
    rec = dict(stage=name,
               device_ms=round(sum(d for _, d in evs) / 1e6 / REPS, 4),
               busy_ms=round(busy_ms(evs) / REPS, 4),
               wall_ms=round(wall, 4), n_kernels=len(evs) // REPS,
               hbm_floor_ms=round(floor_bytes / HBM_BYTES_PER_S * 1e3, 5),
               floor_bytes=int(floor_bytes))
    rec["x_floor"] = round(rec["device_ms"] / max(rec["hbm_floor_ms"],
                                                  1e-9), 1)
    print(json.dumps(rec), flush=True)
    return rec


def stage_records(settings, calib):
    P, F = settings.max_points, settings.max_window_frames
    n_levels = calib.levels
    img = jnp.asarray(np.random.default_rng(0).uniform(0, 255, (H, W)),
                      jnp.float32)
    recs = [measure("pyramid", imops.build_pyramid, img, n_levels)]

    ba, dI = synthetic.make_ba_window(W, H, F, F, P, P, pose_noise=0.003,
                                      idepth_noise=0.05, n_hosts=F - 1,
                                      seed=3)
    sizes = tuple(max(settings.max_track_pts >> (2 * lvl), 1024)
                  for lvl in range(n_levels))
    recs.append(measure("template", WIN.build_track_template, ba,
                        jnp.full((P,), 1e-2),
                        imops.build_pyramid(img, n_levels)[0], n_levels,
                        sizes, W, H))

    gn = jax.jit(functools.partial(E.gn_step, settings=settings, w=W, h=H))
    recs.append(measure("ba_gn_step", gn, ba, dI))

    # activation: K=1024 candidates x F=8 frames, all passes
    K = 1024
    key = jax.random.PRNGKey(5)
    u = jax.random.uniform(key, (K,)) * (W - 24) + 12
    v = jax.random.uniform(jax.random.fold_in(key, 1), (K,)) * (H - 24) + 12
    imm = T.init_immature(u, v, jnp.zeros(K, jnp.int32),
                          jnp.ones(K, jnp.int32), dI[0], settings, K)
    imm = imm._replace(idepth_min=jnp.full((K,), 0.45),
                       idepth_max=jnp.full((K,), 0.55),
                       status=jnp.full((K,), T.IPS_GOOD, jnp.int8))
    pre = B.make_precalc(ba)
    intr = tuple(float(x) for x in B.calib_real(ba))
    r = measure("activation_all_passes", T.activate_points, imm, imm.valid,
                dI, pre.R, pre.t, pre.affLL, ba.frame_valid, intr, W, H,
                settings)
    r["n_passes"] = 1 + settings.gn_its_on_point_activation
    recs.append(r)
    return recs


def frame_record(settings, calib):
    """Device busy time and idle share of N_TRACED_FRAMES steady frames
    of bench.py's mono scene, after prewarm()."""
    imgs, poses = bench.main_scene(calib)
    fs = FullSystem(calib, settings)
    last = bench.WARMUP + N_TRACED_FRAMES - 1
    with tempfile.TemporaryDirectory() as d:
        for i, im in enumerate(imgs):
            if i == bench.WARMUP:
                fs.prewarm()
                jax.block_until_ready(fs.ba.state)
                jax.profiler.start_trace(d)
                t0 = time.perf_counter()
            fs.add_active_frame(im, timestamp=i * 0.05, frame_id=i)
            if i == last:
                fs.finish_pending()
                jax.block_until_ready(fs.ba.state)
                wall_ms = (time.perf_counter() - t0) * 1e3
                jax.profiler.stop_trace()
        fs.finish_pending()
        evs, lines = gpu_events(d)
    busy = busy_ms(evs)
    ate, path = bench.trajectory_ate(fs, poses)
    frame = dict(frames=N_TRACED_FRAMES, wall_ms=round(wall_ms, 2),
                 kernel_ms_per_frame=round(
                     sum(d for _, d in evs) / 1e6 / N_TRACED_FRAMES, 3),
                 busy_ms_per_frame=round(busy / N_TRACED_FRAMES, 3),
                 idle_share_of_wall=round(1 - busy / wall_ms, 4),
                 n_kf=fs.stats["n_kf"], streams=lines, ate=ate, path=path)
    print(json.dumps(frame), flush=True)
    util = bench._utilization_report(fs, N_TRACED_FRAMES / wall_ms * 1e3)
    return frame, util


def main(out_dir):
    require_gpu(jax.devices())
    print("device", jax.devices()[0].device_kind, "| nvidia-smi:",
          gpu_identity(), flush=True)
    settings = default_settings()
    calib = synthetic.default_calib(W, H)
    recs = stage_records(settings, calib)
    frame, util = frame_record(settings, calib)
    for r in recs:
        r["share_of_frame_busy"] = round(
            r["device_ms"] / max(frame["busy_ms_per_frame"], 1e-9), 4)
    out = dict(stages=recs, frame=frame, util=util,
               device=jax.devices()[0].device_kind)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "stage_times.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(dict(stages=recs, util=util)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
