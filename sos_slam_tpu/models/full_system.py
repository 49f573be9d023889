"""FullSystem: the odometry pipeline orchestrator.

JAX rebuild of the reference FullSystem (src/FullSystem/
FullSystem.{h,cpp}): frame ingestion, monocular bootstrap, multi-hypothesis
coarse tracking, keyframe decision, point lifecycle (trace -> activate ->
optimize -> marginalize), windowed BA, and marginalization policy.

Architecture: a thin host-side class owning device-resident state
(BAState window, ImmatureState pool, tracker templates, frame pyramids);
every compute step is a jitted kernel from ops/ and models/. Host logic is
restricted to control decisions the reference also makes on scalars
(keyframe need, marginalization flags, initializer progression).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sos_slam_tpu.models import energy as E
from sos_slam_tpu.models import initializer as CI
from sos_slam_tpu.models import window as WIN
from sos_slam_tpu.ops import ba as B
from sos_slam_tpu.ops import selector
from sos_slam_tpu.ops import trace as TR
from sos_slam_tpu.ops import tracker as TK
from sos_slam_tpu.ops.image import build_pyramid, interp_bilinear
from sos_slam_tpu.utils import lie
from sos_slam_tpu.utils.camera import CalibPyramid
from sos_slam_tpu.utils.config import PATTERN_OFFSETS, Settings
from sos_slam_tpu.utils.hostio import fetch, fetch_future, prefetch


@dataclasses.dataclass
class FrameShell:
    """Permanent per-frame record (reference util/FrameShell.h)."""

    id: int
    timestamp: float
    cam_to_world: np.ndarray            # (4,4)
    aff: np.ndarray                     # (2,)
    pose_valid: bool = True
    tracking_ref: Optional[int] = None  # id of reference KF shell
    is_kf: bool = False
    marginalized_at: int = -1
    # stereo metric-scale bookkeeping (FrameShell.h:51-60)
    scale: float = 1.0
    scale_error: float = -1.0
    cam_to_world_scaled: Optional[np.ndarray] = None
    dso_error: float = np.nan           # BA energy stat for loop-edge weights
    shell_idx: int = -1                 # position in FullSystem.shells (O(1)
                                        # lookup — a list scan is quadratic
                                        # over a long sequence)


@dataclasses.dataclass
class StereoCalib:
    """Right-camera intrinsics + left->right extrinsics (ScaleOptimizer.h)."""

    T_lr: np.ndarray                    # (4,4) left -> right
    calib_right: CalibPyramid


class FullSystem:
    def __init__(self, calib: CalibPyramid, settings: Settings,
                 stereo: Optional[StereoCalib] = None):
        self.calib = calib
        self.settings = settings
        self.n_levels = calib.levels
        self.w = calib.widths[0]
        self.h = calib.heights[0]
        # per-level intrinsics tuple, cached (it is a static jit arg built
        # on every dispatch otherwise)
        self._intr = tuple(calib.intrinsics(l) for l in range(self.n_levels))
        F = settings.max_window_frames
        P = settings.max_points
        self.F, self.P = F, P
        # _flag_frames_jit can flag up to (max_frames - min_frames) + 1
        # frames per keyframe (the sequential count gate stops at
        # min_frames, plus one distance-score drop); the cond-gated
        # marginalization chain dispatches exactly MAX_MARG_FRAMES
        # programs, so a larger flag count would silently truncate
        # marg_ks while the full mask still marginalized the points.
        worst_flags = max(settings.max_frames - settings.min_frames, 2) + 1
        if worst_flags > MAX_MARG_FRAMES:
            raise ValueError(
                f"settings allow up to {worst_flags} frames flagged per KF "
                f"but MAX_MARG_FRAMES={MAX_MARG_FRAMES}; raise it or "
                f"narrow max_frames-min_frames")

        fx, fy, cx, cy = calib.intrinsics(0)
        c0 = jnp.array([fx, fy, cx, cy]) / B.CALIB_SCALE
        D = 4 + 8 * F
        self.ba = B.BAState(
            frame_valid=jnp.zeros(F, bool),
            T_cw_eval=jnp.stack([jnp.eye(4)] * F),
            state=jnp.zeros((F, 8)),
            state_zero=jnp.zeros((F, 8)),
            exposure=jnp.ones(F),
            energy_th=jnp.full((F,), 12.0 * 12.0 * 8.0),
            prior=jnp.zeros((F, 8)),
            c=c0, c_zero=c0,
            pt_valid=jnp.zeros(P, bool),
            host=jnp.zeros(P, jnp.int32),
            u=jnp.zeros(P), v=jnp.zeros(P),
            color=jnp.zeros((P, 8)), weight=jnp.zeros((P, 8)),
            idepth=jnp.zeros(P), idepth_zero=jnp.zeros(P),
            pt_prior=jnp.zeros(P),
            res_exist=jnp.zeros((P, F), bool),
            res_state=jnp.zeros((P, F), jnp.int8),
            HM=jnp.zeros((D, D)), bM=jnp.zeros(D),
        )
        self.dI = jnp.zeros((F, self.h, self.w, 3))   # level-0 images
        self.frame_pyramids: List = [None] * F        # full pyramids per slot
        self.frame_shell_idx: List[int] = []          # shell id per slot
        self.HdiF = jnp.zeros(P)

        N_imm = settings.max_immature
        self.imm = TR.ImmatureState(
            valid=jnp.zeros(N_imm, bool),
            host=jnp.zeros(N_imm, jnp.int32),
            u=jnp.zeros(N_imm), v=jnp.zeros(N_imm),
            color=jnp.zeros((N_imm, 8)), weights=jnp.zeros((N_imm, 8)),
            gradH=jnp.zeros((N_imm, 2, 2)),
            energy_th=jnp.zeros(N_imm),
            idepth_min=jnp.zeros(N_imm),
            idepth_max=jnp.full((N_imm,), jnp.inf),
            status=jnp.zeros(N_imm, jnp.int8),
            quality=jnp.full((N_imm,), 10000.0),
            my_type=jnp.zeros(N_imm, jnp.int32),
        )

        # coarse-tracker state
        tmpl_sizes = []
        for lvl in range(self.n_levels):
            tmpl_sizes.append(max(settings.max_track_pts >> (2 * lvl), 1024))
        self.tmpl_sizes = tuple(tmpl_sizes)
        self.templates = None
        self.ref_slot = -1          # window slot of the tracking reference
        self.ref_aff = np.zeros(2, np.float32)
        self.ref_exposure = 1.0
        self.first_coarse_rmse = -1.0
        self.last_coarse_rmse = np.full(6, 100.0)

        # initializer
        self.initializer: Optional[CI.InitState] = None
        self.init_first_pyr = None

        self.initialized = False
        self.is_lost = False
        self.init_failed = False
        self.current_min_act_dist = 2.0

        self.shells: List[FrameShell] = []
        self._shell_by_id: dict = {}
        self.kf_shell_ids: List[int] = []
        # carried-over world pose for reinitialization: when set (by
        # SlamNode after an init failure), the rebuilt system's first KF
        # starts here instead of the gravity-aligned origin
        # (SlamNode.cpp:174-189 curPose carry + FullSystem.cpp:1040-1042)
        self.initial_pose: Optional[np.ndarray] = None
        self.host_out = np.zeros(F, np.int64)  # per-slot dead-point counts
        # per-slot caches of marginalized points ([u, v, idepth] rows) — the
        # analog of pointHessiansMarginalized, used by the loop closure
        self._marg_pts_cache: List[list] = [[] for _ in range(F)]
        self._last_dso_error = 1e6

        # stereo scale optimization state (FullSystem.cpp:1117-1180)
        self.stereo = stereo
        if settings.enable_scale_opt and stereo is None:
            raise ValueError("enable_scale_opt requires a StereoCalib")
        self.scale_trapped = False
        self.scale_opt_fails = 0
        self.current_scale = 1.0   # global map->metric scale (HCalib.scale)
        self._pending_right = None

        # spline VIO state (models/imu.py)
        from sos_slam_tpu.models import imu as IM
        self.imu = IM.empty_imu(F) if settings.enable_imu else None
        self.imu_initialized = False
        self.imu_queue: List = []   # (t, acc(3,), gyro(3,)) since last KF
        self.key = jax.random.PRNGKey(3141592)
        self.marg_callbacks = []     # loop-closure hooks: fn(kf_dict)
        self.output_wrappers = []    # Output3DWrapper publishers

        # pipelining of the fused path (default on: sync and pipelined
        # modes consume bit-identical chained device values, pipelining
        # only overlaps readback round trips with later frames' execution;
        # see _add_frame_fused). Depth 3 gives each frame's readback
        # (overlapped across frames by the hostio fetch pool) two full
        # frames of slack to land before its future is joined;
        # SOS_SLAM_PIPE_DEPTH overrides.
        self.pipeline = True
        self.pipeline_depth = int(os.environ.get("SOS_SLAM_PIPE_DEPTH", "3"))
        from collections import deque
        self._pending_fused = deque()  # dispatched, not yet completed
        self._last_chain = None      # last completed frame's chain record
        self._last_frame_was_kf = False
        self._stats_dev = None
        self.pc_l0 = None
        self._last_bg = None         # host-cached gyro bias (fused VIO)
        self._last_dispatch = None   # (kind, args, kwargs) for bench MFU
        self._prior_row_cache = None
        # fused per-frame dispatch with the device-side KF decision
        # (default on for mono vision; see _fused_kf_active)
        self.fused_kf = True
        self.stats = dict(n_kf=0, n_frames=0, opt_ms=[])
        from sos_slam_tpu.utils.telemetry import Telemetry
        self.telemetry = Telemetry()

    # ------------------------------------------------------------------
    # public API (reference FullSystem::addActiveFrame, FullSystem.cpp:616)
    # ------------------------------------------------------------------
    def add_active_frame(self, image: jnp.ndarray, timestamp: float,
                         frame_id: int, exposure: float = 1.0,
                         image_right: Optional[jnp.ndarray] = None,
                         imu_samples=None):
        """imu_samples: iterable of (t, acc(3,), gyro(3,)) since last frame."""
        if self.is_lost:
            return
        if self.settings.enable_imu and imu_samples is not None:
            self.imu_queue.extend(imu_samples)
        if self.settings.enable_imu and not self.initialized \
                and self.initializer is None \
                and len(self.imu_queue) < self.settings.min_g_imu:
            # wait for enough accel samples to estimate gravity
            # (FullSystem.cpp:626-631)
            return
        if self.settings.enable_scale_opt and image_right is not None:
            # right pyramid built lazily only when a KF is made (reference
            # builds the stereo frame only on needToMakeKF)
            self._pending_right = jnp.asarray(image_right, jnp.float32)
        else:
            self._pending_right = None
        shell = FrameShell(id=frame_id, timestamp=timestamp,
                           cam_to_world=np.eye(4), aff=np.zeros(2),
                           shell_idx=len(self.shells))
        self.shells.append(shell)
        self._shell_by_id[shell.id] = shell
        self.stats["n_frames"] += 1

        if not self.initialized:
            pyr, absgrads = build_pyramid(jnp.asarray(image, jnp.float32),
                                          self.n_levels)
            self._initializer_step(pyr, absgrads, shell, exposure)
            return

        # steady path: the pyramid is built INSIDE the fused frame step
        if self._fused_kf_active():
            self._add_frame_fused(image, shell, exposure)
            return
        self.finish_pending()
        with self.telemetry.timed("track"):
            tres, pyr, traced, stats = self._track_new_coarse(
                image, shell, exposure)
        self._finish_tracked(tres, pyr, shell, exposure, traced, stats)

    def _fused_kf_active(self) -> bool:
        """Fused per-frame dispatch: the keyframe decision runs ON DEVICE
        (_need_kf_jit) and the whole keyframe chain dispatches cond-gated
        right behind the frame step — one readback per frame, keyframe or
        not. Covers mono and stereo (the scale solve runs inside the
        chain) and, once the IMU is initialized (5th KF), VIO: the chain
        consumes a host-staged candidate IMU-sample block gated on the
        device keyframe decision, and the host reconciles its sample queue
        from the fetched decision. The VIO bootstrap (gravity init, the
        5th-KF IMU initialization with its host-side failure gate) stays
        on the classic path."""
        if not (self.fused_kf and self.initialized):
            return False
        if self.settings.enable_imu:
            return self.imu_initialized
        return True

    def _pipeline_ready(self) -> bool:
        """Pipelining is active from the first post-initialization frame:
        the keyframe chain derives the bootstrap BA iteration budget
        (20/15 iterations for keyframes 2-3) from the DEVICE-chained
        keyframe count and chains first_rmse, so in-flight dispatches are
        bit-identical to synchronous ones at any bootstrap stage. The
        init-failure RMSE gates stay host-side: a failing bootstrap
        keyframe sets init_failed at completion and the in-flight frames
        are discarded with the rebuilt system. VIO pipelines once the IMU
        is initialized (>= 5 keyframes): IMU staging is
        outcome-independent — the device masks the staged block by the
        in-flight frame's own keyframe decision."""
        if not self.pipeline:
            return False
        return (not self.settings.enable_imu) or self.imu_initialized

    def _add_frame_fused(self, image, shell, exposure):
        """Fused driver: dispatch this frame's step + cond-gated keyframe
        chain, all inputs chained from the newest dispatched frame's chain
        outputs (device handles — no host value in the loop). With
        pipelining on, up to `pipeline_depth` frames stay in flight: their
        readback round trips overlap later frames' execution, and the
        sync and pipelined modes consume bit-identical device values.

        Invalidation at completion time (rare):
        - fallback tracking / lost: every newer in-flight frame consumed
          garbage chained state -> reprocess them synchronously;
        - selector-rung change at a keyframe: in-flight records remain
          valid chaining *sources*, but their chain programs ran the old
          rung -> re-dispatch them chained, with the new rung."""
        q = self._pending_fused
        newest = q[-1] if q else None
        if newest is not None:
            # speculative dispatch from the (not yet read back) chain
            spec = self._dispatch_fused(image, shell, exposure,
                                        chain=newest)
            q.append(spec)
        else:
            # the chain derives the bootstrap BA budget from the device
            # keyframe count, so chaining is valid at any n_kf
            spec = self._dispatch_fused(image, shell, exposure,
                                        chain=self._last_chain)
            q.append(spec)
        depth = self.pipeline_depth if self._pipeline_ready() else 0
        self._drain_pending(depth)

    def _drain_pending(self, depth: int) -> None:
        """Complete in-flight frames until at most `depth` remain,
        handling invalidation of the newer in-flight dispatches."""
        q = self._pending_fused
        while len(q) > depth:
            pot_before = getattr(self, "_sel_pot", 3)
            rec = q.popleft()
            redo = self._complete_fused(rec)
            self._last_chain = None if redo else rec
            if self.is_lost or self.init_failed:
                q.clear()
                return
            if redo:
                # newer in-flight dispatches chained from invalid state:
                # reprocess those frames one by one. The FIRST reprocessed
                # frame starts from host state (chain=None); each further
                # one chains from the previous completed record, exactly
                # as the synchronous driver would — dispatching them all
                # with chain=None diverges bitwise from sync (caught by
                # test_pipeline_invalidation).
                stale = list(q)
                q.clear()
                for r in stale:
                    spec = self._dispatch_fused(
                        r["image"], r["shell"], r["exposure"],
                        chain=self._last_chain,
                        stereo_right=r.get("stereo_right"))
                    redo2 = self._complete_fused(spec)
                    self._last_chain = None if redo2 else spec
                    if self.is_lost or self.init_failed:
                        return
                continue
            if getattr(self, "_sel_pot", 3) != pot_before:
                # selector rung changed: re-dispatch in-flight frames
                # chained (same inputs, new-rung program) in order
                stale = list(q)
                q.clear()
                src = self._last_chain
                for r in stale:
                    spec = self._dispatch_fused(
                        r["image"], r["shell"], r["exposure"], chain=src,
                        stereo_right=r.get("stereo_right"))
                    q.append(spec)
                    src = spec

    def _dispatch_fused(self, image, shell, exposure, chain=None,
                        stereo_right=None):
        """Dispatch the fused frame step + keyframe chain. `chain` is the
        previous frame's record (its chain outputs feed every input);
        None falls back to host-computed inputs (after init, fallback
        tracking, or a selector-rung change). `stereo_right` re-supplies
        a reprocessed frame's own staged (img_right, have_right) pair —
        self._pending_right holds the NEWEST frame's by then."""
        with self.telemetry.timed("fused_dispatch"):
            return self._dispatch_fused_inner(image, shell, exposure, chain,
                                              stereo_right)

    def _dispatch_fused_inner(self, image, shell, exposure, chain=None,
                              stereo_right=None):
        s = self.settings
        intr = self._intr
        pot = getattr(self, "_sel_pot", 3)
        n_slots = min(s.max_immature, self.imm.u.shape[0])

        # stereo inputs (the scale solve runs inside the chain); the mono
        # placeholders are device-resident constants (one upload total, not
        # three fresh device_puts per frame)
        stereo_static = None
        consts = getattr(self, "_mono_stereo_consts", None)
        if consts is None:
            consts = (jnp.zeros((1, 1), jnp.float32), jnp.asarray(False),
                      jnp.eye(4, dtype=jnp.float32))
            self._mono_stereo_consts = consts
        img_right, have_right, T_lr_j = consts
        if s.enable_scale_opt and self.stereo is not None:
            cr = self.stereo.calib_right
            stereo_static = (intr, tuple(cr.intrinsics(l)
                                         for l in range(self.n_levels)))
            T_lr_j = jnp.asarray(self.stereo.T_lr, jnp.float32)
            if stereo_right is not None:
                img_right, have_right = stereo_right
            elif self._pending_right is not None:
                img_right = self._pending_right
                have_right = jnp.asarray(True)
            else:
                img_right = jnp.zeros((cr.heights[0], cr.widths[0]),
                                      jnp.float32)

        if chain is None:
            # lag-aware host staging: when _drain_pending reprocesses an
            # invalidated in-flight frame, newer shells are already
            # appended — address the predecessor by shell index, never
            # by [-2] (lag == 0 for a freshly appended frame)
            lag = len(self.shells) - 1 - shell.shell_idx
            prev_sh = self.shells[shell.shell_idx - 1] \
                if shell.shell_idx >= 1 else None
            hyps, _ = self._motion_hypotheses(lag=lag, no_imu=s.enable_imu)
            aff0 = np.asarray(prev_sh.aff, np.float32) \
                if prev_sh is not None else np.zeros(2, np.float32)
            # numpy throughout: host values ride the jit call's transfer
            # batch (an eager jnp construction is a dispatch of its own)
            T_primary = np.asarray(hyps[0], np.float32)
            T_hyps = np.stack(_pad_hyps(hyps[1:], 5)).astype(np.float32)
            aff0_j = aff0
            th = np.float32(self.last_coarse_rmse[0]
                            * s.re_track_threshold)
            ref_shell = self.shells[self.frame_shell_idx[self.ref_slot]]
            T_ref = np.asarray(ref_shell.cam_to_world, np.float32)
            ref_aff = self.ref_aff   # numpy; jit transfers it
            ref_exp = np.float32(self.ref_exposure)
            T_prev = np.asarray(
                prev_sh.cam_to_world if prev_sh is not None
                else np.eye(4), np.float32)
            prev_was_kf = np.bool_(
                prev_sh.is_kf if prev_sh is not None else False)
            last_rmse0 = np.float32(self.last_coarse_rmse[0])
            n_kf_j = np.int32(len(self.kf_shell_ids))
            host_out_j = np.asarray(self.host_out, np.int32)
            ba_in, imm_in, dI_in = self.ba, self.imm, self.dI
            min_act_in = jnp.asarray(self.current_min_act_dist, jnp.float32)
            HdiF_in, templates_in, pc_in = (self.HdiF, self.templates,
                                            self.pc_l0)
            scale_state = (np.float32(self.current_scale),
                           np.bool_(self.scale_trapped),
                           np.int32(self.scale_opt_fails))
            first_rmse_in = np.float32(self.first_coarse_rmse)
            imu_in = self.imu
            # host queue is fully reconciled here: no device-side masking
            t_last_kf_in = np.float32(-1e30)
        else:
            nxt = chain["nxt"]
            T_primary, aff0_j, th = nxt["T_primary"], nxt["aff"], nxt["th"]
            T_hyps = nxt["T_hyps"]
            T_ref, ref_aff = nxt["T_cw_ref"], nxt["ref_aff"]
            ref_exp = nxt["ref_exp"]
            T_prev = nxt["T_cw_prev"]
            prev_was_kf = chain["need_kf_j"]
            last_rmse0 = nxt["rms0"]
            first_rmse_in = nxt["first_rmse"]
            n_kf_j, host_out_j = nxt["n_kf"], nxt["host_out"]
            scale_state = nxt["scale_state"]
            if s.enable_imu:
                (ba_in, imu_in, imm_in, dI_in, min_act_in, HdiF_in,
                 templates_in, pc_in) = chain["state"]
                # in-flight frames' keyframe decisions govern which staged
                # samples they consumed; the chained last-KF timestamp
                # masks them out (no-op once the host queue is reconciled)
                t_last_kf_in = nxt["t_last_kf"]
            else:
                (ba_in, imm_in, dI_in, min_act_in, HdiF_in, templates_in,
                 pc_in) = chain["state"]

        if s.enable_imu:
            # VIO chain: the candidate IMU block is staged from the host
            # queue WITHOUT consuming it; the device masks out samples the
            # previous (possibly in-flight) frame consumed iff its keyframe
            # decision fired, and _complete_fused reconciles the host queue
            # once that decision is read back.
            acc_s, gyro_s, ts_s, valid_s = self._imu_candidate(shell)
            if chain is not None:
                t_prev_frame = chain["shell"].timestamp
            elif shell.shell_idx >= 1:
                t_prev_frame = self.shells[shell.shell_idx - 1].timestamp
            else:
                t_prev_frame = shell.timestamp - 1.0
            # numpy scalars/arrays ride the jit call's own transfer batch;
            # a jnp.float32(...) here would be a separate EAGER dispatch
            args = (jnp.asarray(image, jnp.float32), ba_in, imu_in, imm_in,
                    dI_in, templates_in, T_primary, T_hyps, T_ref, aff0_j,
                    ref_aff, ref_exp, np.float32(exposure), th,
                    first_rmse_in,
                    self._prior_row(first=False), min_act_in, host_out_j,
                    n_kf_j, self.key, np.int32(shell.id), HdiF_in, pc_in,
                    np.asarray(acc_s, np.float32),
                    np.asarray(gyro_s, np.float32),
                    np.asarray(ts_s, np.float32), np.asarray(valid_s),
                    np.float32(shell.timestamp),
                    np.float32(t_prev_frame - shell.timestamp),
                    t_last_kf_in, T_prev, prev_was_kf, last_rmse0,
                    img_right, have_right, T_lr_j, scale_state,
                    s.max_opt_iterations, s.min_opt_iterations,
                    self.tmpl_sizes, pot,
                    n_slots, s, self.w, self.h, self.n_levels, intr)
            # args kept for post-run cost analysis (bench MFU accounting);
            # promoted to _last_dispatch only when the frame completes as a
            # non-keyframe, so the re-dispatch measurement times the steady
            # per-frame branch, not the cond-gated KF chain
            dispatch_rec = ("vio", args, dict(stereo=stereo_static))
            with self.telemetry.timed("jit_call"):
                pyr, need_kf_j, state_o, nxt_o, raw, fvec, ivec = \
                    _fused_frame_vio_jit(*args, stereo=stereo_static)
        else:
            args = (jnp.asarray(image, jnp.float32), ba_in, imm_in, dI_in,
                    templates_in, T_primary, T_hyps, T_ref, aff0_j,
                    ref_aff, ref_exp, np.float32(exposure), th,
                    first_rmse_in,
                    self._prior_row(first=False), min_act_in, host_out_j,
                    n_kf_j, self.key, np.int32(shell.id), HdiF_in, pc_in,
                    T_prev, prev_was_kf, last_rmse0,
                    img_right, have_right, T_lr_j, scale_state,
                    s.max_opt_iterations, s.min_opt_iterations,
                    self.tmpl_sizes, pot,
                    n_slots, s, self.w, self.h, self.n_levels, intr)
            dispatch_rec = ("mono", args, dict(stereo=stereo_static))
            with self.telemetry.timed("jit_call"):
                pyr, need_kf_j, state_o, nxt_o, raw, fvec, ivec = \
                    _fused_frame_mono_jit(*args, stereo=stereo_static)
        fetch_tree = (fvec, ivec)
        # blocking readback starts NOW on the IO thread; _complete_fused
        # joins the future two frames later, by which time the readback
        # has overlapped with the next frames' dispatch + host work
        fetch_fut = fetch_future(fetch_tree)
        return dict(shell=shell, exposure=exposure, image=image, pyr=pyr,
                    need_kf_j=need_kf_j, state=state_o, nxt=nxt_o,
                    raw_spec=raw, fetch_tree=fetch_tree,
                    fetch_fut=fetch_fut, pot=pot,
                    dispatch_rec=dispatch_rec,
                    vio=s.enable_imu,
                    stereo_right=((img_right, have_right)
                                  if stereo_static is not None else None))

    def _complete_fused(self, p) -> bool:
        """ONE batched readback + host bookkeeping for a dispatched fused
        frame. Returns True when dispatches chained from this frame's
        outputs are invalid (fallback tracking used, or tracking lost)."""
        shell, exposure = p["shell"], p["exposure"]
        vio = p.get("vio", False)
        with self.telemetry.timed("fused_fetch"):
            fut = p.get("fetch_fut")
            fvec, ivec = fut.result() if fut is not None \
                else fetch(p["fetch_tree"])
        unpacked = _unpack_fetch(fvec, ivec, p["raw_spec"])
        if vio:
            (need_kf, out, accept_np, T_cw_new,
             (stats_t, T_cw, affs, marg_np, died, n_have, marg_ks,
              ecols_np, marg_pts, host_out_new, slot, scale_o,
              bg)) = unpacked
            (self.ba, self.imu, self.imm, self.dI,
             self.current_min_act_dist, self.HdiF, self.templates,
             self.pc_l0) = p["state"]
            # gyro bias for the next frames' IMU tracking hypothesis —
            # read back here so _imu_hypothesis never touches device state
            self._last_bg = np.asarray(bg, np.float64)
            if bool(need_kf):
                # the chain consumed the staged sample block on device;
                # mirror it on the host queue (setImuData's split)
                self.imu_queue = [q for q in self.imu_queue
                                  if q[0] > shell.timestamp]
        else:
            (need_kf, out, accept_np, T_cw_new,
             (stats_t, T_cw, affs, marg_np, died, n_have, marg_ks,
              ecols_np, marg_pts, host_out_new, slot,
              scale_o)) = unpacked

            # adopt the chain's post-frame device state (pure passthrough
            # for a non-keyframe — the handles are the same arrays)
            (self.ba, self.imm, self.dI, self.current_min_act_dist,
             self.HdiF, self.templates, self.pc_l0) = p["state"]
        self.host_out = np.asarray(host_out_new, np.int64)

        with self.telemetry.timed("finish_step_host"):
            tres = self._finish_step_host(p, out, accept_np, T_cw_new)
        if tres is None:
            self.is_lost = True
            self._last_frame_was_kf = False
            return True
        traced = bool(accept_np)
        need_kf = bool(need_kf)
        if not need_kf and "dispatch_rec" in p:
            self._last_dispatch = p["dispatch_rec"]
        self._last_frame_was_kf = need_kf
        self.telemetry.count("keyframes" if need_kf else "frames")
        for ow in self.output_wrappers:
            ow.publish_cam_pose(shell, None)

        if not traced:
            # fallback tracking was used: the device chain ran its identity
            # branch (need_kf was gated on accept); decide classically
            need_kf = self._keyframe_decision(tres, shell)
            self._last_frame_was_kf = need_kf
            self._deliver_tracked_frame(p["pyr"], shell, exposure, need_kf,
                                        traced=False, stats=None)
            return True
        if not need_kf:
            return False    # trace already applied inside the step

        # ---- keyframe: host bookkeeping on the fetched values ----
        import time as _time
        t0 = _time.time()
        if int(slot) >= self.F:
            raise RuntimeError("window overflow — marginalization failed")
        with self.telemetry.timed("kf_host"):
            self._finish_kf_fused(p, int(slot), shell, exposure, stats_t,
                                  T_cw, affs, marg_np, n_have, marg_ks,
                                  ecols_np, marg_pts, scale_o)
        self.stats["opt_ms"].append((_time.time() - t0) * 1000.0)
        return False

    def _finish_kf_fused(self, p, slot, shell, exposure, stats_t, T_cw,
                         affs, marg_np, n_have, marg_ks, ecols_np,
                         marg_pts, scale_o=None):
        """Host bookkeeping for a device-decided keyframe (the fetched
        values mirror _kf_finish_vision's single readback)."""
        s = self.settings
        pyr = p["pyr"]
        self.frame_pyramids[slot] = pyr
        self.frame_shell_idx.append(shell.shell_idx)
        self.kf_shell_ids.append(shell.id)
        shell.is_kf = True
        self.stats["n_kf"] += 1
        n_kf = len(self.kf_shell_ids)

        energy, rmse, n_its, n_active, is_lost = stats_t
        self.stats.setdefault("ba_its", []).append(int(n_its))
        rmse = float(rmse)
        if bool(is_lost):
            self.is_lost = True
            return
        if (n_kf == 2 and rmse > 25) or (n_kf == 3 and rmse > 15) or \
                (n_kf == 4 and rmse > 10):
            self.init_failed = True
            return

        for i, sh_idx in enumerate(self.frame_shell_idx):
            self.shells[sh_idx].cam_to_world = T_cw[i]
            self.shells[sh_idx].aff = affs[i]
        self.ref_slot = len(self.frame_shell_idx) - 1
        # numpy storage: an eager jnp.asarray here is a separate
        # device_put per keyframe; numpy rides the next jit call's batch
        self.ref_aff = np.asarray(shell.aff, np.float32)
        self.ref_exposure = exposure
        if s.enable_scale_opt and scale_o is not None:
            s_val, trapped_v, fails_v, err_v = scale_o
            shell.scale_error = float(err_v)
            self.current_scale = float(s_val)
            self.scale_trapped = bool(trapped_v)
            self.scale_opt_fails = int(fails_v)
        elif s.enable_imu and scale_o is not None:
            # VIO-mono: the chain's scale trapping evolved imu.scale on
            # device; mirror the metric scale for camToWorldScaled
            self.current_scale = float(scale_o[0])
        self._update_scaled_poses()

        marg_flags = [int(k) for k in marg_ks if k >= 0]   # descending

        # point-marginalization loop-closure cache (host_out already
        # device-evolved inside the chain and adopted in _complete_fused)
        if marg_np.any():
            b_host, b_u, b_v, b_id = marg_pts
            for hh, uu, vv, ii in zip(b_host[marg_np], b_u[marg_np],
                                      b_v[marg_np], b_id[marg_np]):
                self._marg_pts_cache[int(hh)].append((uu, vv, ii))

        # selector potential adaptation (PixelSelector2.cpp K-model);
        # rung changes take effect at the next keyframe's dispatch. When
        # prewarm() compiled a specific rung set, stay inside it — a rung
        # outside the set costs a multi-minute mid-run chain compile.
        pot = p["pot"]
        density = float(s.desired_immature_density)
        n_have = int(n_have)
        quotia = density / max(n_have, 1)
        redo = None
        if quotia > 1.25 and pot > 1:
            redo = selector.pot_step(pot, up=False)
        elif quotia < 0.25:
            redo = selector.pot_step(pot, up=True)
        if redo is not None and redo != pot:
            warm = getattr(self, "_prewarmed_pots", None)
            if warm is None or redo in warm:
                self._sel_pot = redo

        # publishers: non-final keyframe + depth visualization
        if self.output_wrappers:
            u_t, v_t, id_t, ok_t = fetch(self.pc_l0)
            idmap = np.zeros((self.h, self.w), np.float32)
            sel_ok = ok_t.astype(bool)
            idmap[v_t[sel_ok].astype(int), u_t[sel_ok].astype(int)] = \
                id_t[sel_ok]
            img0 = fetch(pyr[0][..., 0])
            for ow in self.output_wrappers:
                ow.publish_keyframes(dict(shell=shell), final=False)
                ow.push_depth_image(img0, idmap)

        # frame-marginalization host bookkeeping (device work already done)
        for k, (e_col, n_col) in zip(marg_flags, ecols_np):
            sh_idx = self.frame_shell_idx[k]
            self.shells[sh_idx].marginalized_at = len(self.shells)
            kf_record = self._export_kf(k, float(e_col), float(n_col))
            self.frame_pyramids = (self.frame_pyramids[:k]
                                   + self.frame_pyramids[k + 1:] + [None])
            del self.frame_shell_idx[k]
            del self._marg_pts_cache[k]
            self._marg_pts_cache.append([])
            if self.ref_slot > k:
                self.ref_slot -= 1
            for cb in self.marg_callbacks:
                cb(kf_record)
            for ow in self.output_wrappers:
                ow.publish_keyframes(kf_record, final=True)

    def finish_pending(self) -> None:
        """Process all in-flight pipelined frames. Must be called before
        reading trajectories/state at a sequence boundary."""
        self._drain_pending(0)

    def _finish_tracked(self, tres, pyr, shell, exposure, traced, stats):
        if tres is None:
            self.is_lost = True
            self._last_frame_was_kf = False
            return
        need_kf = self._keyframe_decision(tres, shell)
        self._last_frame_was_kf = need_kf
        self.telemetry.count("keyframes" if need_kf else "frames")
        for ow in self.output_wrappers:
            ow.publish_cam_pose(shell, None)
        self._deliver_tracked_frame(pyr, shell, exposure, need_kf,
                                    traced, stats)

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def _initializer_step(self, pyr, absgrads, shell, exposure):
        if self.initializer is None:
            self.initializer = CI.set_first(
                pyr, absgrads, self.calib, self.settings, self.key)
            self.init_first_pyr = pyr
            self.init_first_shell = shell
            self.init_first_exposure = exposure
            shell.is_kf = True
            return
        self.initializer, done = CI.track_frame(
            self.initializer, self.init_first_pyr, pyr, self.calib,
            self.settings)
        if done:
            self._initialize_from_initializer(pyr, shell, exposure)

    def _initialize_from_initializer(self, pyr, shell, exposure):
        """Reference FullSystem::initializeFromInitializer
        (FullSystem.cpp:933-1069), mono path."""
        st = self.initializer
        lv0 = st.levels[0]
        good = lv0.valid & lv0.is_good
        init_scale = float(jnp.sum(jnp.where(good, lv0.iR, 0.0))
                           / jnp.maximum(jnp.sum(good), 1))

        # first KF pose: identity, or gravity-aligned when IMU is enabled
        # (FullSystem.cpp:1012-1043)
        T0 = np.eye(4, dtype=np.float32)
        if self.settings.enable_imu and len(self.imu_queue) >= 1:
            n_g = min(self.settings.min_g_imu, len(self.imu_queue))
            g_imu = np.mean([np.asarray(s[1]) for s in self.imu_queue[:n_g]],
                            axis=0)
            g_imu = g_imu / max(np.linalg.norm(g_imu), 1e-9)
            g_w = np.asarray(self.settings.gravity)
            g_w = g_w / max(np.linalg.norm(g_w), 1e-9)
            v = np.cross(g_imu, g_w)
            s_t, c_t = np.linalg.norm(v), float(g_imu @ g_w)
            axis = v / max(s_t, 1e-9)
            K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]])
            rot_w_i0 = c_t * np.eye(3) + (1 - c_t) * np.outer(axis, axis) \
                + s_t * K
            ric = np.asarray(self.settings.rot_imu_cam).reshape(3, 3)
            T0[:3, :3] = (rot_w_i0 @ ric).astype(np.float32)

        # reinitialization: a carried-over pose overrides the fresh origin
        # (FullSystem.cpp:1040-1042: curPose kept unless ~identity)
        if self.initial_pose is not None and \
                np.linalg.norm(lie.np_se3_log(self.initial_pose)) > 1e-3:
            T0 = np.asarray(self.initial_pose, np.float32)

        first_shell = self.init_first_shell
        prior0 = self._prior_row(first=True)
        self.ba = WIN.insert_frame(
            self.ba, jnp.asarray(T0), jnp.zeros(2),
            jnp.asarray(getattr(self, "init_first_exposure", 1.0),
                        jnp.float32), prior0)
        self.dI = self.dI.at[0].set(self.init_first_pyr[0])
        self.frame_pyramids[0] = self.init_first_pyr
        self.frame_shell_idx = [first_shell.shell_idx]
        self.kf_shell_ids.append(first_shell.id)
        first_shell.is_kf = True
        self.stats["n_kf"] += 1

        # sub-select level-0 initializer points into the window
        keep_p = self.settings.desired_point_density / max(
            float(jnp.sum(good)), 1.0)
        self.key, k = jax.random.split(self.key)
        keep = good & (jax.random.uniform(k, good.shape) < keep_p)

        pat = jnp.asarray(PATTERN_OFFSETS)
        u = lv0.u + 0.5
        v = lv0.v + 0.5
        ptc = interp_bilinear(self.init_first_pyr[0],
                              u[:, None] + pat[None, :, 0],
                              v[:, None] + pat[None, :, 1])
        color = ptc[..., 0]
        g2 = jnp.sum(ptc[..., 1:] ** 2, -1)
        weights = jnp.sqrt(self.settings.outlier_th_sum_component
                           / (self.settings.outlier_th_sum_component + g2))
        keep &= jnp.isfinite(color).all(-1)

        slot, accepted = WIN.scatter_into_free_slots(self.ba.pt_valid, keep)
        self.ba = WIN.insert_points(
            self.ba, slot, accepted,
            host=jnp.zeros_like(lv0.u, jnp.int32),
            u=u, v=v, color=color, weight=weights,
            idepth=lv0.iR / init_scale,
            prior_w=jnp.full(lv0.u.shape, self.settings.idepth_fix_prior),
        )

        # second frame pose: thisToNext with metric-rescaled translation
        T_fn = np.array(st.T)  # first -> new (copy: jax arrays are read-only)
        T_fn[:3, 3] *= init_scale
        T_nf = np.linalg.inv(T_fn)
        first_shell.cam_to_world = T0.astype(np.float64)
        shell.cam_to_world = T0 @ T_nf
        shell.tracking_ref = first_shell.id

        self.initialized = True
        self._deliver_tracked_frame(pyr, shell, exposure, need_kf=True)

    def _prior_row(self, first: bool) -> jnp.ndarray:
        # the steady (non-first) row is a settings constant: keep one
        # device-resident copy instead of a host->device upload per frame
        if not first and self._prior_row_cache is not None:
            return self._prior_row_cache
        s = self.settings
        p = np.zeros(8, np.float32)
        if first:
            p[0:3] = s.initial_trans_prior
            p[3:6] = s.initial_rot_prior
            p[6] = s.initial_aff_a_prior
            p[7] = s.initial_aff_b_prior
        else:
            p[6] = (s.initial_aff_a_prior if s.affine_opt_mode_a < 0
                    else s.affine_opt_mode_a)
            p[7] = (s.initial_aff_b_prior if s.affine_opt_mode_b < 0
                    else s.affine_opt_mode_b)
        row = jnp.asarray(p)
        if not first:
            self._prior_row_cache = row
        return row

    # ------------------------------------------------------------------
    # tracking
    # ------------------------------------------------------------------
    def _motion_hypotheses(self, lag: int = 0,
                           no_imu: bool = False) -> jnp.ndarray:
        """lastF -> new initializations (FullSystem.cpp:148-215).

        lag: how many newer shells follow the frame being tracked (the
        pipelined driver processes frame i while frame i+1's shell is
        already appended).
        no_imu: skip the host IMU-predicted hypothesis (the fused VIO
        dispatch integrates it ON DEVICE from the staged sample block and
        overrides the constant-motion primary there)."""
        ref_shell = self.shells[self.frame_shell_idx[self.ref_slot]]
        T_ref = ref_shell.cam_to_world
        if len(self.shells) >= 3 + lag:
            slast = self.shells[-2 - lag]
            sprelast = self.shells[-3 - lag]
            if slast.pose_valid and sprelast.pose_valid and ref_shell.pose_valid:
                T_sl = slast.cam_to_world
                T_spl = sprelast.cam_to_world
                fh_2_sl = np.linalg.inv(T_spl) @ T_sl   # assumed const motion
                lastF_2_sl = np.linalg.inv(T_sl) @ T_ref
                const = np.linalg.inv(fh_2_sl) @ lastF_2_sl
                dbl = np.linalg.inv(fh_2_sl) @ np.linalg.inv(fh_2_sl) @ lastF_2_sl
                half_xi = 0.5 * lie.np_se3_log(fh_2_sl)
                half = np.linalg.inv(lie.np_se3_exp(half_xi)) @ lastF_2_sl
                hyps = [const, dbl, half, lastF_2_sl, np.eye(4)]
                # IMU-predicted hypothesis first (FullSystem.cpp:163-173):
                # gyro-integrated rotation + constant-velocity translation
                if not no_imu:
                    imu_hyp = self._imu_hypothesis(T_ref, T_sl, const, lag)
                    if imu_hyp is not None:
                        hyps.insert(0, imu_hyp)
            else:
                hyps = [np.eye(4)]
        else:
            hyps = [np.eye(4)]
        base = hyps[0]
        rot_signs = [
            (1,0,0),(0,1,0),(0,0,1),(-1,0,0),(0,-1,0),(0,0,-1),
            (1,1,0),(0,1,1),(1,0,1),(-1,1,0),(0,-1,1),(-1,0,1),
            (1,-1,0),(0,1,-1),(1,0,-1),(-1,-1,0),(0,-1,-1),(-1,0,-1),
            (-1,-1,-1),(-1,-1,1),(-1,1,-1),(-1,1,1),(1,-1,-1),(1,-1,1),
            (1,1,-1),(1,1,1),
        ]
        perturbed = []
        for delta in (0.02, 0.03, 0.04):
            for rs in rot_signs:
                q = np.array([1.0, rs[0] * delta, rs[1] * delta, rs[2] * delta])
                Tp = np.eye(4)
                Tp[:3, :3] = lie.np_quat_to_rot(q)
                perturbed.append(base @ Tp)
        return hyps, perturbed

    def _imu_hypothesis(self, T_ref, T_slast, const_hyp, lag: int = 0):
        """Gyro-integrated rotation prediction for the tracker init."""
        if not (self.settings.enable_imu and self.imu_initialized
                and len(self.shells) >= 2 + lag):
            return None
        from sos_slam_tpu.models import imu as IM
        t0 = self.shells[-2 - lag].timestamp
        t1 = self.shells[-1 - lag].timestamp
        samples = [s for s in self.imu_queue if t0 < s[0] <= t1]
        if len(samples) < 2:
            return None
        bg = getattr(self, "_last_bg", None)
        if bg is None:
            # classic path: the bias lives on device (one fetch per frame);
            # the fused VIO loop reads it back in the batched chain fetch
            newest = len(self.frame_shell_idx) - 1
            bg = np.asarray(self.imu.state[newest]
                            * np.asarray(IM.IMU_SCALE21))[3:6]
        ric = np.asarray(self.settings.rot_imu_cam).reshape(3, 3)
        R = T_slast[:3, :3].copy()
        t_prev = t0
        for (t, _, g) in samples:
            dt = max(t - t_prev, 0.0)
            w_cam = ric.T @ (np.asarray(g) - bg)
            R = R @ lie.np_so3_exp(w_cam * dt)
            t_prev = t
        # translation from the constant-motion hypothesis
        T_pred = T_ref @ np.linalg.inv(const_hyp)   # world pose of new frame
        T_pred = T_pred.copy()
        T_pred[:3, :3] = R
        return np.linalg.inv(T_pred) @ T_ref

    def _track_new_coarse(self, image, shell, exposure):
        """Multi-hypothesis coarse tracking (trackNewCoarse,
        FullSystem.cpp:138-309), with hypotheses batched via vmap.

        Phase 1 (the primary hypothesis, which covers the typical frame)
        runs FUSED with the pyramid build, the conditional immature-point
        trace, and the window stats — one device dispatch per steady-state
        frame. Phases 2/3 fall back to separate batched calls.

        Returns (tres, pyramid, traced, stats): `traced` says the trace
        already ran inside the fused step; `stats` are the per-frame window
        stats for the marginalization flags."""
        p = self._dispatch_frame_step(image, shell, exposure)
        return self._process_frame_step(p)

    def _dispatch_frame_step(self, image, shell, exposure):
        """Dispatch the fused frame step from host-computed inputs (the
        classic path) and start its readback transfers. Returns the
        pending record consumed by _process_frame_step."""
        intr = self._intr
        ref_shell = self.shells[self.frame_shell_idx[self.ref_slot]]

        # host inputs (numpy throughout — eager device ops are dispatches
        # of their own): affine init from the last frame (aff_last_2_l,
        # FullSystem.cpp:148), constant-motion primary hypothesis
        aff0 = np.asarray(self.shells[-2].aff, np.float32) \
            if len(self.shells) >= 2 else np.zeros(2, np.float32)
        hyps, _ = self._motion_hypotheses(lag=0)
        T_primary = jnp.asarray(hyps[0], jnp.float32)
        T_hyps = jnp.asarray(np.stack(_pad_hyps(hyps[1:], 5)), jnp.float32)
        achieve_th = jnp.float32(
            self.last_coarse_rmse[0] * self.settings.re_track_threshold)

        pyr, out_j, imm_new, accept_j, T_cw_new_j, stats = \
            _frame_step_jit(
                jnp.asarray(image, jnp.float32), self.ba, self.imm,
                self.templates, T_primary, T_hyps,
                jnp.asarray(ref_shell.cam_to_world, jnp.float32),
                jnp.asarray(aff0), jnp.asarray(self.ref_aff),
                jnp.float32(self.ref_exposure), jnp.float32(exposure),
                achieve_th,
                self.settings, self.w, self.h, self.n_levels, intr)
        fetch_tree = (out_j, accept_j, T_cw_new_j, (*stats, self.ba.exposure))
        # start the blocking readback NOW on the IO thread: by the time the
        # (possibly next-frame) consumption happens, the RPC round trip has
        # overlapped with dispatch + host work
        fetch_fut = fetch_future(fetch_tree)
        return dict(shell=shell, exposure=exposure, pyr=pyr, out_j=out_j,
                    imm_new=imm_new, accept_j=accept_j,
                    T_cw_new_j=T_cw_new_j, stats_dev=stats,
                    fetch_tree=fetch_tree, fetch_fut=fetch_fut)

    def _process_frame_step(self, p):
        """Consume a pending classic frame-step record: fetch, run the
        fallback phases if the primary was rejected, update the shell.
        Returns (tres, pyramid, traced, stats)."""
        # keep the device-resident stats so a keyframe can dispatch its
        # whole chain (flags included) without another readback
        self._stats_dev = p["stats_dev"]
        fut = p.get("fetch_fut")
        out, accept_np, T_cw_new, stats = fut.result() if fut is not None \
            else fetch(p["fetch_tree"])
        traced = bool(accept_np)
        if traced:
            self.imm = p["imm_new"]
        tres = self._finish_step_host(p, out, accept_np, T_cw_new)
        return tres, p["pyr"], traced, stats

    def _finish_step_host(self, p, out, accept_np, T_cw_new):
        """Shared host completion of a fused frame step: fallback tracking
        phases 2/3 when the primary hypothesis was rejected, then the
        shell pose/affine update. Does NOT touch self.imm (callers adopt
        the device-selected immature state themselves)."""
        shell = p["shell"]
        exposure = p["exposure"]
        pyr = p["pyr"]
        intr = self._intr
        ref_shell = self.shells[self.frame_shell_idx[self.ref_slot]]
        exposures = np.array([self.ref_exposure, exposure], np.float32)

        def run_batch(T_list, aff0, min_level=0):
            Ts = np.stack([np.asarray(t, np.float32) for t in T_list])
            out = TK.track_hypotheses(
                pyr, self.templates, Ts, aff0, self.ref_aff,
                exposures, intr, self.n_levels, min_level=min_level,
                coarse_cutoff_th=self.settings.coarse_cutoff_th,
                huber=self.settings.huber_th,
            )
            return fetch(out)

        def pick(out, lvl=0):
            good = out["good"]
            res = out["residuals"][:, lvl]
            ok = good & np.isfinite(res)
            if not ok.any():
                return None, np.inf
            c = np.where(ok)[0]
            b = c[np.argmin(res[c])]
            return int(b), float(res[b])

        achieve_th = self.last_coarse_rmse[0] * \
            self.settings.re_track_threshold
        best, achieved = pick(out)
        traced = bool(accept_np)
        # `traced` is authoritative: the device-side accept decision also
        # selected which imm to keep, so the host must not second-guess it
        # (f32 vs f64 boundary ties would desync pose and trace)
        if not traced and (best is None or achieved >= achieve_th):
            # the fused step already ran the standard-hypothesis retry
            # (tries 0-4) on device; only the rotation-perturbed restart
            # phase is left — screened at the coarsest level, full track
            # on the best 2 (FullSystem.cpp:190). Completion may lag the
            # newest appended shell (pipelined driver): address the
            # predecessor by shell index.
            lag = len(self.shells) - 1 - shell.shell_idx
            _, perturbed = self._motion_hypotheses(lag=lag)
            aff0 = np.asarray(self.shells[shell.shell_idx - 1].aff,
                              np.float32) \
                if shell.shell_idx >= 1 else np.zeros(2, np.float32)
            coarse = run_batch(perturbed, aff0,
                               min_level=self.n_levels - 1)
            res_c = coarse["residuals"][:, self.n_levels - 1]
            res_c = np.where(np.isfinite(res_c), res_c, np.inf)
            top2 = np.argsort(res_c)[:2]
            out3 = run_batch(_pad_hyps([perturbed[i] for i in top2], 5),
                             aff0)
            b3, a3 = pick(out3)
            if b3 is not None and a3 < achieved:
                out, best, achieved = out3, b3, a3

        if best is None:
            shell.pose_valid = False
            shell.cam_to_world = \
                self.shells[shell.shell_idx - 1].cam_to_world \
                if shell.shell_idx >= 1 else np.eye(4)
            return None

        T_ref_to_new = out["T"][best]
        aff = out["aff"][best]
        flow = out["flow"][best]
        residuals = out["residuals"][best]

        shell.cam_to_world = T_cw_new if traced else \
            ref_shell.cam_to_world @ np.linalg.inv(T_ref_to_new)
        shell.aff = aff
        shell.tracking_ref = ref_shell.id

        self.last_coarse_rmse = np.where(np.isfinite(residuals), residuals,
                                         self.last_coarse_rmse)
        if self.first_coarse_rmse < 0:
            self.first_coarse_rmse = float(residuals[0])
        return dict(res=residuals, flow=flow, aff=aff,
                    T_ref_to_new=T_ref_to_new, exposure=exposure)

    def _keyframe_decision(self, tres, shell) -> bool:
        """Optical-flow/brightness heuristic (FullSystem.cpp:709-732)."""
        s = self.settings
        if len(self.kf_shell_ids) == 0:
            return True
        a_ref = np.exp(tres["aff"][0]) * tres["exposure"] / max(self.ref_exposure, 1e-9)
        flow_t, flow_rt = tres["flow"]
        wh = self.w + self.h
        score = (
            s.kf_global_weight * s.max_shift_weight_t * np.sqrt(max(flow_t, 0)) / wh
            + s.kf_global_weight * s.max_shift_weight_rt * np.sqrt(max(flow_rt, 0)) / wh
            + s.kf_global_weight * s.max_affine_weight * abs(np.log(max(a_ref, 1e-9)))
        )
        return bool(score > 1.0 or
                    2.0 * self.first_coarse_rmse < tres["res"][0])

    # ------------------------------------------------------------------
    # keyframe pipeline
    # ------------------------------------------------------------------
    def _deliver_tracked_frame(self, pyr, shell, exposure, need_kf,
                               traced=False, stats=None):
        if need_kf:
            self._make_keyframe(pyr, shell, exposure, traced, stats)
        elif not traced:
            self._trace_new_coarse(pyr, shell, exposure)

    def _host_to_new_transforms(self, T_cw_new):
        """Per-host-slot KRKi/Kt/aff into an (external) new frame."""
        return _host_to_new_transforms_jit(
            self.ba, jnp.asarray(T_cw_new, jnp.float32))

    def _trace_new_coarse(self, pyr, shell, exposure):
        """Trace all immature points onto this (non-key)frame
        (traceNewCoarse, FullSystem.cpp:311-361)."""
        self.imm = _trace_jit(
            self.ba, self.imm, pyr[0],
            jnp.asarray(shell.cam_to_world, jnp.float32),
            jnp.asarray(shell.aff, jnp.float32), jnp.asarray(exposure),
            self.w, self.h, self.settings)

    def _make_keyframe(self, pyr, shell, exposure, traced=False,
                        stats=None):
        import time as _time
        t0 = _time.time()
        s = self.settings

        vision = not s.enable_imu
        if traced:
            # trace + stats already ran inside the fused frame step
            stats_dev = self._stats_dev
            stats_np = stats
        else:
            # fused trace + per-frame stats (one dispatch)
            self.imm, pt_in, imm_in, aff_j, T_cw_stats = _trace_stats_jit(
                self.ba, self.imm, pyr[0],
                jnp.asarray(shell.cam_to_world, jnp.float32),
                jnp.asarray(shell.aff, jnp.float32), jnp.asarray(exposure),
                self.w, self.h, s)
            stats_dev = (pt_in, imm_in, aff_j, T_cw_stats)
            stats_np = None

        if vision:
            # device-side flags: the whole KF chain dispatches with no
            # intermediate readback (flags fetched with the final batch)
            pt_in, imm_in, aff_j, T_cw_stats = stats_dev
            flags_j, marg_ks_j = _flag_frames_jit(
                pt_in, imm_in, aff_j, T_cw_stats, self.ba.exposure,
                self.ba.frame_valid, jnp.asarray(self.host_out),
                jnp.int32(len(self.kf_shell_ids)), s)
            marg_flags = None
        elif len(self.frame_shell_idx) >= s.min_frames:
            if stats_np is None:
                stats_np = fetch((*stats_dev, self.ba.exposure))
            marg_flags = self._flag_frames_for_marginalization(stats_np)
        else:
            marg_flags = []

        # insert frame (+ level-0 image) in one dispatch
        slot = len(self.frame_shell_idx)
        if slot >= self.F:
            raise RuntimeError("window overflow — marginalization failed")
        first = len(self.kf_shell_ids) == 0
        prior_row = self._prior_row(first=first)
        self.frame_pyramids[slot] = pyr
        self.frame_shell_idx.append(shell.shell_idx)
        self.kf_shell_ids.append(shell.id)
        shell.is_kf = True
        self.stats["n_kf"] += 1
        n_kf = len(self.kf_shell_ids)

        # windowed-BA iteration budget (higher during bootstrap)
        max_its = s.max_opt_iterations
        if n_kf < 3:
            max_its = 20
        elif n_kf < 4:
            max_its = 15

        if not s.enable_imu:
            self._kf_finish_vision(pyr, shell, exposure, prior_row, slot,
                                   n_kf, max_its, flags_j, marg_ks_j)
            self.stats["opt_ms"].append((_time.time() - t0) * 1000.0)
            return
        else:
            self.ba, self.dI = _insert_frame_jit(
                self.ba, self.dI, pyr[0],
                jnp.asarray(shell.cam_to_world, jnp.float32),
                jnp.asarray(shell.aff, jnp.float32),
                jnp.asarray(exposure, jnp.float32),
                prior_row, jnp.int32(slot))

            # IMU data intake + spline propagation for the new KF
            self._set_imu_data(slot, shell)
            if self.imu_initialized:
                self._propagate_imu(slot, shell)

            # activate points
            self._activate_points()

            # IMU initialization at the 5th keyframe (FullSystem.cpp:841-848)
            if n_kf == 5 and not self.imu_initialized:
                from sos_slam_tpu.models import imu as IM
                self.imu, ok = IM.initialize_imu(self.ba, self.imu, s)
                if not bool(ok):
                    self.init_failed = True
                    return
                self.imu_initialized = True

            # windowed BA (VIO: the full solve chain in one dispatch)
            if self.imu_initialized:
                (self.ba, self.imu, stats, self.HdiF, self.templates,
                 self.pc_l0, T_cw_j, affs_j) = _kf_core_vio_jit(
                    self.ba, self.imu, self.dI, pyr, s, self.w, self.h,
                    self.tmpl_sizes, max_its, s.min_opt_iterations)
            else:
                (self.ba, stats, self.HdiF, self.templates, self.pc_l0,
                 T_cw_j, affs_j) = _kf_core_jit(
                    self.ba, self.dI, pyr, s, self.w, self.h,
                    self.tmpl_sizes, max_its, s.min_opt_iterations)

        # ONE batched readback: BA stats + optimized poses + affines
        stats, T_cw, affs = fetch((stats, T_cw_j, affs_j))
        rmse = float(stats["rmse"])
        if bool(stats["is_lost"]):
            self.is_lost = True
            return
        if (n_kf == 2 and rmse > 25) or (n_kf == 3 and rmse > 15) or \
                (n_kf == 4 and rmse > 10):
            self.init_failed = True
            return

        for i, sh_idx in enumerate(self.frame_shell_idx):
            self.shells[sh_idx].cam_to_world = T_cw[i]
            self.shells[sh_idx].aff = affs[i]

        self.ref_slot = len(self.frame_shell_idx) - 1
        # numpy storage: an eager jnp.asarray here is a separate
        # device_put per keyframe; numpy rides the next jit call's batch
        self.ref_aff = np.asarray(shell.aff, np.float32)
        self.ref_exposure = exposure

        # stereo scale optimization (optimizeScale, FullSystem.cpp:1117-1180)
        if self.settings.enable_scale_opt:
            self._optimize_scale(shell)

        # IMU post-BA bookkeeping: scale trapping + FEJ reset at init KF
        if self.imu_initialized:
            from sos_slam_tpu.models import imu as IM
            if n_kf == 5:
                self.imu = self.imu._replace(state_zero=self.imu.state)
            if s.enable_scale_opt:
                self.imu = self.imu._replace(
                    scale=jnp.float32(self.current_scale / IM.SCALE_SCALE),
                    scale_trapped=jnp.array(True))
            elif not bool(self.imu.scale_trapped):
                self.imu = IM.try_trap_scale(self.imu, s.scale_trap_thres)
                if bool(self.imu.scale_trapped):
                    self.imu = self.imu._replace(state_zero=self.imu.state)
            self.current_scale = float(self.imu.scale) * IM.SCALE_SCALE \
                if not s.enable_scale_opt else self.current_scale
        self._last_bg = None   # device bias moved; drop the host cache
        self._update_scaled_poses()

        # flag points for removal / marginalization
        self._flag_and_marginalize_points(marg_flags)

        # publishers: non-final keyframe + depth visualization
        if self.output_wrappers:
            u_t, v_t, id_t, ok_t = fetch(self.pc_l0)
            idmap = np.zeros((self.h, self.w), np.float32)
            sel_ok = ok_t.astype(bool)
            idmap[v_t[sel_ok].astype(int), u_t[sel_ok].astype(int)] = \
                id_t[sel_ok]
            img0 = fetch(pyr[0][..., 0])
            for ow in self.output_wrappers:
                ow.publish_keyframes(dict(shell=shell), final=False)
                ow.push_depth_image(img0, idmap)

        # new immature points on the new KF
        self._make_new_traces(pyr, slot)

        # marginalize flagged frames
        self._marginalize_frames(marg_flags)

        self.stats["opt_ms"].append((_time.time() - t0) * 1000.0)


    def _kf_finish_vision(self, pyr, shell, exposure, prior_row, slot,
                          n_kf, max_its, flags_j, marg_ks_j):
        """Pure-vision keyframe finish: dispatch EVERY device program first
        (mega BA step, point-marg + selection, cond-gated frame
        marginalizations — the device executes them in order with no host
        sync between; the marginalization flags are device values from
        _flag_frames_jit), then do ONE batched readback and run all host
        bookkeeping on numpy.

        Each host sync stalls the dispatch queue, so the KF path has
        exactly one."""
        s = self.settings

        # --- dispatch phase (no host syncs) ---
        (self.ba, self.imm, self.dI, self.current_min_act_dist, stats,
         self.HdiF, self.templates, self.pc_l0, T_cw_j, affs_j) = \
            _kf_mega_jit(
                self.ba, self.imm, self.dI, pyr,
                jnp.asarray(shell.cam_to_world, jnp.float32),
                jnp.asarray(shell.aff, jnp.float32),
                jnp.asarray(exposure, jnp.float32), prior_row,
                jnp.int32(slot),
                jnp.asarray(self.current_min_act_dist, jnp.float32),
                self.tmpl_sizes, max_its, s.min_opt_iterations,
                s, self.w, self.h)

        density = float(s.desired_immature_density)
        pot = getattr(self, "_sel_pot", 3)
        n_slots = min(s.max_immature, self.imm.u.shape[0])
        ba_pre_marg = self.ba        # pre-marg arrays for the loop cache
        imm_pre_select = self.imm    # for the rare pot-retry re-selection
        k2 = jax.random.fold_in(self.key, shell.id)
        self.ba, self.imm, marg_j, died_j, n_have_j = _marg_select_jit(
            ba_pre_marg, imm_pre_select, self.dI, self.HdiF,
            flags_j, pyr[0], jnp.int32(slot), k2,
            jnp.float32(density), s, self.w, self.h, pot, n_slots)

        ecols_j = []
        for j in range(MAX_MARG_FRAMES):
            self.ba, self.imm, self.dI, e_col, n_col = _maybe_marg_frame_jit(
                self.ba, self.imm, self.dI, marg_ks_j, j, s, self.w, self.h)
            ecols_j.append((e_col, n_col))

        # --- single batched readback ---
        (stats, T_cw, affs, marg_np, died, n_have, marg_ks, ecols_np,
         b_host, b_u, b_v, b_id) = fetch(
            (stats, T_cw_j, affs_j, marg_j, died_j, n_have_j, marg_ks_j,
             ecols_j,
             ba_pre_marg.host, ba_pre_marg.u, ba_pre_marg.v,
             ba_pre_marg.idepth))
        marg_flags = [int(k) for k in marg_ks if k >= 0]   # descending

        # --- host finish (numpy only) ---
        rmse = float(stats["rmse"])
        if bool(stats["is_lost"]):
            self.is_lost = True
            return
        if (n_kf == 2 and rmse > 25) or (n_kf == 3 and rmse > 15) or \
                (n_kf == 4 and rmse > 10):
            self.init_failed = True
            return

        for i, sh_idx in enumerate(self.frame_shell_idx):
            self.shells[sh_idx].cam_to_world = T_cw[i]
            self.shells[sh_idx].aff = affs[i]
        self.ref_slot = len(self.frame_shell_idx) - 1
        # numpy storage: an eager jnp.asarray here is a separate
        # device_put per keyframe; numpy rides the next jit call's batch
        self.ref_aff = np.asarray(shell.aff, np.float32)
        self.ref_exposure = exposure

        # stereo scale optimization (optimizeScale, FullSystem.cpp:1117-1180)
        if s.enable_scale_opt:
            self._optimize_scale(shell)
        self._update_scaled_poses()

        # point-marginalization bookkeeping + loop-closure cache
        self.host_out += died
        if marg_np.any():
            for hh, uu, vv, ii in zip(b_host[marg_np], b_u[marg_np],
                                      b_v[marg_np], b_id[marg_np]):
                self._marg_pts_cache[int(hh)].append((uu, vv, ii))

        # selector potential adaptation (PixelSelector2.cpp K-model); the
        # same-KF re-selection runs only when no frame is being marginalized
        # (afterwards the immature host indices have already been remapped)
        n_have = int(n_have)
        quotia = density / max(n_have, 1)
        redo = None
        if quotia > 1.25 and pot > 1:
            redo = selector.pot_step(pot, up=False)
        elif quotia < 0.25:
            redo = selector.pot_step(pot, up=True)
        warm = getattr(self, "_prewarmed_pots", None)
        if redo is not None and warm is not None and redo not in warm:
            redo = None
        if redo is not None and redo != pot:
            pot = redo
            if not marg_flags:
                k2 = jax.random.fold_in(
                    jax.random.fold_in(self.key, shell.id), 1)
                self.imm, _ = _select_insert_jit(
                    imm_pre_select, pyr[0], jnp.int32(slot), k2,
                    jnp.float32(density), s, pot, n_slots)
        self._sel_pot = pot

        # publishers: non-final keyframe + depth visualization
        if self.output_wrappers:
            u_t, v_t, id_t, ok_t = fetch(self.pc_l0)
            idmap = np.zeros((self.h, self.w), np.float32)
            sel_ok = ok_t.astype(bool)
            idmap[v_t[sel_ok].astype(int), u_t[sel_ok].astype(int)] = \
                id_t[sel_ok]
            img0 = fetch(pyr[0][..., 0])
            for ow in self.output_wrappers:
                ow.publish_keyframes(dict(shell=shell), final=False)
                ow.push_depth_image(img0, idmap)

        # frame-marginalization host bookkeeping (device work already done);
        # marg_flags is descending so each deletion leaves lower slots valid
        for k, (e_col, n_col) in zip(marg_flags, ecols_np):
            sh_idx = self.frame_shell_idx[k]
            self.shells[sh_idx].marginalized_at = len(self.shells)
            kf_record = self._export_kf(k, float(e_col), float(n_col))
            self.frame_pyramids = (self.frame_pyramids[:k]
                                   + self.frame_pyramids[k + 1:] + [None])
            del self.frame_shell_idx[k]
            self.host_out[k:-1] = self.host_out[k + 1:]
            self.host_out[-1] = 0
            del self._marg_pts_cache[k]
            self._marg_pts_cache.append([])
            if self.ref_slot > k:
                self.ref_slot -= 1
            for cb in self.marg_callbacks:
                cb(kf_record)
            for ow in self.output_wrappers:
                ow.publish_keyframes(kf_record, final=True)

    # ------------------------------------------------------------------
    def _imu_candidate(self, shell):
        """Stage the padded IMU-sample block this frame WOULD consume if
        the device keyframe decision fires (the same split _set_imu_data
        performs) — without touching the host queue. Returns numpy
        (acc, gyro, ts, valid); spline validity and the in-flight-previous-
        frame consumption mask are derived on device (_fused_frame_vio_jit /
        _kf_chain_vio_jit), so the staging is outcome-independent."""
        from sos_slam_tpu.models import imu as IM
        samples = [q for q in self.imu_queue if q[0] <= shell.timestamp]
        samples = samples[-IM.N_IMU:]
        n = len(samples)
        acc = np.zeros((IM.N_IMU, 3), np.float32)
        gyro = np.zeros((IM.N_IMU, 3), np.float32)
        ts = np.zeros(IM.N_IMU, np.float32)
        for i, (t, a, g) in enumerate(samples):
            acc[i] = a
            gyro[i] = g
            ts[i] = t - shell.timestamp
        valid = np.arange(IM.N_IMU) < n
        return acc, gyro, ts, valid

    def _set_imu_data(self, slot: int, shell):
        """Fill the new KF's padded IMU-sample arrays from the host queue
        (FrameHessian::setImuData) and clear the queue."""
        from sos_slam_tpu.models import imu as IM
        samples = [s for s in self.imu_queue if s[0] <= shell.timestamp]
        self.imu_queue = [s for s in self.imu_queue if s[0] > shell.timestamp]
        samples = samples[-IM.N_IMU:]
        n = len(samples)
        acc = np.zeros((IM.N_IMU, 3), np.float32)
        gyro = np.zeros((IM.N_IMU, 3), np.float32)
        ts = np.zeros(IM.N_IMU, np.float32)
        for i, (t, a, g) in enumerate(samples):
            acc[i] = a
            gyro[i] = g
            ts[i] = t - shell.timestamp
        valid = np.arange(IM.N_IMU) < n
        # spline validity: consecutive KFs close enough in time (the
        # previous timestamp is host-known from the shells)
        sv = False
        if slot > 0:
            prev_sh = self.shells[self.frame_shell_idx[slot - 1]]
            dt = shell.timestamp - prev_sh.timestamp
            sv = (n > 3) and dt < self.settings.max_imu_interval
        self.imu = _set_imu_jit(
            self.imu, jnp.int32(slot), jnp.asarray(acc), jnp.asarray(gyro),
            jnp.asarray(ts), jnp.asarray(valid),
            jnp.float32(shell.timestamp), jnp.asarray(sv))

    def _propagate_imu(self, slot: int, shell):
        """propagateImuState for the incoming KF (HessianBlocks.cpp:357-404)."""
        from sos_slam_tpu.models import imu as IM
        prev = slot - 1
        last_bias = (self.imu.state[prev] * IM.IMU_SCALE21)[:6]
        last_R = jnp.asarray(
            self.shells[self.frame_shell_idx[prev]].cam_to_world[:3, :3],
            jnp.float32)
        prev_t = self.shells[self.frame_shell_idx[prev]].timestamp
        self.imu = IM.propagate_imu_state(
            self.imu, slot, jnp.float32(prev_t),
            self.imu.vel[prev], last_R, last_bias, self.settings)

    def _optimize_scale(self, shell):
        """Per-KF stereo 1-DoF scale solve with trapping / fail counting
        (FullSystem::optimizeScale)."""
        from sos_slam_tpu.ops import scale_opt as SO
        if self._pending_right is None:
            shell.scale_error = -1.0
            return
        pyr_r, _ = build_pyramid(self._pending_right,
                                 self.stereo.calib_right.levels)
        T_lr = jnp.asarray(self.stereo.T_lr, jnp.float32)
        R01, t01 = T_lr[:3, :3], T_lr[:3, 3]
        intr0 = tuple(self.calib.intrinsics(l) for l in range(self.n_levels))
        intr1 = tuple(self.stereo.calib_right.intrinsics(l)
                      for l in range(self.n_levels))
        if self.scale_trapped:
            s, err = SO.optimize_scale(
                pyr_r, self.templates, jnp.float32(self.current_scale),
                R01, t01, intr0, intr1, self.n_levels)
        else:
            s, err = SO.optimize_scale_multi_guess(
                pyr_r, self.templates, R01, t01, intr0, intr1, self.n_levels)
        s, err = (float(x) for x in fetch((s, err)))
        ok = 0 < err < self.settings.scale_opt_thres
        self.scale_opt_fails = 0 if ok else self.scale_opt_fails + 1
        if self.scale_opt_fails > 5:
            self.scale_trapped = False
        shell.scale_error = err
        if ok:
            self.current_scale = s
            self.scale_trapped = True

    def _update_scaled_poses(self):
        """camToWorldScaled chain (FullSystemOptimize.cpp:437-456): every
        window shell takes the CURRENT global scale, then the scaled chain
        is rebuilt through each frame's tracking reference."""
        by_id = self._shell_by_id
        for i in self.frame_shell_idx:
            sh = self.shells[i]
            sh.scale = self.current_scale
            ref = by_id.get(sh.tracking_ref) if sh.tracking_ref is not None \
                else None
            if ref is None or ref.cam_to_world_scaled is None:
                sh.cam_to_world_scaled = sh.cam_to_world.copy()
                continue
            rel = np.linalg.inv(ref.cam_to_world) @ sh.cam_to_world
            rel = rel.copy()
            rel[:3, 3] *= ref.scale
            sh.cam_to_world_scaled = ref.cam_to_world_scaled @ rel

    def _flag_frames_for_marginalization(self, stats=None) -> List[int]:
        """flagFramesForMarginalization (FullSystemMarginalize.cpp:54-141).
        Returns window-slot indices to marginalize AFTER this KF."""
        s = self.settings
        n = len(self.frame_shell_idx)
        if n < s.min_frames:
            return []
        flags = []
        # in = active + immature points, out = cumulative deaths per host
        if stats is None:
            stats = (*_frame_stats_jit(self.ba, self.imm), self.ba.exposure)
        pt_in, imm_in, aff, T_cw_j, exp = fetch(stats)
        for i in range(n):
            n_in = pt_in[i] + imm_in[i]
            n_out = self.host_out[i]
            a_rel = np.exp(aff[n - 1, 0] - aff[i, 0]) * exp[i] / max(exp[n - 1], 1e-9)
            if (n_in < s.min_points_remaining * (n_in + n_out)
                    or abs(np.log(max(a_rel, 1e-9))) > s.max_log_aff_fac_in_window) \
                    and n - len(flags) > s.min_frames:
                flags.append(i)
        if n + 1 - len(flags) >= s.max_frames:
            # drop the frame with the smallest pairwise-distance score
            T_cw = T_cw_j
            best_score, best_i = 1.0, None
            for i in range(n - 1):
                if i == 0 and len(self.kf_shell_ids) <= s.max_frames:
                    continue
                if i in flags:
                    continue
                dist_score = 0.0
                for j in range(n - 1):
                    if j == i:
                        continue
                    # distanceLL: translation norm of the relative pose
                    # (FrameFramePrecalc::set, HessianBlocks.cpp:431-461)
                    d = np.linalg.norm(T_cw[i][:3, 3] - T_cw[j][:3, 3])
                    dist_score += 1.0 / (1e-5 + d)
                d_latest = np.linalg.norm(
                    (np.linalg.inv(T_cw[n - 1]) @ T_cw[i])[:3, 3])
                dist_score *= -np.sqrt(max(d_latest, 1e-9))
                if dist_score < best_score:
                    best_score, best_i = dist_score, i
            if best_i is not None:
                flags.append(best_i)
        return sorted(flags)

    def _activate_points(self):
        """activatePointsMT (FullSystem.cpp:375-531) with brute-force
        distance instead of the BFS distance map."""
        self.ba, self.imm, self.current_min_act_dist = _activate_jit(
            self.ba, self.imm, self.dI,
            jnp.asarray(self.current_min_act_dist, jnp.float32),
            self.w, self.h, self.settings)


    def _flag_and_marginalize_points(self, frame_marg_flags):
        """flagPointsForRemoval + dropPointsF + marginalizePointsF."""
        s = self.settings
        ba = self.ba
        flagged_hosts = np.zeros(self.F, bool)
        for k in frame_marg_flags:
            flagged_hosts[k] = True
        if s.enable_imu and self.imu_initialized:
            marg, drop, died = _flag_points_jit(
                ba, self.HdiF, jnp.asarray(flagged_hosts), s)
            self.ba, self.imu = E.marginalize_points_vio(
                ba, self.imu, self.dI, marg, s, self.w, self.h)
            self.ba = E.drop_points(self.ba, drop)
        else:
            # fused flag + marginalize + drop (one dispatch)
            self.ba, marg, died = _marg_points_jit(
                ba, self.dI, self.HdiF, jnp.asarray(flagged_hosts), s,
                self.w, self.h)
        died, marg_np, b_host, b_u, b_v, b_id = fetch(
            (died, marg, ba.host, ba.u, ba.v, ba.idepth))
        self.host_out += died

        # cache marginalized points per host for the loop-closure export
        # (reads the PRE-marginalization arrays, which `ba` still holds)
        if marg_np.any():
            hosts = b_host[marg_np]
            us = b_u[marg_np]
            vs = b_v[marg_np]
            ids = b_id[marg_np]
            for hh, uu, vv, ii in zip(hosts, us, vs, ids):
                self._marg_pts_cache[int(hh)].append((uu, vv, ii))

    def _make_new_traces(self, pyr, slot):
        """makeNewTraces (FullSystem.cpp:1071-1097): fused gradient
        pyramid + thresholds + selection + density subsample + immature
        construction + pool scatter — one dispatch in the steady state.
        The potential adaptation (PixelSelector2.cpp:146-283 K-model) runs
        on the returned pre-subsample count; a re-selection happens within
        the same KF only when the density is far off (the reference's
        recursion), otherwise the adapted pot applies from the next KF."""
        s = self.settings
        density = float(s.desired_immature_density)
        pot = getattr(self, "_sel_pot", 3)
        n_slots = min(s.max_immature, self.imm.u.shape[0])
        for attempt in range(2):
            self.key, k = jax.random.split(self.key)
            imm_new, n_have_j = _select_insert_jit(
                self.imm, pyr[0], jnp.int32(slot), k, jnp.float32(density),
                s, pot, n_slots)
            n_have = int(n_have_j)
            quotia = density / max(n_have, 1)
            K = n_have * (pot + 1) ** 2
            ideal = selector._snap_pot(
                max(int((K / density) ** 0.5) - 1, 1))
            if attempt == 0 and quotia > 1.25 and pot > 1:
                pot = selector._snap_pot(min(ideal, pot - 1))
                continue
            if attempt == 0 and quotia < 0.25:
                pot = selector._snap_pot(max(ideal, pot + 1))
                continue
            break
        self._sel_pot = pot
        self.imm = imm_new

    def _marginalize_frames(self, flags: List[int]):
        """Marginalize flagged window slots (highest first so indices hold)."""
        for k in sorted(flags, reverse=True):
            sh_idx = self.frame_shell_idx[k]
            self.shells[sh_idx].marginalized_at = len(self.shells)
            if self.settings.enable_imu and self.imu_initialized:
                # export FIRST: dso_error needs the residuals targeting k
                e_col, n_col = _frame_residual_energy(
                    self.ba, self.dI, jnp.int32(k), self.settings,
                    self.w, self.h)
                kf_record = self._export_kf(k, float(e_col), float(n_col))
                self.ba, self.imm = _pre_marg_jit(self.ba, self.imm,
                                                  jnp.int32(k))
                self.ba, self.imu = E.marginalize_frame_vio(
                    self.ba, self.imu, jnp.int32(k), self.settings)
                self.dI = jnp.concatenate(
                    [self.dI[:k], self.dI[k + 1:],
                     jnp.zeros_like(self.dI[:1])], 0)
            else:
                # fused: dso_error energy (pre-marg state) + straggler drop
                # + residual-column kill + frame Schur + dI shift — one call
                self.ba, self.imm, self.dI, e_col, n_col = _marg_frame_jit(
                    self.ba, self.imm, self.dI, jnp.int32(k), self.settings,
                    self.w, self.h)
                e_col, n_col = fetch((e_col, n_col))
                kf_record = self._export_kf(k, float(e_col), float(n_col))
            self.frame_pyramids = (self.frame_pyramids[:k]
                                   + self.frame_pyramids[k + 1:] + [None])
            del self.frame_shell_idx[k]
            self.host_out[k:-1] = self.host_out[k + 1:]
            self.host_out[-1] = 0
            del self._marg_pts_cache[k]
            self._marg_pts_cache.append([])
            if self.ref_slot > k:
                self.ref_slot -= 1
            for cb in self.marg_callbacks:
                cb(kf_record)
            for ow in self.output_wrappers:
                ow.publish_keyframes(kf_record, final=True)

    def _export_kf(self, k: int, e_col: float, n_col: float):
        """Final-KF record for loop closure / output (publishKeyframes
        final=true, LoopHandler.cpp:142-220): metric-rescaled [u, v, idepth]
        points, per-level intensities, dso_error / scale_error. e_col/n_col:
        energy/count of residuals targeting the dying frame, computed on the
        PRE-marginalization state (FullSystemMarginalize.cpp:151-187)."""
        sh = self.shells[self.frame_shell_idx[k]]

        if n_col > 0:
            dso_error = e_col / n_col / n_col
            self._last_dso_error = dso_error
        else:
            dso_error = 10.0 * self._last_dso_error

        if not (self.marg_callbacks or self.output_wrappers):
            # nobody consumes the record: skip the pyramid transfer and
            # the point sampling (they are the expensive parts)
            return dict(shell=sh, slot=k,
                        pts_uvdi=np.zeros((0, 3), np.float32),
                        intensities=np.zeros((0, self.n_levels), np.float32),
                        pyramid=None, dso_error=dso_error,
                        scale_error=sh.scale_error,
                        calib=self.calib.intrinsics(0))

        pts = np.array(self._marg_pts_cache[k], np.float32).reshape(-1, 3)
        scale = max(sh.scale, 1e-9)
        pyramid = self.frame_pyramids[k]
        if len(pts) and pyramid is not None:
            pts_uvdi = pts.copy()
            pts_uvdi[:, 2] = pts[:, 2] / scale    # idepth -> metric
            inten = np.zeros((len(pts), self.n_levels), np.float32)
            pyr_np = fetch(pyramid)   # one batched transfer
            for lvl in range(self.n_levels):
                u = (pts[:, 0] + 0.5) / (1 << lvl) - 0.5
                v = (pts[:, 1] + 0.5) / (1 << lvl) - 0.5
                # host-side numpy sampling: the point count varies per
                # export, so an eager device interp would recompile each time
                inten[:, lvl] = _np_bilinear(pyr_np[lvl][:, :, 0], u, v)
        else:
            pts_uvdi = np.zeros((0, 3), np.float32)
            inten = np.zeros((0, self.n_levels), np.float32)

        return dict(shell=sh, slot=k, pts_uvdi=pts_uvdi, intensities=inten,
                    pyramid=pyramid, dso_error=dso_error,
                    scale_error=sh.scale_error,
                    calib=self.calib.intrinsics(0))

    # ------------------------------------------------------------------
    def prewarm(self, pots=(1, 2, 3, 4)) -> None:
        """Pre-dispatch rare program variants so no XLA compile (or
        multi-second executable cache load) lands inside the steady-state
        loop. Covers: the phase-2 (5-wide full) and phase-3 (78-wide
        coarsest-screen) tracker fallbacks and the selector-potential
        ladder rungs of the makeNewTraces / point-marg programs.

        Pure dispatches on copies of the current state — no state mutated.
        Requires an initialized system with a built tracker template."""
        if not self.initialized or self.templates is None:
            return
        self.finish_pending()
        # record the compiled rung set: the density adaptation clamps
        # its ladder moves to it (a rung outside = multi-minute compile)
        self._prewarmed_pots = {selector._snap_pot(p) for p in pots}
        s = self.settings
        intr = self._intr
        pyr = self.frame_pyramids[self.ref_slot]
        if pyr is None:
            return
        outs = []
        aff0 = jnp.zeros(2, jnp.float32)
        exposures = jnp.ones(2, jnp.float32)
        eye = np.eye(4, dtype=np.float32)
        for width, min_level in ((5, 0), (78, self.n_levels - 1)):
            outs.append(TK.track_hypotheses(
                pyr, self.templates, jnp.asarray(np.stack([eye] * width)),
                aff0, jnp.asarray(self.ref_aff), exposures, intr,
                self.n_levels, min_level=min_level,
                coarse_cutoff_th=s.coarse_cutoff_th, huber=s.huber_th))
        n_slots = min(s.max_immature, self.imm.u.shape[0])
        density = jnp.float32(s.desired_immature_density)
        no_flags = jnp.zeros(self.F, bool)
        for i, pot in enumerate(pots):
            pot = selector._snap_pot(pot)
            k2 = jax.random.fold_in(self.key, 990000 + i)
            outs.append(_select_insert_jit(
                self.imm, pyr[0], jnp.int32(0), k2, density, s, pot,
                n_slots)[1])
            outs.append(_marg_select_jit(
                self.ba, self.imm, self.dI, self.HdiF, no_flags, pyr[0],
                jnp.int32(0), k2, density, s, self.w, self.h, pot,
                n_slots)[4])
            if self._fused_kf_active():
                # the fused chain is one big program per pot rung: compile
                # it (identity-branch dispatch through the production
                # driver so the program structure matches exactly)
                saved_pot = getattr(self, "_sel_pot", 3)
                saved_last = self._last_chain
                self._sel_pot = pot
                dummy = FrameShell(id=990000 + i, timestamp=0.0,
                                   cam_to_world=np.eye(4),
                                   aff=np.zeros(2))
                img0 = jnp.zeros((self.h, self.w), jnp.float32)
                rec = self._dispatch_fused(img0, dummy, 1.0, chain=None)
                outs.append(rec["fetch_tree"])
                self._sel_pot = saved_pot
                self._last_chain = saved_last
        jax.block_until_ready(outs)

    # ------------------------------------------------------------------
    def trajectory(self, scaled: bool = False) -> np.ndarray:
        """poses.txt contract: one row `id x y z` per keyframe
        (LoopHandler::savePose, LoopHandler.cpp:62-76). scaled=True uses the
        metric camToWorldScaled chain (stereo)."""
        self.finish_pending()
        rows = []
        for sh in self.shells:
            if sh.is_kf:
                T = sh.cam_to_world_scaled if (
                    scaled and sh.cam_to_world_scaled is not None
                ) else sh.cam_to_world
                t = T[:3, 3]
                rows.append([sh.id, t[0], t[1], t[2]])
        return np.array(rows)


import functools


@jax.jit
def _host_to_new_transforms_jit(ba, T_cw_new):
    """Per-host-slot KRKi/Kt into an external new frame (one fused call)."""
    T_cw = B.state_to_pose(ba.T_cw_eval, ba.state)
    T_wc_new = lie.se3_inv(T_cw_new)
    rel = jnp.einsum("ij,fjk->fik", T_wc_new, T_cw)
    fx, fy, cx, cy = B.calib_real(ba)
    K = jnp.stack([
        jnp.stack([fx, 0.0 * fx, cx]),
        jnp.stack([0.0 * fx, fy, cy]),
        jnp.stack([0.0 * fx, 0.0 * fx, 1.0 + 0.0 * fx]),
    ])
    Ki = jnp.linalg.inv(K)
    KRKi = jnp.einsum("ij,fjk,kl->fil", K, rel[:, :3, :3], Ki)
    Kt = jnp.einsum("ij,fj->fi", K, rel[:, :3, 3])
    return KRKi, Kt, rel


@functools.partial(jax.jit, static_argnames=("w", "h", "settings"))
def _trace_jit(ba, imm, dI0_new, T_cw_new, aff_new, exposure_new, w, h,
               settings):
    """Fused per-frame trace: transforms + affine + trace_points in ONE
    device call (the per-frame host-device chatter killer)."""
    KRKi, Kt, _ = _host_to_new_transforms_jit(ba, T_cw_new)
    aff_cur = B.aff_real(ba.state)
    affs = TK.aff_from_to(
        ba.exposure, exposure_new,
        aff_cur.T, jnp.broadcast_to(aff_new[:, None], (2, ba.F)),
    ).T
    return TR.trace_points(imm, dI0_new, KRKi, Kt, affs, w, h, settings)


@functools.partial(jax.jit, static_argnames=("w", "h", "settings"))
def _activation_jit(ba, imm, dI, min_act_dist, w, h, settings):
    """Fused candidate gating + distance gating + batched activation GN
    (activatePointsMT, FullSystem.cpp:375-531) in one device call."""
    s = settings
    newest = jnp.sum(ba.frame_valid) - 1
    can = (
        imm.valid
        & ((imm.status == TR.IPS_GOOD) | (imm.status == TR.IPS_SKIPPED)
           | (imm.status == TR.IPS_BADCONDITION) | (imm.status == TR.IPS_OOB))
        & (imm.quality > s.min_trace_quality)
        & ((imm.idepth_max + imm.idepth_min) > 0)
        & jnp.isfinite(imm.idepth_max)
    )
    kill = imm.valid & (~jnp.isfinite(imm.idepth_max)
                        | (imm.status == TR.IPS_OUTLIER))
    pre = B.make_precalc(ba)
    Rn = pre.R[imm.host, newest]
    tn = pre.t[imm.host, newest]
    fx, fy, cx, cy = B.calib_real(ba)
    KliP = jnp.stack([(imm.u - cx) / fx, (imm.v - cy) / fy,
                      jnp.ones_like(imm.u)], -1)
    mid_id = 0.5 * (imm.idepth_min + jnp.where(
        jnp.isfinite(imm.idepth_max), imm.idepth_max, imm.idepth_min))
    ptp = jnp.einsum("nij,nj->ni", Rn, KliP) + tn * mid_id[:, None]
    pu = (ptp[:, 0] / ptp[:, 2] * fx + cx) * 0.5   # level-1 coords
    pv = (ptp[:, 1] / ptp[:, 2] * fy + cy) * 0.5
    inb = (pu > 0) & (pv > 0) & (pu < w // 2) & (pv < h // 2)
    kill |= imm.valid & can & ~inb
    can &= inb

    # exact brute-force distance map (replaces CoarseDistanceMap's BFS)
    Rm = pre.R[ba.host, newest]
    tm = pre.t[ba.host, newest]
    KliPm = jnp.stack([(ba.u - cx) / fx, (ba.v - cy) / fy,
                       jnp.ones_like(ba.u)], -1)
    ptm = jnp.einsum("nij,nj->ni", Rm, KliPm) + tm * ba.idepth[:, None]
    mu = (ptm[:, 0] / ptm[:, 2] * fx + cx) * 0.5
    mv = (ptm[:, 1] / ptm[:, 2] * fy + cy) * 0.5
    m_ok = ba.pt_valid & (ptm[:, 2] > 0)
    dist = _min_dist(pu, pv, mu, mv, m_ok)
    want = can & (dist >= min_act_dist * imm.my_type)

    # compact the candidate set before the expensive 1-DoF GN against all
    # window frames: steady state activates a few hundred points per KF,
    # so running the (N, F, 8)-tap linearizations over the full immature
    # pool wastes >2x the gathers. K keeps headroom over any realistic
    # per-KF activation burst; overflow candidates simply stay immature
    # and activate at the next keyframe.
    N = imm.u.shape[0]
    K = min(1024, N)
    idx, _ = selector.compact_mask_indices(want, K)
    sub = jax.tree.map(lambda a: a[idx], imm)
    from sos_slam_tpu.ops import ba_t as BT
    act_fn = TR.activate_points_t if BT.enabled() else TR.activate_points
    idepth_k, ok_k, _ = act_fn(
        sub, want[idx], dI, pre.R, pre.t, pre.affLL, ba.frame_valid,
        (fx, fy, cx, cy), w, h, settings,
    )
    idepth = jnp.zeros(N, idepth_k.dtype).at[idx].set(idepth_k)
    ok = jnp.zeros(N, bool).at[idx].set(ok_k)
    return want, kill, idepth, ok & want, None


@functools.partial(jax.jit, static_argnames=("settings", "n_slots"))
def _insert_new_traces_jit(imm, dI0, status, slot, settings, n_slots):
    """Fused extraction + immature-point construction + pool scatter —
    one device call per keyframe, no per-slot program variants."""
    u, v, my_type = selector.extract_points(status, n_slots)
    new_pts = TR.init_immature(
        u, v, jnp.zeros_like(u, jnp.int32) + slot, my_type, dI0,
        settings, n_slots)
    slot_idx, accepted = WIN.scatter_into_free_slots(imm.valid, new_pts.valid)
    si = jnp.where(accepted, slot_idx, imm.u.shape[0])

    def put(arr, vals):
        return arr.at[si].set(vals, mode="drop")

    return imm._replace(
        valid=imm.valid.at[si].set(True, mode="drop"),
        host=put(imm.host, new_pts.host),
        u=put(imm.u, new_pts.u), v=put(imm.v, new_pts.v),
        color=put(imm.color, new_pts.color),
        weights=put(imm.weights, new_pts.weights),
        gradH=put(imm.gradH, new_pts.gradH),
        energy_th=put(imm.energy_th, new_pts.energy_th),
        idepth_min=put(imm.idepth_min, jnp.zeros_like(new_pts.u)),
        idepth_max=put(imm.idepth_max, jnp.full_like(new_pts.u, jnp.inf)),
        status=put(imm.status, jnp.full_like(
            new_pts.host, TR.IPS_UNINITIALIZED).astype(jnp.int8)),
        quality=put(imm.quality, jnp.full_like(new_pts.u, 10000.0)),
        my_type=put(imm.my_type, new_pts.my_type),
    )


@jax.jit
def _insert_activated_jit(ba, imm, ok, kill, idepth):
    """Scatter newly-activated points into the window and retire the
    consumed/killed immature slots — one device call."""
    slot, accepted = WIN.scatter_into_free_slots(ba.pt_valid, ok)
    ba = WIN.insert_points(
        ba, slot, accepted, host=imm.host, u=imm.u, v=imm.v,
        color=imm.color, weight=imm.weights, idepth=idepth,
        prior_w=jnp.zeros_like(idepth),
    )
    imm = imm._replace(valid=imm.valid & ~ok & ~kill)
    return ba, imm


def _np_bilinear(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = img.shape
    x0 = np.clip(np.floor(u), 0, w - 2).astype(int)
    y0 = np.clip(np.floor(v), 0, h - 2).astype(int)
    dx = np.clip(u - x0, 0, 1)
    dy = np.clip(v - y0, 0, 1)
    return (img[y0, x0] * (1 - dx) * (1 - dy) + img[y0, x0 + 1] * dx * (1 - dy)
            + img[y0 + 1, x0] * (1 - dx) * dy + img[y0 + 1, x0 + 1] * dx * dy)


def _pad_hyps(hyps, size):
    """Pad a hypothesis list to a fixed batch size (stable jit signatures)."""
    out = list(hyps)[:size]
    while len(out) < size:
        out.append(out[-1] if out else np.eye(4))
    return out


@jax.jit
def _frame_stats_jit(ba, imm):
    """Per-frame point counts + affines + current poses in one call."""
    pt_in = jax.ops.segment_sum(ba.pt_valid.astype(jnp.int32), ba.host, ba.F)
    imm_in = jax.ops.segment_sum(imm.valid.astype(jnp.int32), imm.host, ba.F)
    return pt_in, imm_in, B.aff_real(ba.state), \
        B.state_to_pose(ba.T_cw_eval, ba.state)


MAX_MARG_FRAMES = 4   # >= (max_frames - min_frames) + 1 for the defaults


@functools.partial(jax.jit, static_argnames=("settings",))
def _flag_frames_jit(pt_in, imm_in, aff, T_cw, exp, frame_valid, host_out,
                     n_kf, settings):
    """Device-side flagFramesForMarginalization
    (FullSystemMarginalize.cpp:54-141): lets the whole keyframe chain
    dispatch without a host readback of the window stats.

    Mirrors the host `_flag_frames_for_marginalization` decision exactly
    (same thresholds, same sequential count gating, same latest-frame
    exclusion); pairwise distances use the translation norm of the
    relative transform (distanceLL, HessianBlocks.cpp:431-461).

    Returns (flags (F,) bool, marg_ks (MAX_MARG_FRAMES,) int32 descending
    slot indices padded with -1)."""
    s = settings
    F = pt_in.shape[0]
    n = jnp.sum(frame_valid)
    newest = n - 1
    aff_n = jnp.take(aff[:, 0], newest)
    exp_n = jnp.take(exp, newest)

    flags = jnp.zeros(F, bool)
    cnt = jnp.int32(0)
    for i in range(F):
        n_in = (pt_in[i] + imm_in[i]).astype(jnp.float32)
        n_out = host_out[i].astype(jnp.float32)
        a_rel = jnp.exp(aff_n - aff[i, 0]) * exp[i] / jnp.maximum(exp_n, 1e-9)
        c = (
            ((n_in < s.min_points_remaining * (n_in + n_out))
             | (jnp.abs(jnp.log(jnp.maximum(a_rel, 1e-9)))
                > s.max_log_aff_fac_in_window))
            & ((n - cnt) > s.min_frames) & (i < n)
        )
        flags = flags.at[i].set(c)
        cnt = cnt + c.astype(jnp.int32)

    # distance-score drop when the window would overflow
    need = (n + 1 - cnt) >= s.max_frames
    t = T_cw[:, :3, 3]
    D = jnp.linalg.norm(t[:, None] - t[None, :], axis=-1)        # (F,F)
    idx = jnp.arange(F)
    tgt_ok = (idx < n - 1)[None, :] & (idx[:, None] != idx[None, :])
    inv_sum = jnp.sum(jnp.where(tgt_ok, 1.0 / (1e-5 + D), 0.0), axis=1)
    d_latest = jnp.linalg.norm(
        t - jnp.take(t, newest, axis=0)[None, :], axis=-1)
    score = inv_sum * -jnp.sqrt(jnp.maximum(d_latest, 1e-9))
    skip0 = jnp.asarray(n_kf <= s.max_frames)
    eligible = (idx < n - 1) & ~flags & ~((idx == 0) & skip0)
    score = jnp.where(eligible, score, 2.0)
    best = jnp.argmin(score)
    flags = flags | ((idx == best) & need & (score[best] < 1.0))

    # descending flagged slots, padded with -1
    marked = jnp.where(flags, idx, -1)
    marg_ks, _ = jax.lax.top_k(marked, MAX_MARG_FRAMES)
    return flags, marg_ks


@functools.partial(jax.jit, static_argnames=("sizes", "pot", "n_slots",
                                             "settings", "w", "h", "stereo"))
def _kf_chain_jit(need_kf, ba, imm, dI, pyr, out_step, T_cw_new, exposure,
                  prior_row, min_act_dist, host_out, n_kf, key0, shell_id,
                  stats_dev, HdiF_in, templates_in, pc_in,
                  T_cw_ref_in, ref_aff_in, ref_exp_in, T_cw_prev_in,
                  prev_was_kf, last_rmse0,
                  img_right, have_right, T_lr, scale_state,
                  max_its, min_its, sizes, pot, n_slots, settings, w, h,
                  stereo=None):
    """The ENTIRE keyframe chain (marg flags + insert/activate/BA/template
    + point marg/selection + up to MAX_MARG_FRAMES frame marginalizations),
    cond-gated on the device-side keyframe decision.

    Dispatched EVERY frame right after the fused step: non-keyframes run
    the identity branch (full state passes through untouched), keyframes
    run the full chain. Either way the outputs are the COMPLETE post-frame
    state plus the next frame's dispatch inputs (`nxt`: constant-motion
    primary hypothesis, tracking-reference pose/affine/exposure, achieve
    threshold, device-evolved host_out / keyframe counters) — so the next
    frame's step AND chain can dispatch with zero host readbacks, keyframe
    or not. The host fetches one batched readback per frame, purely for
    bookkeeping.

    Returns (state, readback, nxt):
      state    = (ba, imm, dI, min_act_dist, HdiF, templates, pc_l0)
      readback = (stats5, T_cw_all, affs, marg, died, n_have, marg_ks,
                  ecols, marg_pts, host_out, slot)
      nxt      = dict of next-frame chaining inputs
    """
    s = settings
    slot = jnp.sum(ba.frame_valid).astype(jnp.int32)
    key = jax.random.fold_in(key0, shell_id)
    aff_new = out_step["aff"][0]
    # bootstrap BA budget from the DEVICE-chained keyframe count (incl.
    # this keyframe) — matches _make_keyframe's 20/15-iteration ladder, so
    # in-flight bootstrap keyframes solve with the synchronous budget
    max_its = jnp.where(n_kf + 1 < 3, 20,
                        jnp.where(n_kf + 1 < 4, 15, max_its))

    def run(_):
        pt_in, imm_in, aff_j, T_cw_stats = stats_dev
        flags, marg_ks = _flag_frames_jit(
            pt_in, imm_in, aff_j, T_cw_stats, ba.exposure, ba.frame_valid,
            host_out, n_kf, s)
        (ba2, imm2, dI2, min_act2, stats, HdiF2, templates2, pc2,
         T_cw_all, affs) = _kf_mega_jit(
            ba, imm, dI, pyr, T_cw_new, aff_new, exposure, prior_row,
            slot, min_act_dist, sizes, max_its, min_its, s, w, h)
        marg_pts = (ba2.host, ba2.u, ba2.v, ba2.idepth)  # loop-cache source
        ba3, imm3, marg, died, n_have = _marg_select_jit(
            ba2, imm2, dI2, HdiF2, flags, pyr[0], slot, key,
            jnp.float32(s.desired_immature_density), s, w, h, pot, n_slots)
        host_out2 = host_out + died
        ecols = []
        dimap = jnp.arange(ba.F, dtype=jnp.int32)
        for j in range(MAX_MARG_FRAMES):
            ba3, imm3, dimap, e_col, n_col = _maybe_marg_frame_lean_jit(
                ba3, imm3, dI2, dimap, marg_ks, j, s, w, h)
            host_out2 = _shift_host_out(host_out2, marg_ks[j])
            ecols.append(jnp.stack([e_col, n_col.astype(jnp.float32)]))
        dI3 = _compact_dI(dI2, dimap, jnp.sum(ba3.frame_valid))

        # stereo 1-DoF scale solve on the fresh template (optimizeScale,
        # FullSystem.cpp:1117-1180) with trapping / fail counting
        if stereo is not None:
            from sos_slam_tpu.ops import scale_opt as SO
            intr0, intr1 = stereo
            pyr_r, _ = build_pyramid(img_right, len(pyr))
            s_cur, trapped, fails = scale_state
            R01, t01 = T_lr[:3, :3], T_lr[:3, 3]

            def do_trap(_):
                return SO.optimize_scale(pyr_r, templates2, s_cur, R01,
                                         t01, intr0, intr1, len(pyr))

            def do_multi(_):
                return SO.optimize_scale_multi_guess(
                    pyr_r, templates2, R01, t01, intr0, intr1, len(pyr))

            s_new, err = jax.lax.cond(trapped, do_trap, do_multi, None)
            err = jnp.where(have_right, err, jnp.float32(-1.0))
            ok = (err > 0) & (err < s.scale_opt_thres)
            # no right image: skip the solve entirely (optimizeScale's
            # early return) — no fail-count / trapping update
            fails2 = jnp.where(ok, 0,
                               jnp.where(have_right, fails + 1, fails))
            trapped2 = jnp.where(ok, True,
                                 jnp.where(have_right,
                                           trapped & (fails2 <= 5), trapped))
            scale_out = (jnp.where(ok, s_new, s_cur), trapped2, fails2, err)
        else:
            scale_out = (*scale_state, jnp.float32(-1.0))
        return ((ba3, imm3, dI3, min_act2, HdiF2, templates2, pc2),
                ((stats["energy"], stats["rmse"], stats["n_its"],
                  stats["n_active"], stats["is_lost"]),
                 T_cw_all, affs, marg, died, n_have, marg_ks,
                 jnp.stack(ecols), marg_pts, host_out2, scale_out))

    def skip(_):
        F, P = ba.F, ba.P
        return ((ba, imm, dI, min_act_dist, HdiF_in, templates_in, pc_in),
                ((jnp.float32(0), jnp.float32(0), jnp.int32(0),
                  jnp.int32(0), jnp.array(False)),
                 jnp.zeros((F, 4, 4)), jnp.zeros((F, 2)),
                 jnp.zeros(P, bool), jnp.zeros(F, jnp.int32), jnp.int32(0),
                 jnp.full((MAX_MARG_FRAMES,), -1, jnp.int32),
                 jnp.zeros((MAX_MARG_FRAMES, 2)),
                 (jnp.zeros(P, jnp.int32), jnp.zeros(P), jnp.zeros(P),
                  jnp.zeros(P)),
                 host_out, (*scale_state, jnp.float32(-1.0))))

    state, readback = jax.lax.cond(need_kf, run, skip, None)
    (stats5, T_cw_all, affs, marg, died, n_have, marg_ks, ecols, marg_pts,
     host_out_o, scale_o) = readback

    # ---- next-frame chaining inputs (FullSystem.cpp:148-173 equivalents,
    # computed from the post-frame state so a keyframe needs no redo) ----
    res0 = out_step["residuals"][0, 0]
    rms0 = jnp.where(jnp.isfinite(res0), res0, last_rmse0)
    T_kf = T_cw_all[slot]                   # post-BA pose of this frame
    aff_kf = affs[slot]
    T_me = jnp.where(need_kf, T_kf, T_cw_new)
    T_ref_n = jnp.where(need_kf, T_kf, T_cw_ref_in)
    # the previous frame's final pose: BA moved it iff it was a keyframe
    # (then it sits at window slot slot-1 of the post-BA pose array)
    T_prev_f = jnp.where(need_kf & prev_was_kf,
                         T_cw_all[jnp.maximum(slot - 1, 0)], T_cw_prev_in)
    fh_2_sl = lie.se3_inv(T_prev_f) @ T_me          # assumed const motion
    lastF_2_sl = lie.se3_inv(T_me) @ T_ref_n
    # standard retry hypotheses (trackNewCoarse tries 1-4,
    # FullSystem.cpp:193-208): double / half / last / zero motion
    fh_inv = lie.se3_inv(fh_2_sl)
    dbl = fh_inv @ fh_inv @ lastF_2_sl
    half = lie.se3_exp(-0.5 * lie.se3_log(fh_2_sl)) @ lastF_2_sl
    eye4 = jnp.eye(4)
    nxt = dict(
        T_primary=fh_inv @ lastF_2_sl,
        T_hyps=jnp.stack([dbl, half, lastF_2_sl, eye4, eye4]),
        aff=jnp.where(need_kf, aff_kf, aff_new),
        th=rms0 * s.re_track_threshold,
        rms0=rms0,
        T_cw_ref=T_ref_n,
        ref_aff=jnp.where(need_kf, aff_kf, ref_aff_in),
        ref_exp=jnp.where(need_kf, exposure, ref_exp_in),
        T_cw_prev=T_me,
        n_kf=n_kf + need_kf.astype(jnp.int32),
        host_out=host_out_o,
        scale_state=scale_o[:3],
    )
    readback = (stats5, T_cw_all, affs, marg, died, n_have, marg_ks, ecols,
                marg_pts, host_out_o, slot, scale_o)
    return state, readback, nxt


@functools.partial(jax.jit, static_argnames=("sizes", "pot", "n_slots",
                                             "settings", "w", "h", "stereo"))
def _kf_chain_vio_jit(need_kf, ba, imu, imm, dI, pyr, out_step, T_cw_new,
                      exposure, prior_row, min_act_dist, host_out, n_kf,
                      key0, shell_id, stats_dev, HdiF_in, templates_in,
                      pc_in, acc_s, gyro_s, ts_s, valid_s, timestamp,
                      t_last_kf_in,
                      T_cw_ref_in, ref_aff_in, ref_exp_in, T_cw_prev_in,
                      prev_was_kf, last_rmse0, img_right, have_right, T_lr,
                      scale_state, max_its, min_its, sizes, pot, n_slots,
                      settings, w, h, stereo=None):
    """The VIO keyframe chain, cond-gated on the device keyframe decision:
    insert + IMU sample intake + spline propagation + activation + the
    visual-inertial KKT BA + scale trapping (or the in-chain stereo scale
    solve) + VIO point/frame marginalization + new-trace selection — one
    dispatch, one readback, like the mono/stereo chain. The staged IMU
    block (`valid_s` already masked for an in-flight previous frame's
    keyframe consumption) is consumed on device iff the decision fires;
    spline validity is derived on device from the block and the previous
    window KF's timestamp. Emits the same `nxt` chaining outputs as
    _kf_chain_jit so VIO dispatches chain and pipeline like mono."""
    from sos_slam_tpu.models import imu as IM
    s = settings
    slot = jnp.sum(ba.frame_valid).astype(jnp.int32)
    key = jax.random.fold_in(key0, shell_id)
    aff_new = out_step["aff"][0]
    # bootstrap BA budget from the DEVICE-chained keyframe count (incl.
    # this keyframe) — matches _make_keyframe's 20/15-iteration ladder, so
    # in-flight bootstrap keyframes solve with the synchronous budget
    max_its = jnp.where(n_kf + 1 < 3, 20,
                        jnp.where(n_kf + 1 < 4, 15, max_its))

    def run(_):
        pt_in, imm_in, aff_j, T_cw_stats = stats_dev
        flags, marg_ks = _flag_frames_jit(
            pt_in, imm_in, aff_j, T_cw_stats, ba.exposure, ba.frame_valid,
            host_out, n_kf, s)
        ba2 = WIN.insert_frame(ba, T_cw_new, aff_new, exposure, prior_row)
        dI2 = dI.at[slot].set(pyr[0])
        # spline validity (setImuData, HessianBlocks.h): >3 samples in the
        # consumed block and a bounded gap to the previous window keyframe
        dt_kf = timestamp - imu.timestamps[jnp.maximum(slot - 1, 0)]
        sv = (jnp.sum(valid_s) > 3) & (dt_kf < s.max_imu_interval)
        imu2 = _set_imu_jit(imu, slot, acc_s, gyro_s, ts_s, valid_s,
                            timestamp, sv)
        # spline propagation for the incoming KF (HessianBlocks.cpp:357)
        T_all = B.state_to_pose(ba2.T_cw_eval, ba2.state)
        prev = jnp.maximum(slot - 1, 0)
        last_bias = (imu2.state[prev] * IM.IMU_SCALE21)[:6]
        imu2 = IM.propagate_imu_state(
            imu2, slot, imu2.timestamps[prev], imu2.vel[prev],
            T_all[prev, :3, :3], last_bias, s)
        ba2, imm2, min_act2 = _activate_jit(ba2, imm, dI2, min_act_dist,
                                            w, h, s)
        (ba3, imu3, stats, HdiF2, templates2, pc2, T_cw_all, affs) = \
            _kf_core_vio_jit(ba2, imu2, dI2, pyr, s, w, h, sizes,
                             max_its, min_its)

        # scale: stereo solve in-chain, or mono trapping queue
        if stereo is not None:
            from sos_slam_tpu.ops import scale_opt as SO
            intr0, intr1 = stereo
            pyr_r, _ = build_pyramid(img_right, len(pyr))
            s_cur, trapped, fails = scale_state
            R01, t01 = T_lr[:3, :3], T_lr[:3, 3]

            def do_trap(_):
                return SO.optimize_scale(pyr_r, templates2, s_cur, R01,
                                         t01, intr0, intr1, len(pyr))

            def do_multi(_):
                return SO.optimize_scale_multi_guess(
                    pyr_r, templates2, R01, t01, intr0, intr1, len(pyr))

            s_new, err = jax.lax.cond(trapped, do_trap, do_multi, None)
            err = jnp.where(have_right, err, jnp.float32(-1.0))
            ok = (err > 0) & (err < s.scale_opt_thres)
            fails2 = jnp.where(ok, 0,
                               jnp.where(have_right, fails + 1, fails))
            trapped2 = jnp.where(ok, True,
                                 jnp.where(have_right,
                                           trapped & (fails2 <= 5), trapped))
            s2 = jnp.where(ok, s_new, s_cur)
            imu3 = imu3._replace(scale=s2 / IM.SCALE_SCALE,
                                 scale_trapped=jnp.array(True))
            scale_out = (s2, trapped2, fails2, err)
        else:
            was_trapped = imu3.scale_trapped
            imu_t = IM.try_trap_scale(imu3, s.scale_trap_thres)
            newly = imu_t.scale_trapped & ~was_trapped
            imu_t = imu_t._replace(
                state_zero=jnp.where(newly, imu_t.state, imu_t.state_zero))
            imu3 = jax.tree.map(
                lambda a, b: jnp.where(was_trapped, a, b), imu3, imu_t)
            scale_out = (imu3.scale * IM.SCALE_SCALE, imu3.scale_trapped,
                         jnp.int32(0), jnp.float32(-1.0))

        # VIO point marginalization + new-trace selection
        marg, drop, died = _flag_points_jit(ba3, HdiF2, flags, s)
        marg_pts = (ba3.host, ba3.u, ba3.v, ba3.idepth)
        ba4, imu5 = E.marginalize_points_vio(ba3, imu3, dI2, marg, s, w, h)
        ba4 = E.drop_points(ba4, drop)
        imm3, n_have = _select_insert_jit(
            imm2, pyr[0], slot, key,
            jnp.float32(s.desired_immature_density), s, pot, n_slots)

        host_out2 = host_out + died
        ecols = []
        dimap = jnp.arange(ba.F, dtype=jnp.int32)
        for j in range(MAX_MARG_FRAMES):
            (ba4, imm3, imu5, dimap, e_col,
             n_col) = _maybe_marg_frame_vio_lean_jit(
                ba4, imm3, imu5, dI2, dimap, marg_ks, j, s, w, h)
            host_out2 = _shift_host_out(host_out2, marg_ks[j])
            ecols.append(jnp.stack([e_col, n_col.astype(jnp.float32)]))
        dI3 = _compact_dI(dI2, dimap, jnp.sum(ba4.frame_valid))

        newest = jnp.sum(ba4.frame_valid).astype(jnp.int32) - 1
        bg = (imu5.state[newest] * IM.IMU_SCALE21)[3:6]
        return ((ba4, imu5, imm3, dI3, min_act2, HdiF2, templates2, pc2),
                ((stats["energy"], stats["rmse"], stats["n_its"],
                  stats["n_active"], stats["is_lost"]),
                 T_cw_all, affs, marg, died, n_have, marg_ks,
                 jnp.stack(ecols), marg_pts, host_out2, scale_out, bg))

    def skip(_):
        F, P = ba.F, ba.P
        newest = jnp.maximum(jnp.sum(ba.frame_valid) - 1, 0)
        bg = (imu.state[newest] * IM.IMU_SCALE21)[3:6]
        return ((ba, imu, imm, dI, min_act_dist, HdiF_in, templates_in,
                 pc_in),
                ((jnp.float32(0), jnp.float32(0), jnp.int32(0),
                  jnp.int32(0), jnp.array(False)),
                 jnp.zeros((F, 4, 4)), jnp.zeros((F, 2)),
                 jnp.zeros(P, bool), jnp.zeros(F, jnp.int32), jnp.int32(0),
                 jnp.full((MAX_MARG_FRAMES,), -1, jnp.int32),
                 jnp.zeros((MAX_MARG_FRAMES, 2)),
                 (jnp.zeros(P, jnp.int32), jnp.zeros(P), jnp.zeros(P),
                  jnp.zeros(P)),
                 host_out, (*scale_state, jnp.float32(-1.0)), bg))

    state, readback = jax.lax.cond(need_kf, run, skip, None)
    (stats5, T_cw_all, affs, marg, died, n_have, marg_ks, ecols, marg_pts,
     host_out_o, scale_o, bg) = readback

    # ---- next-frame chaining inputs (same construction as _kf_chain_jit;
    # the dispatch program overrides the constant-motion primary with the
    # device gyro-integrated IMU hypothesis from its own staged block) ----
    res0 = out_step["residuals"][0, 0]
    rms0 = jnp.where(jnp.isfinite(res0), res0, last_rmse0)
    T_kf = T_cw_all[slot]
    aff_kf = affs[slot]
    T_me = jnp.where(need_kf, T_kf, T_cw_new)
    T_ref_n = jnp.where(need_kf, T_kf, T_cw_ref_in)
    T_prev_f = jnp.where(need_kf & prev_was_kf,
                         T_cw_all[jnp.maximum(slot - 1, 0)], T_cw_prev_in)
    fh_2_sl = lie.se3_inv(T_prev_f) @ T_me
    lastF_2_sl = lie.se3_inv(T_me) @ T_ref_n
    fh_inv = lie.se3_inv(fh_2_sl)
    dbl = fh_inv @ fh_inv @ lastF_2_sl
    half = lie.se3_exp(-0.5 * lie.se3_log(fh_2_sl)) @ lastF_2_sl
    eye4 = jnp.eye(4)
    nxt = dict(
        T_primary=fh_inv @ lastF_2_sl,
        T_hyps=jnp.stack([dbl, half, lastF_2_sl, eye4, eye4]),
        aff=jnp.where(need_kf, aff_kf, aff_new),
        th=rms0 * s.re_track_threshold,
        rms0=rms0,
        T_cw_ref=T_ref_n,
        ref_aff=jnp.where(need_kf, aff_kf, ref_aff_in),
        ref_exp=jnp.where(need_kf, exposure, ref_exp_in),
        T_cw_prev=T_me,
        n_kf=n_kf + need_kf.astype(jnp.int32),
        host_out=host_out_o,
        scale_state=scale_o[:3],
        # most recent device-decided keyframe timestamp: later chained
        # dispatches mask their staged IMU blocks by it (depth-agnostic)
        t_last_kf=jnp.where(need_kf, timestamp, t_last_kf_in),
    )
    readback = (stats5, T_cw_all, affs, marg, died, n_have, marg_ks, ecols,
                marg_pts, host_out_o, slot, scale_o, bg)
    return state, readback, nxt


@functools.partial(jax.jit, static_argnames=("j", "settings", "w", "h"))
def _maybe_marg_frame_vio_jit(ba, imm, dI, imu, marg_ks, j, settings, w, h):
    """cond-gated VIO frame marginalization (dso_error energy + straggler
    cleanup + 29-dim Schur fold + dI compaction), slot marg_ks[j]."""
    k = marg_ks[j]

    def do(args):
        ba_, imm_, dI_, imu_ = args
        e_col, n_col = _frame_residual_energy(ba_, dI_, k, settings, w, h)
        ba_, imm_ = _pre_marg_jit(ba_, imm_, k)
        ba_, imu_ = E.marginalize_frame_vio(ba_, imu_, k, settings)
        F = dI_.shape[0]
        idx = jnp.arange(F)
        src = jnp.minimum(jnp.where(idx < k, idx, idx + 1), F - 1)
        dI_ = dI_[src].at[F - 1].set(0.0)
        return ba_, imm_, dI_, imu_, e_col, n_col

    def skip(args):
        ba_, imm_, dI_, imu_ = args
        return ba_, imm_, dI_, imu_, jnp.float32(0.0), jnp.int32(0)

    return jax.lax.cond(k >= 0, do, skip, (ba, imm, dI, imu))


@functools.partial(jax.jit, static_argnames=("j", "settings", "w", "h"))
def _maybe_marg_frame_jit(ba, imm, dI, marg_ks, j, settings, w, h):
    """cond-gated frame marginalization: slot marg_ks[j] if >= 0, else a
    no-op — lets a fixed number of marginalization programs dispatch
    before the flags are ever read back."""
    k = marg_ks[j]

    def do(args):
        ba_, imm_, dI_ = args
        return _marg_frame_jit(ba_, imm_, dI_, k, settings, w, h)

    def skip(args):
        ba_, imm_, dI_ = args
        return ba_, imm_, dI_, jnp.float32(0.0), jnp.int32(0)

    return jax.lax.cond(k >= 0, do, skip, (ba, imm, dI))


def _maybe_marg_frame_lean_jit(ba, imm, dI, dimap, marg_ks, j, settings,
                               w, h):
    """Cond-gated frame marginalization with dI kept OUT of the cond carry:
    the identity branch of a cond copies every output, and dI is a ~29 MB
    image stack — a full copy per skipped slot. Instead the freed
    slot's physical dI row is tracked in `dimap` (slot -> row) and the
    caller compacts dI ONCE after all marg slots. The dso_error energy
    reads the dying slot's image through dimap."""
    k = marg_ks[j]

    def do(args):
        ba_, imm_, dimap_ = args
        pre = B.make_precalc(ba_)
        energy, new_state = B.linearize_energy_col(
            ba_, pre, dI, k, settings, w, h, row=dimap_[k])
        col = ba_.res_exist[:, k] & ba_.pt_valid & (new_state == B.RES_IN)
        e_col = jnp.sum(jnp.where(col, energy, 0.0))
        n_col = jnp.sum(col)
        ba_, imm_ = _pre_marg_jit(ba_, imm_, k)
        ba_ = E.marginalize_frame(ba_, k)
        F = dimap_.shape[0]
        idx = jnp.arange(F)
        src = jnp.minimum(jnp.where(idx < k, idx, idx + 1), F - 1)
        dimap2 = jnp.where(idx == F - 1, dimap_[k], dimap_[src])
        return ba_, imm_, dimap2, e_col, n_col

    def skip(args):
        ba_, imm_, dimap_ = args
        return ba_, imm_, dimap_, jnp.float32(0.0), jnp.int32(0)

    return jax.lax.cond(k >= 0, do, skip, (ba, imm, dimap))


def _maybe_marg_frame_vio_lean_jit(ba, imm, imu, dI, dimap, marg_ks, j,
                                   settings, w, h):
    """VIO twin of _maybe_marg_frame_lean_jit (29-dim Schur fold)."""
    k = marg_ks[j]

    def do(args):
        ba_, imm_, imu_, dimap_ = args
        pre = B.make_precalc(ba_)
        energy, new_state = B.linearize_energy_col(
            ba_, pre, dI, k, settings, w, h, row=dimap_[k])
        col = ba_.res_exist[:, k] & ba_.pt_valid & (new_state == B.RES_IN)
        e_col = jnp.sum(jnp.where(col, energy, 0.0))
        n_col = jnp.sum(col)
        ba_, imm_ = _pre_marg_jit(ba_, imm_, k)
        ba_, imu_ = E.marginalize_frame_vio(ba_, imu_, k, settings)
        F = dimap_.shape[0]
        idx = jnp.arange(F)
        src = jnp.minimum(jnp.where(idx < k, idx, idx + 1), F - 1)
        dimap2 = jnp.where(idx == F - 1, dimap_[k], dimap_[src])
        return ba_, imm_, imu_, dimap2, e_col, n_col

    def skip(args):
        ba_, imm_, imu_, dimap_ = args
        return ba_, imm_, imu_, dimap_, jnp.float32(0.0), jnp.int32(0)

    return jax.lax.cond(k >= 0, do, skip, (ba, imm, imu, dimap))


def _compact_dI(dI, dimap, n_live):
    """Apply the deferred slot->row compaction: one gather of the stack +
    zeroed freed rows (bitwise what the per-marg in-cond compaction left)."""
    live = (jnp.arange(dI.shape[0]) < n_live).astype(dI.dtype)
    return dI[dimap] * live[:, None, None, None]


@jax.jit
def _pre_marg_jit(ba, imm, k):
    """Straggler-point drop + residual-column kill + immature remap before a
    frame marginalization — one device call."""
    stragglers = ba.pt_valid & (ba.host == k)
    ba = ba._replace(
        pt_valid=ba.pt_valid & ~stragglers,
        res_exist=jnp.where((jnp.arange(ba.F) == k)[None, :], False,
                            ba.res_exist & ~stragglers[:, None]),
    )
    imm = imm._replace(
        valid=imm.valid & (imm.host != k),
        host=jnp.where(imm.host > k, imm.host - 1, imm.host),
    )
    return ba, imm



@jax.jit
def _set_imu_jit(imu, slot, acc, gyro, ts, valid, timestamp, spline_valid):
    """Fused per-KF IMU-sample intake (FrameHessian::setImuData) — one
    dispatch instead of six eager scatters."""
    return imu._replace(
        acc=imu.acc.at[slot].set(acc),
        gyro=imu.gyro.at[slot].set(gyro),
        ts=imu.ts.at[slot].set(ts),
        imu_valid=imu.imu_valid.at[slot].set(valid),
        timestamps=imu.timestamps.at[slot].set(timestamp),
        spline_valid=imu.spline_valid.at[slot].set(spline_valid),
    )


@functools.partial(jax.jit, static_argnames=("settings", "w", "h", "sizes"))
def _kf_core_vio_jit(ba, imu, dI, pyr, settings, w, h, sizes, max_its,
                     min_its):
    """Fused VIO keyframe core: windowed visual-inertial BA + HdiF +
    pose extraction + tracker template — one device call (the VIO analog
    of _kf_core_jit)."""
    ba, imu, stats = E.optimize_vio(ba, imu, dI, settings, w, h,
                                    max_its=max_its, min_its=min_its)
    HdiF = stats.pop("HdiF")   # rides the final linearization
    templates, pc_l0 = WIN.build_track_template(
        ba, HdiF, pyr, len(pyr), sizes, w, h)
    return (ba, imu, stats, HdiF, templates, pc_l0,
            B.state_to_pose(ba.T_cw_eval, ba.state), B.aff_real(ba.state))



@functools.partial(jax.jit, static_argnames=("settings", "w", "h", "sizes"))
def _kf_mega_jit(ba, imm, dI, pyr, T_cw, aff, exposure, prior_row, slot,
                 min_act_dist, sizes, max_its, min_its, settings, w, h):
    """Pure-vision keyframe mega-step — ONE dispatch: frame insertion +
    image store + point activation (with traced density adaptation) +
    windowed BA + HdiF + tracker-template rebuild + pose extraction."""
    ba = WIN.insert_frame(ba, T_cw, aff, exposure, prior_row)
    dI = dI.at[slot].set(pyr[0])
    ba, imm, min_act_dist = _activate_jit(ba, imm, dI, min_act_dist,
                                          w, h, settings)
    ba, stats, HdiF, templates, pc_l0, T_cw_all, affs = _kf_core_jit(
        ba, dI, pyr, settings, w, h, sizes, max_its, min_its)
    return (ba, imm, dI, min_act_dist, stats, HdiF, templates, pc_l0,
            T_cw_all, affs)


@functools.partial(jax.jit,
                   static_argnames=("settings", "w", "h", "pot", "n_slots"))
def _marg_select_jit(ba, imm, dI, HdiF, flagged_hosts, dI0, slot, key,
                     density, settings, w, h, pot, n_slots):
    """Fused point marginalization + makeNewTraces selection — one
    dispatch (the two are independent; fused purely to save a round trip)."""
    ba, marg, died = _marg_points_jit(ba, dI, HdiF, flagged_hosts,
                                      settings, w, h)
    imm, n_have = _select_insert_jit(imm, dI0, slot, key, density,
                                     settings, pot, n_slots)
    return ba, imm, marg, died, n_have


@functools.partial(jax.jit,
                   static_argnames=("settings", "w", "h", "n_levels", "intr"))
def _frame_step_jit(image, ba, imm, templates, T_primary, T_hyps, T_cw_ref,
                    aff0, ref_aff, ref_exp, exposure, achieve_th,
                    settings, w, h, n_levels, intr):
    """Fused steady-state frame step — ONE dispatch for the typical frame:
    pyramid build + primary-hypothesis coarse track (trackNewCoarse try 0,
    FullSystem.cpp:270) + cond-gated standard-hypothesis retry (tries 1-4,
    FullSystem.cpp:227-270 — runs only when the primary misses the achieve
    threshold, so threshold-edge frames never detour through the host) +
    conditional immature-point trace (traceNewCoarse, FullSystem.cpp:311-361,
    applied only if the best track achieves) + per-frame window stats.

    Every input that depends on the previous frame's outcome (hypotheses,
    tracking reference pose/affine/exposure, achieve threshold) can be fed
    directly from the previous frame's `_kf_chain_jit` outputs — the host
    never has to read anything back between frames."""
    pyr, _ = build_pyramid(image, n_levels)
    exposures = jnp.stack([ref_exp, exposure])
    # direct single-hypothesis track (no 1-wide vmap: the batch dim forces
    # (1, ...) layouts through the whole cascade); keep the leading axis on
    # the outputs for interface parity with the batched fallback phases
    out1 = TK.track_newest_coarse(
        pyr, templates, T_primary, aff0, ref_aff, exposures,
        jnp.full((6,), jnp.nan), tuple(intr), n_levels,
        coarse_cutoff_th=settings.coarse_cutoff_th,
        huber=settings.huber_th)
    out = jax.tree.map(lambda a: a[None], out1)
    res0 = out["residuals"][0, 0]
    prim_ok = out["good"][0] & jnp.isfinite(res0) & (res0 < achieve_th)

    def retry(_):
        outb = TK.track_hypotheses(
            pyr, templates, T_hyps, aff0, ref_aff, exposures, tuple(intr),
            n_levels, coarse_cutoff_th=settings.coarse_cutoff_th,
            huber=settings.huber_th)
        resb = outb["residuals"][:, 0]
        resb = jnp.where(outb["good"] & jnp.isfinite(resb), resb, jnp.inf)
        bi = jnp.argmin(resb)
        best = jax.tree.map(lambda a: a[bi][None], outb)
        res_p = jnp.where(out["good"][0] & jnp.isfinite(res0), res0, jnp.inf)
        use_prim = res_p <= resb[bi]
        return jax.tree.map(lambda a, b: jnp.where(use_prim, a, b), out,
                            best)

    out = jax.lax.cond(prim_ok, lambda _: out, retry, None)
    res_best = out["residuals"][0, 0]
    # accept the best-of-retry up to the escalation bound: the reference
    # takes the best hypothesis even over the achieve threshold after its
    # escalation ladder; only a genuinely broken track (res far over the
    # threshold) falls back to the host's rotation-restart phase
    accept = out["good"][0] & jnp.isfinite(res_best) \
        & (res_best < achieve_th * settings.re_track_escalation)
    T_cw_new = T_cw_ref @ jnp.linalg.inv(out["T"][0])
    imm_traced = _trace_jit(ba, imm, pyr[0], T_cw_new, out["aff"][0],
                            exposures[1], w, h, settings)
    imm = jax.tree.map(lambda a, b: jnp.where(accept, a, b), imm_traced, imm)
    stats = _frame_stats_jit(ba, imm)
    return pyr, out, imm, accept, T_cw_new, stats


@functools.partial(jax.jit, static_argnames=("settings", "w", "h"))
def _need_kf_jit(out, accept, exposure_new, ref_exposure, first_rmse,
                 n_kf, settings, w, h):
    """Device-side keyframe decision — the same optical-flow/brightness
    heuristic as FullSystem._keyframe_decision (FullSystem.cpp:709-732),
    computed from the fused step's outputs so the whole keyframe chain can
    dispatch cond-gated before any host readback."""
    s = settings
    a_ref = jnp.exp(out["aff"][0, 0]) * exposure_new \
        / jnp.maximum(ref_exposure, 1e-9)
    flow_t = out["flow"][0, 0]
    flow_rt = out["flow"][0, 1]
    wh = float(w + h)
    score = (
        s.kf_global_weight * s.max_shift_weight_t
        * jnp.sqrt(jnp.maximum(flow_t, 0.0)) / wh
        + s.kf_global_weight * s.max_shift_weight_rt
        * jnp.sqrt(jnp.maximum(flow_rt, 0.0)) / wh
        + s.kf_global_weight * s.max_affine_weight
        * jnp.abs(jnp.log(jnp.maximum(a_ref, 1e-9)))
    )
    res0 = out["residuals"][0, 0]
    # first_rmse < 0 means no frame has been tracked yet; the host sets it
    # to this frame's res0 before deciding, so the gate is never triggered
    first_eff = jnp.where(first_rmse < 0, res0, first_rmse)
    decide = (score > 1.0) | (2.0 * first_eff < res0) | (n_kf == 0)
    return accept & decide


def _pack_fetch(tree):
    """Inside-jit: flatten a readback pytree into TWO dense vectors
    (floats as f32, ints/bools as i32). Every fetched leaf is its own
    device->host transfer with a fixed overhead; packing the ~25-leaf
    per-frame readback into 2 leaves turns the per-frame fetch into a
    single round trip."""
    fs, is_ = [], []
    for leaf in jax.tree.leaves(tree):
        leaf = jnp.asarray(leaf)
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            fs.append(leaf.ravel().astype(jnp.float32))
        else:
            is_.append(leaf.ravel().astype(jnp.int32))
    fvec = jnp.concatenate(fs) if fs else jnp.zeros((0,), jnp.float32)
    ivec = jnp.concatenate(is_) if is_ else jnp.zeros((0,), jnp.int32)
    return fvec, ivec


def _unpack_fetch(fvec, ivec, spec_tree):
    """Host-side inverse of _pack_fetch. `spec_tree` is any pytree with
    the same structure whose leaves carry .shape/.dtype (the device
    handles returned by the merged frame program)."""
    leaves, treedef = jax.tree.flatten(spec_tree)
    out, fo, io = [], 0, 0
    for leaf in leaves:
        n = int(np.prod(leaf.shape)) if leaf.shape else 1
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            arr = np.asarray(fvec[fo:fo + n]).reshape(leaf.shape)
            fo += n
        else:
            arr = np.asarray(ivec[io:io + n]).reshape(leaf.shape)
            if leaf.dtype == jnp.bool_:
                arr = arr.astype(bool)
            io += n
        out.append(arr)
    return jax.tree.unflatten(treedef, out)


@functools.partial(jax.jit, static_argnames=(
    "sizes", "pot", "n_slots", "settings", "w", "h", "n_levels", "intr",
    "stereo"))
def _fused_frame_mono_jit(image, ba, imm, dI, templates, T_primary, T_hyps,
                          T_cw_ref, aff0, ref_aff, ref_exp, exposure,
                          achieve_th, first_rmse, prior_row, min_act_dist,
                          host_out, n_kf, key0, shell_id, HdiF_in, pc_in,
                          T_cw_prev_in, prev_was_kf, last_rmse0,
                          img_right, have_right, T_lr, scale_state,
                          max_its, min_its,
                          sizes, pot, n_slots, settings, w, h, n_levels,
                          intr, stereo=None):
    """ONE program per frame: fused step + device keyframe decision +
    cond-gated keyframe chain + packed 2-leaf readback. Merging the three
    per-frame dispatches cuts the host dispatch overhead (a jit call of
    this arity costs milliseconds of host time) and lets the whole
    readback ride a single transfer."""
    pyr, out_j, imm_new, accept_j, T_cw_new_j, stats_dev = _frame_step_jit(
        image, ba, imm, templates, T_primary, T_hyps, T_cw_ref, aff0,
        ref_aff, ref_exp, exposure, achieve_th, settings, w, h, n_levels,
        intr)
    need_kf_j = _need_kf_jit(out_j, accept_j, exposure, ref_exp,
                             first_rmse, n_kf, settings, w, h)
    state_o, readback, nxt_o = _kf_chain_jit(
        need_kf_j, ba, imm_new, dI, pyr, out_j, T_cw_new_j, exposure,
        prior_row, min_act_dist, host_out, n_kf, key0, shell_id, stats_dev,
        HdiF_in, templates, pc_in, T_cw_ref, ref_aff, ref_exp,
        T_cw_prev_in, prev_was_kf, last_rmse0,
        img_right, have_right, T_lr, scale_state,
        max_its, min_its, sizes, pot, n_slots, settings, w, h,
        stereo=stereo)
    # chained first-RMSE (host sets first_coarse_rmse from the first
    # tracked frame's res0; in-flight successors must see the same value)
    res0_step = out_j["residuals"][0, 0]
    nxt_o = dict(nxt_o, first_rmse=jnp.where(
        (first_rmse < 0) & accept_j & jnp.isfinite(res0_step),
        res0_step, first_rmse))
    raw = (need_kf_j, out_j, accept_j, T_cw_new_j, readback)
    fvec, ivec = _pack_fetch(raw)
    return pyr, need_kf_j, state_o, nxt_o, raw, fvec, ivec


def _imu_hyp_device(T_prev, T_cw_ref, T_primary_const, T_hyps_const,
                    gyro_s, ts_s, valid_s, ts_thresh, bg, settings):
    """Gyro-integrated rotation hypothesis for the tracker init
    (FullSystem.cpp:163-173; device analog of _imu_hypothesis), computed
    from the staged IMU block's samples in (t_prev_frame, t_new]. When at
    least 2 samples fall in the window, the IMU prediction becomes the
    primary hypothesis and the constant-motion one shifts into the retry
    batch — exactly the host's hypothesis staging, with no readback."""
    ric = jnp.asarray(np.asarray(settings.rot_imu_cam, np.float32)
                      .reshape(3, 3))
    in_win = valid_s & (ts_s > ts_thresh)
    t_eff = jnp.maximum(ts_s, ts_thresh)
    t_pre = jnp.concatenate([jnp.reshape(ts_thresh, (1,)), t_eff[:-1]])
    dts = jnp.where(in_win, jnp.maximum(t_eff - t_pre, 0.0), 0.0)
    w_cam = (gyro_s - bg[None, :]) @ ric          # == (ric^T (g - bg))^T

    def step(R, x):
        dt, wv = x
        return R @ lie.so3_exp(wv * dt), None

    R, _ = jax.lax.scan(step, T_prev[:3, :3], (dts, w_cam), unroll=8)
    T_pred = T_cw_ref @ lie.se3_inv(T_primary_const)
    T_pred = T_pred.at[:3, :3].set(R)
    T_imu = lie.se3_inv(T_pred) @ T_cw_ref
    use = jnp.sum(in_win) >= 2
    T_primary = jnp.where(use, T_imu, T_primary_const)
    T_hyps = jnp.where(
        use,
        jnp.concatenate([T_primary_const[None], T_hyps_const[:-1]], 0),
        T_hyps_const)
    return T_primary, T_hyps


@functools.partial(jax.jit, static_argnames=(
    "sizes", "pot", "n_slots", "settings", "w", "h", "n_levels", "intr",
    "stereo"))
def _fused_frame_vio_jit(image, ba, imu, imm, dI, templates, T_primary,
                         T_hyps, T_cw_ref, aff0, ref_aff, ref_exp,
                         exposure, achieve_th, first_rmse, prior_row,
                         min_act_dist, host_out, n_kf, key0, shell_id,
                         HdiF_in, pc_in,
                         acc_s, gyro_s, ts_s, valid_s, timestamp,
                         ts_thresh, t_last_kf_in,
                         T_cw_prev_in, prev_was_kf, last_rmse0,
                         img_right, have_right, T_lr,
                         scale_state, max_its, min_its,
                         sizes, pot, n_slots, settings, w, h, n_levels,
                         intr, stereo=None):
    """VIO variant of the merged per-frame program (step + decision +
    VIO keyframe chain + packed readback). The staged IMU block comes
    from the host queue WITHOUT assuming in-flight frames' keyframe
    outcomes: `t_last_kf_in` is the device-chained timestamp of the most
    recent (possibly still in-flight) device-decided keyframe, and
    samples at or before it are masked out of the consumable block —
    making pipelined staging bit-identical to synchronous staging at any
    pipeline depth. The IMU tracking hypothesis is integrated on device
    from the same block, so dispatches chain with zero host readbacks."""
    from sos_slam_tpu.models import imu as IM
    valid_eff = valid_s & (ts_s > t_last_kf_in - timestamp)
    # compact surviving samples to the FRONT of the padded block: the
    # synchronous driver stages from a reconciled queue (samples start at
    # index 0), and downstream f32 reductions are position-sensitive —
    # compaction keeps pipelined staging BIT-identical to sync staging
    order = jnp.argsort(jnp.logical_not(valid_eff))   # stable
    acc_s, gyro_s, ts_s = acc_s[order], gyro_s[order], ts_s[order]
    valid_eff = valid_eff[order]
    newest = jnp.maximum(jnp.sum(ba.frame_valid).astype(jnp.int32) - 1, 0)
    bg = (imu.state[newest] * IM.IMU_SCALE21)[3:6]
    T_primary, T_hyps = _imu_hyp_device(
        T_cw_prev_in, T_cw_ref, T_primary, T_hyps, gyro_s, ts_s, valid_eff,
        ts_thresh, bg, settings)
    pyr, out_j, imm_new, accept_j, T_cw_new_j, stats_dev = _frame_step_jit(
        image, ba, imm, templates, T_primary, T_hyps, T_cw_ref, aff0,
        ref_aff, ref_exp, exposure, achieve_th, settings, w, h, n_levels,
        intr)
    need_kf_j = _need_kf_jit(out_j, accept_j, exposure, ref_exp,
                             first_rmse, n_kf, settings, w, h)
    state_o, readback, nxt_o = _kf_chain_vio_jit(
        need_kf_j, ba, imu, imm_new, dI, pyr, out_j, T_cw_new_j, exposure,
        prior_row, min_act_dist, host_out, n_kf, key0, shell_id, stats_dev,
        HdiF_in, templates, pc_in, acc_s, gyro_s, ts_s, valid_eff,
        timestamp, t_last_kf_in, T_cw_ref, ref_aff, ref_exp, T_cw_prev_in,
        prev_was_kf, last_rmse0, img_right, have_right, T_lr, scale_state,
        max_its, min_its, sizes, pot, n_slots, settings, w, h,
        stereo=stereo)
    res0_step = out_j["residuals"][0, 0]
    nxt_o = dict(nxt_o, first_rmse=jnp.where(
        (first_rmse < 0) & accept_j & jnp.isfinite(res0_step),
        res0_step, first_rmse))
    raw = (need_kf_j, out_j, accept_j, T_cw_new_j, readback)
    fvec, ivec = _pack_fetch(raw)
    return pyr, need_kf_j, state_o, nxt_o, raw, fvec, ivec


def _shift_host_out(ho, k):
    """Delete row k of the per-host dead-point counters and append a zero
    (the device analog of the host_out list compaction on frame
    marginalization); identity when k < 0."""
    F = ho.shape[0]
    idx = jnp.arange(F)
    src = jnp.where(idx < k, idx, jnp.minimum(idx + 1, F - 1))
    shifted = ho[src].at[F - 1].set(0)
    return jnp.where(k >= 0, shifted, ho)


@functools.partial(jax.jit, static_argnames=("w", "h", "settings"))
def _trace_stats_jit(ba, imm, dI0_new, T_cw_new, aff_new, exposure_new,
                     w, h, settings):
    """Fused KF-path trace + per-frame window stats — one dispatch."""
    imm = _trace_jit(ba, imm, dI0_new, T_cw_new, aff_new, exposure_new,
                     w, h, settings)
    pt_in, imm_in, aff, T_cw = _frame_stats_jit(ba, imm)
    return imm, pt_in, imm_in, aff, T_cw


@jax.jit
def _insert_frame_jit(ba, dI, img0, T_cw, aff, exposure, prior_row, slot):
    """Fused frame insertion + level-0 image store — one dispatch."""
    ba = WIN.insert_frame(ba, T_cw, aff, exposure, prior_row)
    return ba, dI.at[slot].set(img0)


@functools.partial(jax.jit, static_argnames=("w", "h", "settings"))
def _activate_jit(ba, imm, dI, min_act_dist, w, h, settings):
    """Fused activatePointsMT: traced density adaptation of the activation
    distance (FullSystem.cpp:377-392) + candidate gating + activation GN +
    window scatter — one dispatch. Returns (ba, imm, new_min_act_dist)."""
    s = settings
    d = float(s.desired_point_density)
    n = jnp.sum(ba.pt_valid).astype(jnp.float32)
    delta = (
        -0.8 * (n < 0.66 * d)
        + jnp.where(n < 0.8 * d, -0.5,
                    jnp.where(n < 0.9 * d, -0.2,
                              jnp.where(n < d, -0.1, 0.0)))
        + 0.8 * (n > 1.5 * d) + 0.5 * (n > 1.3 * d)
        + 0.2 * (n > 1.15 * d) + 0.1 * (n > d)
    )
    min_act_dist = jnp.clip(min_act_dist + delta, 0.0, 4.0)
    want, kill, idepth, ok, _ = _activation_jit(
        ba, imm, dI, min_act_dist, w, h, settings)
    ba, imm = _insert_activated_jit(ba, imm, ok, kill, idepth)
    return ba, imm, min_act_dist


@functools.partial(jax.jit, static_argnames=("settings", "w", "h"))
def _marg_points_jit(ba, dI, HdiF, flagged_hosts, settings, w, h):
    """Fused flagPointsForRemoval + marginalizePointsF + dropPointsF —
    one dispatch. Returns (ba, marg-mask, died-per-host)."""
    marg, drop, died = _flag_points_jit(ba, HdiF, flagged_hosts, settings)
    ba = E.marginalize_points(ba, dI, marg, settings, w, h)
    ba = E.drop_points(ba, drop)
    return ba, marg, died


@functools.partial(jax.jit, static_argnames=("settings", "w", "h"))
def _marg_frame_jit(ba, imm, dI, k, settings, w, h):
    """Fused frame marginalization: dying-frame residual energy (on the
    pre-marg state, for dso_error) + straggler/column cleanup + Schur
    frame fold + dI compaction — one dispatch."""
    e_col, n_col = _frame_residual_energy(ba, dI, k, settings, w, h)
    ba, imm = _pre_marg_jit(ba, imm, k)
    ba = E.marginalize_frame(ba, k)
    F = dI.shape[0]
    idx = jnp.arange(F)
    src = jnp.minimum(jnp.where(idx < k, idx, idx + 1), F - 1)
    dI = dI[src].at[F - 1].set(0.0)
    return ba, imm, dI, e_col, n_col


@functools.partial(jax.jit, static_argnames=("settings", "pot", "n_slots"))
def _select_insert_jit(imm, dI0, slot, key, density, settings, pot, n_slots):
    """Fused makeNewTraces compute: 3-level gradient pyramid + block
    thresholds + hierarchical selection + density subsample + immature
    construction + pool scatter (PixelSelector2.cpp:146-283 +
    FullSystem.cpp:1071-1097). Returns (imm, pre-subsample count)."""
    s = settings
    _, absgrads = build_pyramid(dI0[..., 0], 3)
    ths = selector.block_thresholds(
        absgrads[0], s.min_grad_hist_cut, s.min_grad_hist_add)
    status, _ = selector.select(
        dI0, absgrads[0], absgrads[1], absgrads[2], ths, pot, 2.0,
        s.grad_downweight_per_level, key)
    n_have = jnp.sum(status != 0)
    quotia = density / jnp.maximum(n_have.astype(jnp.float32), 1.0)
    keep = jax.random.uniform(
        jax.random.fold_in(key, 99), status.shape) < quotia
    status = jnp.where(quotia < 0.95, jnp.where(keep, status, 0), status)
    imm = _insert_new_traces_jit(imm, dI0, status, slot, settings, n_slots)
    return imm, n_have


@functools.partial(jax.jit, static_argnames=("settings", "w", "h", "sizes"))
def _kf_core_jit(ba, dI, pyr, settings, w, h, sizes, max_its, min_its):
    """Fused keyframe core: windowed BA + HdiF + pose extraction + tracker
    template rebuild — one device call instead of four."""
    ba, stats = E.optimize(ba, dI, settings, w, h, max_its=max_its,
                           min_its=min_its)
    HdiF = stats.pop("HdiF")   # rides the final linearization
    templates, pc_l0 = WIN.build_track_template(
        ba, HdiF, pyr, len(pyr), sizes, w, h)
    return (ba, stats, HdiF, templates, pc_l0,
            B.state_to_pose(ba.T_cw_eval, ba.state), B.aff_real(ba.state))


@functools.partial(jax.jit, static_argnames=("settings", "w", "h"))
def _hdif_jit(ba, dI, settings, w, h):
    """Point idepth-Hessian inverses at the current state (template weights
    + marginalization gates) — one fused call."""
    fm = E._forms()
    pre = B.make_precalc(ba)
    lin = fm["lin"](ba, pre, dI, settings, w, h)
    return fm["schur"](ba, pre, lin).HdiF


@functools.partial(jax.jit, static_argnames=("settings",))
def _flag_points_jit(ba, HdiF, flagged_hosts, settings):
    """flagPointsForRemoval (FullSystem.cpp:533-614) as one device call.
    Returns (marg (P,), drop (P,), died-per-host (F,))."""
    s = settings
    n = jnp.sum(ba.frame_valid)
    newest = n - 1
    n_res = jnp.sum(ba.res_exist & ba.pt_valid[:, None], -1)
    host_flagged = flagged_hosts[ba.host]
    drop = ba.pt_valid & ((ba.idepth < 0) | (n_res == 0))
    vis_in_marg = jnp.sum(
        ba.res_exist & flagged_hosts[None, :]
        & (ba.res_state == B.RES_IN), -1)
    oob = ba.pt_valid & (
        host_flagged
        | ((n_res >= s.min_good_active_res_for_marg)
           & (n_res - vis_in_marg < s.min_good_active_res_for_marg))
    )
    # last-residual OOB proxy: invisible in the two newest frames
    prev = jnp.maximum(newest - 1, 0)
    re_new = ba.res_exist[:, jnp.maximum(newest, 0)]
    re_prev = ba.res_exist[:, prev]
    oob |= jnp.where(n >= 3,
                     ba.pt_valid & ~re_new & ~re_prev & (n_res >= 2),
                     False)
    inlier = n_res >= s.min_good_active_res_for_marg
    hess_ok = jnp.where(HdiF > 0, 1.0 / jnp.maximum(HdiF, 1e-12), 0.0) \
        > s.min_idepth_h_marg
    marg = oob & inlier & hess_ok & ~drop
    drop = drop | (oob & ~(inlier & hess_ok))
    died = jax.ops.segment_sum((marg | drop).astype(jnp.int32), ba.host,
                               ba.F)
    return marg, drop, died


@functools.partial(jax.jit, static_argnames=("settings", "w", "h"))
def _frame_residual_energy(ba, dI, k, settings, w, h):
    """Sum + count of live residual energies targeting frame slot k
    (the dso_error ingredient, FullSystemMarginalize.cpp:151-187).
    Column-restricted linearization: 1/F of the full gather."""
    pre = B.make_precalc(ba)
    k = jnp.asarray(k, jnp.int32)
    energy, new_state = B.linearize_energy_col(ba, pre, dI, k, settings,
                                               w, h)
    col = ba.res_exist[:, k] & ba.pt_valid & (new_state == B.RES_IN)
    e = jnp.sum(jnp.where(col, energy, 0.0))
    return e, jnp.sum(col)


@jax.jit
def _min_dist(qu, qv, tu, tv, tvalid):
    """Min distance from each query to the point set (same-level pixels)."""
    d = (qu[:, None] - tu[None, :]) ** 2 + (qv[:, None] - tv[None, :]) ** 2
    d = jnp.where(tvalid[None, :], d, jnp.inf)
    return jnp.sqrt(jnp.min(d, -1))
