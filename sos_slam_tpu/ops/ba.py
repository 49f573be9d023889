"""Windowed bundle-adjustment kernels: residual linearization, Hessian
assembly, Schur complement, and the damped solve.

JAX rebuild of the reference's optimization backend:
  * PointFrameResidual::linearize (src/FullSystem/Residuals.cpp:77-271)
  * AccumulatedTopHessian addPoint/stitch (src/OptimizationBackend/
    AccumulatedTopHessian.cpp:35-303)
  * AccumulatedSCHessian (AccumulatedSCHessian.cpp:32-145)
  * EnergyFunctional::{setAdjointsF,setDeltaF,solveSystemF,resubstituteF}
    (EnergyFunctional.cpp:42-103,163-194,496-551,1029-1184)

Design:
  * All residuals live in a dense (P points x F frames) masked grid; the
    pointer web of EFFrame/EFPoint/EFResidual becomes validity masks.
  * Linearization is one batched pass: vmap over target frames, all points at
    once per target. Per-residual output is the factored RawResidualJacobian
    (rank-2 through the projected point): X = [Jpdc|Jpdxi] (2,10), JIdx2,
    JabJIdx, Jab2 middle matrices — same factorization the reference exploits.
  * Host/target transfer uses the same adjoints (frame state = LEFT
    perturbation of camToWorld at the FEJ evaluation point; adHost =
    Adj(worldToTarget_eval)^T, adTarget = -adHost, affine diag [a, a] /
    [-a, -1], rows scaled by DSO's internal-state scales).
  * The Schur complement is assembled as H_sc = sum_p HdiF * v_p v_p^T where
    v_p is the absolute-space cross column of point p — algebraically
    identical to the reference's accD/accE/accHcc split, one einsum here.
  * Internal-unit convention: all states, Jacobians, H/b, HM/bM use DSO's
    scaled internal units (SCALE_F/C=50, trans 0.5, rot 1, a 10, b 1000,
    idepth 1), so every prior/threshold constant matches the reference
    verbatim. Conversion to real units happens only when poses are composed
    (state_to_pose) or steps applied.

Energies and Jacobians are f32 (like the reference); the final D~68-dim
solve is Jacobi-preconditioned exactly like the reference (+10 damping).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from sos_slam_tpu.ops.image import (interp_bilinear,
                                    interp_bilinear_frames,
                                    interp_bilinear_nfk)
from sos_slam_tpu.utils import lie
from sos_slam_tpu.utils.config import CPARS, PATTERN_OFFSETS, Settings

HIGH = jax.lax.Precision.HIGHEST

# DSO internal-state scales (reference HessianBlocks.h:53-60)
SCALE_F = 50.0
SCALE_C = 50.0
SCALE_XI_TRANS = 0.5
SCALE_XI_ROT = 1.0
SCALE_A = 10.0
SCALE_B = 1000.0
SCALE_IDEPTH = 1.0

# state8 internal -> real multipliers
STATE8_SCALE = jnp.array(
    [SCALE_XI_TRANS] * 3 + [SCALE_XI_ROT] * 3 + [SCALE_A, SCALE_B], jnp.float32
)
CALIB_SCALE = jnp.array([SCALE_F, SCALE_F, SCALE_C, SCALE_C], jnp.float32)

# residual states
RES_IN = 0
RES_OOB = 1
RES_OUTLIER = 2


def nth_smallest(e: jnp.ndarray, nth: jnp.ndarray) -> jnp.ndarray:
    """Exact nth-smallest element of a 1-D f32 array (== jnp.sort(e)[nth])
    without a sort: 4-pass radix select over the sign-adjusted f32 bit
    pattern. Each pass is one (P,256) compare + column reduction — ~0.5M
    elementwise ops total instead of a full sort (the quantile in
    setNewFrameEnergyTH runs every GN iteration).

    Total order matches jnp.sort for all non-NaN values (+-0.0 tie ranks
    deterministically; both bitcast to distinct keys but compare equal as
    floats, so a selected +-0.0 is numerically identical either way)."""
    u = jax.lax.bitcast_convert_type(e, jnp.uint32)
    neg = u >> jnp.uint32(31)
    key = jnp.where(neg == 1, ~u, u | jnp.uint32(0x80000000))
    bins = jnp.arange(256, dtype=jnp.uint32)
    cand = jnp.ones(e.shape[0], bool)
    k = nth.astype(jnp.int32)
    sel = jnp.uint32(0)
    for shift in (24, 16, 8, 0):
        digit = (key >> jnp.uint32(shift)) & jnp.uint32(0xFF)
        hist = jnp.sum(
            (digit[:, None] == bins[None, :]) & cand[:, None],
            axis=0, dtype=jnp.int32)                      # (256,)
        c = jnp.cumsum(hist)
        b = jnp.sum((c <= k).astype(jnp.int32))           # chosen bin
        below = jnp.where(b > 0, jnp.take(c, jnp.maximum(b - 1, 0)), 0)
        k = k - below
        b_u = b.astype(jnp.uint32)
        cand = cand & (digit == b_u)
        sel = sel | (b_u << jnp.uint32(shift))
    # invert the order-preserving map
    val_bits = jnp.where(sel >= jnp.uint32(0x80000000),
                         sel & jnp.uint32(0x7FFFFFFF), ~sel)
    return jax.lax.bitcast_convert_type(val_bits, jnp.float32)


class BAState(NamedTuple):
    """The sliding window as fixed-shape arrays (padded + masked).

    Frame slots are compact: valid frames occupy slots [0, n). All 8-dim
    frame states and the 4-dim calib state are in DSO INTERNAL units.
    """

    # frames ------------------------------------------------------------
    frame_valid: jnp.ndarray   # (F,) bool
    T_cw_eval: jnp.ndarray     # (F,4,4) camToWorld at FEJ evaluation point
    state: jnp.ndarray         # (F,8) internal [xi(6) c2w-left-eps, a, b]
    state_zero: jnp.ndarray    # (F,8) FEJ zero state (pose part == 0)
    exposure: jnp.ndarray      # (F,)
    energy_th: jnp.ndarray     # (F,) adaptive outlier threshold
    prior: jnp.ndarray         # (F,8) diagonal prior weights (internal units)
    # calib ---------------------------------------------------------------
    c: jnp.ndarray             # (4,) internal calib [fx,fy,cx,cy]/50
    c_zero: jnp.ndarray        # (4,)
    # points --------------------------------------------------------------
    pt_valid: jnp.ndarray      # (P,) bool
    host: jnp.ndarray          # (P,) int32 frame slot
    u: jnp.ndarray             # (P,)
    v: jnp.ndarray             # (P,)
    color: jnp.ndarray         # (P,8)
    weight: jnp.ndarray        # (P,8) pattern gradient weights
    idepth: jnp.ndarray        # (P,)
    idepth_zero: jnp.ndarray   # (P,)
    pt_prior: jnp.ndarray      # (P,) prior weight (idepth_fix_prior or 0)
    res_exist: jnp.ndarray     # (P,F) bool residual exists
    res_state: jnp.ndarray     # (P,F) int8 IN/OOB/OUTLIER
    # marginalization prior (internal units) -------------------------------
    HM: jnp.ndarray            # (D,D)
    bM: jnp.ndarray            # (D,)

    @property
    def F(self) -> int:
        return self.frame_valid.shape[0]

    @property
    def P(self) -> int:
        return self.pt_valid.shape[0]


def calib_real(ba: BAState) -> jnp.ndarray:
    return ba.c * CALIB_SCALE


def state_to_pose(T_cw_eval: jnp.ndarray, state: jnp.ndarray) -> jnp.ndarray:
    """camToWorld = exp(scaled_xi) @ T_cw_eval (left eps on camToWorld)."""
    xi = state[..., :6] * STATE8_SCALE[:6]
    return lie.se3_exp(xi) @ T_cw_eval


def aff_real(state: jnp.ndarray) -> jnp.ndarray:
    return state[..., 6:8] * STATE8_SCALE[6:8]


def aff_transfer(exp_h, exp_t, aff_h, aff_t):
    """(a, b) with I_t ~ a I_h + b (NumType.h:157-168). Real-unit affs."""
    exp_h = jnp.where(exp_h == 0, 1.0, exp_h)
    exp_t = jnp.where(exp_t == 0, 1.0, exp_t)
    a = jnp.exp(aff_t[..., 0] - aff_h[..., 0]) * exp_t / exp_h
    b = aff_t[..., 1] - a * aff_h[..., 1]
    return jnp.stack([a, b], -1)


class Precalc(NamedTuple):
    """Per-(host, target) cached transforms (FrameFramePrecalc,
    HessianBlocks.cpp:431-461) + adjoints. All (F,F,...)."""

    R0: jnp.ndarray      # (F,F,3,3) FEJ rotation host->target
    t0: jnp.ndarray      # (F,F,3)
    R: jnp.ndarray       # (F,F,3,3) current
    t: jnp.ndarray       # (F,F,3)
    affLL: jnp.ndarray   # (F,F,2) current-state affine transfer
    b0: jnp.ndarray      # (F,) host zero-state aff b (real units)
    adHost: jnp.ndarray  # (F,F,8,8) internal-unit adjoints
    adTarget: jnp.ndarray
    adHTdelta: jnp.ndarray  # (F,F,8) per-pair FEJ delta (internal units)


class PrecalcEval(NamedTuple):
    """The FEJ-evaluation-point part of Precalc: constant across the GN
    iterations of one optimize() call (depends only on T_cw_eval,
    state_zero, exposure — none of which the while_loop changes), so the
    loop body reuses it instead of rebuilding adjoints every iteration."""

    R0: jnp.ndarray      # (F,F,3,3) FEJ rotation host->target
    t0: jnp.ndarray      # (F,F,3)
    b0: jnp.ndarray      # (F,) host zero-state aff b (real units)
    adHost: jnp.ndarray  # (F,F,8,8) internal-unit adjoints
    adTarget: jnp.ndarray


def make_precalc_eval(ba: BAState) -> PrecalcEval:
    """Adjoints + FEJ relative transforms (setAdjointsF,
    EnergyFunctional.cpp:42-103)."""
    T_wc_eval = lie.se3_inv(ba.T_cw_eval)
    # host->target relative transforms: T_th = T_wc[t] @ T_cw[h]
    rel0 = jnp.einsum("tij,hjk->htik", T_wc_eval, ba.T_cw_eval, precision=HIGH)

    aff0 = aff_real(ba.state_zero)      # (F,2) FEJ
    affLL0 = aff_transfer(
        ba.exposure[:, None], ba.exposure[None, :],
        aff0[:, None, :].repeat(ba.F, 1), aff0[None, :, :].repeat(ba.F, 0),
    )

    # frame state is a left-eps on camToWorld at eval PT; d xi_rel/d
    # eps_host = Adj(worldToTarget_eval), d/d eps_target = -same.
    AdjT = lie.se3_adj(T_wc_eval)       # (F,6,6) of worldToTarget
    adj_ht = jnp.broadcast_to(AdjT[None, :, :, :], (ba.F, ba.F, 6, 6))

    AH = jnp.zeros((ba.F, ba.F, 8, 8), jnp.float32)
    AT = jnp.zeros((ba.F, ba.F, 8, 8), jnp.float32)
    # NOTE: reference stores (d xi/d eps)^T; we store the forward map and
    # transpose at use sites. AH_fwd[i,j] = d xi_rel[i] / d eps_host[j].
    AH = AH.at[..., :6, :6].set(adj_ht)
    AT = AT.at[..., :6, :6].set(-adj_ht)
    a0 = affLL0[..., 0]
    AH = AH.at[..., 6, 6].set(a0)
    AH = AH.at[..., 7, 7].set(a0)
    AT = AT.at[..., 6, 6].set(-a0)
    AT = AT.at[..., 7, 7].set(-1.0)
    # internal-unit column scaling (state internal -> real eps)
    AH = AH * STATE8_SCALE[None, None, None, :]
    AT = AT * STATE8_SCALE[None, None, None, :]
    return PrecalcEval(R0=rel0[..., :3, :3], t0=rel0[..., :3, 3],
                       b0=aff0[:, 1], adHost=AH, adTarget=AT)


def make_precalc(ba: BAState, ev: PrecalcEval | None = None) -> Precalc:
    """Current-state transforms + the (loop-reusable) eval-point part."""
    if ev is None:
        ev = make_precalc_eval(ba)
    T_cw = state_to_pose(ba.T_cw_eval, ba.state)           # (F,4,4)
    T_wc = lie.se3_inv(T_cw)
    rel = jnp.einsum("tij,hjk->htik", T_wc, T_cw, precision=HIGH)

    aff = aff_real(ba.state)            # (F,2) current
    affLL = aff_transfer(
        ba.exposure[:, None], ba.exposure[None, :],
        aff[:, None, :].repeat(ba.F, 1), aff[None, :, :].repeat(ba.F, 0),
    )

    # per-pair delta (setDeltaF): dp = forward map of host/target internal
    # deltas into relative-state space.
    delta = ba.state - ba.state_zero     # (F,8) internal
    adHTdelta = (
        jnp.einsum("htij,hj->hti", ev.adHost, delta, precision=HIGH)
        + jnp.einsum("htij,tj->hti", ev.adTarget, delta, precision=HIGH)
    )

    return Precalc(
        R0=ev.R0, t0=ev.t0,
        R=rel[..., :3, :3], t=rel[..., :3, 3],
        affLL=affLL, b0=ev.b0,
        adHost=ev.adHost, adTarget=ev.adTarget, adHTdelta=adHTdelta,
    )


class LinData(NamedTuple):
    """Per-(point,target) factored linearization (RawResidualJacobian,
    src/OptimizationBackend/RawResidualJacobian.h:29-55)."""

    X: jnp.ndarray        # (P,F,2,10) [Jpdc(4) | Jpdxi(6)] internal units
    Jpdd: jnp.ndarray     # (P,F,2)
    resF: jnp.ndarray     # (P,F,8) hw-weighted residuals
    JIdx: jnp.ndarray     # (P,F,2,8) hw-weighted image gradients
    JabF: jnp.ndarray     # (P,F,2,8) affine jacobians
    JIdx2: jnp.ndarray    # (P,F,2,2)
    JabJIdx: jnp.ndarray  # (P,F,2,2)
    Jab2: jnp.ndarray     # (P,F,2,2)
    energy: jnp.ndarray   # (P,F) huber energy (after outlier clamping)
    energy_raw: jnp.ndarray  # (P,F) energy before outlier decision
    new_state: jnp.ndarray   # (P,F) int8 proposed residual state
    active: jnp.ndarray   # (P,F) bool: exists & new_state == IN


def linearize(ba: BAState, pre: Precalc, dI: jnp.ndarray,
              settings: Settings, w: int, h: int) -> LinData:
    """Batched PointFrameResidual::linearize over the (P,F) residual grid.

    dI: (F,H,W,3) stacked level-0 images of all frames.
    """
    fx, fy, cx, cy = calib_real(ba)
    F, P = ba.F, ba.P
    pat = jnp.asarray(PATTERN_OFFSETS)           # (8,2)

    hostP = ba.host
    # gather per-point host rows of precalc: (P,F,...)
    R0 = pre.R0[hostP]       # (P,F,3,3)
    t0 = pre.t0[hostP]
    Rc = pre.R[hostP]
    tc = pre.t[hostP]
    affLL = pre.affLL[hostP]  # (P,F,2)
    b0 = pre.b0[hostP]        # (P,)

    # ---- geometry part at FEJ (center pixel, idepth_zero) ----
    KliP = jnp.stack(
        [(ba.u - cx) / fx, (ba.v - cy) / fy, jnp.ones_like(ba.u)], -1
    )  # (P,3)
    ptp = jnp.einsum("pfij,pj->pfi", R0, KliP, precision=HIGH) \
        + t0 * ba.idepth_zero[:, None, None]
    drescale = 1.0 / ptp[..., 2]
    geo_ok = drescale > 0
    new_idepth = ba.idepth_zero[:, None] * drescale
    u_ = ptp[..., 0] * drescale
    v_ = ptp[..., 1] * drescale
    Ku = u_ * fx + cx
    Kv = v_ * fy + cy
    geo_ok &= (Ku > 1.1) & (Kv > 1.1) & (Ku < w - 3) & (Kv < h - 3)

    # d proj / d idepth (2,)
    d_d = jnp.stack(
        [
            drescale * (t0[..., 0] - t0[..., 2] * u_) * SCALE_IDEPTH * fx,
            drescale * (t0[..., 1] - t0[..., 2] * v_) * SCALE_IDEPTH * fy,
        ],
        -1,
    )  # (P,F,2)

    # d proj / d calib (2,4) — internal units (SCALE_F/SCALE_C folded in),
    # following Residuals.cpp:122-143 exactly.
    A = drescale * (R0[..., 2, 0] * u_ - R0[..., 0, 0])
    B = fx * drescale * (R0[..., 2, 1] * u_ - R0[..., 0, 1]) / fy
    C = fy * drescale * (R0[..., 2, 0] * v_ - R0[..., 1, 0]) / fx
    Dv = drescale * (R0[..., 2, 1] * v_ - R0[..., 1, 1])
    d_C_x = jnp.stack(
        [(KliP[:, None, 0] * A + u_) * SCALE_F, KliP[:, None, 1] * B * SCALE_F,
         (A + 1.0) * SCALE_C, B * SCALE_C], -1,
    )
    d_C_y = jnp.stack(
        [KliP[:, None, 0] * C * SCALE_F, (KliP[:, None, 1] * Dv + v_) * SCALE_F,
         C * SCALE_C, (Dv + 1.0) * SCALE_C], -1,
    )

    # d proj / d xi_rel (2,6) — real units (adjoints carry the scales)
    idp = new_idepth
    one = jnp.ones_like(u_)
    d_xi_x = jnp.stack(
        [idp * fx, 0 * one, -idp * u_ * fx,
         -u_ * v_ * fx, (1 + u_ * u_) * fx, -v_ * fx], -1,
    )
    d_xi_y = jnp.stack(
        [0 * one, idp * fy, -idp * v_ * fy,
         -(1 + v_ * v_) * fy, u_ * v_ * fy, u_ * fy], -1,
    )
    X = jnp.concatenate(
        [jnp.stack([d_C_x, d_C_y], -2), jnp.stack([d_xi_x, d_xi_y], -2)], -1
    )  # (P,F,2,10)

    # ---- pattern part at current state ----
    up = ba.u[:, None] + pat[None, :, 0]   # (P,8)
    vp = ba.v[:, None] + pat[None, :, 1]
    KliPp = jnp.stack(
        [(up - cx) / fx, (vp - cy) / fy, jnp.ones_like(up)], -1
    )  # (P,8,3)
    ptp_c = (
        jnp.einsum("pfij,pkj->pfki", Rc, KliPp, precision=HIGH)
        + tc[:, :, None, :] * ba.idepth[:, None, None, None]
    )  # (P,F,8,3)
    z = ptp_c[..., 2]
    pat_ok = z > 1e-6
    Kup = ptp_c[..., 0] / z * fx + cx
    Kvp = ptp_c[..., 1] / z * fy + cy
    pat_ok &= (Kup > 1.1) & (Kvp > 1.1) & (Kup < w - 3) & (Kvp < h - 3)

    # gather hit colors for all target frames in ONE fused 4-corner take
    # (a vmap over F emits a batched gather instead; see
    # interp_bilinear_frames and interp_bilinear_nfk)
    hit = interp_bilinear_frames(dI, Kup, Kvp)   # (P,F,8,3)
    hit_ok = jnp.isfinite(hit[..., 0])
    ok = geo_ok[:, :, None] & pat_ok & hit_ok
    oob = ~jnp.all(ok, -1)   # any bad pattern pixel -> OOB (reference behavior)

    r = hit[..., 0] - (affLL[..., 0:1] * ba.color[:, None, :] + affLL[..., 1:2])
    drdA = ba.color[:, None, :] - b0[:, None, None]
    gx, gy = hit[..., 1], hit[..., 2]
    wgrad = jnp.sqrt(
        settings.outlier_th_sum_component
        / (settings.outlier_th_sum_component + gx * gx + gy * gy)
    )
    wgt = 0.5 * (wgrad + ba.weight[:, None, :])
    abs_r = jnp.abs(r)
    hw = jnp.where(abs_r < settings.huber_th, 1.0,
                   settings.huber_th / jnp.maximum(abs_r, 1e-9))
    energy_raw = jnp.sum(wgt * wgt * hw * r * r * (2.0 - hw), -1)

    hw2 = jnp.where(hw < 1.0, jnp.sqrt(hw), hw) * wgt
    JIdx = jnp.stack([gx * hw2, gy * hw2], -2)     # (P,F,2,8)
    resF = r * hw2                                  # (P,F,8)
    JabF = jnp.stack([drdA * hw2, hw2], -2)         # (P,F,2,8)

    wJI2 = jnp.sum(hw2 * hw2 * (gx * gx + gy * gy), -1)

    # outlier decision (Residuals.cpp:253-265)
    th_h = ba.energy_th[hostP]               # (P,)
    th_t = ba.energy_th[None, :]             # (1,F)
    th = jnp.maximum(th_h[:, None], th_t)
    outlier = (energy_raw > th) | (wJI2 < 2.0)
    energy = jnp.where(outlier, th, energy_raw)

    # sticky OOB within one optimize() call: prior OOB stays OOB
    prev_oob = ba.res_state == RES_OOB
    new_state = jnp.where(
        oob | prev_oob, RES_OOB, jnp.where(outlier, RES_OUTLIER, RES_IN)
    ).astype(jnp.int8)
    # OOB residuals keep their previous energy in the reference; we simply
    # exclude them from the energy sum via masks at use sites.

    active = ba.res_exist & ba.pt_valid[:, None] & ba.frame_valid[None, :] \
        & (new_state == RES_IN)
    mask_f = active.astype(jnp.float32)

    JIdx2 = jnp.einsum("pfik,pfjk->pfij", JIdx, JIdx, precision=HIGH)
    JabJIdx = jnp.einsum("pfik,pfjk->pfij", JabF, JIdx, precision=HIGH)
    Jab2 = jnp.einsum("pfik,pfjk->pfij", JabF, JabF, precision=HIGH)

    return LinData(
        X=X * mask_f[..., None, None],
        Jpdd=d_d * mask_f[..., None],
        resF=resF * mask_f[..., None],
        JIdx=JIdx * mask_f[..., None, None],
        JabF=JabF * mask_f[..., None, None],
        JIdx2=JIdx2 * mask_f[..., None, None],
        JabJIdx=JabJIdx * mask_f[..., None, None],
        Jab2=Jab2 * mask_f[..., None, None],
        energy=energy, energy_raw=energy_raw,
        new_state=new_state, active=active,
    )


def linearize_energy_col(ba: BAState, pre: Precalc, dI: jnp.ndarray,
                         k: jnp.ndarray, settings: Settings,
                         w: int, h: int, row: jnp.ndarray | None = None):
    """Energy + residual-state of the single target-frame column `k` —
    bitwise the k-column of `linearize(...)`'s (energy, new_state), at 1/F
    of the gather cost. Used for the dying-frame dso_error sum inside
    frame marginalization (FullSystemMarginalize.cpp:151-187), where a
    full (P,F,8) linearization was ~F x wasted work.

    `row` is the physical dI row holding slot k's image (defaults to k;
    the fused chain defers dI compaction and passes its slot->row map).

    Returns (energy (P,), new_state (P,) int8)."""
    if row is None:
        row = k
    fx, fy, cx, cy = calib_real(ba)
    F, P = ba.F, ba.P
    H, W = dI.shape[1], dI.shape[2]
    pat = jnp.asarray(PATTERN_OFFSETS)
    hostP = ba.host

    R0 = pre.R0[hostP, k]        # (P,3,3)
    t0 = pre.t0[hostP, k]        # (P,3)
    Rc = pre.R[hostP, k]
    tc = pre.t[hostP, k]
    affLL = pre.affLL[hostP, k]  # (P,2)

    # geometry at FEJ (center pixel, idepth_zero) — OOB gate
    KliP = jnp.stack(
        [(ba.u - cx) / fx, (ba.v - cy) / fy, jnp.ones_like(ba.u)], -1)
    ptp = jnp.einsum("pij,pj->pi", R0, KliP, precision=HIGH) \
        + t0 * ba.idepth_zero[:, None]
    drescale = 1.0 / ptp[..., 2]
    geo_ok = drescale > 0
    u_ = ptp[..., 0] * drescale
    v_ = ptp[..., 1] * drescale
    Ku = u_ * fx + cx
    Kv = v_ * fy + cy
    geo_ok &= (Ku > 1.1) & (Kv > 1.1) & (Ku < w - 3) & (Kv < h - 3)

    # pattern at current state
    up = ba.u[:, None] + pat[None, :, 0]
    vp = ba.v[:, None] + pat[None, :, 1]
    KliPp = jnp.stack(
        [(up - cx) / fx, (vp - cy) / fy, jnp.ones_like(up)], -1)  # (P,8,3)
    ptp_c = (
        jnp.einsum("pij,pkj->pki", Rc, KliPp, precision=HIGH)
        + tc[:, None, :] * ba.idepth[:, None, None]
    )  # (P,8,3)
    z = ptp_c[..., 2]
    pat_ok = z > 1e-6
    Kup = ptp_c[..., 0] / z * fx + cx
    Kvp = ptp_c[..., 1] / z * fy + cy
    pat_ok &= (Kup > 1.1) & (Kvp > 1.1) & (Kup < w - 3) & (Kvp < h - 3)

    # single-frame taps via the flat fused take (row offset k*H*W)
    flat = dI.reshape(F * H * W, -1)
    x0 = jnp.clip(jnp.floor(Kup), 0, W - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(Kvp), 0, H - 2).astype(jnp.int32)
    dx = jnp.clip(Kup - x0, 0.0, 1.0)[..., None]
    dy = jnp.clip(Kvp - y0, 0.0, 1.0)[..., None]
    idx = row.astype(jnp.int32) * (H * W) + y0 * W + x0
    # one stacked-corner take (see image.interp_bilinear_frames)
    idx4 = jnp.stack([idx, idx + 1, idx + W, idx + W + 1], 0)
    cn = jnp.take(flat, idx4, axis=0)
    hit = (cn[0] * (1 - dx) * (1 - dy) + cn[1] * dx * (1 - dy)
           + cn[2] * (1 - dx) * dy + cn[3] * dx * dy)   # (P,8,3)
    hit_ok = jnp.isfinite(hit[..., 0])
    ok = geo_ok[:, None] & pat_ok & hit_ok
    oob = ~jnp.all(ok, -1)

    r = hit[..., 0] - (affLL[..., 0:1] * ba.color + affLL[..., 1:2])
    gx, gy = hit[..., 1], hit[..., 2]
    wgrad = jnp.sqrt(
        settings.outlier_th_sum_component
        / (settings.outlier_th_sum_component + gx * gx + gy * gy))
    wgt = 0.5 * (wgrad + ba.weight)
    abs_r = jnp.abs(r)
    hw = jnp.where(abs_r < settings.huber_th, 1.0,
                   settings.huber_th / jnp.maximum(abs_r, 1e-9))
    energy_raw = jnp.sum(wgt * wgt * hw * r * r * (2.0 - hw), -1)
    hw2 = jnp.where(hw < 1.0, jnp.sqrt(hw), hw) * wgt
    wJI2 = jnp.sum(hw2 * hw2 * (gx * gx + gy * gy), -1)

    th = jnp.maximum(ba.energy_th[hostP], ba.energy_th[k])
    outlier = (energy_raw > th) | (wJI2 < 2.0)
    energy = jnp.where(outlier, th, energy_raw)
    prev_oob = ba.res_state[:, k] == RES_OOB
    new_state = jnp.where(
        oob | prev_oob, RES_OOB, jnp.where(outlier, RES_OUTLIER, RES_IN)
    ).astype(jnp.int8)
    return energy, new_state


def res_to_zero(ba: BAState, pre: Precalc, lin: LinData) -> jnp.ndarray:
    """FEJ shift: res_toZero = resF - J * delta (fixLinearizationF,
    EnergyFunctionalStructs.cpp:75-103). Returns (P,F,8)."""
    dp = pre.adHTdelta[ba.host]                   # (P,F,8)
    dc = ba.c - ba.c_zero                         # (4,)
    dd = ba.idepth - ba.idepth_zero               # (P,)
    delta10 = jnp.concatenate(
        [jnp.broadcast_to(dc, (ba.P, ba.F, 4)), dp[..., :6]], -1
    )
    Jp_delta = (
        jnp.einsum("pfij,pfj->pfi", lin.X, delta10, precision=HIGH)
        + lin.Jpdd * dd[:, None, None]
    )  # (P,F,2)
    shift = (
        jnp.einsum("pfik,pfi->pfk", lin.JIdx, Jp_delta, precision=HIGH)
        + lin.JabF[:, :, 0, :] * dp[..., 6:7]
        + lin.JabF[:, :, 1, :] * dp[..., 7:8]
    )
    return lin.resF - shift


def accumulate_top(ba: BAState, pre: Precalc, lin: LinData,
                   resApprox: jnp.ndarray | None = None
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Assemble the (D,D) top Hessian and (D,) b from the linearization.

    resApprox defaults to lin.resF (mode 0 / active); pass res_toZero for
    mode 2 (marginalization). Returns internal-unit H, b WITHOUT priors.
    """
    F, P = ba.F, ba.P
    D = CPARS + 8 * F
    if resApprox is None:
        resApprox = lin.resF

    JI_r = jnp.einsum("pfik,pfk->pfi", lin.JIdx, resApprox, precision=HIGH)
    Jab_r = jnp.einsum("pfik,pfk->pfi", lin.JabF, resApprox, precision=HIGH)
    rr = jnp.sum(resApprox * resApprox, -1)

    onehot = jax.nn.one_hot(ba.host, F, dtype=jnp.float32)  # (P,F_host)

    # per-(h,t) 12x12 accumulator blocks in order [c(4), xi(6), aff(2)] + rhs
    # geo-geo: X^T JIdx2 X
    G_gg = jnp.einsum("pfai,pfab,pfbj->pfij", lin.X, lin.JIdx2, lin.X,
                      precision=HIGH)                    # (P,F,10,10)
    G_ga = jnp.einsum("pfai,pfba->pfib", lin.X, lin.JabJIdx, precision=HIGH)
    G_gb = jnp.einsum("pfai,pfa->pfi", lin.X, JI_r, precision=HIGH)
    # aggregate over points into (h,t) cells
    A_gg = jnp.einsum("ph,pfij->hfij", onehot, G_gg, precision=HIGH)
    A_ga = jnp.einsum("ph,pfib->hfib", onehot, G_ga, precision=HIGH)
    A_aa = jnp.einsum("ph,pfij->hfij", onehot, lin.Jab2, precision=HIGH)
    b_g = jnp.einsum("ph,pfi->hfi", onehot, G_gb, precision=HIGH)
    b_a = jnp.einsum("ph,pfi->hfi", onehot, Jab_r, precision=HIGH)

    # build per-(h,t) 12x12 "accH" and 12 rhs: order [c, xi, a, b]
    accH = jnp.zeros((F, F, 12, 12), jnp.float32)
    accH = accH.at[..., :10, :10].set(A_gg)
    accH = accH.at[..., :10, 10:].set(A_ga)
    accH = accH.at[..., 10:, :10].set(jnp.swapaxes(A_ga, -1, -2))
    accH = accH.at[..., 10:, 10:].set(A_aa)
    accb = jnp.concatenate([b_g, b_a], -1)      # (F,F,12)

    return stitch_acc(ba, pre, accH, accb)


def stitch_acc(ba: BAState, pre: Precalc, accH: jnp.ndarray,
               accb: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Adjoint stitch of per-(h,t) 12x12 cells into the (D,D) absolute H
    and (D,) b (stitchDouble, AccumulatedTopHessian.cpp:155-301) — shared
    by accumulate_top / accumulate_top_kr / ba_t.accumulate_top_t."""
    F = ba.F
    D = CPARS + 8 * F
    # split: calib rows (4) and rel-frame rows (8 = xi+aff)
    Hcc = accH[..., :4, :4].sum((0, 1))
    Gfc = accH[..., 4:, :4]                     # (F,F,8,4)
    Gff = accH[..., 4:, 4:]                     # (F,F,8,8)
    bc = accb[..., :4].sum((0, 1))
    bf_rel = accb[..., 4:]                      # (F,F,8)

    AH, AT = pre.adHost, pre.adTarget           # forward maps (8rel x 8abs)

    # frame-frame blocks: sum over (h,t) of (P_h AH + P_t AT)^T Gff (...)
    Hff = jnp.zeros((F, 8, F, 8), jnp.float32)
    d_h = jnp.einsum("htri,htrs,htsj->hij", AH, Gff, AH, precision=HIGH)
    d_t = jnp.einsum("htri,htrs,htsj->tij", AT, Gff, AT, precision=HIGH)
    x_ht = jnp.einsum("htri,htrs,htsj->htij", AH, Gff, AT, precision=HIGH)
    idxF = jnp.arange(F)
    Hff = Hff.at[idxF, :, idxF, :].add(d_h + d_t)
    Hff = Hff + jnp.transpose(x_ht, (0, 2, 1, 3))
    Hff = Hff + jnp.transpose(x_ht, (1, 3, 0, 2))

    # frame-calib
    Hfc = (
        jnp.einsum("htri,htrc->hic", AH, Gfc, precision=HIGH)
        + jnp.einsum("htri,htrc->tic", AT, Gfc, precision=HIGH)
    )  # (F,8,4)
    bf = (
        jnp.einsum("htri,htr->hi", AH, bf_rel, precision=HIGH)
        + jnp.einsum("htri,htr->ti", AT, bf_rel, precision=HIGH)
    )  # (F,8)

    H = jnp.zeros((D, D), jnp.float32)
    H = H.at[:4, :4].set(Hcc)
    H = H.at[4:, 4:].set(Hff.reshape(8 * F, 8 * F))
    H = H.at[4:, :4].set(Hfc.reshape(8 * F, 4))
    H = H.at[:4, 4:].set(Hfc.reshape(8 * F, 4).T)
    b = jnp.concatenate([bc, bf.reshape(-1)])
    return H, b


def accumulate_top_kr(ba: BAState, pre: Precalc, lin: LinData,
                      resApprox: jnp.ndarray | None = None
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """accumulate_top in khatri-rao/matmul form — same contract, same
    algebra, different summation shape.

    The factored einsum chain materializes (P,F,10,10) blocks from
    tiny batched 2-contractions (G_gg = X^T JIdx2 X per residual pair)
    with minor dims of 2..10.
    This form instead builds per-(pattern-pixel) 13-rows
    Y = [X^T JI (10) | Jab (2) | r (1)] and reduces the (h,t) cells with
    ONE contraction over the (point, pattern) row axis:
        acc[h,t] = sum_rows onehot_h(row) * Y_i Y_j
    i.e. a (13 x N)(N x F*13) matmul per target — a GEMM whose
    contraction is over N = P*8 rows. Algebraically identical to
    AccumulatedTopHessian addPoint/stitch (summation order differs ->
    f32 rounding differs at ~1e-6 relative).
    """
    F, P = ba.F, ba.P
    D = CPARS + 8 * F
    if resApprox is None:
        resApprox = lin.resF

    # per-row 13-vector: [c(4), xi(6), ab(2), r(1)]
    q = jnp.einsum("pfak,pfai->pfki", lin.JIdx, lin.X, precision=HIGH)
    ab = jnp.swapaxes(lin.JabF, -1, -2)                  # (P,F,8,2)
    Y = jnp.concatenate([q, ab, resApprox[..., None]], -1)  # (P,F,8,13)

    onehot = jax.nn.one_hot(ba.host, F, dtype=jnp.float32)  # (P,Fh)
    # khatri-rao over the host axis; XLA fuses the broadcast-multiply
    # into the matmul operand (no (P,F,8,Fh,13) materialization).
    U = onehot[:, None, None, :, None] * Y[:, :, :, None, :]
    acc = jnp.einsum("pfki,pfkhj->hfij", Y, U, precision=HIGH)  # (Fh,Ft,13,13)

    return stitch_acc(ba, pre, acc[..., :12, :12], acc[..., :12, 12])


class SchurData(NamedTuple):
    Hdd: jnp.ndarray      # (P,) idepth hessian (+ prior)
    HdiF: jnp.ndarray     # (P,) its (masked) inverse
    bd: jnp.ndarray       # (P,) idepth rhs (incl. prior pull)
    vcross: jnp.ndarray   # (P,D) absolute-space cross column
    has_res: jnp.ndarray  # (P,) bool any active residual


def accumulate_schur(ba: BAState, pre: Precalc, lin: LinData,
                     resApprox: jnp.ndarray | None = None,
                     shift_prior_to_zero: bool = True,
                     prior_fac: float = 1.0) -> SchurData:
    """Point-elimination quantities (AccumulatedSCHessian.cpp:32-79), as
    H_sc = sum_p HdiF v v^T with v the cross column."""
    F, P = ba.F, ba.P
    D = CPARS + 8 * F
    if resApprox is None:
        resApprox = lin.resF

    JI_r = jnp.einsum("pfik,pfk->pfi", lin.JIdx, resApprox, precision=HIGH)
    Ji2_Jpdd = jnp.einsum("pfij,pfj->pfi", lin.JIdx2, lin.Jpdd, precision=HIGH)

    Hdd = jnp.sum(jnp.einsum("pfi,pfi->pf", Ji2_Jpdd, lin.Jpdd,
                             precision=HIGH), -1)
    bd = jnp.sum(jnp.einsum("pfi,pfi->pf", JI_r, lin.Jpdd, precision=HIGH), -1)
    Hcd = jnp.einsum("pfic,pfi->pc", lin.X[..., :4], Ji2_Jpdd,
                     precision=HIGH)                       # (P,4)

    # JpJdF per (p,t): [Jpdxi^T Ji2_Jpdd (6), JabJIdx @ Jpdd (2)]
    JpJd = jnp.concatenate(
        [
            jnp.einsum("pfij,pfi->pfj", lin.X[..., 4:], Ji2_Jpdd,
                       precision=HIGH),
            jnp.einsum("pfij,pfj->pfi", lin.JabJIdx, lin.Jpdd, precision=HIGH),
        ],
        -1,
    )  # (P,F,8)

    has_res = jnp.any(lin.active, -1)
    prior = ba.pt_prior * prior_fac
    Hdd_full = jnp.maximum(Hdd + prior, 1e-10)
    HdiF = jnp.where(has_res, 1.0 / Hdd_full, 0.0)
    bd_full = bd + jnp.where(
        shift_prior_to_zero, prior * (ba.idepth - ba.idepth_zero), 0.0
    )

    # absolute cross column v (P,D)
    AHp = pre.adHost[ba.host]      # (P,F,8,8)
    ATp = pre.adTarget[ba.host]
    v_host = jnp.einsum("pfri,pfr->pi", AHp, JpJd, precision=HIGH)   # (P,8)
    v_tgt = jnp.einsum("pfri,pfr->pfi", ATp, JpJd, precision=HIGH)   # (P,F,8)
    onehot = jax.nn.one_hot(ba.host, F, dtype=jnp.float32)
    v_frames = v_tgt + onehot[:, :, None] * v_host[:, None, :]
    v = jnp.concatenate([Hcd, v_frames.reshape(P, 8 * F)], -1)
    return SchurData(Hdd=Hdd_full, HdiF=HdiF, bd=bd_full, vcross=v,
                     has_res=has_res)


def schur_Hb(sc: SchurData) -> Tuple[jnp.ndarray, jnp.ndarray]:
    H_sc = jnp.einsum("pi,p,pj->ij", sc.vcross, sc.HdiF, sc.vcross,
                      precision=HIGH)
    b_sc = jnp.einsum("pi,p->i", sc.vcross, sc.HdiF * sc.bd, precision=HIGH)
    return H_sc, b_sc


def add_priors(ba: BAState, H: jnp.ndarray, b: jnp.ndarray,
               settings: Settings) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Calib + per-frame diagonal priors (stitchDouble usePrior branch)."""
    F = ba.F
    c_prior = jnp.full((4,), settings.initial_calib_hessian, jnp.float32)
    H = H.at[jnp.arange(4), jnp.arange(4)].add(c_prior)
    b = b.at[:4].add(c_prior * (ba.c - ba.c_zero))

    fprior = ba.prior * ba.frame_valid[:, None]         # (F,8)
    delta_prior = ba.state * ba.frame_valid[:, None]    # priorZero == 0
    didx = jnp.arange(CPARS, CPARS + 8 * F)
    H = H.at[didx, didx].add(fprior.reshape(-1))
    b = b.at[4:].add((fprior * delta_prior).reshape(-1))
    return H, b


def solve_system(ba: BAState, H_top: jnp.ndarray, b_top: jnp.ndarray,
                 H_sc: jnp.ndarray, b_sc: jnp.ndarray,
                 lam: float = 1e-5) -> jnp.ndarray:
    """The damped, Jacobi-preconditioned solve (solveSystemF,
    EnergyFunctional.cpp:1142-1148). Adds the FEJ-shifted marg prior.
    Returns x (D,) in internal units (step = -x)."""
    D = H_top.shape[0]
    # marginalization prior with FEJ delta shift
    delta = get_stitched_delta(ba)
    H = H_top + ba.HM
    b = b_top + ba.bM + ba.HM @ delta

    diag = jnp.diagonal(H) * (1.0 + lam)
    H = H.at[jnp.arange(D), jnp.arange(D)].set(diag)
    H = H - H_sc * (1.0 / (1.0 + lam))
    b = b - b_sc

    # mask invalid frame slots: unit diagonal, zero rhs
    m = state_mask(ba)
    H = H * m[:, None] * m[None, :]
    H = H + jnp.diag(1.0 - m)
    b = b * m

    svec_i = 1.0 / jnp.sqrt(jnp.abs(jnp.diagonal(H)) + 10.0)
    Hs = H * svec_i[:, None] * svec_i[None, :]
    x = svec_i * jnp.linalg.solve(Hs, svec_i * b)
    return x


def state_mask(ba: BAState) -> jnp.ndarray:
    """(D,) 1.0 for live state dims (calib + valid frames)."""
    fm = jnp.repeat(ba.frame_valid.astype(jnp.float32), 8)
    return jnp.concatenate([jnp.ones(4, jnp.float32), fm])


def get_stitched_delta(ba: BAState) -> jnp.ndarray:
    return jnp.concatenate(
        [ba.c - ba.c_zero, (ba.state - ba.state_zero).reshape(-1)]
    )


def resubstitute(sc: SchurData, x: jnp.ndarray) -> jnp.ndarray:
    """Per-point idepth step from the frame/calib solution x
    (resubstituteF/resubstituteFPt, EnergyFunctional.cpp:496-551)."""
    bshift = sc.bd - sc.vcross @ x
    return jnp.where(sc.has_res, -bshift * sc.HdiF, 0.0)
