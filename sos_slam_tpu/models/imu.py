"""Continuous-time cubic-spline visual-inertial fusion.

JAX rebuild of the SOS-SLAM spline VIO:
  * 21-dim per-keyframe IMU state [ba(3), bg(3), l_rot(3), q(6), c(6)]
    (reference src/FullSystem/HessianBlocks.h:316-424) with spline
    evaluators for predicted acc / gyro / relative rotation;
  * per-sample IMU residual Jacobians (getImuHi, HessianBlocks.cpp:178-223);
  * closed-form initialization from 5 KF poses (initializeImu, :253-355);
  * per-frame spline propagation from raw IMU (propagateImuState, :357-404);
  * the BA-side IMU Hessian: bias random walk, spline rotation / velocity
    hard constraints (KKT rows), per-sample dynamics terms with FEJ
    (EnergyFunctional::getImuHessian[CurrentFrame], EnergyFunctional.cpp:
    288-494) — all batched over frames and samples with masks;
  * global metric-scale state with trapping (CalibHessian::tryTrapScale,
    HessianBlocks.cpp:414-429).

State layout inside the (5 + 29F)-dim VIO system: [c(4), scale(1)] +
per-frame [dso(8), ba(3), bg(3), l_rot(3), q_t(3), q_r(3), c_t(3), c_r(3)].
All states in DSO internal units (scales below).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from sos_slam_tpu.ops import ba as B
from sos_slam_tpu.utils import lie
from sos_slam_tpu.utils.config import CPARS, Settings

HIGH = jax.lax.Precision.HIGHEST

# internal-unit scales (HessianBlocks.h:71-89)
SCALE_SCALE = 200.0
IMU_SCALE21 = jnp.array(
    [100.0] * 3       # ba
    + [1.0] * 3       # bg
    + [100.0] * 3     # l_rot
    + [1000.0] * 6    # q (trans, rot)
    + [1000.0] * 6,   # c (trans, rot)
    jnp.float32,
)

N_IMU = 128          # padded IMU samples per keyframe interval


class ImuState(NamedTuple):
    """Per-window IMU data + states (fixed shapes, slot-aligned with BAState)."""

    state: jnp.ndarray        # (F,21) internal units
    state_zero: jnp.ndarray   # (F,21) FEJ zero
    vel: jnp.ndarray          # (F,3) velInWorld per KF
    bias_valid: jnp.ndarray   # (F,) frames with imu states
    spline_valid: jnp.ndarray # (F,) spline usable between (i-1, i)
    timestamps: jnp.ndarray   # (F,)
    acc: jnp.ndarray          # (F,N_IMU,3) raw accelerometer
    gyro: jnp.ndarray         # (F,N_IMU,3)
    ts: jnp.ndarray           # (F,N_IMU) sample time minus frame time (<=0)
    imu_valid: jnp.ndarray    # (F,N_IMU)
    # scale state (CalibHessian)
    scale: jnp.ndarray        # () internal (real = *SCALE_SCALE)
    scale_zero: jnp.ndarray
    scale_trapped: jnp.ndarray  # bool
    scale_queue: jnp.ndarray    # (10,)
    queue_i: jnp.ndarray        # int32
    # VIO-mode marginalization prior at full (5+29F) dim
    HM: jnp.ndarray
    bM: jnp.ndarray


def empty_imu(F: int, scale_scaled: float = 1.0) -> ImuState:
    D = vio_dim(F)
    return ImuState(
        state=jnp.zeros((F, 21)), state_zero=jnp.zeros((F, 21)),
        vel=jnp.zeros((F, 3)),
        bias_valid=jnp.zeros(F, bool), spline_valid=jnp.zeros(F, bool),
        timestamps=jnp.zeros(F),
        acc=jnp.zeros((F, N_IMU, 3)), gyro=jnp.zeros((F, N_IMU, 3)),
        ts=jnp.zeros((F, N_IMU)), imu_valid=jnp.zeros((F, N_IMU), bool),
        scale=jnp.float32(scale_scaled / SCALE_SCALE),
        scale_zero=jnp.float32(scale_scaled / SCALE_SCALE),
        scale_trapped=jnp.array(False),
        scale_queue=jnp.zeros(10), queue_i=jnp.int32(0),
        HM=jnp.zeros((D, D)), bM=jnp.zeros(D),
    )


# ---------------------------------------------------------------------------
# spline evaluators (scaled/real units; state internal)
# ---------------------------------------------------------------------------

def _scaled(state21):
    return state21 * IMU_SCALE21


def spline_acc(state21, t):
    """World-frame translational acceleration (…, 3); t (…)."""
    s = _scaled(state21)
    return 2.0 * s[..., 9:12] + 6.0 * t[..., None] * s[..., 15:18]


def spline_gyro(state21, t):
    s = _scaled(state21)
    return (s[..., 6:9] + 2.0 * t[..., None] * s[..., 12:15]
            + 3.0 * (t * t)[..., None] * s[..., 18:21])


def spline_rot_c_t(state21, t):
    """R_{cam@frame <- cam@t}: (…,3,3)."""
    s = _scaled(state21)
    t2 = t * t
    so3 = (t[..., None] * s[..., 6:9] + t2[..., None] * s[..., 12:15]
           + (t * t2)[..., None] * s[..., 18:21])
    return lie.so3_exp(so3)


def spline_t_c2t(state21, vel, t):
    """Translation of cam@t relative to cam@frame in world (…,3)."""
    s = _scaled(state21)
    t2 = t * t
    return (t[..., None] * vel + t2[..., None] * s[..., 9:12]
            + (t * t2)[..., None] * s[..., 15:18])


# ---------------------------------------------------------------------------
# the IMU Hessian (vision-window side)
# ---------------------------------------------------------------------------

def vio_dim(F: int) -> int:
    return CPARS + 1 + 29 * F


def expand_vision_Hb(H8: jnp.ndarray, b8: jnp.ndarray, F: int):
    """Scatter the (4+8F) vision system into the (5+29F) VIO layout
    (expandHbtoFitImu, EnergyFunctional.cpp:256-286)."""
    D = vio_dim(F)
    idx = jnp.concatenate(
        [jnp.arange(CPARS),
         (CPARS + 1 + 29 * jnp.arange(F)[:, None]
          + jnp.arange(8)[None, :]).reshape(-1)])
    H = jnp.zeros((D, D), H8.dtype).at[jnp.ix_(idx, idx)].set(H8)
    b = jnp.zeros((D,), b8.dtype).at[idx].set(b8)
    return H, b


def _frame_block(i):
    return CPARS + 1 + 29 * i


def imu_sample_jacobians(ba: B.BAState, imu: ImuState, settings: Settings,
                         rot_imu_cam: jnp.ndarray, gravity: jnp.ndarray,
                         weight_imu: jnp.ndarray):
    """Per-(frame, sample) residuals + FEJ Jacobians (getImuHi batched).

    Returns (r (F,N,6), Js (F,N,6), Jf (F,N,6,29), valid (F,N)).
    Jacobian state: state_imu_zero + camToWorld_evalPT + scale_zero when
    trapped, current otherwise (exactly the reference's split).
    """
    F = ba.F
    tt = imu.ts                                   # (F,N) <= 0
    trapped = imu.scale_trapped

    st_cur = imu.state                            # internal
    st_jac = jnp.where(trapped, imu.state_zero, imu.state)
    s_cur = imu.scale * SCALE_SCALE
    s_jac = jnp.where(trapped, imu.scale_zero, imu.scale) * SCALE_SCALE

    # residual at CURRENT state
    R_ct = spline_rot_c_t(st_cur[:, None, :], tt)        # (F,N,3,3)
    T_cw = B.state_to_pose(ba.T_cw_eval, ba.state)
    R_wc = jnp.swapaxes(T_cw[:, :3, :3], -1, -2)         # worldToCam current
    acc_w = s_cur * spline_acc(st_cur[:, None, :], tt) + gravity
    rot_t_w = jnp.einsum("fnji,fjk->fnik", R_ct, R_wc, precision=HIGH)
    acc_pred = jnp.einsum("ij,fnjk,fnk->fni", rot_imu_cam, rot_t_w, acc_w,
                          precision=HIGH)
    gyro_pred = jnp.einsum("ij,fnj->fni", rot_imu_cam,
                           spline_gyro(st_cur[:, None, :], tt))
    bias = _scaled(st_cur)[:, :6]
    r = jnp.concatenate([acc_pred, gyro_pred], -1) + bias[:, None, :] \
        - jnp.concatenate([imu.acc, imu.gyro], -1)       # (F,N,6)

    # Jacobians at FEJ state
    R_ct0 = spline_rot_c_t(st_jac[:, None, :], tt)
    R_wc0 = jnp.swapaxes(ba.T_cw_eval[:, :3, :3], -1, -2)
    acc_w0 = s_jac * spline_acc(st_jac[:, None, :], tt) + gravity
    rot_t_w0 = jnp.einsum("fnji,fjk->fnik", R_ct0, R_wc0, precision=HIGH)
    rot_i_w = jnp.einsum("ij,fnjk->fnik", rot_imu_cam, rot_t_w0)
    Racc = jnp.einsum("fnij,fnj->fni", rot_t_w0, acc_w0, precision=HIGH)
    R_acc_hat = jnp.einsum("ij,fnjk->fnik", rot_imu_cam, lie.so3_hat(Racc))

    N = tt.shape[1]
    Jf = jnp.zeros((F, N, 6, 29))
    I3 = jnp.eye(3)
    tt1 = tt[..., None, None]
    # acc rows (0:3)
    acc_rot_dso = jnp.einsum("fnij,fnjk->fnik", rot_i_w,
                             lie.so3_hat(acc_w0))       # d acc / d dso-rot
    Jf = Jf.at[..., 0:3, 3:6].set(
        jnp.where(trapped, B.SCALE_XI_ROT * acc_rot_dso, 0.0))
    Jf = Jf.at[..., 0:3, 8:11].set(100.0 * I3)                    # ba
    Jf = Jf.at[..., 0:3, 14:17].set(100.0 * R_acc_hat * tt1)      # l_rot
    Jf = Jf.at[..., 0:3, 20:23].set(1000.0 * R_acc_hat * tt1 ** 2)
    Jf = Jf.at[..., 0:3, 26:29].set(1000.0 * R_acc_hat * tt1 ** 3)
    Jf = Jf.at[..., 0:3, 17:20].set(1000.0 * rot_i_w * 2.0
                                    * s_jac)                      # q_trans
    Jf = Jf.at[..., 0:3, 23:26].set(1000.0 * rot_i_w * 6.0 * tt1
                                    * s_jac)                      # c_trans
    # gyro rows (3:6)
    Jf = Jf.at[..., 3:6, 11:14].set(1.0 * I3)                     # bg
    Jf = Jf.at[..., 3:6, 14:17].set(100.0 * rot_imu_cam)
    Jf = Jf.at[..., 3:6, 20:23].set(1000.0 * rot_imu_cam * 2.0 * tt1)
    Jf = Jf.at[..., 3:6, 26:29].set(1000.0 * rot_imu_cam * 3.0 * tt1 ** 2)

    Js = jnp.zeros((F, N, 6))
    Js = Js.at[..., 0:3].set(
        SCALE_SCALE * jnp.einsum("fnij,fnj->fni", rot_i_w,
                                 spline_acc(st_jac[:, None, :], tt)))
    valid = imu.imu_valid & imu.spline_valid[:, None] & ba.frame_valid[:, None]
    return r, Js, Jf, valid


def imu_hessian(ba: B.BAState, imu: ImuState, settings: Settings):
    """H, b, J_cst, r_cst, cst_valid for the (5+29F)-dim VIO system
    (getImuHessian, EnergyFunctional.cpp:457-494)."""
    F = ba.F
    D = vio_dim(F)
    w_imu, w_bias = settings.imu_weights()
    weight_imu = jnp.asarray(w_imu, jnp.float32)
    weight_bias = jnp.asarray(w_bias, jnp.float32)
    rot_imu_cam = jnp.asarray(settings.rot_imu_cam, jnp.float32).reshape(3, 3)
    gravity = jnp.asarray(settings.gravity, jnp.float32)

    H = jnp.zeros((D, D))
    b = jnp.zeros(D)

    # ---- bias random walk between consecutive frames ----
    dts = imu.timestamps[1:] - imu.timestamps[:-1]      # (F-1,)
    pair_valid = ba.frame_valid[1:] & ba.frame_valid[:-1] \
        & imu.bias_valid[1:] & imu.bias_valid[:-1]
    sba = jnp.concatenate([jnp.full(3, 100.0), jnp.full(3, 1.0)])
    Wb = weight_bias * sba[:, None] * sba[None, :]
    bias = imu.state[:, :6]   # internal
    for i in range(F - 1):
        blk_p = _frame_block(i) + 8
        blk_c = _frame_block(i + 1) + 8
        wi = jnp.where(pair_valid[i], 1.0 / jnp.maximum(dts[i], 1e-3), 0.0)
        Hb = Wb * wi
        H = H.at[blk_p:blk_p + 6, blk_p:blk_p + 6].add(Hb)
        H = H.at[blk_c:blk_c + 6, blk_c:blk_c + 6].add(Hb)
        H = H.at[blk_p:blk_p + 6, blk_c:blk_c + 6].add(-Hb)
        H = H.at[blk_c:blk_c + 6, blk_p:blk_p + 6].add(-Hb)
        r_b = (bias[i + 1] - bias[i]) * sba       # real-unit residual
        tb = (weight_bias * wi) @ r_b * sba
        b = b.at[blk_p:blk_p + 6].add(-tb)
        b = b.at[blk_c:blk_c + 6].add(tb)

    # ---- per-sample dynamics terms ----
    r, Js, Jf, valid = imu_sample_jacobians(
        ba, imu, settings, rot_imu_cam, gravity, weight_imu)
    vf = valid.astype(jnp.float32)
    JfW = jnp.einsum("fnri,rs->fnis", Jf, weight_imu, precision=HIGH)  # (F,N,29,6)
    Hff = jnp.einsum("fnis,fnsj->fij", JfW * vf[..., None, None], Jf,
                     precision=HIGH)                     # (F,29,29)
    Hfs = jnp.einsum("fnis,fns->fi", JfW * vf[..., None, None], Js,
                     precision=HIGH)                     # (F,29)
    Hss = jnp.einsum("fnr,rs,fns,fn->", Js, weight_imu, Js, vf,
                     precision=HIGH)
    bf = jnp.einsum("fnis,fns,fn->fi", JfW, r, vf, precision=HIGH)
    bs = jnp.einsum("fnr,rs,fns,fn->", Js, weight_imu, r, vf, precision=HIGH)

    H = H.at[CPARS, CPARS].add(Hss)
    b = b.at[CPARS].add(bs)
    for i in range(F):
        blk = _frame_block(i)
        H = H.at[blk:blk + 29, blk:blk + 29].add(Hff[i])
        H = H.at[blk:blk + 29, CPARS].add(Hfs[i])
        H = H.at[CPARS, blk:blk + 29].add(Hfs[i])
        b = b.at[blk:blk + 29].add(bf[i])

    # ---- spline rotation + velocity constraints (KKT rows) ----
    C = 6 * (F - 1)
    J_cst = jnp.zeros((C, D))
    r_cst = jnp.zeros(C)
    cst_valid = jnp.zeros(C, bool)
    T_cw = B.state_to_pose(ba.T_cw_eval, ba.state)
    R_w_eval = ba.T_cw_eval[:, :3, :3]
    n = jnp.sum(ba.frame_valid)
    for i in range(1, F):
        row = 6 * (i - 1)
        blk_p, blk_c = _frame_block(i - 1), _frame_block(i)
        tpf = imu.timestamps[i - 1] - imu.timestamps[i]
        sv = imu.spline_valid[i] & ba.frame_valid[i] & ba.frame_valid[i - 1]
        # rotation constraint
        R_pred = spline_rot_c_t(imu.state[i], tpf)
        R_meas = jnp.swapaxes(T_cw[i, :3, :3], -1, -2) @ T_cw[i - 1, :3, :3]
        r_rot = lie.so3_log(R_meas.T @ R_pred)
        rot_p_w = jnp.swapaxes(R_w_eval[i - 1], -1, -2)
        J_cst = J_cst.at[row:row + 3, blk_p + 3:blk_p + 6].set(
            -B.SCALE_XI_ROT * rot_p_w * sv)
        J_cst = J_cst.at[row:row + 3, blk_c + 3:blk_c + 6].set(
            B.SCALE_XI_ROT * rot_p_w * sv)
        I3 = jnp.eye(3)
        J_cst = J_cst.at[row:row + 3, blk_c + 14:blk_c + 17].set(
            100.0 * tpf * I3 * sv)
        J_cst = J_cst.at[row:row + 3, blk_c + 20:blk_c + 23].set(
            1000.0 * tpf ** 2 * I3 * sv)
        J_cst = J_cst.at[row:row + 3, blk_c + 26:blk_c + 29].set(
            1000.0 * tpf ** 3 * I3 * sv)
        r_cst = r_cst.at[row:row + 3].set(r_rot * sv)
        cst_valid = cst_valid.at[row:row + 3].set(sv)

        # velocity constraint (needs a next frame)
        if i + 1 < F:
            blk_n = _frame_block(i + 1)
            tnf = imu.timestamps[i] - imu.timestamps[i + 1]
            vv = sv & imu.spline_valid[i + 1] & ba.frame_valid[i + 1]
            tpf_s = jnp.where(jnp.abs(tpf) < 1e-6, -1e-6, tpf)
            tnf_s = jnp.where(jnp.abs(tnf) < 1e-6, -1e-6, tnf)
            sq_c = _scaled(imu.state[i])
            sq_n = _scaled(imu.state[i + 1])
            d_vel_dso = (T_cw[i - 1, :3, 3] - T_cw[i, :3, 3]) / tpf_s \
                - (T_cw[i, :3, 3] - T_cw[i + 1, :3, 3]) / tnf_s
            d_vel_imu = (tpf * sq_c[9:12] + tpf ** 2 * sq_c[15:18]
                         + tnf * sq_n[9:12] + 2 * tnf ** 2 * sq_n[15:18])
            J_cst = J_cst.at[row + 3:row + 6, blk_p:blk_p + 3].set(
                -B.SCALE_XI_TRANS / tpf_s * I3 * vv)
            J_cst = J_cst.at[row + 3:row + 6, blk_c:blk_c + 3].set(
                B.SCALE_XI_TRANS * (1.0 / tpf_s + 1.0 / tnf_s) * I3 * vv)
            J_cst = J_cst.at[row + 3:row + 6, blk_n:blk_n + 3].set(
                -B.SCALE_XI_TRANS / tnf_s * I3 * vv)
            J_cst = J_cst.at[row + 3:row + 6, blk_c + 17:blk_c + 20].set(
                1000.0 * tpf * I3 * vv)
            J_cst = J_cst.at[row + 3:row + 6, blk_c + 23:blk_c + 26].set(
                1000.0 * tpf ** 2 * I3 * vv)
            J_cst = J_cst.at[row + 3:row + 6, blk_n + 17:blk_n + 20].set(
                1000.0 * tnf * I3 * vv)
            J_cst = J_cst.at[row + 3:row + 6, blk_n + 23:blk_n + 26].set(
                1000.0 * 2 * tnf ** 2 * I3 * vv)
            r_cst = r_cst.at[row + 3:row + 6].set((d_vel_imu - d_vel_dso) * vv)
            cst_valid = cst_valid.at[row + 3:row + 6].set(vv)

    return H, b, J_cst, r_cst, cst_valid


def vio_state_mask(ba: B.BAState, imu: ImuState, settings: Settings):
    """(D,) live-dimension mask: calib + (scale iff not stereo-driven) +
    per-frame [8 dso | 6 bias | 15 spline iff spline_valid]
    (the unconstrained-state elision, EnergyFunctional.cpp:1113-1132)."""
    F = ba.F
    D = vio_dim(F)
    m = jnp.zeros(D)
    m = m.at[:CPARS].set(1.0)
    m = m.at[CPARS].set(0.0 if settings.enable_scale_opt else 1.0)
    for i in range(F):
        blk = _frame_block(i)
        fv = ba.frame_valid[i].astype(jnp.float32)
        m = m.at[blk:blk + 8].set(fv)
        m = m.at[blk + 8:blk + 14].set(fv * imu.bias_valid[i])
        m = m.at[blk + 14:blk + 29].set(
            fv * (imu.spline_valid[i] & imu.bias_valid[i]))
    return m


def solve_vio(ba: B.BAState, imu: ImuState, H8, b8, H8_sc, b8_sc,
              HM, bM, settings: Settings, lam: float = 1e-5):
    """The full VIO KKT solve (solveSystemF, EnergyFunctional.cpp:1029-1184).

    Returns (x8 (4+8F) vision step source, x_scale, x_imu (F,21)).
    """
    F = ba.F
    D = vio_dim(F)
    H, b = expand_vision_Hb(H8, b8, F)
    H_sc, b_sc = expand_vision_Hb(H8_sc, b8_sc, F)

    H_imu, b_imu, J_cst, r_cst, cst_valid = imu_hessian(ba, imu, settings)
    H = H + H_imu
    b = b + b_imu

    # marg prior with FEJ delta (delta2 construction, :1073-1088)
    delta8 = get_vio_delta(ba, imu)
    H = H + HM
    b = b + bM + HM @ delta8

    # damping + Schur part
    H = H.at[jnp.arange(D), jnp.arange(D)].mul(1.0 + lam)
    H = H - H_sc / (1.0 + lam)
    b = b - b_sc

    # elision masking
    m = vio_state_mask(ba, imu, settings)
    H = H * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
    b = b * m
    J_cst = J_cst * m[None, :]

    # KKT assembly
    C = J_cst.shape[0]
    cm = cst_valid.astype(jnp.float32)
    J_cst = J_cst * cm[:, None]
    r_cst = r_cst * cm
    K = jnp.zeros((D + C, D + C))
    K = K.at[:D, :D].set(H)
    K = K.at[:D, D:].set(J_cst.T)
    K = K.at[D:, :D].set(J_cst)
    K = K.at[D + jnp.arange(C), D + jnp.arange(C)].set(1.0 - cm)
    rhs = jnp.concatenate([b, r_cst])

    svec_i = 1.0 / jnp.sqrt(jnp.abs(jnp.diagonal(K)) + 10.0)
    Ks = K * svec_i[:, None] * svec_i[None, :]
    x_full = svec_i * jnp.linalg.solve(Ks, svec_i * rhs)
    x = x_full[:D]

    # extract: vision 8F part, scale, imu 21F part
    idx8 = jnp.concatenate(
        [jnp.arange(CPARS),
         (CPARS + 1 + 29 * jnp.arange(F)[:, None]
          + jnp.arange(8)[None, :]).reshape(-1)])
    x8 = x[idx8]
    x_scale = x[CPARS]
    idx21 = (CPARS + 1 + 8 + 29 * jnp.arange(F)[:, None]
             + jnp.arange(21)[None, :]).reshape(-1)
    x_imu = x[idx21].reshape(F, 21)
    return x8, x_scale, x_imu


def get_vio_delta(ba: B.BAState, imu: ImuState) -> jnp.ndarray:
    """FEJ delta in the (5+29F) layout; imu/scale deltas only once trapped."""
    F = ba.F
    D = vio_dim(F)
    d = jnp.zeros(D)
    d = d.at[:CPARS].set(ba.c - ba.c_zero)
    d = d.at[CPARS].set(jnp.where(imu.scale_trapped,
                                  imu.scale - imu.scale_zero, 0.0))
    d8 = ba.state - ba.state_zero
    d21 = jnp.where(imu.scale_trapped, imu.state - imu.state_zero, 0.0)
    for i in range(F):
        blk = _frame_block(i)
        d = d.at[blk:blk + 8].set(d8[i])
        d = d.at[blk + 8:blk + 29].set(d21[i])
    return d


# ---------------------------------------------------------------------------
# initialization / propagation (host-side small solves)
# ---------------------------------------------------------------------------

def initialize_imu(ba: B.BAState, imu: ImuState, settings: Settings):
    """Closed-form spline + gyro-bias + scale init from 5 KFs
    (FrameHessian::initializeImu, HessianBlocks.cpp:253-355).
    Returns (imu, ok)."""
    rot_imu_cam = jnp.asarray(settings.rot_imu_cam, jnp.float32).reshape(3, 3)
    gravity = jnp.asarray(settings.gravity, jnp.float32)
    T_cw = B.state_to_pose(ba.T_cw_eval, ba.state)
    base = 4    # newest of the 5 KFs (slots 0..4)
    ts = imu.timestamps

    # cubic fit through relative poses of frames 1..3 wrt base
    A = jnp.zeros((3, 3))
    rhs = jnp.zeros((3, 6))
    for i in range(3):
        t0 = ts[i + 1] - ts[base]
        A = A.at[i].set(jnp.array([t0, t0 * t0, t0 ** 3]))
        rel = lie.se3_log(lie.se3_inv(T_cw[base]) @ T_cw[i + 1])
        rhs = rhs.at[i, 3:].set(rel[3:])
        rhs = rhs.at[i, :3].set(T_cw[i + 1, :3, 3] - T_cw[base, :3, 3])
    x = jnp.linalg.solve(A, rhs)          # rows: l0, q0, c0 (real units)
    l0, q0, c0 = x[0], x[1], x[2]

    state = imu.state
    vel = imu.vel
    for i in range(5):
        t0 = ts[i] - ts[base]
        v = l0 + 2 * q0 * t0 + 3 * c0 * t0 * t0
        q_i = q0 + 3 * c0 * t0
        s21 = jnp.zeros(21)
        s21 = s21.at[6:9].set(v[3:])          # l_rot
        s21 = s21.at[9:12].set(q_i[:3])       # q_trans
        s21 = s21.at[12:15].set(q_i[3:])      # q_rot
        s21 = s21.at[15:18].set(c0[:3])
        s21 = s21.at[18:21].set(c0[3:])
        state = state.at[i].set(s21 / IMU_SCALE21)
        vel = vel.at[i].set(v[:3])

    # gyro bias from frames 2..4 samples against the base spline
    sel = jnp.zeros((ba.F,), bool).at[2].set(True).at[3].set(True).at[4].set(True)
    mask = imu.imu_valid & sel[:, None]
    t_all = (imu.ts + ts[:, None]) - ts[base]     # sample time wrt base frame
    gyro_pred = jnp.einsum("ij,fnj->fni", rot_imu_cam,
                           spline_gyro(state[base][None, None, :], t_all))
    dg = jnp.where(mask[..., None], imu.gyro - gyro_pred, 0.0)
    n_samples = jnp.maximum(jnp.sum(mask), 1)
    gyro_bias = jnp.sum(dg, (0, 1)) / n_samples
    state = state.at[:5, 3:6].set(gyro_bias[None, :] / 1.0)  # SCALE_BG=1

    # scale (mono+imu only): LSQ acc_pred*s = acc_meas - R g
    scale_scaled = imu.scale * SCALE_SCALE
    if not settings.enable_scale_opt:
        R_ct = spline_rot_c_t(state[base][None, None, :], t_all)
        R_wc = jnp.swapaxes(T_cw[base, :3, :3], -1, -2)
        rot_ti_w = jnp.einsum("ij,fnkj,kl->fnil", rot_imu_cam, R_ct,
                              R_wc, precision=HIGH)
        acc_pred = jnp.einsum("fnij,fnj->fni", rot_ti_w,
                              spline_acc(state[base][None, None, :], t_all))
        acc_meas = imu.acc - jnp.einsum("fnij,j->fni", rot_ti_w, gravity)
        msk = mask[..., None].astype(jnp.float32)
        num = jnp.sum(acc_pred * acc_meas * msk)
        den = jnp.maximum(jnp.sum(acc_pred * acc_pred * msk), 1e-9)
        scale_scaled = num / den

    ok = scale_scaled > 0
    imu = imu._replace(
        state=state, state_zero=state, vel=vel,
        bias_valid=imu.bias_valid | (jnp.arange(ba.F) < 5),
        spline_valid=imu.spline_valid.at[1:5].set(True),
        scale=scale_scaled / SCALE_SCALE,
        scale_zero=scale_scaled / SCALE_SCALE,
    )
    return imu, ok


def propagate_imu_state(imu: ImuState, slot: int, last_ts, last_vel,
                        last_R_wc_world, last_bias6, settings: Settings):
    """Fit this frame's spline from raw IMU between the last KF and now
    (propagateImuState, HessianBlocks.cpp:357-404). Host-side tiny LSQ."""
    rot_imu_cam = jnp.asarray(settings.rot_imu_cam, jnp.float32).reshape(3, 3)
    gravity = jnp.asarray(settings.gravity, jnp.float32)
    acc = imu.acc[slot]
    gyro = imu.gyro[slot]
    ts_rel = imu.ts[slot]
    valid = imu.imu_valid[slot]
    scale_scaled = imu.scale * SCALE_SCALE

    ub_acc = acc - last_bias6[:3]
    ub_gyro = gyro - last_bias6[3:]

    # integrate gyro to world rotations at each sample (cumulative)
    ts_abs = ts_rel + imu.timestamps[slot]
    dt = jnp.diff(ts_abs, prepend=last_ts)
    dt = jnp.where(valid, jnp.maximum(dt, 0.0), 0.0)

    def step(R, inp):
        w, d = inp
        R2 = R @ lie.so3_exp(w * d)
        return R2, R2

    _, R_stack = jax.lax.scan(step, last_R_wc_world, (ub_gyro, dt))
    t = ts_rel
    Aa = jnp.stack([jnp.zeros_like(t), 2 * scale_scaled * jnp.ones_like(t),
                    6 * t * scale_scaled], -1)          # (N,3)
    ba_rhs = jnp.einsum("nij,jk,nk->ni", R_stack, rot_imu_cam.T, ub_acc) \
        - gravity
    Ag = jnp.stack([jnp.ones_like(t), 2 * t, 3 * t * t], -1)
    bg_rhs = jnp.einsum("ij,nj->ni", rot_imu_cam.T, ub_gyro)

    vm = valid.astype(jnp.float32)[:, None]
    AtA_a = (Aa * vm).T @ Aa + 1e-6 * jnp.eye(3)
    xa = jnp.linalg.solve(AtA_a, (Aa * vm).T @ ba_rhs)   # (3,3) rows 1,2 used
    AtA_g = (Ag * vm).T @ Ag + 1e-6 * jnp.eye(3)
    xg = jnp.linalg.solve(AtA_g, (Ag * vm).T @ bg_rhs)

    s21 = jnp.zeros(21)
    s21 = s21.at[0:6].set(last_bias6)
    s21 = s21.at[9:12].set(xa[1])
    s21 = s21.at[15:18].set(xa[2])
    s21 = s21.at[6:9].set(xg[0])
    s21 = s21.at[12:15].set(xg[1])
    s21 = s21.at[18:21].set(xg[2])
    state = imu.state.at[slot].set(s21 / IMU_SCALE21)

    t_last = last_ts - imu.timestamps[slot]
    vel_new = last_vel - (2 * t_last * s21[9:12] + 3 * t_last ** 2 * s21[15:18])
    return imu._replace(
        state=state,
        state_zero=imu.state_zero.at[slot].set(s21 / IMU_SCALE21),
        vel=imu.vel.at[slot].set(vel_new),
        bias_valid=imu.bias_valid.at[slot].set(True),
    )


def try_trap_scale(imu: ImuState, thres: float):
    """Scale trapping by queue variance (tryTrapScale)."""
    q = imu.scale_queue.at[imu.queue_i].set(imu.scale)
    qi = (imu.queue_i + 1) % 10
    var = (SCALE_SCALE ** 2 / 9.0) * jnp.sum((q - q.mean()) ** 2)
    trapped = var < thres
    return imu._replace(
        scale_queue=q, queue_i=qi,
        scale_trapped=imu.scale_trapped | trapped,
        scale_zero=jnp.where(trapped, q.mean(), imu.scale),
    )
