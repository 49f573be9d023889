"""Lanes-last (transposed) forms of the BA linearization + accumulation.

Same math as ops/ba.py (PointFrameResidual::linearize,
src/FullSystem/Residuals.cpp:77-271; AccumulatedTopHessian.cpp:35-147;
AccumulatedSCHessian.cpp:32-79) in a lanes-last memory layout.

Why: a compiler that tiles the LAST TWO dims of every f32 array to
(8, 128) pads the ba.py forms' per-residual data — (P, F, 8) /
(P, F, 2, 10), minor dims of 8/10/2 — up to 128 lanes. These forms put the
big point axis LAST: per-tap arrays are (F, K=8, P), per-(p,f) features are
(F, C, P), and reductions over points become (13, N)x(N, 13) contractions.

Host-indexed gathers (R0[host], adHost[host], ...) are replaced by
one-hot contractions over the F<=8 frame slots: F-fold redundant FLOPs
(trivial at these sizes) instead of (P, F, 3, 3)-shaped padded gathers.

Everything here is algebraically identical to the ba.py forms
(summation order differs -> f32 rounding differs at ~1e-6 relative);
tests/test_ba_t.py checks every output against them.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from sos_slam_tpu.ops import ba as B
from sos_slam_tpu.utils.config import CPARS, PATTERN_OFFSETS, Settings

HIGH = jax.lax.Precision.HIGHEST


def enabled() -> bool:
    """Use the lanes-last BA forms on the device path. Default OFF: the
    reference-shaped einsum forms (ops/ba.py) measured faster where this
    layout was first tried, and it has not been measured on the GPU.
    Kept as a tested alternative form; SOS_SLAM_BA_T=1 opts in."""
    v = os.environ.get("SOS_SLAM_BA_T")
    if v is not None:
        return v == "1"
    return False


class LinDataT(NamedTuple):
    """Transposed twin of ba.LinData — same quantities, lanes-last."""

    X: jnp.ndarray        # (F,2,10,P)
    Jpdd: jnp.ndarray     # (F,2,P)
    resF: jnp.ndarray     # (F,8,P)
    JIdx: jnp.ndarray     # (F,2,8,P)
    JabF: jnp.ndarray     # (F,2,8,P)
    JIdx2: jnp.ndarray    # (F,2,2,P)
    JabJIdx: jnp.ndarray  # (F,2,2,P)
    Jab2: jnp.ndarray     # (F,2,2,P)
    energy: jnp.ndarray   # (F,P)
    energy_raw: jnp.ndarray  # (F,P)
    new_state: jnp.ndarray   # (F,P) int8
    active: jnp.ndarray   # (F,P) bool
    onehot: jnp.ndarray   # (P,F) host one-hot (reused by every consumer)


def linearize_t(ba: B.BAState, pre: B.Precalc, dI: jnp.ndarray,
                settings: Settings, w: int, h: int) -> LinDataT:
    """Batched PointFrameResidual::linearize, lanes-last layout."""
    fx, fy, cx, cy = B.calib_real(ba)
    F, P = ba.F, ba.P
    pat = jnp.asarray(PATTERN_OFFSETS, jnp.float32)      # (8,2)

    onehot = jax.nn.one_hot(ba.host, F, dtype=jnp.float32)  # (P,Fh)
    onehotT = onehot.T                                        # (Fh,P)

    # host-row precalc entries per point, via one-hot contraction:
    # Xe[f,i,j,p] = R0[host[p],f,i,j] etc. — F-fold FLOP redundancy instead
    # of a (P,F,3,3) padded gather.
    def hsel(a):  # (Fh, Ft, ...) -> (Ft, ..., P)
        return jnp.einsum("h...,ph->...p", a, onehot, precision=HIGH)

    R0e = hsel(pre.R0)        # (F,3,3,P)
    t0e = hsel(pre.t0)        # (F,3,P)
    Rce = hsel(pre.R)         # (F,3,3,P)
    tce = hsel(pre.t)         # (F,3,P)
    affe = hsel(pre.affLL)    # (F,2,P)
    b0e = jnp.einsum("ph,h->p", onehot, pre.b0, precision=HIGH)  # (P,)

    # ---- geometry part at FEJ (center pixel, idepth_zero) ----
    KliP = jnp.stack(
        [(ba.u - cx) / fx, (ba.v - cy) / fy, jnp.ones_like(ba.u)], 0
    )  # (3,P)
    ptp = (jnp.einsum("fijp,jp->fip", R0e, KliP, precision=HIGH)
           + t0e * ba.idepth_zero[None, None, :])            # (F,3,P)
    drescale = 1.0 / ptp[:, 2]                                # (F,P)
    geo_ok = drescale > 0
    new_idepth = ba.idepth_zero[None, :] * drescale
    u_ = ptp[:, 0] * drescale
    v_ = ptp[:, 1] * drescale
    Ku = u_ * fx + cx
    Kv = v_ * fy + cy
    geo_ok &= (Ku > 1.1) & (Kv > 1.1) & (Ku < w - 3) & (Kv < h - 3)

    # d proj / d idepth (F,2,P)
    Jpdd = jnp.stack(
        [
            drescale * (t0e[:, 0] - t0e[:, 2] * u_) * B.SCALE_IDEPTH * fx,
            drescale * (t0e[:, 1] - t0e[:, 2] * v_) * B.SCALE_IDEPTH * fy,
        ],
        1,
    )

    # d proj / d calib — internal units (Residuals.cpp:122-143)
    A = drescale * (R0e[:, 2, 0] * u_ - R0e[:, 0, 0])
    Bv = fx * drescale * (R0e[:, 2, 1] * u_ - R0e[:, 0, 1]) / fy
    C = fy * drescale * (R0e[:, 2, 0] * v_ - R0e[:, 1, 0]) / fx
    Dv = drescale * (R0e[:, 2, 1] * v_ - R0e[:, 1, 1])
    k0 = KliP[0][None, :]
    k1 = KliP[1][None, :]
    d_C_x = jnp.stack(
        [(k0 * A + u_) * B.SCALE_F, k1 * Bv * B.SCALE_F,
         (A + 1.0) * B.SCALE_C, Bv * B.SCALE_C], 1,
    )  # (F,4,P)
    d_C_y = jnp.stack(
        [k0 * C * B.SCALE_F, (k1 * Dv + v_) * B.SCALE_F,
         C * B.SCALE_C, (Dv + 1.0) * B.SCALE_C], 1,
    )

    # d proj / d xi_rel — real units (adjoints carry the scales)
    idp = new_idepth
    zero = jnp.zeros_like(u_)
    d_xi_x = jnp.stack(
        [idp * fx, zero, -idp * u_ * fx,
         -u_ * v_ * fx, (1 + u_ * u_) * fx, -v_ * fx], 1,
    )  # (F,6,P)
    d_xi_y = jnp.stack(
        [zero, idp * fy, -idp * v_ * fy,
         -(1 + v_ * v_) * fy, u_ * v_ * fy, u_ * fy], 1,
    )
    X = jnp.stack(
        [jnp.concatenate([d_C_x, d_xi_x], 1),
         jnp.concatenate([d_C_y, d_xi_y], 1)], 1,
    )  # (F,2,10,P)

    # ---- pattern part at current state ----
    up = ba.u[None, :] + pat[:, 0:1]    # (8,P)
    vp = ba.v[None, :] + pat[:, 1:2]
    KliPp = jnp.stack(
        [(up - cx) / fx, (vp - cy) / fy, jnp.ones_like(up)], 0
    )  # (3,8,P)
    ptp_c = (jnp.einsum("fijp,jkp->fikp", Rce, KliPp, precision=HIGH)
             + tce[:, :, None, :] * ba.idepth[None, None, None, :])
    z = ptp_c[:, 2]                     # (F,8,P)
    pat_ok = z > 1e-6
    Kup = ptp_c[:, 0] / z * fx + cx
    Kvp = ptp_c[:, 1] / z * fy + cy
    pat_ok &= (Kup > 1.1) & (Kvp > 1.1) & (Kup < w - 3) & (Kvp < h - 3)

    # planar-channel 4-corner gathers: idx (F,8,P) over (F*H*W,) channel
    # rows — every take output is (F,8,P), the point axis last
    H_, W_ = dI.shape[1], dI.shape[2]
    flatT = dI.reshape(F * H_ * W_, 3).T       # (3, F*H*W)
    x0 = jnp.clip(jnp.floor(Kup), 0, W_ - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(Kvp), 0, H_ - 2).astype(jnp.int32)
    dx = jnp.clip(Kup - x0, 0.0, 1.0)
    dy = jnp.clip(Kvp - y0, 0.0, 1.0)
    fofs = (jnp.arange(F, dtype=jnp.int32) * (H_ * W_))[:, None, None]
    idx = fofs + y0 * W_ + x0

    def sample(c):
        row = flatT[c]
        tl = jnp.take(row, idx)
        tr = jnp.take(row, idx + 1)
        bl = jnp.take(row, idx + W_)
        br = jnp.take(row, idx + W_ + 1)
        return (tl * (1 - dx) * (1 - dy) + tr * dx * (1 - dy)
                + bl * (1 - dx) * dy + br * dx * dy)

    hitI, gx, gy = sample(0), sample(1), sample(2)   # each (F,8,P)
    hit_ok = jnp.isfinite(hitI)
    ok = geo_ok[:, None, :] & pat_ok & hit_ok
    oob = ~jnp.all(ok, 1)               # (F,P)

    colorT = ba.color.T                 # (8,P)
    weightT = ba.weight.T               # (8,P)
    r = hitI - (affe[:, 0:1, :] * colorT[None] + affe[:, 1:2, :])
    drdA = colorT[None] - b0e[None, None, :]
    wgrad = jnp.sqrt(
        settings.outlier_th_sum_component
        / (settings.outlier_th_sum_component + gx * gx + gy * gy))
    wgt = 0.5 * (wgrad + weightT[None])
    abs_r = jnp.abs(r)
    hw = jnp.where(abs_r < settings.huber_th, 1.0,
                   settings.huber_th / jnp.maximum(abs_r, 1e-9))
    energy_raw = jnp.sum(wgt * wgt * hw * r * r * (2.0 - hw), 1)   # (F,P)

    hw2 = jnp.where(hw < 1.0, jnp.sqrt(hw), hw) * wgt
    JIdx = jnp.stack([gx * hw2, gy * hw2], 1)       # (F,2,8,P)
    resF = r * hw2                                   # (F,8,P)
    JabF = jnp.stack([drdA * hw2, jnp.broadcast_to(hw2, hw2.shape)], 1)

    wJI2 = jnp.sum(hw2 * hw2 * (gx * gx + gy * gy), 1)   # (F,P)

    # outlier decision (Residuals.cpp:253-265)
    th_h = jnp.einsum("ph,h->p", onehot, ba.energy_th, precision=HIGH)  # (P,)
    th = jnp.maximum(th_h[None, :], ba.energy_th[:, None])   # (F,P)
    outlier = (energy_raw > th) | (wJI2 < 2.0)
    energy = jnp.where(outlier, th, energy_raw)

    prev_oob = ba.res_state.T == B.RES_OOB           # (F,P)
    new_state = jnp.where(
        oob | prev_oob, B.RES_OOB,
        jnp.where(outlier, B.RES_OUTLIER, B.RES_IN)
    ).astype(jnp.int8)

    active = (ba.res_exist.T & ba.pt_valid[None, :]
              & ba.frame_valid[:, None] & (new_state == B.RES_IN))
    mask_f = active.astype(jnp.float32)

    X = X * mask_f[:, None, None, :]
    Jpdd = Jpdd * mask_f[:, None, :]
    resF = resF * mask_f[:, None, :]
    JIdx = JIdx * mask_f[:, None, None, :]
    JabF = JabF * mask_f[:, None, None, :]
    JIdx2 = jnp.einsum("fikp,fjkp->fijp", JIdx, JIdx, precision=HIGH)
    JabJIdx = jnp.einsum("fikp,fjkp->fijp", JabF, JIdx, precision=HIGH)
    Jab2 = jnp.einsum("fikp,fjkp->fijp", JabF, JabF, precision=HIGH)

    return LinDataT(
        X=X, Jpdd=Jpdd, resF=resF, JIdx=JIdx, JabF=JabF,
        JIdx2=JIdx2, JabJIdx=JabJIdx, Jab2=Jab2,
        energy=energy, energy_raw=energy_raw,
        new_state=new_state, active=active, onehot=onehot,
    )


_stitch_acc = B.stitch_acc  # shared adjoint stitch (ba.stitch_acc)


def accumulate_top_t(ba: B.BAState, pre: B.Precalc, lin: LinDataT,
                     resApprox: jnp.ndarray | None = None
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """accumulate_top on the lanes-last linearization: per-row 13-vectors
    Y = [X^T JI (10) | Jab (2) | r], reduced into (h,t) cells with one
    (13,N)x(N,13)-shaped contraction over the N = 8*P row axis."""
    F, P = ba.F, ba.P
    if resApprox is None:
        resApprox = lin.resF                        # (F,8,P)

    q = jnp.einsum("fakp,faip->fikp", lin.JIdx, lin.X, precision=HIGH)
    Y = jnp.concatenate([q, lin.JabF, resApprox[:, None]], 1)  # (F,13,8,P)
    Yr = Y.reshape(F, 13, 8 * P)
    oh_n = jnp.broadcast_to(lin.onehot[None], (8, P, F)).reshape(8 * P, F)
    Yh = Yr[:, :, :, None] * oh_n[None, None, :, :]            # (F,13,N,Fh)
    acc = jnp.einsum("fin,fjnh->hfij", Yr, Yh, precision=HIGH)  # (Fh,Ft,13,13)
    return B.stitch_acc(ba, pre, acc[..., :12, :12], acc[..., :12, 12])


class SchurDataT(NamedTuple):
    """Transposed twin of ba.SchurData (vcross is (D,P))."""

    Hdd: jnp.ndarray      # (P,)
    HdiF: jnp.ndarray     # (P,)
    bd: jnp.ndarray       # (P,)
    vcross: jnp.ndarray   # (D,P)
    has_res: jnp.ndarray  # (P,)


def accumulate_schur_t(ba: B.BAState, pre: B.Precalc, lin: LinDataT,
                       resApprox: jnp.ndarray | None = None,
                       shift_prior_to_zero: bool = True,
                       prior_fac: float = 1.0) -> SchurDataT:
    F, P = ba.F, ba.P
    if resApprox is None:
        resApprox = lin.resF

    JI_r = jnp.einsum("fikp,fkp->fip", lin.JIdx, resApprox, precision=HIGH)
    Ji2_Jpdd = jnp.einsum("fijp,fjp->fip", lin.JIdx2, lin.Jpdd,
                          precision=HIGH)
    Hdd = jnp.einsum("fip,fip->p", Ji2_Jpdd, lin.Jpdd, precision=HIGH)
    bd = jnp.einsum("fip,fip->p", JI_r, lin.Jpdd, precision=HIGH)
    Hcd = jnp.einsum("facp,fap->cp", lin.X[:, :, :4], Ji2_Jpdd,
                     precision=HIGH)                            # (4,P)

    JpJd = jnp.concatenate(
        [
            jnp.einsum("fajp,fap->fjp", lin.X[:, :, 4:], Ji2_Jpdd,
                       precision=HIGH),
            jnp.einsum("fijp,fjp->fip", lin.JabJIdx, lin.Jpdd,
                       precision=HIGH),
        ],
        1,
    )  # (F,8,P)

    has_res = jnp.any(lin.active, 0)
    prior = ba.pt_prior * prior_fac
    Hdd_full = jnp.maximum(Hdd + prior, 1e-10)
    HdiF = jnp.where(has_res, 1.0 / Hdd_full, 0.0)
    bd_full = bd + jnp.where(
        shift_prior_to_zero, prior * (ba.idepth - ba.idepth_zero), 0.0)

    # absolute cross column, via one-hot (no (P,F,8,8) adjoint gather):
    # s*[h,f,i,p] = sum_r ad*[h,f,r,i] JpJd[f,r,p]
    sH = jnp.einsum("hfri,frp->hfip", pre.adHost, JpJd, precision=HIGH)
    sT = jnp.einsum("hfri,frp->hfip", pre.adTarget, JpJd, precision=HIGH)
    v_host = jnp.einsum("hfip,ph->ip", sH, lin.onehot, precision=HIGH)
    v_tgt = jnp.einsum("hfip,ph->fip", sT, lin.onehot, precision=HIGH)
    v_frames = v_tgt + lin.onehot.T[:, None, :] * v_host[None]
    v = jnp.concatenate([Hcd, v_frames.reshape(8 * F, P)], 0)   # (D,P)
    return SchurDataT(Hdd=Hdd_full, HdiF=HdiF, bd=bd_full, vcross=v,
                      has_res=has_res)


def schur_Hb_t(sc: SchurDataT) -> Tuple[jnp.ndarray, jnp.ndarray]:
    vw = sc.vcross * sc.HdiF[None, :]
    H_sc = jnp.einsum("ip,jp->ij", vw, sc.vcross, precision=HIGH)
    b_sc = vw @ sc.bd
    return H_sc, b_sc


def resubstitute_t(sc: SchurDataT, x: jnp.ndarray) -> jnp.ndarray:
    bshift = sc.bd - x @ sc.vcross
    return jnp.where(sc.has_res, -bshift * sc.HdiF, 0.0)


def res_to_zero_t(ba: B.BAState, pre: B.Precalc, lin: LinDataT
                  ) -> jnp.ndarray:
    """FEJ shift (fixLinearizationF) in the transposed layout: (F,8,P)."""
    dp = jnp.einsum("hfi,ph->fip", pre.adHTdelta, lin.onehot,
                    precision=HIGH)                 # (F,8,P)
    dc = ba.c - ba.c_zero                           # (4,)
    dd = ba.idepth - ba.idepth_zero                 # (P,)
    delta10 = jnp.concatenate(
        [jnp.broadcast_to(dc[None, :, None], (ba.F, 4, ba.P)), dp[:, :6]], 1)
    Jp_delta = (jnp.einsum("faip,fip->fap", lin.X, delta10, precision=HIGH)
                + lin.Jpdd * dd[None, None, :])     # (F,2,P)
    shift = (jnp.einsum("fakp,fap->fkp", lin.JIdx, Jp_delta, precision=HIGH)
             + lin.JabF[:, 0] * dp[:, 6:7]
             + lin.JabF[:, 1] * dp[:, 7:8])
    return lin.resF - shift


def update_energy_th_t(ba: B.BAState, lin: LinDataT,
                       settings: Settings) -> jnp.ndarray:
    """update_energy_th on the transposed linearization (same algebra as
    energy.update_energy_th — newest-column quantile)."""
    newest = jnp.sum(ba.frame_valid) - 1
    considered = (
        jnp.take(ba.res_exist.T, newest, axis=0) & ba.pt_valid
        & (jnp.take(lin.new_state, newest, axis=0) != B.RES_OOB)
    )
    e = jnp.where(considered, jnp.take(lin.energy_raw, newest, axis=0),
                  jnp.inf)
    n = jnp.sum(considered)
    nth = jnp.clip((settings.frame_energy_th_n * n).astype(jnp.int32), 0,
                   e.shape[0] - 1)
    nth_el = jnp.sqrt(B.nth_smallest(e, nth))   # exact, sort-free
    th = nth_el * settings.frame_energy_th_fac_median
    th = (26.0 * settings.frame_energy_th_const_weight
          + th * (1.0 - settings.frame_energy_th_const_weight))
    th = th * th * settings.overall_energy_th_weight ** 2
    th = jnp.where(n > 0, th, 12.0 * 12.0 * 8.0)
    return jnp.where(jnp.arange(ba.F) == newest, th, ba.energy_th)


def mask_lin_t(lin: LinDataT, pmask: jnp.ndarray) -> LinDataT:
    """Restrict a transposed linearization to a subset of points (twin of
    energy._mask_lin)."""
    f = pmask.astype(jnp.float32)[None, :]
    return lin._replace(
        X=lin.X * f[:, None, None, :],
        Jpdd=lin.Jpdd * f[:, None, :],
        resF=lin.resF * f[:, None, :],
        JIdx=lin.JIdx * f[:, None, None, :],
        JabF=lin.JabF * f[:, None, None, :],
        JIdx2=lin.JIdx2 * f[:, None, None, :],
        JabJIdx=lin.JabJIdx * f[:, None, None, :],
        Jab2=lin.Jab2 * f[:, None, None, :],
        active=lin.active & pmask[None, :],
    )
