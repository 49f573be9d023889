"""Sliding-window bundle adjustment driver + marginalization.

JAX rebuild of FullSystem::optimize (src/FullSystem/
FullSystemOptimize.cpp:305-489) and EnergyFunctional::{marginalizeFrame,
marginalizePointsF} (src/OptimizationBackend/EnergyFunctional.cpp:730-936).

The reference's effective algorithm (with its default settings): up to
`max_opt_iterations` Gauss-Newton steps at fixed damping lambda = 1e-5,
steps always accepted (setting_forceAceptStep), early break when step norms
fall below thresholds; after the loop the newest frame's FEJ point is moved
to its current pose (affine kept in state_zero) and a final linearization
drops OOB/outlier residuals. We reproduce exactly that as a `lax.while_loop`
over jitted GN steps.

Marginalization follows the reference verbatim: frame priors folded in, the
block permuted last, Schur complement under the (|diag|+10)^1/2 Jacobi
scaling, symmetrized; point marginalization accumulates mode-2 (FEJ-shifted
res_toZero) top and Schur parts into HM/bM with the 0.5^2 weight.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from sos_slam_tpu.ops import ba as B
from sos_slam_tpu.ops import ba_t as BT
from sos_slam_tpu.utils import lie
from sos_slam_tpu.utils.config import CPARS, Settings

HIGH = jax.lax.Precision.HIGHEST


def _iter_quants(ba: B.BAState, pre: B.Precalc, dI: jnp.ndarray,
                 settings: Settings, w: int, h: int) -> dict:
    """Everything one GN iteration consumes from the (P,F) linearization,
    composed from the forms of `_forms()`. Returned keys: Htop/btop (no
    priors), Hsc/bsc, resub (x -> idepth step), HdiF,
    energy_pf/new_state_pf ((P,F) layout), lin_for_th + upth (the
    energy-threshold update pair), n_active."""
    fm = _forms()
    lin = fm["lin"](ba, pre, dI, settings, w, h)
    H_top, b_top = fm["top"](ba, pre, lin)
    sc = fm["schur"](ba, pre, lin)
    H_sc, b_sc = fm["shb"](sc)
    return dict(
        Htop=H_top, btop=b_top, Hsc=H_sc, bsc=b_sc,
        resub=lambda x: fm["resub"](sc, x), HdiF=sc.HdiF,
        energy_pf=fm["pf"](lin.energy), new_state_pf=fm["pf"](lin.new_state),
        lin_for_th=lin, upth=fm["upth"], n_active=jnp.sum(lin.active))


def _marg_Hb(ba: B.BAState, pre: B.Precalc, dI: jnp.ndarray,
             marg: jnp.ndarray, settings: Settings, w: int, h: int):
    """(H, b, H_sc, b_sc) of the marginalized-point subset, mode 2
    (FEJ-shifted res_toZero residuals)."""
    fm = _forms()
    lin = fm["mask"](fm["lin"](ba, pre, dI, settings, w, h), marg)
    resZ = fm["rz"](ba, pre, lin)
    H, b = fm["top"](ba, pre, lin, resApprox=resZ)
    sc = fm["schur"](
        ba, pre, lin, resApprox=resZ, shift_prior_to_zero=False,
        prior_fac=settings.idepth_fix_prior_marg_fac)
    H_sc, b_sc = fm["shb"](sc)
    return H, b, H_sc, b_sc


def _forms():
    """BA kernel form dispatch: the reference-shaped (P,F,...) einsum forms
    (ops/ba.py, the default) or the lanes-last transposed forms
    (ops/ba_t.py, opt-in — see ba_t.enabled()). `pf` maps a per-residual
    (grid-shaped) array to (P,F) layout. Resolved at trace time; both forms are algebraically
    identical (tests/test_ba_t.py)."""
    if BT.enabled():
        return dict(lin=BT.linearize_t, top=BT.accumulate_top_t,
                    schur=BT.accumulate_schur_t, shb=BT.schur_Hb_t,
                    resub=BT.resubstitute_t, rz=BT.res_to_zero_t,
                    upth=BT.update_energy_th_t, mask=BT.mask_lin_t,
                    pf=lambda a: a.T)
    return dict(lin=B.linearize, top=B.accumulate_top,
                schur=B.accumulate_schur, shb=B.schur_Hb,
                resub=B.resubstitute, rz=B.res_to_zero,
                upth=update_energy_th, mask=_mask_lin,
                pf=lambda a: a)


def update_energy_th(ba: B.BAState, lin: B.LinData,
                     settings: Settings) -> jnp.ndarray:
    """Adaptive outlier threshold for the newest frame (setNewFrameEnergyTH,
    FullSystemOptimize.cpp:84-124). Returns new energy_th (F,)."""
    newest = jnp.sum(ba.frame_valid) - 1
    # only the newest frame's column is ever considered — slice it before
    # sorting ((P,) instead of (P*F,), an 8x smaller sort on the hot path)
    col = lambda a: jnp.take(a, newest, axis=1)
    considered = (
        col(ba.res_exist) & ba.pt_valid
        & (col(lin.new_state) != B.RES_OOB)
    )
    e = jnp.where(considered, col(lin.energy_raw), jnp.inf)
    n = jnp.sum(considered)
    nth = jnp.clip((settings.frame_energy_th_n * n).astype(jnp.int32), 0,
                   e.shape[0] - 1)
    # exact nth element by radix select (== jnp.sort(e)[nth]); the sort ran
    # every GN iteration and was a measurable slice of the KF chain
    nth_el = jnp.sqrt(B.nth_smallest(e, nth))
    th = nth_el * settings.frame_energy_th_fac_median
    th = (26.0 * settings.frame_energy_th_const_weight
          + th * (1.0 - settings.frame_energy_th_const_weight))
    th = th * th * settings.overall_energy_th_weight ** 2
    th = jnp.where(n > 0, th, 12.0 * 12.0 * 8.0)
    return jnp.where(
        jnp.arange(ba.F) == newest, th, ba.energy_th
    )


def gn_step(ba: B.BAState, dI: jnp.ndarray, settings: Settings,
            w: int, h: int, ev: B.PrecalcEval | None = None):
    """One damped GN iteration. Returns (new ba, diag dict). `ev` is the
    loop-invariant eval-point precalc (adjoints/FEJ transforms), computed
    once per optimize() outside the while_loop."""
    pre = B.make_precalc(ba, ev)
    q = _iter_quants(ba, pre, dI, settings, w, h)

    energy_th = q["upth"](ba, q["lin_for_th"], settings)
    ba = ba._replace(energy_th=energy_th)

    H_top, b_top = B.add_priors(ba, q["Htop"], q["btop"], settings)
    x = B.solve_system(ba, H_top, b_top, q["Hsc"], q["bsc"])
    x = jnp.where(jnp.isfinite(x), x, 0.0)

    step_fr = -x[CPARS:].reshape(ba.F, 8) * ba.frame_valid[:, None]
    step_c = -x[:CPARS]
    step_pt = q["resub"](x) * ba.pt_valid
    step_pt = jnp.where(jnp.isfinite(step_pt), step_pt, 0.0)

    new_state = ba.state + step_fr
    new_c = ba.c + step_c
    new_id = ba.idepth + step_pt

    nvalid = jnp.maximum(jnp.sum(ba.frame_valid), 1)
    sumA = jnp.sum(step_fr[:, 6] ** 2) / nvalid
    sumB = jnp.sum(step_fr[:, 7] ** 2) / nvalid
    sumT = jnp.sum(step_fr[:, 0:3] ** 2) / nvalid
    sumR = jnp.sum(step_fr[:, 3:6] ** 2) / nvalid
    npt = jnp.maximum(jnp.sum(ba.pt_valid), 1)
    sumNID = jnp.sum(jnp.abs(ba.idepth) * ba.pt_valid) / npt
    th = settings.th_opt_iterations
    canbreak = (
        (jnp.sqrt(sumA) < 0.0005 * th)
        & (jnp.sqrt(sumB) < 0.00005 * th)
        & (jnp.sqrt(sumR) < 0.00005 * th)
        & (jnp.sqrt(sumT) * sumNID < 0.00005 * th)
    )

    # energy bookkeeping (OOB keeps no contribution; outliers clamped)
    new_state_pf = q["new_state_pf"]
    live = ba.res_exist & ba.pt_valid[:, None] & ba.frame_valid[None, :] \
        & (new_state_pf != B.RES_OOB)
    energy = jnp.sum(jnp.where(live, q["energy_pf"], 0.0))

    ba = ba._replace(
        state=new_state, c=new_c, idepth=new_id, idepth_zero=new_id,
        res_state=new_state_pf,
    )
    return ba, canbreak, energy


@functools.partial(jax.jit, static_argnames=("settings", "w", "h"))
def optimize(ba: B.BAState, dI: jnp.ndarray, settings: Settings,
             w: int, h: int, max_its=6, min_its=1):
    """The windowed BA (FullSystem::optimize). Returns (ba, stats dict).
    max_its/min_its are traced (one compiled program for all window sizes)."""
    max_its = jnp.asarray(max_its, jnp.int32)
    min_its = jnp.asarray(min_its, jnp.int32)
    # resetOOB: all existing residuals restart as IN
    ba = ba._replace(
        res_state=jnp.where(ba.res_exist, B.RES_IN, ba.res_state)
    )

    # adjoints/FEJ transforms are loop-invariant (T_cw_eval, state_zero,
    # exposure don't change inside the loop): build once, reuse per step
    ev = B.make_precalc_eval(ba)

    def cond(carry):
        ba_, it, canbreak, _ = carry
        return (it < max_its) & ~(canbreak & (it >= min_its))

    def body(carry):
        ba_, it, _, _ = carry
        ba2, canbreak, energy = gn_step(ba_, dI, settings, w, h, ev=ev)
        return (ba2, it + 1, canbreak, energy)

    ba, n_its, _, energy = jax.lax.while_loop(
        cond, body, (ba, jnp.int32(0), jnp.array(False), jnp.float32(0.0))
    )

    # move newest frame's FEJ to its current pose (affine kept as new zero)
    newest = jnp.sum(ba.frame_valid) - 1
    T_cw = B.state_to_pose(ba.T_cw_eval, ba.state)
    sel = (jnp.arange(ba.F) == newest)[:, None]
    zero_pose_state = ba.state.at[:, :6].set(0.0)
    new_eval = jnp.where(sel[..., None], T_cw, ba.T_cw_eval)
    new_state = jnp.where(sel, zero_pose_state, ba.state)
    new_zero = jnp.where(sel, zero_pose_state, ba.state_zero)
    ba = ba._replace(T_cw_eval=new_eval, state=new_state, state_zero=new_zero)

    # final linearization: permanently drop OOB/outlier residuals.
    # Point idepth-Hessian inverses (template weights + marg gates) ride
    # the same linearization — a separate post-optimize pass would repeat
    # the gather-bound (P,F,8) linearize, the chain's hottest op.
    pre = B.make_precalc(ba)
    q = _iter_quants(ba, pre, dI, settings, w, h)
    HdiF = q["HdiF"]
    new_state_pf = q["new_state_pf"]
    ba = ba._replace(
        energy_th=q["upth"](ba, q["lin_for_th"], settings),
        res_exist=ba.res_exist & (new_state_pf == B.RES_IN),
        res_state=new_state_pf,
    )
    n_active = q["n_active"]
    live = ba.res_exist & ba.pt_valid[:, None] & ba.frame_valid[None, :]
    energy_final = jnp.sum(jnp.where(live, q["energy_pf"], 0.0))
    rmse = jnp.sqrt(energy_final / jnp.maximum(8.0 * n_active, 1.0))
    is_lost = ~jnp.isfinite(energy_final)
    return ba, dict(energy=energy_final, rmse=rmse, n_its=n_its,
                    n_active=n_active, is_lost=is_lost, HdiF=HdiF)


def gn_step_vio(ba: B.BAState, imu, dI: jnp.ndarray, settings: Settings,
                w: int, h: int, ev: B.PrecalcEval | None = None):
    """One VIO GN iteration: vision linearization + IMU Hessian + KKT solve
    (the imu_valid branch of solveSystemF)."""
    from sos_slam_tpu.models import imu as IM

    pre = B.make_precalc(ba, ev)
    q = _iter_quants(ba, pre, dI, settings, w, h)
    ba = ba._replace(energy_th=q["upth"](ba, q["lin_for_th"], settings))

    H_top, b_top = B.add_priors(ba, q["Htop"], q["btop"], settings)

    x8, x_scale, x_imu = IM.solve_vio(ba, imu, H_top, b_top, q["Hsc"],
                                      q["bsc"], imu.HM, imu.bM, settings)
    x8 = jnp.where(jnp.isfinite(x8), x8, 0.0)
    x_imu = jnp.where(jnp.isfinite(x_imu), x_imu, 0.0)
    x_scale = jnp.where(jnp.isfinite(x_scale), x_scale, 0.0)

    step_fr = -x8[CPARS:].reshape(ba.F, 8) * ba.frame_valid[:, None]
    step_pt = q["resub"](x8) * ba.pt_valid
    step_pt = jnp.where(jnp.isfinite(step_pt), step_pt, 0.0)

    new_imu_state = imu.state - x_imu * imu.bias_valid[:, None]
    new_scale = imu.scale - jnp.where(settings.enable_scale_opt, 0.0, x_scale)

    nvalid = jnp.maximum(jnp.sum(ba.frame_valid), 1)
    sumA = jnp.sum(step_fr[:, 6] ** 2) / nvalid
    sumB = jnp.sum(step_fr[:, 7] ** 2) / nvalid
    sumT = jnp.sum(step_fr[:, 0:3] ** 2) / nvalid
    sumR = jnp.sum(step_fr[:, 3:6] ** 2) / nvalid
    npt = jnp.maximum(jnp.sum(ba.pt_valid), 1)
    sumNID = jnp.sum(jnp.abs(ba.idepth) * ba.pt_valid) / npt
    th = settings.th_opt_iterations
    canbreak = (
        (jnp.sqrt(sumA) < 0.0005 * th) & (jnp.sqrt(sumB) < 0.00005 * th)
        & (jnp.sqrt(sumR) < 0.00005 * th)
        & (jnp.sqrt(sumT) * sumNID < 0.00005 * th)
    )

    new_state_pf = q["new_state_pf"]
    live = ba.res_exist & ba.pt_valid[:, None] & ba.frame_valid[None, :] \
        & (new_state_pf != B.RES_OOB)
    energy = jnp.sum(jnp.where(live, q["energy_pf"], 0.0))

    ba = ba._replace(
        state=ba.state + step_fr, c=ba.c - x8[:CPARS],
        idepth=ba.idepth + step_pt, idepth_zero=ba.idepth + step_pt,
        res_state=new_state_pf,
    )
    imu = imu._replace(state=new_imu_state, scale=new_scale)
    return ba, imu, canbreak, energy


@functools.partial(jax.jit, static_argnames=("settings", "w", "h"))
def optimize_vio(ba: B.BAState, imu, dI: jnp.ndarray, settings: Settings,
                 w: int, h: int, max_its=6, min_its=1):
    """FullSystem::optimize with IMU initialized: VIO KKT solve per step,
    velocity update and newest-frame IMU FEJ reset afterwards."""
    max_its = jnp.asarray(max_its, jnp.int32)
    min_its = jnp.asarray(min_its, jnp.int32)
    ba = ba._replace(
        res_state=jnp.where(ba.res_exist, B.RES_IN, ba.res_state))

    ev = B.make_precalc_eval(ba)   # loop-invariant (see optimize)

    def cond(carry):
        _, _, it, canbreak, _ = carry
        return (it < max_its) & ~(canbreak & (it >= min_its))

    def body(carry):
        ba_, imu_, it, _, _ = carry
        ba2, imu2, canbreak, energy = gn_step_vio(ba_, imu_, dI, settings,
                                                  w, h, ev=ev)
        return (ba2, imu2, it + 1, canbreak, energy)

    ba, imu, n_its, _, energy = jax.lax.while_loop(
        cond, body, (ba, imu, jnp.int32(0), jnp.array(False), jnp.float32(0.0)))

    # newest frame FEJ reset (pose part) — same as mono
    newest = jnp.sum(ba.frame_valid) - 1
    T_cw = B.state_to_pose(ba.T_cw_eval, ba.state)
    sel = (jnp.arange(ba.F) == newest)[:, None]
    zero_pose_state = ba.state.at[:, :6].set(0.0)
    ba = ba._replace(
        T_cw_eval=jnp.where(sel[..., None], T_cw, ba.T_cw_eval),
        state=jnp.where(sel, zero_pose_state, ba.state),
        state_zero=jnp.where(sel, zero_pose_state, ba.state_zero),
    )

    # updateVel(newest) from the second-newest window frame
    from sos_slam_tpu.models import imu as IM
    prev = jnp.maximum(newest - 1, 0)
    t = imu.timestamps[prev] - imu.timestamps[newest]
    T_cw2 = B.state_to_pose(ba.T_cw_eval, ba.state)
    tsl_diff = T_cw2[prev, :3, 3] - T_cw2[newest, :3, 3]
    sq = (imu.state[newest] * IM.IMU_SCALE21)[9:12]
    vel_new = tsl_diff / jnp.where(jnp.abs(t) < 1e-6, -1e-6, t) \
        - t * sq - t * t * sq
    imu = imu._replace(
        vel=imu.vel.at[newest].set(jnp.where(imu.scale_trapped, vel_new,
                                             imu.vel[newest])),
        state_zero=jnp.where(sel, imu.state, imu.state_zero),
    )

    # final linearization + residual pruning (same as mono)
    pre = B.make_precalc(ba)
    q = _iter_quants(ba, pre, dI, settings, w, h)
    HdiF = q["HdiF"]   # see optimize()
    new_state_pf = q["new_state_pf"]
    ba = ba._replace(
        energy_th=q["upth"](ba, q["lin_for_th"], settings),
        res_exist=ba.res_exist & (new_state_pf == B.RES_IN),
        res_state=new_state_pf,
    )
    n_active = q["n_active"]
    live = ba.res_exist & ba.pt_valid[:, None] & ba.frame_valid[None, :]
    energy_final = jnp.sum(jnp.where(live, q["energy_pf"], 0.0))
    rmse = jnp.sqrt(energy_final / jnp.maximum(8.0 * n_active, 1.0))
    return ba, imu, dict(energy=energy_final, rmse=rmse, n_its=n_its,
                         n_active=n_active,
                         is_lost=~jnp.isfinite(energy_final), HdiF=HdiF)


@functools.partial(jax.jit, static_argnames=("settings",))
def marginalize_frame_vio(ba: B.BAState, imu, k: jnp.ndarray,
                          settings: Settings):
    """VIO-mode frame marginalization (EnergyFunctional::marginalizeFrame
    IMU branch, EnergyFunctional.cpp:730-889): fold the dying frame's IMU
    links into HM, Schur out its 29-dim block, compact both states."""
    from sos_slam_tpu.models import imu as IM

    F = ba.F
    D = IM.vio_dim(F)
    n = jnp.sum(ba.frame_valid)

    # --- IMU connection terms of pairs (k-1,k) and (k,k+1) ---
    keep_bias = (jnp.arange(F) >= k - 1) & (jnp.arange(F) <= k + 1)
    keep_spl = (jnp.arange(F) == k) | (jnp.arange(F) == k + 1)
    imu_m = imu._replace(
        bias_valid=imu.bias_valid & keep_bias,
        spline_valid=imu.spline_valid & keep_spl,
    )
    HM_change, bM_change, _, _, _ = IM.imu_hessian(ba, imu_m, settings)
    # delta2: neighbors' deltas only (slot k stays zero)
    delta = IM.get_vio_delta(ba, imu)
    dim_frame = (jnp.arange(D) - (CPARS + 1)) // 29
    keep_delta = (dim_frame != k) | (jnp.arange(D) < CPARS + 1)
    delta = delta * keep_delta
    bM_change = bM_change - HM_change @ delta
    HM = imu.HM + settings.marg_weight_fac * HM_change
    bM = imu.bM + settings.marg_weight_fac * bM_change

    # --- add the dying frame's dso prior ---
    blk = CPARS + 1 + 29 * k
    didx = blk + jnp.arange(8)
    HM = HM.at[didx, didx].add(ba.prior[k])
    bM = bM.at[didx].add(ba.prior[k] * ba.state[k])

    # --- discard unconstrained spline dims of the dying frame ---
    spline_dead = ~((k > 0) & imu.spline_valid[k])
    dim_in_frame = (jnp.arange(D) - (CPARS + 1)) % 29
    spline_dims = (dim_frame == k) & (dim_in_frame >= 14)
    dead = spline_dims & spline_dead
    keepm = (~dead).astype(jnp.float32)
    HM = HM * keepm[:, None] * keepm[None, :]
    bM = bM * keepm

    # --- permute frame k's 29-block to the last valid block, Schur it out ---
    blk_idx = jnp.arange(F)
    shifted = jnp.where((blk_idx >= k) & (blk_idx < n - 1), blk_idx + 1,
                        blk_idx)
    order = jnp.where(blk_idx == n - 1, k, shifted)
    perm = jnp.concatenate(
        [jnp.arange(CPARS + 1),
         (CPARS + 1 + 29 * order[:, None] + jnp.arange(29)[None, :]
          ).reshape(-1)])
    HMp = HM[perm][:, perm]
    bMp = bM[perm]

    sl = CPARS + 1 + 29 * (n - 1)
    in_marg = (jnp.arange(D) >= sl) & (jnp.arange(D) < sl + 29)
    svec = jnp.sqrt(jnp.abs(jnp.diagonal(HMp)) + 10.0)
    svec_i = 1.0 / svec
    Hs = HMp * svec_i[:, None] * svec_i[None, :]
    bs = bMp * svec_i
    gidx = sl + jnp.arange(29)
    Hmm = Hs[gidx][:, gidx]
    Hmm = 0.5 * (Hmm + Hmm.T)
    Hmm_inv = jnp.linalg.inv(Hmm)
    Hmm_inv = 0.5 * (Hmm_inv + Hmm_inv.T)
    keep = (~in_marg).astype(jnp.float32)
    Hxm = Hs[:, gidx] * keep[:, None]
    bli = Hxm @ Hmm_inv
    Hs_new = (Hs - bli @ Hxm.T) * keep[:, None] * keep[None, :]
    bs_new = (bs - bli @ bs[gidx]) * keep
    HM2 = Hs_new * svec[:, None] * svec[None, :]
    HM2 = 0.5 * (HM2 + HM2.T)
    bM2 = bs_new * svec

    # --- compact imu frame arrays ---
    def shift(a):
        return a[order]

    last = jnp.arange(F) == (n - 1)
    fv_new = shift(ba.frame_valid) & ~last
    imu = imu._replace(
        state=shift(imu.state) * fv_new[:, None],
        state_zero=shift(imu.state_zero) * fv_new[:, None],
        vel=shift(imu.vel), timestamps=shift(imu.timestamps),
        bias_valid=shift(imu.bias_valid) & fv_new,
        spline_valid=shift(imu.spline_valid) & fv_new,
        acc=shift(imu.acc), gyro=shift(imu.gyro), ts=shift(imu.ts),
        imu_valid=shift(imu.imu_valid) & fv_new[:, None],
        HM=HM2, bM=bM2,
    )
    # spline validity of the frame now following slot k-1 breaks (its
    # predecessor changed) unless it was k+1 tracking k-1... conservative:
    imu = imu._replace(
        spline_valid=imu.spline_valid.at[jnp.clip(k, 0, F - 1)].set(False))
    ba2 = marginalize_frame(ba._replace(prior=ba.prior.at[k].set(0.0)), k)
    return ba2, imu


@functools.partial(jax.jit, static_argnames=("settings", "w", "h"))
def marginalize_points_vio(ba: B.BAState, imu, dI, marg, settings, w, h):
    """Point marginalization in VIO mode: the vision H goes into the
    expanded (5+29F) HM (marginalizePointsF + expandHbtoFitImu)."""
    from sos_slam_tpu.models import imu as IM
    marg = marg & ba.pt_valid
    pre = B.make_precalc(ba)
    H, b, H_sc, b_sc = _marg_Hb(ba, pre, dI, marg, settings, w, h)
    He, be = IM.expand_vision_Hb(H - H_sc, b - b_sc, ba.F)
    HM = imu.HM + settings.marg_weight_fac * He
    HM = 0.5 * (HM + HM.T)
    bM = imu.bM + settings.marg_weight_fac * be
    imu = imu._replace(HM=HM, bM=bM)
    ba = ba._replace(pt_valid=ba.pt_valid & ~marg,
                     res_exist=ba.res_exist & ~marg[:, None])
    return ba, imu


def _mask_lin(lin: B.LinData, pmask: jnp.ndarray) -> B.LinData:
    """Restrict a linearization to a subset of points."""
    f = pmask.astype(jnp.float32)
    return B.LinData(
        X=lin.X * f[:, None, None, None],
        Jpdd=lin.Jpdd * f[:, None, None],
        resF=lin.resF * f[:, None, None],
        JIdx=lin.JIdx * f[:, None, None, None],
        JabF=lin.JabF * f[:, None, None, None],
        JIdx2=lin.JIdx2 * f[:, None, None, None],
        JabJIdx=lin.JabJIdx * f[:, None, None, None],
        Jab2=lin.Jab2 * f[:, None, None, None],
        energy=lin.energy, energy_raw=lin.energy_raw,
        new_state=lin.new_state,
        active=lin.active & pmask[:, None],
    )


@functools.partial(jax.jit, static_argnames=("settings", "w", "h"))
def marginalize_points(ba: B.BAState, dI: jnp.ndarray, marg: jnp.ndarray,
                       settings: Settings, w: int, h: int) -> B.BAState:
    """Fold flagged points into HM/bM (marginalizePointsF,
    EnergyFunctional.cpp:891-936) and drop them. marg: (P,) bool."""
    marg = marg & ba.pt_valid
    pre = B.make_precalc(ba)
    H, b, H_sc, b_sc = _marg_Hb(ba, pre, dI, marg, settings, w, h)
    HM = ba.HM + settings.marg_weight_fac * (H - H_sc)
    HM = 0.5 * (HM + HM.T)   # kill f32 rounding asymmetry
    bM = ba.bM + settings.marg_weight_fac * (b - b_sc)
    return ba._replace(
        HM=HM, bM=bM,
        pt_valid=ba.pt_valid & ~marg,
        res_exist=ba.res_exist & ~marg[:, None],
    )


def drop_points(ba: B.BAState, drop: jnp.ndarray) -> B.BAState:
    """Remove points without marginalization (dropPointsF)."""
    drop = drop & ba.pt_valid
    return ba._replace(
        pt_valid=ba.pt_valid & ~drop,
        res_exist=ba.res_exist & ~drop[:, None],
    )


# ----------------------------------------------------------------------
# gauge null spaces (FullSystem::getNullspaces, FullSystemOptimize.cpp:
# 528-576; per-frame parts FrameHessian::setStateZero,
# HessianBlocks.cpp:66-102) and the EnergyFunctional::orthogonalize
# projection (EnergyFunctional.cpp:971-1027). Like the reference, the
# solver does not apply the projection by default (solver mode flags off);
# both are provided for parity and diagnostics.
# ----------------------------------------------------------------------

def frame_nullspaces(T_cw_eval: jnp.ndarray, exposure: jnp.ndarray,
                     aff_a0: jnp.ndarray):
    """Per-frame gauge null-space directions at the FEJ pose.

    Central-difference derivative of the left-increment coordinates under a
    global gauge change, evaluated exactly as the reference does
    (HessianBlocks.cpp:70-101). Returns (pose (6,6), scale (6,),
    affine (2,2) columns [A, B])."""
    eps = 1e-3
    T = T_cw_eval
    Ti = lie.se3_inv(T)

    basis = jnp.eye(6) * eps
    logP = jax.vmap(lambda e: lie.se3_log(T @ lie.se3_exp(e) @ Ti))(basis)
    logM = jax.vmap(lambda e: lie.se3_log(T @ lie.se3_exp(-e) @ Ti))(basis)
    ns_pose = ((logP - logM) / (2.0 * eps)).T        # (6,6), col i = dir i

    Tp = T.at[:3, 3].multiply(1.00001)
    Tm = T.at[:3, 3].divide(1.00001)
    ns_scale = (lie.se3_log(Tp @ Ti) - lie.se3_log(Tm @ Ti)) / (2.0 * eps)

    ns_aff = jnp.array([[1.0, 0.0], [0.0, 1.0]]) \
        * jnp.array([1.0, jnp.exp(aff_a0) * exposure])[None, :]
    return ns_pose, ns_scale, ns_aff


@jax.jit
def get_nullspaces(ba: B.BAState) -> jnp.ndarray:
    """Window-wide null-space vectors in internal (scaled) state units.

    Returns (9, 4+8F): rows 0-5 global pose gauge, 6-7 affine A/B gauge,
    8 global scale gauge — the same order as the reference's
    nullspaces_x0_pre (FullSystemOptimize.cpp:537-575), with the
    SCALE_*_INVERSE factors folded in. Rows for invalid frame slots are
    zero."""
    F = ba.F
    D = CPARS + 8 * F
    a0 = B.aff_real(ba.state_zero)[:, 0]
    ns_pose, ns_scale, ns_aff = jax.vmap(frame_nullspaces)(
        ba.T_cw_eval, ba.exposure, a0)
    fv = ba.frame_valid.astype(jnp.float32)
    inv_s = 1.0 / B.STATE8_SCALE

    rows = []
    for i in range(6):
        blk = jnp.zeros((F, 8)).at[:, :6].set(ns_pose[:, :, i])
        blk = blk * inv_s[None, :] * fv[:, None]
        rows.append(jnp.concatenate([jnp.zeros(CPARS), blk.reshape(-1)]))
    for i in range(2):
        blk = jnp.zeros((F, 8)).at[:, 6:8].set(ns_aff[:, :, i])
        blk = blk * inv_s[None, :] * fv[:, None]
        rows.append(jnp.concatenate([jnp.zeros(CPARS), blk.reshape(-1)]))
    blk = jnp.zeros((F, 8)).at[:, :6].set(ns_scale)
    blk = blk * inv_s[None, :] * fv[:, None]
    rows.append(jnp.concatenate([jnp.zeros(CPARS), blk.reshape(-1)]))
    return jnp.stack(rows)                            # (9, D)


@functools.partial(jax.jit, static_argnames=("delta",))
def orthogonalize(b: jnp.ndarray, H: jnp.ndarray, nullspaces: jnp.ndarray,
                  delta: float = 1e-5):
    """Project (b, H) onto the complement of the gauge null spaces
    (EnergyFunctional::orthogonalize, EnergyFunctional.cpp:971-1027).

    nullspaces: (K, D) rows; like the reference, callers pass the pose (6)
    and scale (1) rows — the affine rows are commented out there too.
    delta mirrors setting_solverModeDelta."""
    norms = jnp.linalg.norm(nullspaces, axis=1, keepdims=True)
    N = (nullspaces / jnp.maximum(norms, 1e-12)).T    # (D, K)
    U, S, Vt = jnp.linalg.svd(N, full_matrices=False)
    keep = S > delta * jnp.max(S)
    S_inv = jnp.where(keep, 1.0 / jnp.maximum(S, 1e-30), 0.0)
    Npi = U * S_inv[None, :] @ Vt                     # pseudo-inverse pieces
    NNpiT = N @ Npi.T
    NNpiTS = 0.5 * (NNpiT + NNpiT.T)
    b_out = b - NNpiTS @ b
    H_out = H - NNpiTS @ H @ NNpiTS
    return b_out, H_out


@functools.partial(jax.jit, static_argnames=())
def marginalize_frame(ba: B.BAState, k: jnp.ndarray) -> B.BAState:
    """Schur-marginalize frame slot k out of HM/bM and compact the window
    (EnergyFunctional::marginalizeFrame, EnergyFunctional.cpp:730-889).

    Requires: no remaining valid points hosted in k, no residuals targeting k
    (the caller drops/marginalizes them first).
    """
    F = ba.F
    D = CPARS + 8 * F
    n = jnp.sum(ba.frame_valid)

    # add the frame's prior before marginalizing
    HM, bM = ba.HM, ba.bM
    didx = CPARS + 8 * k + jnp.arange(8)
    HM = HM.at[didx, didx].add(ba.prior[k])
    bM = bM.at[didx].add(ba.prior[k] * ba.state[k])

    # permutation moving block k to the last *valid* block position (n-1)
    blk = jnp.arange(F)
    # new order of frame blocks: [0..k-1, k+1..n-1, k, n..F-1]
    shifted = jnp.where((blk >= k) & (blk < n - 1), blk + 1, blk)
    order = jnp.where(blk == n - 1, k, shifted)          # (F,) old index per new slot
    perm = jnp.concatenate(
        [jnp.arange(CPARS), (CPARS + 8 * order[:, None] + jnp.arange(8)[None, :]
                             ).reshape(-1)]
    )
    HMp = HM[perm][:, perm]
    bMp = bM[perm]

    # Schur out the last valid block (dims [CPARS+8(n-1), CPARS+8n))
    sl = CPARS + 8 * (n - 1)
    dim_idx = jnp.arange(D)
    in_marg = (dim_idx >= sl) & (dim_idx < sl + 8)

    svec = jnp.sqrt(jnp.abs(jnp.diagonal(HMp)) + 10.0)
    svec_i = 1.0 / svec
    Hs = HMp * svec_i[:, None] * svec_i[None, :]
    bs = bMp * svec_i

    # invert the marginalized 8x8 block (gathered densely)
    gidx = sl + jnp.arange(8)
    Hmm = Hs[gidx][:, gidx]
    Hmm = 0.5 * (Hmm + Hmm.T)
    Hmm_inv = jnp.linalg.inv(Hmm)
    Hmm_inv = 0.5 * (Hmm_inv + Hmm_inv.T)
    Hxm = Hs[:, gidx]                      # (D,8) includes marg rows
    keep = (~in_marg).astype(jnp.float32)
    Hxm = Hxm * keep[:, None]
    bli = Hxm @ Hmm_inv                    # (D,8)
    Hs_new = Hs - bli @ Hxm.T
    bs_new = bs - bli @ bs[gidx]
    # keep only non-marg rows/cols
    Hs_new = Hs_new * keep[:, None] * keep[None, :]
    bs_new = bs_new * keep

    HM2 = Hs_new * svec[:, None] * svec[None, :]
    HM2 = 0.5 * (HM2 + HM2.T)
    bM2 = bs_new * svec

    # compact frame-indexed arrays: new slot i <- old slot order[i]
    def shift(a):
        return a[order]

    last = jnp.arange(F) == (n - 1)
    frame_valid = shift(ba.frame_valid) & ~last
    state = shift(ba.state) * frame_valid[:, None]
    state_zero = shift(ba.state_zero) * frame_valid[:, None]
    T_cw_eval = jnp.where(frame_valid[:, None, None], shift(ba.T_cw_eval),
                          jnp.eye(4))
    prior = shift(ba.prior) * frame_valid[:, None]
    exposure = shift(ba.exposure)
    energy_th = shift(ba.energy_th)

    # remap point host indices and residual targets
    new_host = jnp.where(ba.host > k, ba.host - 1, ba.host)
    inv_order = jnp.argsort(order)          # old block -> new block
    res_exist = ba.res_exist[:, order] & frame_valid[None, :]
    res_state = ba.res_state[:, order]

    return ba._replace(
        frame_valid=frame_valid, T_cw_eval=T_cw_eval, state=state,
        state_zero=state_zero, exposure=exposure, energy_th=energy_th,
        prior=prior, host=new_host, res_exist=res_exist, res_state=res_state,
        HM=HM2, bM=bM2,
    )
