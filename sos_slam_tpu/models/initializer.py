"""Monocular bootstrap: joint pose + per-point inverse-depth estimation.

JAX rebuild of CoarseInitializer (src/FullSystem/
CoarseInitializer.{h,cpp}): multi-level point selection with a kNN
neighbor/parent graph (makeNN, :966-1035), per-level Levenberg optimization
jointly over SE(3)+affine and all point inverse depths with Schur complement
on the depths (calcResAndGS, :450-676), translation-evidence "snap" test
(alphaW/alphaK), neighbor-median idepth regularization (optReg, :720-752),
and cross-level propagation (propagateUp/Down, :754-816).

Array design: each pyramid level is a fixed-size padded point pool; the
10-NN graph is dense (N,10) index arrays built by chunked brute-force top-k
(replaces nanoflann); the per-level LM loop is a lax.while_loop; levels are
statically unrolled (shapes differ).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sos_slam_tpu.ops import selector
from sos_slam_tpu.ops.image import interp_bilinear
from sos_slam_tpu.utils import lie
from sos_slam_tpu.utils.camera import CalibPyramid
from sos_slam_tpu.utils.config import PATTERN_OFFSETS, Settings

HIGH = jax.lax.Precision.HIGHEST

DENSITIES = (0.03, 0.05, 0.15, 0.5, 1.0)      # CoarseInitializer.cpp:829
MAX_ITS = (5, 5, 10, 30, 50)                  # :234
ALPHA_K = 2.5 * 2.5
ALPHA_W = 150.0 * 150.0
REG_WEIGHT = 0.8
COUPLING_WEIGHT = 1.0
# conditioning rescale wM (CoarseInitializer.h:62-65): note the reference
# puts SCALE_XI_ROT on dims 0:3 and SCALE_XI_TRANS on 3:6 here.
WM = jnp.array([1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 10.0, 1000.0], jnp.float32)


class InitLevel(NamedTuple):
    u: jnp.ndarray           # (N,)
    v: jnp.ndarray
    valid: jnp.ndarray       # (N,) slot occupied
    is_good: jnp.ndarray     # (N,)
    idepth: jnp.ndarray
    iR: jnp.ndarray
    energy: jnp.ndarray      # (N,2) [photometric, regularizer]
    last_hessian: jnp.ndarray
    nn: jnp.ndarray          # (N,10) neighbor indices (-1 = none)
    parent: jnp.ndarray      # (N,) index into level+1 (-1 at top)


class InitState(NamedTuple):
    levels: Tuple[InitLevel, ...]
    T: jnp.ndarray           # (4,4) thisToNext (first -> current)
    aff: jnp.ndarray         # (2,)
    snapped: jnp.ndarray     # bool
    frame_id: jnp.ndarray    # int32
    snapped_at: jnp.ndarray  # int32


def _knn(u, v, valid, k, chunk=512):
    """Brute-force kNN indices among valid points. Returns (N,k) int32, -1 pad."""
    n = u.shape[0]
    pts = jnp.stack([u, v], -1)

    def chunk_knn(q, qvalid):
        d = jnp.sum((q[:, None, :] - pts[None, :, :]) ** 2, -1)
        d = jnp.where(valid[None, :], d, jnp.inf)
        # exclude self (distance 0 handled by masking the exact same index)
        neg, idx = jax.lax.top_k(-d, k + 1)
        return idx, -neg

    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    qu = jnp.pad(pts, ((0, pad), (0, 0)))
    qv = jnp.pad(valid, (0, pad))
    idxs, dists = jax.lax.map(
        lambda c: chunk_knn(jax.lax.dynamic_slice_in_dim(qu, c * chunk, chunk),
                            jax.lax.dynamic_slice_in_dim(qv, c * chunk, chunk)),
        jnp.arange(n_chunks),
    )
    idx = idxs.reshape(-1, k + 1)[:n]
    dist = dists.reshape(-1, k + 1)[:n]
    # drop self column (first, distance 0) and mark infs as -1
    self_col = idx[:, 0:1]
    idx = idx[:, 1:]
    dist = dist[:, 1:]
    idx = jnp.where(jnp.isfinite(dist), idx, -1)
    idx = jnp.where(valid[:, None], idx, -1)
    return idx


def _parents(u, v, valid, pu, pv, pvalid, chunk=512):
    """Nearest coarser-level point for each point (coords halved)."""
    n = u.shape[0]
    q = jnp.stack([u * 0.5, v * 0.5], -1)
    pts = jnp.stack([pu, pv], -1)

    def chunk_near(qc):
        d = jnp.sum((qc[:, None, :] - pts[None, :, :]) ** 2, -1)
        d = jnp.where(pvalid[None, :], d, jnp.inf)
        return jnp.argmin(d, -1)

    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    qp = jnp.pad(q, ((0, pad), (0, 0)))
    par = jax.lax.map(
        lambda c: chunk_near(jax.lax.dynamic_slice_in_dim(qp, c * chunk, chunk)),
        jnp.arange(n_chunks),
    ).reshape(-1)[:n]
    return jnp.where(valid, par, -1)


def level_slots(calib: CalibPyramid, lvl: int) -> int:
    budget = DENSITIES[min(lvl, len(DENSITIES) - 1)] * calib.widths[0] * calib.heights[0]
    cap = calib.widths[lvl] * calib.heights[lvl] // 3
    return max(int(-(-min(budget * 1.5, cap) // 256) * 256), 256)


def set_first(pyr, absgrads, calib: CalibPyramid, settings: Settings,
              key) -> InitState:
    """Select points at every level and build the NN graph (setFirst)."""
    n_levels = calib.levels
    levels = []
    sel_data = []
    for lvl in range(n_levels):
        n_slots = level_slots(calib, lvl)
        density = DENSITIES[min(lvl, len(DENSITIES) - 1)] * calib.widths[0] * calib.heights[0]
        if lvl == 0:
            if len(absgrads) < 3:
                # the selector always wants 3 gradient octaves
                # (PixelSelector2 uses absSquaredGrad[0..2] regardless of
                # the calib pyramid depth) — rebuild them from level 0
                from sos_slam_tpu.ops.image import build_pyramid
                _, absgrads = build_pyramid(pyr[0][..., 0], 3)
            status, _, _ = selector.make_maps(
                pyr[0], absgrads, settings, density, key, recursions=1,
                th_factor=2.0)
        else:
            m, _ = selector.make_pixel_status(pyr[lvl], density)
            status = m.astype(jnp.int8)
        u, v, my_type = selector.extract_points(status, n_slots)
        valid = my_type > 0
        # reference offsets coords by +0.1 and excludes a pattern border
        w_l, h_l = calib.widths[lvl], calib.heights[lvl]
        inb = (u >= 3) & (v >= 3) & (u < w_l - 4) & (v < h_l - 4)
        valid &= inb
        u = u + 0.1
        v = v + 0.1
        sel_data.append((u, v, valid))

    for lvl in range(n_levels):
        u, v, valid = sel_data[lvl]
        n = u.shape[0]
        nn = _knn(u, v, valid, 10)
        if lvl + 1 < n_levels:
            pu, pv, pvalid = sel_data[lvl + 1]
            parent = _parents(u, v, valid, pu, pv, pvalid)
        else:
            parent = jnp.full((n,), -1, jnp.int32)
        levels.append(InitLevel(
            u=u, v=v, valid=valid, is_good=valid,
            idepth=jnp.ones(n), iR=jnp.ones(n),
            energy=jnp.zeros((n, 2)), last_hessian=jnp.zeros(n),
            nn=nn, parent=parent,
        ))

    return InitState(
        levels=tuple(levels), T=jnp.eye(4), aff=jnp.zeros(2),
        snapped=jnp.array(False), frame_id=jnp.int32(0),
        snapped_at=jnp.int32(0),
    )


def _masked_median(vals, mask):
    """Median over masked entries per row ((N,K) arrays)."""
    big = jnp.where(mask, vals, jnp.inf)
    s = jnp.sort(big, -1)
    cnt = jnp.sum(mask, -1)
    mid = jnp.clip(cnt // 2, 0, vals.shape[-1] - 1)
    return jnp.take_along_axis(s, mid[:, None], -1)[:, 0], cnt


def opt_reg(lv: InitLevel, snapped) -> InitLevel:
    """Neighbor-median pull of iR (optReg, CoarseInitializer.cpp:720-752)."""
    nn_ok = lv.nn >= 0
    nidx = jnp.maximum(lv.nn, 0)
    n_good = lv.is_good[nidx] & nn_ok
    n_iR = lv.iR[nidx]
    med, cnt = _masked_median(n_iR, n_good)
    new_iR = jnp.where(
        lv.is_good & (cnt > 2),
        (1.0 - REG_WEIGHT) * lv.idepth + REG_WEIGHT * med,
        lv.iR,
    )
    new_iR = jnp.where(snapped, new_iR, jnp.ones_like(new_iR))
    return lv._replace(iR=new_iR)


def calc_res_gs(lv: InitLevel, dI_first, dI_new, intr, w, h, T, aff,
                snapped, settings: Settings):
    """calcResAndGS: energy + acc9 H,b + Schur pieces, fully batched.

    Returns (E_photo, E_alpha, n_good, H (8,8), b (8,), Hsc, bsc, Jb (N,10),
    is_good_new (N,), energy_new (N,), maxstep (N,), alpha_snap (bool))."""
    fx, fy, cx, cy = intr
    pat = jnp.asarray(PATTERN_OFFSETS)
    N = lv.u.shape[0]
    R = T[:3, :3]
    t = T[:3, 3]
    a_aff = jnp.exp(aff[0])
    b_aff = aff[1]

    up = lv.u[:, None] + pat[None, :, 0]
    vp = lv.v[:, None] + pat[None, :, 1]
    KliP = jnp.stack([(up - cx) / fx, (vp - cy) / fy, jnp.ones_like(up)], -1)
    pt = jnp.einsum("ij,nkj->nki", R, KliP, precision=HIGH) \
        + t[None, None, :] * lv.idepth[:, None, None]
    z = pt[..., 2]
    u_ = pt[..., 0] / z
    v_ = pt[..., 1] / z
    Ku = fx * u_ + cx
    Kv = fy * v_ + cy
    new_idepth = lv.idepth[:, None] / z
    ok = (Ku > 1) & (Kv > 1) & (Ku < w - 2) & (Kv < h - 2) & (new_idepth > 0)

    hit = interp_bilinear(dI_new, Ku, Kv)       # (N,8,3)
    rlR = interp_bilinear(dI_first[..., 0], up, vp)
    ok &= jnp.isfinite(hit[..., 0]) & jnp.isfinite(rlR)
    all_ok = jnp.all(ok, -1)

    r = hit[..., 0] - a_aff * rlR - b_aff
    ar = jnp.abs(r)
    hw = jnp.where(ar < settings.huber_th, 1.0,
                   settings.huber_th / jnp.maximum(ar, 1e-9))
    energy_pat = hw * r * r * (2.0 - hw)
    energy = jnp.sum(energy_pat, -1)

    dxdd = (t[0] - t[2] * u_) / z
    dydd = (t[1] - t[2] * v_) / z
    hws = jnp.where(hw < 1, jnp.sqrt(hw), hw)
    dxI = hws * hit[..., 1] * fx
    dyI = hws * hit[..., 2] * fy
    J = jnp.stack(
        [
            new_idepth * dxI,
            new_idepth * dyI,
            -new_idepth * (u_ * dxI + v_ * dyI),
            -u_ * v_ * dxI - (1 + v_ * v_) * dyI,
            (1 + u_ * u_) * dxI + u_ * v_ * dyI,
            -v_ * dxI + u_ * dyI,
            -hws * a_aff * rlR,
            -hws,
            hws * r,
        ],
        -1,
    )  # (N,8,9)
    dd = dxI * dxdd + dyI * dydd                # (N,8)

    outlier_th = 8.0 * settings.outlier_th
    good_new = lv.is_good & all_ok & (energy <= outlier_th * 20.0)
    energy_new = jnp.where(good_new, energy, lv.energy[:, 0])
    E_photo = jnp.sum(jnp.where(lv.valid,
                                jnp.where(good_new, energy, lv.energy[:, 0]),
                                0.0))

    gmask = good_new.astype(jnp.float32)
    Jm = J * gmask[:, None, None]
    M = jnp.einsum("nki,nkj->ij", Jm, Jm, precision=HIGH)
    H8 = M[:8, :8]
    b8 = M[:8, 8]

    Jb = jnp.concatenate(
        [
            jnp.einsum("nki,nk->ni", J[..., :9], dd, precision=HIGH),
            jnp.sum(dd * dd, -1, keepdims=True),
        ],
        -1,
    )  # (N,10): [0:8]=dp*dd, [8]=r*dd, [9]=dd*dd
    Jb = Jb * gmask[:, None]

    maxstep = jnp.min(
        jnp.where(ok, 1.0 / jnp.maximum(
            jnp.sqrt((dxdd * fx) ** 2 + (dydd * fy) ** 2), 1e-10), 1e10),
        -1,
    )

    # alpha (translation-evidence) energy
    e_alpha_pt = jnp.where(
        good_new, (lv.idepth - 1.0) ** 2, lv.energy[:, 1]
    )
    npts = jnp.maximum(jnp.sum(lv.valid), 1).astype(jnp.float32)
    t_log = lie.se3_log(T)[:3]
    EAlpha = jnp.sum(jnp.where(lv.valid & good_new, e_alpha_pt, 0.0))
    alpha_energy_raw = ALPHA_W * (EAlpha + jnp.sum(t * t) * npts)
    snap_now = alpha_energy_raw <= ALPHA_K * npts
    alpha_energy = jnp.minimum(alpha_energy_raw, ALPHA_K * npts)
    alpha_opt = jnp.where(snap_now, ALPHA_W, 0.0)

    # Schur pieces with alpha / coupling priors on idepth
    Jb8 = Jb[:, 8] + alpha_opt * (lv.idepth - 1.0) + jnp.where(
        snap_now, 0.0, COUPLING_WEIGHT * (lv.idepth - lv.iR))
    Jb9 = Jb[:, 9] + alpha_opt + jnp.where(snap_now, 0.0, COUPLING_WEIGHT)
    Jb9i = jnp.where(good_new, 1.0 / (1.0 + Jb9), 0.0)

    Jhead = Jb[:, :8]
    Hsc = jnp.einsum("ni,n,nj->ij", Jhead, Jb9i, Jhead, precision=HIGH)
    bsc = jnp.einsum("ni,n->i", Jhead, Jb9i * Jb8, precision=HIGH)

    H8 = H8.at[jnp.arange(3), jnp.arange(3)].add(alpha_opt * npts)
    b8 = b8.at[:3].add(t_log * alpha_opt * npts)

    Jb_out = jnp.concatenate([Jhead, Jb8[:, None], Jb9i[:, None]], -1)
    return dict(E=E_photo, E_alpha=alpha_energy, H=H8, b=b8, Hsc=Hsc, bsc=bsc,
                Jb=Jb_out, good_new=good_new, energy_new=energy_new,
                e_alpha_new=e_alpha_pt, maxstep=maxstep, snap=snap_now)


def _do_point_step(lv, res, inc, lam):
    """doStep: per-point idepth update with maxstep clamp."""
    b = res["Jb"][:, 8] + res["Jb"][:, :8] @ inc
    step = -b * res["Jb"][:, 9] / (1.0 + lam)
    ms = jnp.minimum(0.25 * res["maxstep"], 1e10)
    step = jnp.clip(step, -ms, ms)
    return jnp.clip(lv.idepth + step, 1e-3, 50.0)


def track_level(lv: InitLevel, dI_first, dI_new, intr, w, h, T0, aff0,
                snapped, max_its: int, settings: Settings):
    """Per-level LM loop (trackFrame inner loop, CoarseInitializer.cpp:295-385)."""

    def res_at(lv_, T, aff):
        return calc_res_gs(lv_, dI_first, dI_new, intr, w, h, T, aff,
                           snapped, settings)

    res0 = res_at(lv, T0, aff0)
    # applyStep semantics at entry: energies from res0 (accept initial state)
    lv = lv._replace(is_good=res0["good_new"],
                     energy=jnp.stack([res0["energy_new"],
                                       res0["e_alpha_new"]], -1),
                     last_hessian=res0["Jb"][:, 9])

    npix = 0.01 / (w * h)

    def body(carry):
        lv_, T, aff, res, lam, fails, it, done, snap = carry
        H = res["H"] * (1.0 + lam)
        H = H - res["Hsc"] * (1.0 / (1.0 + lam))
        bl = res["b"] - res["bsc"] * (1.0 / (1.0 + lam))
        Hw = H * WM[:, None] * WM[None, :] * npix
        bw = bl * WM * npix
        m = jnp.eye(8)
        inc_w = -jnp.linalg.solve(Hw + 1e-12 * m, bw)
        inc = WM * inc_w
        inc = jnp.where(jnp.isfinite(inc), inc, 0.0)

        T_new = lie.se3_exp(inc[:6]) @ T
        aff_new = aff + inc[6:8]
        idepth_new = _do_point_step(lv_, res, inc, lam)
        lv_new = lv_._replace(idepth=idepth_new)
        res_new = res_at(lv_new, T_new, aff_new)

        # reg energy (calcEC): coupling residual old vs new over good_new pts
        gm = res_new["good_new"]
        reg_old = jnp.sum(jnp.where(gm, (lv_.idepth - lv_.iR) ** 2, 0.0))
        reg_new = jnp.sum(jnp.where(gm, (idepth_new - lv_.iR) ** 2, 0.0))
        reg_old = jnp.where(snapped, COUPLING_WEIGHT * reg_old, 0.0)
        reg_new = jnp.where(snapped, COUPLING_WEIGHT * reg_new, 0.0)

        e_old = res["E"] + res["E_alpha"] + reg_old
        e_new = res_new["E"] + res_new["E_alpha"] + reg_new
        accept = e_old > e_new

        # on accept: apply step (point states + iR regularization)
        def acc_fn():
            lv_a = lv_new._replace(
                is_good=res_new["good_new"],
                energy=jnp.stack([res_new["energy_new"],
                                  res_new["e_alpha_new"]], -1),
                last_hessian=res_new["Jb"][:, 9],
            )
            lv_a = opt_reg(lv_a, snapped | res_new["snap"])
            return lv_a, T_new, aff_new, res_at(lv_a, T_new, aff_new), \
                jnp.maximum(lam * 0.5, 1e-4), jnp.int32(0)

        def rej_fn():
            return lv_, T, aff, res, jnp.minimum(lam * 4.0, 1e4), fails + 1

        lv2, T2, aff2, res2, lam2, fails2 = jax.lax.cond(accept, acc_fn, rej_fn)
        snap2 = snap | (accept & res_new["snap"])
        done2 = (jnp.linalg.norm(inc) <= 1e-4) | (fails2 >= 2)
        return (lv2, T2, aff2, res2, lam2, fails2, it + 1, done2, snap2)

    def cond(carry):
        *_, it, done, _ = carry
        return (it < max_its) & ~done

    init = (lv, T0, aff0, res0, jnp.float32(0.1), jnp.int32(0), jnp.int32(0),
            jnp.array(False), jnp.array(False))
    lv, T, aff, res, _, _, _, _, snap = jax.lax.while_loop(cond, body, init)
    return lv, T, aff, snap


def propagate_down(src: InitLevel, dst: InitLevel) -> InitLevel:
    """Pull iR/idepth from parents (propagateDown)."""
    pok = dst.parent >= 0
    pidx = jnp.maximum(dst.parent, 0)
    p_good = src.is_good[pidx] & (src.last_hessian[pidx] >= 0.1) & pok
    p_iR = src.iR[pidx]
    newiR = jnp.where(
        dst.is_good,
        (dst.iR * dst.last_hessian * 2.0 + p_iR * src.last_hessian[pidx])
        / jnp.maximum(dst.last_hessian * 2.0 + src.last_hessian[pidx], 1e-10),
        p_iR,
    )
    upd = p_good & dst.valid
    return dst._replace(
        iR=jnp.where(upd, newiR, dst.iR),
        idepth=jnp.where(upd, newiR, dst.idepth),
        is_good=dst.is_good | upd,
        last_hessian=jnp.where(upd & ~dst.is_good, 0.0, dst.last_hessian),
    )


def propagate_up(src: InitLevel, dst: InitLevel) -> InitLevel:
    """Push Hessian-weighted iR to parents (propagateUp)."""
    n_dst = dst.u.shape[0]
    pok = (src.parent >= 0) & src.is_good & src.valid
    pidx = jnp.where(pok, src.parent, 0)
    wsum = jax.ops.segment_sum(
        jnp.where(pok, src.iR * src.last_hessian, 0.0), pidx, n_dst)
    hsum = jax.ops.segment_sum(
        jnp.where(pok, src.last_hessian, 0.0), pidx, n_dst)
    has = hsum > 0
    newv = jnp.where(has, wsum / jnp.maximum(hsum, 1e-10), dst.iR)
    return dst._replace(
        iR=newv, idepth=jnp.where(has, newv, dst.idepth),
        is_good=dst.is_good | (has & dst.valid),
    )


def reset_points_coarsest(lv: InitLevel) -> InitLevel:
    """At the coarsest level, revive bad points from neighbor means."""
    nn_ok = lv.nn >= 0
    nidx = jnp.maximum(lv.nn, 0)
    ngood = lv.is_good[nidx] & nn_ok
    s = jnp.sum(jnp.where(ngood, lv.iR[nidx], 0.0), -1)
    c = jnp.sum(ngood, -1)
    revive = ~lv.is_good & (c > 0) & lv.valid
    val = s / jnp.maximum(c, 1)
    return lv._replace(
        is_good=lv.is_good | revive,
        iR=jnp.where(revive, val, lv.iR),
        idepth=jnp.where(revive, val, lv.idepth),
    )


def track_frame(state: InitState, pyr_first, pyr_new, calib: CalibPyramid,
                settings: Settings, exposures=(1.0, 1.0)):
    """One initializer frame (CoarseInitializer::trackFrame): the full
    level cascade runs as ONE fused device program (per-level loops and
    propagation statically unrolled); the host reads back a single done
    flag. Returns (state, done)."""
    aff_override = None
    if exposures[0] > 0 and exposures[1] > 0:
        aff_override = np.array(
            [np.log(exposures[1] / exposures[0]), 0.0], np.float32)
    aff = state.aff if aff_override is None else jnp.asarray(aff_override)

    intr = tuple(calib.intrinsics(l) for l in range(calib.levels))
    state, done = _init_step_jit(
        state._replace(aff=aff), tuple(pyr_first), tuple(pyr_new),
        intr, tuple(calib.widths), tuple(calib.heights), settings)
    return state, bool(done)


@functools.partial(jax.jit, static_argnames=("intr", "widths", "heights",
                                             "settings"))
def _init_step_jit(state: InitState, pyr_first, pyr_new, intr, widths,
                   heights, settings):
    """Fused CoarseInitializer::trackFrame: pre-snap reset + the
    coarse-to-fine level cascade + upward propagation + snap bookkeeping
    in one device dispatch (the bootstrap was ~12 dispatches/frame)."""
    n_levels = len(pyr_first)
    levels = list(state.levels)

    # if not yet snapped: reset idepths to 1 and zero translation
    reset = ~state.snapped
    T = jnp.where(reset, state.T.at[:3, 3].set(0.0), state.T)
    levels = [
        lv._replace(
            iR=jnp.where(reset, jnp.ones_like(lv.iR), lv.iR),
            idepth=jnp.where(reset, jnp.ones_like(lv.idepth), lv.idepth),
            last_hessian=jnp.where(reset, jnp.zeros_like(lv.last_hessian),
                                   lv.last_hessian),
        )
        for lv in levels
    ]
    aff = state.aff

    snapped = state.snapped
    snap_any = jnp.array(False)
    for lvl in range(n_levels - 1, -1, -1):
        lv = levels[lvl]
        if lvl < n_levels - 1:
            lv = propagate_down(levels[lvl + 1], lv)
        else:
            lv = reset_points_coarsest(lv)
        max_its = MAX_ITS[min(lvl, len(MAX_ITS) - 1)]
        lv, T, aff, snap = track_level(
            lv, pyr_first[lvl], pyr_new[lvl], intr[lvl],
            widths[lvl], heights[lvl], T, aff, snapped, max_its, settings,
        )
        snap_any |= snap
        levels[lvl] = lv

    for lvl in range(n_levels - 1):
        levels[lvl + 1] = propagate_up(levels[lvl], levels[lvl + 1])

    snapped = jnp.logical_or(state.snapped, snap_any)
    frame_id = state.frame_id + 1
    snapped_at = jnp.where(
        snapped & (state.snapped_at == 0), frame_id, state.snapped_at
    )
    snapped_at = jnp.where(snapped, snapped_at, 0)
    done = snapped & (frame_id > snapped_at + 5)

    return InitState(tuple(levels), T, aff, snapped, frame_id,
                     snapped_at), done


@functools.partial(jax.jit,
                   static_argnames=("intr", "w", "h", "max_its", "settings"))
def jit_track_level(lv, dI_first, dI_new, intr, w, h, T, aff, snapped,
                    max_its, settings):
    return track_level(lv, dI_first, dI_new, intr, w, h, T, aff, snapped,
                       max_its, settings)
