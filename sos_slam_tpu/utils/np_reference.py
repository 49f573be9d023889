"""Plain float64 NumPy references of the device stages.

Each function restates one stage's semantics without JAX, vectorised the
straightforward way, so that the jitted forms can be checked against it: in
the CPU tests at small shapes, and by `chip_smoke.py` on the GPU at full
width. Nothing on the pipeline's own path imports this module.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def make_images(image: np.ndarray, n_levels: int
                ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """FrameHessian::makeImages (HessianBlocks.cpp:121-176): per level the
    intensity, central-difference gradients on interior rows/columns only,
    |grad|^2, and a 2x2 box average for the next level.
    Returns (levels (H_l, W_l, 3) [I, dx, dy], abs_sq_grads (H_l, W_l))."""
    cur = np.asarray(image, np.float64)
    levels, absgrads = [], []
    for lvl in range(n_levels):
        if lvl > 0:
            h, w = cur.shape
            cur = 0.25 * (cur[0:h:2, 0:w:2] + cur[1:h:2, 0:w:2]
                          + cur[0:h:2, 1:w:2] + cur[1:h:2, 1:w:2])
        h, w = cur.shape
        dx = np.zeros_like(cur)
        dy = np.zeros_like(cur)
        dx[1:h - 1, 1:w - 1] = 0.5 * (cur[1:h - 1, 2:] - cur[1:h - 1, :-2])
        dy[1:h - 1, :] = 0.5 * (cur[2:, :] - cur[:-2, :])
        levels.append(np.stack([cur, dx, dy], -1))
        absgrads.append(dx * dx + dy * dy)
    return levels, absgrads


def template_level(idm: np.ndarray, wm: np.ndarray, color: np.ndarray,
                   diag: bool) -> Tuple[np.ndarray, np.ndarray]:
    """One template level of makeCoarseDepthL0 (CoarseTracker.cpp:100-230):
    every empty pixel takes the mean idepth and weight of its occupied
    neighbours (the four diagonal ones when `diag`, else the four axial
    ones; indices wrap at the image edge, which only the masked 2-px border
    sees), then idepth is normalised by weight. Returns (idn, good)."""
    idm = np.asarray(idm, np.float64)
    wm = np.asarray(wm, np.float64)
    h, w = idm.shape
    offs = [(-1, -1), (1, 1), (-1, 1), (1, -1)] if diag else \
        [(0, -1), (0, 1), (-1, 0), (1, 0)]
    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    s = np.zeros_like(idm)
    c = np.zeros_like(wm)
    n = np.zeros_like(wm)
    for oy, ox in offs:
        nb_w = wm[(rows + oy) % h, (cols + ox) % w]
        nb_i = idm[(rows + oy) % h, (cols + ox) % w]
        has = nb_w > 0
        s += np.where(has, nb_i, 0.0)
        c += np.where(has, nb_w, 0.0)
        n += has
    fill = (wm <= 0) & (n > 0)
    idm2 = np.where(fill, s / np.maximum(n, 1), idm)
    wm2 = np.where(fill, c / np.maximum(n, 1), wm)
    idn = np.full_like(idm2, -1.0)
    pos = wm2 > 0
    idn[pos] = idm2[pos] / wm2[pos]
    border = np.zeros((h, w), bool)
    border[2:h - 2, 2:w - 2] = True
    good = border & (idn > 0) & np.isfinite(color)
    return idn, good


def bilinear_frames(dI: np.ndarray, Ku: np.ndarray, Kv: np.ndarray
                    ) -> np.ndarray:
    """Bilinear sample of (F, H, W, C) at (..., F, K) positions, clamped to
    the image like getInterpolatedElement33. Returns (..., F, K, C)."""
    F, H, W = dI.shape[:3]
    x0 = np.clip(np.floor(Ku), 0, W - 2).astype(np.int64)
    y0 = np.clip(np.floor(Kv), 0, H - 2).astype(np.int64)
    ax = np.clip(Ku - x0, 0.0, 1.0)[..., None]
    ay = np.clip(Kv - y0, 0.0, 1.0)[..., None]
    f = np.arange(F).reshape((F, 1))
    f = np.broadcast_to(f, Ku.shape)
    return (dI[f, y0, x0] * (1 - ax) * (1 - ay)
            + dI[f, y0, x0 + 1] * ax * (1 - ay)
            + dI[f, y0 + 1, x0] * (1 - ax) * ay
            + dI[f, y0 + 1, x0 + 1] * ax * ay)


def activation_pass(color, weights, energy_th, Rp, tp, ap, KliP, dI, idepth,
                    oob_in, clamp: bool, intr, w: int, h: int,
                    huber_th: float):
    """One GN linearization of the 1-DoF idepth problem of point activation
    (FullSystemOptPoint.cpp:47-192 with linearizeResidual,
    ImmaturePoint.cpp:475-545). Same contract as trace.activation_pass,
    with the point fields passed as arrays.
    Returns (e_res (N,F), oob (N,F), eN, HN, bN (N,))."""
    f64 = lambda a: np.asarray(a, np.float64)
    color, weights, energy_th = f64(color), f64(weights), f64(energy_th)
    Rp, tp, ap, KliP, dI, idepth = (f64(a) for a in (Rp, tp, ap, KliP, dI,
                                                     idepth))
    fx, fy, cx, cy = intr
    ptp = (np.einsum("nfij,nkj->nfki", Rp, KliP)
           + tp[:, :, None, :] * idepth[:, None, None, None])
    with np.errstate(divide="ignore", invalid="ignore"):
        drescale = 1.0 / ptp[..., 2]
    uu = ptp[..., 0] * drescale
    vv = ptp[..., 1] * drescale
    Ku = uu * fx + cx
    Kv = vv * fy + cy
    ok = (drescale > 0) & (Ku > 1.1) & (Kv > 1.1) & (Ku < w - 3) & (Kv < h - 3)
    hit = bilinear_frames(dI, np.nan_to_num(Ku), np.nan_to_num(Kv))
    ok &= np.isfinite(hit[..., 0])
    oob = np.asarray(oob_in, bool) | ~np.all(ok, -1)

    r = hit[..., 0] - (ap[..., 0:1] * color[:, None, :] + ap[..., 1:2])
    ar = np.abs(r)
    hw = np.where(ar < huber_th, 1.0, huber_th / np.maximum(ar, 1e-9))
    w2 = weights[:, None, :] ** 2
    e_res = np.sum(w2 * hw * r * r * (2 - hw), -1)
    d_id = (hit[..., 1] * fx * drescale * (tp[..., 0:1] - tp[..., 2:3] * uu)
            + hit[..., 2] * fy * drescale * (tp[..., 1:2] - tp[..., 2:3] * vv))
    Hdd_res = np.sum(hw * w2 * d_id * d_id, -1)
    bd_res = np.sum(hw * w2 * r * d_id, -1)

    live = ~oob
    ec = np.minimum(e_res, energy_th[:, None]) if clamp else e_res
    eN = np.sum(np.where(live, ec, 0.0), -1)
    HN = np.sum(np.where(live, Hdd_res, 0.0), -1)
    bN = np.sum(np.where(live, bd_res, 0.0), -1)
    return e_res, oob, eN, HN, bN


def dense_ba_system(X, Jpdd, resF, JIdx, JabF, active, host, adHost,
                    adTarget, pt_prior, idepth, idepth_zero,
                    shift_prior_to_zero: bool = True, prior_fac: float = 1.0):
    """The windowed-BA normal equations assembled residual by residual
    (AccumulatedTopHessian / AccumulatedSCHessian semantics), from one
    linearization's per-residual Jacobians (ops/ba.py LinData fields).

    Each pattern pixel k of residual (p, t) gets a dense row over the D =
    4 + 8F absolute parameters: calib, then the relative [xi, a, b] row
    mapped to the host and target frames through the adjoints. The top
    system is sum J^T J, J^T r; the Schur part eliminates each point's
    idepth. Returns float64 (H_top, b_top, H_sc, b_sc, HdiF)."""
    f64 = lambda a: np.asarray(a, np.float64)
    X, Jpdd, resF, JIdx, JabF = (f64(a) for a in (X, Jpdd, resF, JIdx, JabF))
    adHost, adTarget = f64(adHost), f64(adTarget)
    act = np.asarray(active, bool)
    host = np.asarray(host)
    P, F = act.shape
    D = 4 + 8 * F
    m = act[..., None].astype(np.float64)
    # per-pattern-pixel relative rows [c(4), xi(6), a, b] and idepth column
    rel = np.concatenate([np.einsum("pfak,pfai->pfki", JIdx, X),
                          np.swapaxes(JabF, -1, -2)], -1) * m[..., None]
    r = resF * m
    jd = np.einsum("pfak,pfa->pfk", JIdx, Jpdd) * m

    J = np.zeros((P, F, 8, D))
    J[..., :4] = rel[..., :4]
    for hh in range(F):
        sel = host == hh
        for t in range(F):
            blk = rel[sel, t, :, 4:]                       # (n,8,8)
            J[sel, t, :, 4 + 8 * hh:12 + 8 * hh] += blk @ adHost[hh, t]
            J[sel, t, :, 4 + 8 * t:12 + 8 * t] += blk @ adTarget[hh, t]

    H_top = np.einsum("pfki,pfkj->ij", J, J)
    b_top = np.einsum("pfki,pfk->i", J, r)

    Hdd = np.sum(jd * jd, (1, 2))
    bd = np.sum(r * jd, (1, 2))
    v = np.einsum("pfki,pfk->pi", J, jd)
    has_res = act.any(-1)
    prior = f64(pt_prior) * prior_fac
    Hdd_full = np.maximum(Hdd + prior, 1e-10)
    HdiF = np.where(has_res, 1.0 / Hdd_full, 0.0)
    if shift_prior_to_zero:
        bd = bd + prior * (f64(idepth) - f64(idepth_zero))
    H_sc = np.einsum("pi,p,pj->ij", v, HdiF, v)
    b_sc = np.einsum("pi,p->i", v, HdiF * bd)
    return H_top, b_top, H_sc, b_sc, HdiF
