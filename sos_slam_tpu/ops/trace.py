"""Immature points: epipolar-line depth search and activation.

JAX rebuild of ImmaturePoint::traceOn (src/FullSystem/
ImmaturePoint.cpp:70-415), ImmaturePoint::linearizeResidual (:475-545) and
FullSystem::optimizeImmaturePoint (src/FullSystem/FullSystemOptPoint.cpp:
47-192).

All candidate points trace in one batched pass: the discrete epipolar search
becomes an (N, MAX_STEPS) masked scan (the reference's `errors[100]` loop),
the 3-step GN refinement a fori_loop over arrays, and the status machine
(UNINITIALIZED/GOOD/OOB/OUTLIER/SKIPPED/BADCONDITION) masked selects.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from sos_slam_tpu.ops.image import (interp_bilinear,
                                    interp_bilinear_blin,
                                    interp_bilinear_frames,
                                    interp_bilinear_nfk)
from sos_slam_tpu.utils.config import PATTERN_OFFSETS, Settings

# status codes (ImmaturePointStatus, ImmaturePoint.h)
IPS_UNINITIALIZED = 0
IPS_GOOD = 1
IPS_OOB = 2
IPS_OUTLIER = 3
IPS_SKIPPED = 4
IPS_BADCONDITION = 5

# DSO's epipolar segment is hard-capped at (w+h)*setting_maxPixSearch
# (~30 px at 640x480, ImmaturePoint.cpp:145), so with stepsize 1.0 the
# discrete search never needs more than ~34 slots; 40 keeps headroom for
# larger inputs while cutting the (N, S, 8)-tap energy sweep 2.5x.
MAX_STEPS = 40


class ImmatureState(NamedTuple):
    """Fixed-size pool of immature points (padded + masked)."""

    valid: jnp.ndarray        # (N,) bool
    host: jnp.ndarray         # (N,) int32 frame slot
    u: jnp.ndarray            # (N,)
    v: jnp.ndarray            # (N,)
    color: jnp.ndarray        # (N,8)
    weights: jnp.ndarray      # (N,8)
    gradH: jnp.ndarray        # (N,2,2)
    energy_th: jnp.ndarray    # (N,)
    idepth_min: jnp.ndarray   # (N,)
    idepth_max: jnp.ndarray   # (N,)  (inf = uninitialized)
    status: jnp.ndarray       # (N,) int8
    quality: jnp.ndarray      # (N,)
    my_type: jnp.ndarray      # (N,) selector tier (1/2/4)


def init_immature(u, v, host, my_type, dI_host, settings: Settings,
                  n_slots: int) -> ImmatureState:
    """Create immature points at (u, v) in their host image (the reference's
    ImmaturePoint constructor, ImmaturePoint.cpp:25-60). Inputs are padded
    (N,) arrays with a validity mask implied by my_type > 0."""
    pat = jnp.asarray(PATTERN_OFFSETS)
    up = u[:, None] + pat[None, :, 0]
    vp = v[:, None] + pat[None, :, 1]
    # BiLin variant: forward-difference cell gradients, matching the
    # reference ctor's getInterpolatedElement33BiLin (ImmaturePoint.cpp:40)
    ptc = interp_bilinear_blin(dI_host[..., 0], up, vp)   # (N,8,3)
    color = ptc[..., 0]
    g = ptc[..., 1:]                           # (N,8,2)
    gradH = jnp.einsum("nki,nkj->nij", g, g)
    weights = jnp.sqrt(
        settings.outlier_th_sum_component
        / (settings.outlier_th_sum_component + jnp.sum(g * g, -1))
    )
    energy_th = (8.0 * settings.outlier_th
                 * settings.overall_energy_th_weight ** 2)
    n = u.shape[0]
    return ImmatureState(
        valid=(my_type > 0) & jnp.isfinite(color).all(-1),
        host=host.astype(jnp.int32),
        u=u, v=v, color=color, weights=weights, gradH=gradH,
        energy_th=jnp.full((n,), energy_th),
        idepth_min=jnp.zeros(n),
        idepth_max=jnp.full((n,), jnp.inf),
        status=jnp.full((n,), IPS_UNINITIALIZED, jnp.int8),
        quality=jnp.full((n,), 10000.0),
        my_type=my_type.astype(jnp.int32),
    )


def _pattern_energy_i(img, px, py, rot_pat, color, aff, huber):
    """Huber energy of the 8-pattern at (px, py), intensity-only.
    img: (H,W) intensity plane — the discrete epipolar sweep never uses the
    gradient channels, so gathering them would triple the load traffic."""
    qx = px[..., None] + rot_pat[..., 0]
    qy = py[..., None] + rot_pat[..., 1]
    hit = interp_bilinear(img, qx, qy)
    ok = jnp.isfinite(hit)
    r = hit - (aff[..., 0:1] * color + aff[..., 1:2])
    ar = jnp.abs(r)
    hw = jnp.where(ar < huber, 1.0, huber / jnp.maximum(ar, 1e-9))
    e = jnp.where(ok, hw * r * r * (2.0 - hw), 1e5)
    return jnp.sum(e, -1)


# patch side length for the sweep sampler: must cover the longest epipolar
# segment (MAX_STEPS-1 px) + rotated pattern extent + bilinear margin
SWEEP_PATCH = 56


def _sweep_energy_patch(img, ptx, pty, dxn, dyn, rot_pat, color, aff, huber):
    """(N, MAX_STEPS) pattern energies along the epipolar segment — the
    batched form of the reference's errors[] loop (ImmaturePoint.cpp
    discrete search).

    Instead of MAX_STEPS x 8 scattered bilinear gathers per point, each
    point extracts one (P, P) patch around its segment (a coherent
    dynamic-slice; the segment + rotated pattern fits by construction) and
    samples all taps as two hat-weight matmuls. bf16 operands with f32
    accumulation: the sweep only brackets the subsequent f32 Gauss-Newton
    refinement, and the ~0.4% rounding is far below the photometric noise
    the Huber handles. Whether this beats the flat gather on the GPU is not
    yet measured."""
    N = ptx.shape[0]
    P = SWEEP_PATCH
    h, w = img.shape
    steps = jnp.arange(MAX_STEPS, dtype=jnp.float32)
    sx = ptx[:, None] + steps[None, :] * dxn[:, None]        # (N,S)
    sy = pty[:, None] + steps[None, :] * dyn[:, None]
    qx = sx[:, :, None] + rot_pat[:, None, :, 0]             # (N,S,8)
    qy = sy[:, :, None] + rot_pat[:, None, :, 1]

    ox = jnp.clip(jnp.floor(jnp.min(qx, axis=(1, 2))) - 2, 0, w - P
                  ).astype(jnp.int32)
    oy = jnp.clip(jnp.floor(jnp.min(qy, axis=(1, 2))) - 2, 0, h - P
                  ).astype(jnp.int32)
    patches = jax.vmap(
        lambda y0, x0: jax.lax.dynamic_slice(img, (y0, x0), (P, P))
    )(oy, ox)                                                # (N,P,P)

    SK = MAX_STEPS * 8
    lx = jnp.clip(qx - ox[:, None, None], 0.0, P - 2.0).reshape(N, SK)
    ly = jnp.clip(qy - oy[:, None, None], 0.0, P - 2.0).reshape(N, SK)
    ii = jnp.arange(P, dtype=jnp.float32)
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(lx[..., None] - ii))  # (N,SK,P)
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(ly[..., None] - ii))
    t = jnp.einsum("nij,nsj->nsi", patches.astype(jnp.bfloat16),
                   wx.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    hit = jnp.einsum("nsi,nsi->ns", t.astype(jnp.bfloat16),
                     wy.astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32)
    hit = hit.reshape(N, MAX_STEPS, 8)

    r = hit - (aff[:, None, 0:1] * color[:, None, :] + aff[:, None, 1:2])
    ar = jnp.abs(r)
    hw = jnp.where(ar < huber, 1.0, huber / jnp.maximum(ar, 1e-9))
    return jnp.sum(hw * r * r * (2.0 - hw), -1)


def _pattern_energy(dI, px, py, rot_pat, color, aff, huber):
    """Huber energy of the 8-pattern at (px, py) + hit colors.
    px, py: (...,); rot_pat: (N,8,2); returns (energy (...), hit (...,8,3))."""
    qx = px[..., None] + rot_pat[..., 0]
    qy = py[..., None] + rot_pat[..., 1]
    hit = interp_bilinear(dI, qx, qy)
    ok = jnp.isfinite(hit[..., 0])
    r = hit[..., 0] - (aff[..., 0:1] * color + aff[..., 1:2])
    ar = jnp.abs(r)
    hw = jnp.where(ar < huber, 1.0, huber / jnp.maximum(ar, 1e-9))
    e = jnp.where(ok, hw * r * r * (2.0 - hw), 1e5)
    return jnp.sum(e, -1), hit


@functools.partial(jax.jit, static_argnames=("w", "h", "settings"))
def trace_points(
    imm: ImmatureState,
    dI_new: jnp.ndarray,     # (H,W,3) the new frame
    KRKi: jnp.ndarray,       # (F,3,3) host->new, K R K^-1 per host slot
    Kt: jnp.ndarray,         # (F,3)
    aff: jnp.ndarray,        # (F,2) host->new affine transfer
    w: int, h: int,
    settings: Settings,
) -> ImmatureState:
    """Batched traceOn of every immature point onto the new frame."""
    # static guard: the discrete sweep must cover the longest possible
    # epipolar segment ((w+h)*max_pix_search px at trace_stepsize)
    need = int(2 + (w + h) * settings.max_pix_search
               / max(settings.trace_stepsize, 1e-6)) + 1
    if need > MAX_STEPS:
        raise ValueError(
            f"MAX_STEPS={MAX_STEPS} cannot cover the epipolar search "
            f"({need} steps needed for {w}x{h} at max_pix_search="
            f"{settings.max_pix_search}); raise trace.MAX_STEPS")
    N = imm.u.shape[0]
    pat = jnp.asarray(PATTERN_OFFSETS)
    max_pix_search = (w + h) * settings.max_pix_search

    KRKi_p = KRKi[imm.host]      # (N,3,3)
    Kt_p = Kt[imm.host]          # (N,3)
    aff_p = aff[imm.host]        # (N,2)

    was_oob = imm.status == IPS_OOB

    pr = jnp.einsum("nij,nj->ni", KRKi_p,
                    jnp.stack([imm.u, imm.v, jnp.ones(N)], -1))
    ptpMin = pr + Kt_p * imm.idepth_min[:, None]
    uMin = ptpMin[:, 0] / ptpMin[:, 2]
    vMin = ptpMin[:, 1] / ptpMin[:, 2]
    inb = lambda x, y: (x > 4) & (y > 4) & (x < w - 5) & (y < h - 5)
    oob = ~inb(uMin, vMin)

    has_max = jnp.isfinite(imm.idepth_max)
    ptpMax = pr + Kt_p * jnp.where(has_max, imm.idepth_max, 0.01)[:, None]
    uMax0 = ptpMax[:, 0] / ptpMax[:, 2]
    vMax0 = ptpMax[:, 1] / ptpMax[:, 2]

    dist_f = jnp.sqrt((uMin - uMax0) ** 2 + (vMin - vMax0) ** 2)
    # uninitialized: shoot along the epipolar direction for maxPixSearch px
    dnorm = 1.0 / jnp.maximum(dist_f, 1e-9)
    uMax = jnp.where(has_max, uMax0, uMin + max_pix_search * (uMax0 - uMin) * dnorm)
    vMax = jnp.where(has_max, vMax0, vMin + max_pix_search * (vMax0 - vMin) * dnorm)
    dist = jnp.where(has_max, dist_f, max_pix_search)

    oob |= ~inb(uMax, vMax)
    skipped = has_max & (dist < settings.trace_slack_interval)
    # scale-change OOB gate (ImmaturePoint.cpp:176-183); checked AFTER the
    # skip gate in the reference, so it must not override SKIPPED
    scale_oob = ~((imm.idepth_min < 0)
                  | ((ptpMin[:, 2] > 0.75) & (ptpMin[:, 2] < 1.5)))

    # error bound from the gradient matrix (ImmaturePoint.cpp:186-198)
    dx = settings.trace_stepsize * (uMax - uMin)
    dy = settings.trace_stepsize * (vMax - vMin)
    dvec = jnp.stack([dx, dy], -1)
    nvec = jnp.stack([dy, -dx], -1)
    a = jnp.einsum("ni,nij,nj->n", dvec, imm.gradH, dvec)
    b = jnp.einsum("ni,nij,nj->n", nvec, imm.gradH, nvec)
    error_px = 0.2 + 0.2 * (a + b) / jnp.maximum(a, 1e-9)
    badcond = (error_px * settings.trace_min_improvement_factor > dist) & has_max
    error_px = jnp.minimum(error_px, 10.0)

    # normalize direction; clamp segment to maxPixSearch
    dxn = dx / jnp.maximum(dist, 1e-9)
    dyn = dy / jnp.maximum(dist, 1e-9)
    clamp = dist > max_pix_search
    uMax = jnp.where(clamp, uMin + max_pix_search * dxn, uMax)
    vMax = jnp.where(clamp, vMin + max_pix_search * dyn, vMax)
    dist = jnp.where(clamp, max_pix_search, dist)
    # non-finite direction -> OOB, checked after badcond in the reference
    dir_oob = ~jnp.isfinite(dxn) | ~jnp.isfinite(dyn)

    num_steps = jnp.minimum(
        (1.9999 + dist / settings.trace_stepsize).astype(jnp.int32), MAX_STEPS - 1
    )
    # deterministic sub-pixel shift (reference uses frac(u*1000))
    rshift = uMin * 1000.0 - jnp.floor(uMin * 1000.0)
    ptx = uMin - rshift * dxn
    pty = vMin - rshift * dyn

    rot = KRKi_p[:, :2, :2]                     # (N,2,2) pattern rotation
    rot_pat = jnp.einsum("nij,kj->nki", rot, pat)

    # ---- discrete search over MAX_STEPS positions (patch-sampled) ----
    e_steps = _sweep_energy_patch(
        dI_new[..., 0], ptx, pty, dxn, dyn, rot_pat,
        imm.color, aff_p, settings.huber_th,
    )  # (N,S)
    steps = jnp.arange(MAX_STEPS, dtype=jnp.float32)
    step_ok = steps[None, :] < num_steps[:, None].astype(jnp.float32)
    e_steps = jnp.where(step_ok, e_steps, jnp.inf)
    best_idx = jnp.argmin(e_steps, -1)
    best_e = jnp.min(e_steps, -1)
    bestU = ptx + best_idx * dxn
    bestV = pty + best_idx * dyn

    # second-best outside +-radius
    off = jnp.abs(jnp.arange(MAX_STEPS)[None, :] - best_idx[:, None])
    e2 = jnp.where(off > settings.min_trace_test_radius, e_steps, jnp.inf)
    second = jnp.min(e2, -1)
    new_quality = second / jnp.maximum(best_e, 1e-9)
    quality = jnp.where(
        (new_quality < imm.quality) | (num_steps > 10), new_quality, imm.quality
    )

    # ---- GN refinement along the line (3 its, masked accept/backstep) ----
    def gn_body(it, carry):
        bu, bv, be, ubak, vbak, stepback, done = carry
        e, hit = _pattern_energy(dI_new, bu, bv, rot_pat, imm.color, aff_p,
                                 settings.huber_th)
        r = hit[..., 0] - (aff_p[:, 0:1] * imm.color + aff_p[:, 1:2])
        ar = jnp.abs(r)
        hw = jnp.where(ar < settings.huber_th, 1.0,
                       settings.huber_th / jnp.maximum(ar, 1e-9))
        dres = dxn[:, None] * hit[..., 1] + dyn[:, None] * hit[..., 2]
        ok = jnp.isfinite(hit[..., 0])
        Hgn = 1.0 + jnp.sum(jnp.where(ok, hw * dres * dres, 0.0), -1)
        bgn = jnp.sum(jnp.where(ok, hw * r * dres, 0.0), -1)
        ew = jnp.sum(
            jnp.where(ok, imm.weights ** 2 * hw * r * r * (2 - hw), 1e5), -1
        )

        worse = ew > be
        # backstep: halve the last step from the old point
        sb_new = jnp.where(worse, stepback * 0.5, 0.0)
        step = jnp.clip(-bgn / Hgn, -0.5, 0.5)
        step = jnp.where(jnp.isfinite(step), step, 0.0)

        bu2 = jnp.where(worse, ubak + sb_new * dxn, bu + step * dxn)
        bv2 = jnp.where(worse, vbak + sb_new * dyn, bv + step * dyn)
        ubak2 = jnp.where(worse, ubak, bu)
        vbak2 = jnp.where(worse, vbak, bv)
        be2 = jnp.where(worse, be, ew)
        sb2 = jnp.where(worse, sb_new, step)
        upd = ~done
        sel = lambda new, old: jnp.where(upd, new, old)
        done2 = done | (jnp.abs(sb2) < settings.trace_gn_threshold)
        return (sel(bu2, bu), sel(bv2, bv), sel(be2, be), sel(ubak2, ubak),
                sel(vbak2, vbak), sel(sb2, stepback), done2)

    carry = (bestU, bestV, jnp.full((N,), 1e5), bestU, bestV,
             jnp.zeros(N), jnp.zeros(N, bool))
    # unrolled: the iteration count is a small static setting, and XLA
    # fuses unrolled bodies across iterations, which a while-loop body
    # boundary prevents
    for _it in range(settings.trace_gn_iterations):
        carry = gn_body(_it, carry)
    bestU, bestV, best_e_gn, _, _, _, _ = carry

    outlier = ~(best_e_gn < imm.energy_th * settings.trace_extra_slack_on_th)
    # second consecutive outlier escalates to OOB
    outlier_to_oob = outlier & (imm.status == IPS_OUTLIER)

    # ---- new idepth interval from the refined position ----
    use_x = dxn * dxn > dyn * dyn
    eU_lo, eU_hi = bestU - error_px * dxn, bestU + error_px * dxn
    eV_lo, eV_hi = bestV - error_px * dyn, bestV + error_px * dyn
    id_lo_x = (pr[:, 2] * eU_lo - pr[:, 0]) / (Kt_p[:, 0] - Kt_p[:, 2] * eU_lo)
    id_hi_x = (pr[:, 2] * eU_hi - pr[:, 0]) / (Kt_p[:, 0] - Kt_p[:, 2] * eU_hi)
    id_lo_y = (pr[:, 2] * eV_lo - pr[:, 1]) / (Kt_p[:, 1] - Kt_p[:, 2] * eV_lo)
    id_hi_y = (pr[:, 2] * eV_hi - pr[:, 1]) / (Kt_p[:, 1] - Kt_p[:, 2] * eV_hi)
    id_lo = jnp.where(use_x, id_lo_x, id_lo_y)
    id_hi = jnp.where(use_x, id_hi_x, id_hi_y)
    id_min = jnp.minimum(id_lo, id_hi)
    id_max = jnp.maximum(id_lo, id_hi)
    bad_interval = ~jnp.isfinite(id_min) | ~jnp.isfinite(id_max) | (id_max < 0)

    # ---- combine the status machine ----
    # reference check order (earlier wins, ImmaturePoint.cpp:70-415):
    # sticky OOB > uv-OOB > SKIPPED > scale-OOB > BADCONDITION > dir-OOB
    # > OUTLIER > bad-interval OUTLIER > GOOD
    status = jnp.full((N,), IPS_GOOD, jnp.int8)
    new_min, new_max = id_min, id_max
    status = jnp.where(bad_interval, IPS_OUTLIER, status)
    status = jnp.where(outlier, jnp.where(outlier_to_oob, IPS_OOB, IPS_OUTLIER),
                       status)
    keep_interval = outlier | bad_interval
    status = jnp.where(dir_oob, IPS_OOB, status)
    status = jnp.where(badcond, IPS_BADCONDITION, status)
    status = jnp.where(scale_oob, IPS_OOB, status)
    status = jnp.where(skipped, IPS_SKIPPED, status)
    keep_interval |= dir_oob | badcond | scale_oob | skipped
    status = jnp.where(oob | was_oob, IPS_OOB, status)
    keep_interval |= oob | was_oob
    status = jnp.where(imm.valid, status, imm.status)
    keep_interval |= ~imm.valid
    # quality only updates when the discrete search actually ran (i.e. the
    # trace reached the sweep: not returned-early, but outliers DO count)
    ran_sweep = ~(oob | was_oob | skipped | scale_oob | badcond | dir_oob
                  | ~imm.valid)
    quality = jnp.where(ran_sweep, quality, imm.quality)

    new_min = jnp.where(keep_interval, imm.idepth_min, new_min)
    new_max = jnp.where(keep_interval, imm.idepth_max, new_max)

    return imm._replace(
        idepth_min=new_min, idepth_max=new_max, status=status, quality=quality
    )


def activation_pass(imm: ImmatureState, Rp, tp, ap, KliP, dI, idepth,
                    oob_in, clamp: bool, intr, w: int, h: int,
                    huber_th: float):
    """One GN linearization of optimizeImmaturePoint's 1-DoF idepth
    problem (FullSystemOptPoint.cpp:47-192, linearizeResidual
    ImmaturePoint.cpp:475-545) for every candidate against every frame.

    Rp (N,F,3,3), tp (N,F,3), ap (N,F,2): host->frame rotation, translation
    and affine transfer per point; KliP (N,8,3): the pattern's unprojected
    host rays; dI (F,H,W,3); idepth (N,); oob_in (N,F) bool.

    Returns (e_res (N,F) unclamped, oob (N,F), eN, HN, bN (N,)) with eN
    clamped at energy_th when clamp=True (outlierTHSlack=1)."""
    fx, fy, cx, cy = intr
    ptp = (
        jnp.einsum("nfij,nkj->nfki", Rp, KliP)
        + tp[:, :, None, :] * idepth[:, None, None, None]
    )  # (N,F,8,3)
    drescale = 1.0 / ptp[..., 2]
    uu = ptp[..., 0] * drescale
    vv = ptp[..., 1] * drescale
    Ku = uu * fx + cx
    Kv = vv * fy + cy
    ok = (drescale > 0) & (Ku > 1.1) & (Kv > 1.1) & (Ku < w - 3) & (Kv < h - 3)

    # one fused 4-corner take over all frames (see interp_bilinear_frames)
    hit = interp_bilinear_frames(dI, Ku, Kv)
    ok &= jnp.isfinite(hit[..., 0])
    oob = oob_in | ~jnp.all(ok, -1)     # any bad pattern pixel -> OOB

    r = hit[..., 0] - (ap[..., 0:1] * imm.color[:, None, :] + ap[..., 1:2])
    ar = jnp.abs(r)
    hw = jnp.where(ar < huber_th, 1.0, huber_th / jnp.maximum(ar, 1e-9))
    e_pat = imm.weights[:, None, :] ** 2 * hw * r * r * (2 - hw)
    e_res = jnp.sum(e_pat, -1)         # (N,F)

    d_id = (
        hit[..., 1] * fx * drescale * (tp[..., 0:1] - tp[..., 2:3] * uu)
        + hit[..., 2] * fy * drescale * (tp[..., 1:2] - tp[..., 2:3] * vv)
    )  # (N,F,8)
    hw_w = hw * imm.weights[:, None, :] ** 2
    Hdd_res = jnp.sum(hw_w * d_id * d_id, -1)
    bd_res = jnp.sum(hw_w * r * d_id, -1)

    live = ~oob
    ec = jnp.minimum(e_res, imm.energy_th[:, None]) if clamp else e_res
    eN = jnp.sum(jnp.where(live, ec, 0.0), -1)
    HN = jnp.sum(jnp.where(live, Hdd_res, 0.0), -1)
    bN = jnp.sum(jnp.where(live, bd_res, 0.0), -1)
    return e_res, oob, eN, HN, bN


@functools.partial(jax.jit, static_argnames=("w", "h", "settings"))
def activate_points(
    imm: ImmatureState,
    candidate: jnp.ndarray,    # (N,) bool: which immature points to try
    dI: jnp.ndarray,           # (F,H,W,3) window frames
    R: jnp.ndarray,            # (F,F,3,3) current host->target rotations
    t: jnp.ndarray,            # (F,F,3)
    affLL: jnp.ndarray,        # (F,F,2)
    frame_valid: jnp.ndarray,  # (F,)
    intr: Tuple[float, float, float, float],
    w: int, h: int,
    settings: Settings,
):
    """Batched optimizeImmaturePoint: 1-DoF GN on inverse depth against all
    window frames. Returns (idepth (N,), ok (N,) bool, res_in (N,F) bool)."""
    fx, fy, cx, cy = intr
    N = imm.u.shape[0]
    F = dI.shape[0]
    pat = jnp.asarray(PATTERN_OFFSETS)

    Rp = R[imm.host]        # (N,F,3,3)
    tp = t[imm.host]        # (N,F,3)
    ap = affLL[imm.host]    # (N,F,2)
    is_host = jax.nn.one_hot(imm.host, F, dtype=bool)
    res_ok0 = candidate[:, None] & frame_valid[None, :] & ~is_host

    KliP = jnp.stack(
        [
            (imm.u[:, None] + pat[None, :, 0] - cx) / fx,
            (imm.v[:, None] + pat[None, :, 1] - cy) / fy,
            jnp.ones((N, 8)),
        ],
        -1,
    )  # (N,8,3)

    linearize_pass = functools.partial(
        activation_pass, imm, Rp, tp, ap, KliP, dI, intr=intr, w=w, h=h,
        huber_th=settings.huber_th)

    idepth0 = 0.5 * (imm.idepth_min + imm.idepth_max)
    idepth0 = jnp.where(jnp.isfinite(idepth0), idepth0, 0.5)

    # first linearization with outlierTHSlack = 1000 (never clamps)
    e0, oob, energy, Hdd, bd = linearize_pass(idepth0, ~res_ok0, clamp=False)

    def gn_body(it, carry):
        idp, Hdd, bd, energy, oob, e_res, lam = carry
        step = bd / (Hdd * (1.0 + lam))
        new_idp = idp - step
        e1, oob1, eN, HN, bN = linearize_pass(new_idp, oob, clamp=True)
        accept = eN < energy
        idp2 = jnp.where(accept, new_idp, idp)
        lam2 = jnp.where(accept, lam * 0.5, lam * 5.0)
        return (
            idp2,
            jnp.where(accept, HN, Hdd),
            jnp.where(accept, bN, bd),
            jnp.where(accept, eN, energy),
            jnp.where(accept[:, None], oob1, oob),
            jnp.where(accept[:, None], e1, e_res),
            lam2,
        )

    carry = (idepth0, Hdd, bd, energy, oob, e0, jnp.full((N,), 0.1))
    # unrolled (see trace GN note): static small iteration count
    for _it in range(settings.gn_its_on_point_activation):
        carry = gn_body(_it, carry)
    idepth, Hdd, bd, energy, oob, e_res, _ = carry

    # final residual states: IN if not OOB and below energy_th. The carry
    # already holds the per-residual energies and OOB mask linearized AT the
    # accepted idepth (linearize_idepth's e/oob depend only on the idepth and
    # the OR-folded oob input), so a 5th full (N,F,8)-tap gather pass is
    # redundant — e_res/oob ARE eF/oobF.
    res_in = ~oob & (e_res <= imm.energy_th[:, None]) & res_ok0
    n_good = jnp.sum(res_in, -1)

    ok = (
        candidate
        & jnp.isfinite(energy)
        & (Hdd >= settings.min_idepth_h_act)
        & jnp.isfinite(idepth)
        & (n_good >= 1)
        & (idepth > 0)
    )
    return idepth, ok, res_in

def activate_points_t(
    imm: ImmatureState,
    candidate: jnp.ndarray,
    dI: jnp.ndarray,
    R: jnp.ndarray,
    t: jnp.ndarray,
    affLL: jnp.ndarray,
    frame_valid: jnp.ndarray,
    intr: Tuple[float, float, float, float],
    w: int, h: int,
    settings: Settings,
):
    """activate_points in the lanes-last layout (see ops/ba_t.py): per-tap
    arrays are (F, 8, N) with the candidate axis on lanes, host-indexed
    transforms become one-hot contractions, gathers go through planar
    channel rows. Same contract and algebra as activate_points (parity:
    tests/test_ba_t.py::TestActivateT); f32 rounding differs ~1e-6."""
    fx, fy, cx, cy = intr
    N = imm.u.shape[0]
    F = dI.shape[0]
    HIGH = jax.lax.Precision.HIGHEST
    pat = jnp.asarray(PATTERN_OFFSETS, jnp.float32)

    onehot = jax.nn.one_hot(imm.host, F, dtype=jnp.float32)   # (N,Fh)
    Re = jnp.einsum("hfij,nh->fijn", R, onehot, precision=HIGH)
    te = jnp.einsum("hfi,nh->fin", t, onehot, precision=HIGH)
    ae = jnp.einsum("hfc,nh->fcn", affLL, onehot, precision=HIGH)
    is_host = onehot.T.astype(bool)                            # (F,N)
    res_ok0 = candidate[None, :] & frame_valid[:, None] & ~is_host

    KliPp = jnp.stack(
        [
            (imm.u[None, :] + pat[:, 0:1] - cx) / fx,
            (imm.v[None, :] + pat[:, 1:2] - cy) / fy,
            jnp.ones((8, N)),
        ],
        0,
    )  # (3,8,N)
    colorT = imm.color.T      # (8,N)
    w2T = (imm.weights.T) ** 2

    H_, W_ = dI.shape[1], dI.shape[2]
    flatT = dI.reshape(F * H_ * W_, 3).T
    fofs = (jnp.arange(F, dtype=jnp.int32) * (H_ * W_))[:, None, None]

    def linearize_idepth(idepth, oob_in):
        """(energy (F,N), Hdd (F,N), bd (F,N), new_oob (F,N))."""
        ptp = (jnp.einsum("fijn,jkn->fikn", Re, KliPp, precision=HIGH)
               + te[:, :, None, :] * idepth[None, None, None, :])
        drescale = 1.0 / ptp[:, 2]          # (F,8,N)
        uu = ptp[:, 0] * drescale
        vv = ptp[:, 1] * drescale
        Ku = uu * fx + cx
        Kv = vv * fy + cy
        ok = (drescale > 0) & (Ku > 1.1) & (Kv > 1.1) \
            & (Ku < w - 3) & (Kv < h - 3)

        x0 = jnp.clip(jnp.floor(Ku), 0, W_ - 2).astype(jnp.int32)
        y0 = jnp.clip(jnp.floor(Kv), 0, H_ - 2).astype(jnp.int32)
        dx = jnp.clip(Ku - x0, 0.0, 1.0)
        dy = jnp.clip(Kv - y0, 0.0, 1.0)
        idx = fofs + y0 * W_ + x0

        def sample(c):
            row = flatT[c]
            tl = jnp.take(row, idx)
            tr = jnp.take(row, idx + 1)
            bl = jnp.take(row, idx + W_)
            br = jnp.take(row, idx + W_ + 1)
            return (tl * (1 - dx) * (1 - dy) + tr * dx * (1 - dy)
                    + bl * (1 - dx) * dy + br * dx * dy)

        hitI, gx, gy = sample(0), sample(1), sample(2)
        ok &= jnp.isfinite(hitI)
        oob = oob_in | ~jnp.all(ok, 1)      # (F,N)

        r = hitI - (ae[:, 0:1, :] * colorT[None] + ae[:, 1:2, :])
        ar = jnp.abs(r)
        hw = jnp.where(ar < settings.huber_th, 1.0,
                       settings.huber_th / jnp.maximum(ar, 1e-9))
        e_pat = w2T[None] * hw * r * r * (2 - hw)
        e_res = jnp.sum(e_pat, 1)           # (F,N)

        d_id = (
            gx * fx * drescale * (te[:, 0:1, :] - te[:, 2:3, :] * uu)
            + gy * fy * drescale * (te[:, 1:2, :] - te[:, 2:3, :] * vv)
        )  # (F,8,N)
        hw_w = hw * w2T[None]
        Hdd_res = jnp.sum(hw_w * d_id * d_id, 1)
        bd_res = jnp.sum(hw_w * r * d_id, 1)
        return e_res, Hdd_res, bd_res, oob

    idepth0 = 0.5 * (imm.idepth_min + imm.idepth_max)
    idepth0 = jnp.where(jnp.isfinite(idepth0), idepth0, 0.5)

    e0, H0, b0, oob = linearize_idepth(idepth0, ~res_ok0)
    live = ~oob
    Hdd = jnp.sum(jnp.where(live, H0, 0.0), 0)
    bd = jnp.sum(jnp.where(live, b0, 0.0), 0)
    energy = jnp.sum(jnp.where(live, e0, 0.0), 0)

    def gn_body(it, carry):
        idp, Hdd, bd, energy, oob, e_res, lam = carry
        step = bd / (Hdd * (1.0 + lam))
        new_idp = idp - step
        e1, H1, b1, oob1 = linearize_idepth(new_idp, oob)
        live1 = ~oob1
        e1c = jnp.minimum(e1, imm.energy_th[None, :])
        eN = jnp.sum(jnp.where(live1, e1c, 0.0), 0)
        HN = jnp.sum(jnp.where(live1, H1, 0.0), 0)
        bN = jnp.sum(jnp.where(live1, b1, 0.0), 0)
        accept = eN < energy
        idp2 = jnp.where(accept, new_idp, idp)
        lam2 = jnp.where(accept, lam * 0.5, lam * 5.0)
        return (
            idp2,
            jnp.where(accept, HN, Hdd),
            jnp.where(accept, bN, bd),
            jnp.where(accept, eN, energy),
            jnp.where(accept[None, :], oob1, oob),
            jnp.where(accept[None, :], e1, e_res),
            lam2,
        )

    carry = (idepth0, Hdd, bd, energy, oob, e0, jnp.full((N,), 0.1))
    for _it in range(settings.gn_its_on_point_activation):
        carry = gn_body(_it, carry)
    idepth, Hdd, bd, energy, oob, e_res, _ = carry

    res_in_t = ~oob & (e_res <= imm.energy_th[None, :]) & res_ok0
    n_good = jnp.sum(res_in_t, 0)

    ok = (
        candidate
        & jnp.isfinite(energy)
        & (Hdd >= settings.min_idepth_h_act)
        & jnp.isfinite(idepth)
        & (n_good >= 1)
        & (idepth > 0)
    )
    return idepth, ok, res_in_t.T
