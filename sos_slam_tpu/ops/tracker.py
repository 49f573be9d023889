"""Direct coarse tracking: frame-to-keyframe photometric alignment.

JAX rebuild of CoarseTracker::trackNewestCoarse / calcResPose /
calcGSSSEPose (reference: src/FullSystem/CoarseTracker.cpp:366-764).

Design (vs the reference's per-point scalar loop + SSE accumulator):
  * The semi-dense template is a fixed-size padded point list per pyramid
    level (u, v, idepth, color, valid).
  * One fused pass per LM iteration: warp all points, bilinear-gather
    [I, dx, dy], compute Huber-weighted residuals AND the 8x8 H / 8-vector b
    in a single (N,9)^T (N,9) matmul (the Accumulator9 trick -> one GEMM).
  * Per-point early-exits (OOB, saturation) are masked lanes.
  * The Levenberg loop (accept/reject, lambda, cutoff-repeat) is a
    `lax.while_loop`; the level cascade is statically unrolled. The whole
    multi-level track jits to one XLA program; `vmap` batches motion
    hypotheses (FullSystem::trackNewCoarse's ~80 restarts become a leading
    axis instead of sequential early-exit tries).

Parity notes:
  * Jacobian, Huber/cutoff energy, (1/n) normalization, DSO's conditioning
    rescale S = [1,1,1,.5,.5,.5,10,1000] (SCALE_XI_*, SCALE_A/B), lambda
    schedule (x0.5 / x4), extrapolation factor, inc-norm break at 1e-3, the
    cutoff-doubling loop (>60% saturated), and the per-level maxIterations
    {10,20,50,50,50} all follow the reference.
  * Affine parameters (a, b) relate ref->new as r = I_new - (a*I_ref + b)
    with a = exp(a_new - a_ref) * exposure_new / exposure_ref
    (AffLight::fromToVecExposure, util/NumType.h:157-168).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from sos_slam_tpu.ops.image import interp_bilinear

# DSO conditioning rescale (reference HessianBlocks.h:54-60; note the
# reference applies "SCALE_XI_ROT"=1 to coords 0:3 and "SCALE_XI_TRANS"=0.5 to
# coords 3:6 — with Sophus [v, w] tangent order that is a 0.5 rescale of the
# rotation block; we reproduce it verbatim for identical LM behavior).
_SCALE8 = jnp.array([1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 10.0, 1000.0], jnp.float32)

MAX_ITERS_PER_LEVEL = (10, 20, 50, 50, 50, 50)
LAMBDA_EXTRAPOLATION_LIMIT = 1e-3
LM_CHUNK = 2   # LM iterations per device-loop trip (see track_level);
               # steady-state tracking converges in 1-3 iterations, so
               # larger chunks waste full res_and_hb passes on done lanes
# cond-gated unrolled LM iterations before the while_loop tail: each is
# wrapped in lax.cond (an identity branch is ~free, a while trip is not),
# so the common 1-3-iteration convergence never enters the while_loop at
# all and the math is bit-identical either way. 0 = classic loop only.
import os as _os
LM_UNROLL = int(_os.environ.get("SOS_TRACK_UNROLL", "0"))


class LevelTemplate(NamedTuple):
    """Padded semi-dense tracking template at one pyramid level."""

    u: jnp.ndarray       # (N,) pixel x in the reference KF
    v: jnp.ndarray       # (N,) pixel y
    idepth: jnp.ndarray  # (N,) inverse depth in the reference KF
    color: jnp.ndarray   # (N,) reference intensity
    valid: jnp.ndarray   # (N,) bool


def aff_from_to(exp_f: jnp.ndarray, exp_t: jnp.ndarray,
                aff_f: jnp.ndarray, aff_t: jnp.ndarray) -> jnp.ndarray:
    """Exposure-aware affine transfer (a, b): I_t ~= a * I_f + b."""
    exp_f = jnp.where(exp_f == 0, 1.0, exp_f)
    exp_t = jnp.where(exp_t == 0, 1.0, exp_t)
    a = jnp.exp(aff_t[0] - aff_f[0]) * exp_t / exp_f
    b = aff_t[1] - a * aff_f[1]
    return jnp.stack([a, b])


def res_and_hb(
    dI_new: jnp.ndarray,          # (H, W, 3) target level
    tmpl: LevelTemplate,
    T_ref_to_new: jnp.ndarray,    # (4, 4)
    aff_ab: jnp.ndarray,          # (2,) transfer [a, b]
    ref_b0: jnp.ndarray,          # scalar: reference frame's own aff b
    intr: Tuple[float, float, float, float],
    cutoff: jnp.ndarray,
    huber: float,
    compute_flow: bool = False,
):
    """One fused residual + Gauss-Newton pass at one level.

    Returns dict with E, num_in, num_sat, H (8,8), b (8,), and (optionally)
    flow indicator sums. All reductions masked.
    """
    fx, fy, cx, cy = intr
    h, w = dI_new.shape[0], dI_new.shape[1]
    Ki_diag = jnp.array([1.0 / fx, 1.0 / fy], jnp.float32)

    R = T_ref_to_new[:3, :3]
    t = T_ref_to_new[:3, 3]

    # x_norm = Ki [u,v,1]
    xn = jnp.stack(
        [(tmpl.u - cx) / fx, (tmpl.v - cy) / fy, jnp.ones_like(tmpl.u)], -1
    )  # (N,3)
    pt = xn @ R.T + t[None, :] * tmpl.idepth[:, None]
    u_ = pt[:, 0] / pt[:, 2]
    v_ = pt[:, 1] / pt[:, 2]
    Ku = fx * u_ + cx
    Kv = fy * v_ + cy
    new_idepth = tmpl.idepth / pt[:, 2]

    inb = (
        tmpl.valid
        & (Ku > 2) & (Kv > 2) & (Ku < w - 3) & (Kv < h - 3)
        & (new_idepth > 0)
    )

    hit = interp_bilinear(dI_new, Ku, Kv)  # (N, 3) [I, dx, dy]
    hit_ok = jnp.isfinite(hit[:, 0])
    inb = inb & hit_ok

    r = hit[:, 0] - (aff_ab[0] * tmpl.color + aff_ab[1])
    abs_r = jnp.abs(r)
    hw = jnp.where(abs_r < huber, 1.0, huber / jnp.maximum(abs_r, 1e-9))
    saturated = inb & (abs_r > cutoff)
    active = inb & ~saturated

    max_energy = 2.0 * huber * cutoff - huber * huber
    E = jnp.sum(
        jnp.where(saturated, max_energy, 0.0)
        + jnp.where(active, hw * r * r * (2.0 - hw), 0.0)
    )
    num_in = jnp.sum(inb)
    num_sat = jnp.sum(saturated)

    # Jacobian (N, 8): [v(3), w(3), a, b] — calcGSSSEPose ordering
    dxf = hit[:, 1] * fx
    dyf = hit[:, 2] * fy
    idp = new_idepth
    J = jnp.stack(
        [
            idp * dxf,
            idp * dyf,
            -idp * (u_ * dxf + v_ * dyf),
            -(u_ * v_ * dxf + dyf * (1.0 + v_ * v_)),
            u_ * v_ * dyf + dxf * (1.0 + u_ * u_),
            u_ * dyf - v_ * dxf,
            aff_ab[0] * (ref_b0 - tmpl.color),
            -jnp.ones_like(u_),
        ],
        -1,
    )
    Jr = jnp.concatenate([J, r[:, None]], -1)  # (N, 9)
    wts = jnp.where(active, hw, 0.0)
    M = jnp.einsum("ni,nj->ij", Jr * wts[:, None], Jr,
                   precision=jax.lax.Precision.HIGHEST)
    n_act = jnp.maximum(jnp.sum(active).astype(jnp.float32), 1.0)
    H = M[:8, :8] / n_act
    b = M[:8, 8] / n_act

    out = dict(E=E, num_in=num_in, num_sat=num_sat, H=H, b=b)

    if compute_flow:
        # flow indicators on every 32nd point (calcResPose lvl-0 block)
        stride_mask = tmpl.valid & (jnp.arange(tmpl.u.shape[0]) % 32 == 0)
        tid = t[None, :] * tmpl.idepth[:, None]

        def shift(pp):
            uu = fx * (pp[:, 0] / pp[:, 2]) + cx
            vv = fy * (pp[:, 1] / pp[:, 2]) + cy
            return (uu - tmpl.u) ** 2 + (vv - tmpl.v) ** 2

        ptT = xn + tid
        ptT2 = xn - tid
        pt3 = xn @ R.T - tid
        ssT = jnp.sum(jnp.where(stride_mask, shift(ptT) + shift(ptT2), 0.0))
        ssRT = jnp.sum(jnp.where(stride_mask, shift(pt) + shift(pt3), 0.0))
        n_flow = 2.0 * jnp.sum(stride_mask)
        out["flow_t"] = ssT / (n_flow + 0.1)
        out["flow_rt"] = ssRT / (n_flow + 0.1)
    return out


def _solve_damped(H, b, lam, fix_a: bool, fix_b: bool):
    """Scaled, damped 8x8 solve with optional affine fixing via masking."""
    S = _SCALE8
    Hs = H * S[:, None] * S[None, :]
    bs = b * S
    Hl = Hs + jnp.diag(jnp.diag(Hs)) * lam

    mask = jnp.array([1.0] * 6 + [0.0 if fix_a else 1.0, 0.0 if fix_b else 1.0],
                     jnp.float32)
    Hl = Hl * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
    bs = bs * mask

    inc = jnp.linalg.solve(Hl, -bs)
    extrap = jnp.where(
        lam < LAMBDA_EXTRAPOLATION_LIMIT,
        jnp.sqrt(jnp.sqrt(LAMBDA_EXTRAPOLATION_LIMIT / jnp.maximum(lam, 1e-12))),
        1.0,
    )
    inc = inc * extrap
    inc = jnp.where(jnp.isfinite(inc), inc, 0.0)
    return inc * S * mask, inc  # (scaled step, raw inc for the norm check)


def track_level(
    dI_new,
    tmpl: LevelTemplate,
    T0: jnp.ndarray,
    aff0: jnp.ndarray,           # (2,) this frame's aff_g2l [a, b]
    ref_aff: jnp.ndarray,        # (2,) reference KF's aff_g2l
    exposures: jnp.ndarray,      # (2,) [ref_exposure, new_exposure]
    intr,
    max_iters: int,
    coarse_cutoff_th: float,
    huber: float,
    fix_a: bool = False,
    fix_b: bool = False,
):
    """LM at one pyramid level. Returns (T, aff, rms, E_mean, sat_ratio,
    cutoff_repeat, flow_t, flow_rt)."""
    from sos_slam_tpu.utils import lie

    def res_pass(T, aff, cutoff, flow=False):
        aff_ab = aff_from_to(exposures[0], exposures[1], ref_aff, aff)
        return res_and_hb(dI_new, tmpl, T, aff_ab, ref_aff[1], intr, cutoff,
                          huber, compute_flow=flow)

    # cutoff-doubling loop: while sat ratio > 0.6 and repeat < 50
    def cutoff_cond(c):
        rep, sat = c
        return (sat > 0.6) & (rep < 50.0)

    def cutoff_body(c):
        rep, _ = c
        rep = rep * 2.0
        r = res_pass(T0, aff0, coarse_cutoff_th * rep)
        sat = r["num_sat"] / jnp.maximum(r["num_in"], 1)
        return rep, sat

    r0 = res_pass(T0, aff0, jnp.asarray(coarse_cutoff_th), flow=True)
    sat0 = r0["num_sat"] / jnp.maximum(r0["num_in"], 1)
    cutoff_repeat, _ = jax.lax.while_loop(cutoff_cond, cutoff_body,
                                          (jnp.float32(1.0), sat0))
    cutoff = coarse_cutoff_th * cutoff_repeat
    # cutoff == coarse_cutoff_th (the common case: no doubling) makes the
    # re-pass bitwise identical to r0 — skip it behind a cond (an identity
    # cond branch is ~free; a second full warp+reduce pass per level isn't)
    r0 = jax.lax.cond(
        cutoff_repeat > 1.0,
        lambda: res_pass(T0, aff0, cutoff, flow=True),
        lambda: r0,
    )

    # LM loop state: (it, T, aff, E, num, H, b, lam, done). The while body
    # runs LM_CHUNK iterations per trip (frozen once done/over-budget):
    # device-loop trips have a fixed per-iteration overhead that dwarfs the
    # fused warp+reduce itself, so amortizing it LM_CHUNK-fold cuts the
    # level cost (LM_CHUNK=2: steady-state tracking converges in 1-3
    # iterations, larger chunks waste passes on done lanes).
    def lm_iter(s):
        active = ~s["done"] & (s["it"] < max_iters)
        step, inc_raw = _solve_damped(s["H"], s["b"], s["lam"], fix_a, fix_b)
        T_new = lie.se3_exp(step[:6]) @ s["T"]
        aff_new = s["aff"] + step[6:8]
        rn = res_pass(T_new, aff_new, cutoff)
        # 0 in-bounds terms -> NaN mean -> never accept (reference's 0/0 path)
        mean_new = jnp.where(rn["num_in"] > 0, rn["E"] / rn["num_in"], jnp.nan)
        mean_old = jnp.where(s["num"] > 0, s["E"] / s["num"], jnp.nan)
        accept = active & (mean_new < mean_old)
        sel = lambda a, b_: jnp.where(accept, a, b_)
        new_lam = jnp.where(
            accept,
            s["lam"] * 0.5,
            jnp.maximum(s["lam"] * 4.0, LAMBDA_EXTRAPOLATION_LIMIT),
        )
        done = s["done"] | (active & (jnp.linalg.norm(inc_raw) <= 1e-3))
        return dict(
            it=s["it"] + active.astype(jnp.int32),
            T=jnp.where(accept, T_new, s["T"]),
            aff=sel(aff_new, s["aff"]),
            E=sel(rn["E"], s["E"]),
            num=sel(rn["num_in"], s["num"]),
            H=sel(rn["H"], s["H"]),
            b=sel(rn["b"], s["b"]),
            lam=jnp.where(active, new_lam, s["lam"]),
            done=done,
        )

    def lm_cond(s):
        return (s["it"] < max_iters) & ~s["done"]

    def lm_body(s):
        for _ in range(LM_CHUNK):
            s = lm_iter(s)
        return s

    init = dict(it=jnp.int32(0), T=T0, aff=aff0, E=r0["E"], num=r0["num_in"],
                H=r0["H"], b=r0["b"], lam=jnp.float32(0.01),
                done=jnp.array(False))
    s = init
    for _ in range(min(LM_UNROLL, max_iters)):
        s = jax.lax.cond(lm_cond(s), lm_iter, lambda c: c, s)
    if LM_UNROLL < max_iters:
        s = jax.lax.while_loop(lm_cond, lm_body, s)

    rms = jnp.sqrt(
        jnp.where(s["num"] > 0, s["E"] / jnp.maximum(s["num"], 1), jnp.nan)
    )
    return (s["T"], s["aff"], rms, cutoff_repeat, r0["flow_t"], r0["flow_rt"])


@functools.partial(
    jax.jit,
    static_argnames=("intrinsics", "n_levels", "coarse_cutoff_th", "huber",
                     "fix_a", "fix_b", "min_level"),
)
def track_newest_coarse(
    pyramid_new: Tuple[jnp.ndarray, ...],   # tuple of (H_l, W_l, 3)
    templates: Tuple[LevelTemplate, ...],
    T_init: jnp.ndarray,
    aff_init: jnp.ndarray,
    ref_aff: jnp.ndarray,
    exposures: jnp.ndarray,
    min_res_for_abort: jnp.ndarray,          # (6,) NaN = no bound
    intrinsics: Tuple[Tuple[float, float, float, float], ...],
    n_levels: int,
    coarse_cutoff_th: float = 20.0,
    huber: float = 9.0,
    fix_a: bool = False,
    fix_b: bool = False,
    min_level: int = 0,
):
    """Coarse-to-fine track down to `min_level`. Returns dict with T, aff,
    residuals (6,), flow (2,), good (bool).

    min_level = n_levels-1 gives the cheap coarsest-only screening pass the
    reference uses for its rotation-perturbed restart hypotheses
    ("they will only be tried on the coarsest level", FullSystem.cpp:190).
    The repeat-level trick (CoarseTracker.cpp:517-520) is a lax.cond re-run.
    """
    T = T_init
    aff = aff_init
    residuals = jnp.full((6,), jnp.nan, jnp.float32)
    flow = jnp.zeros((2,), jnp.float32)
    good = jnp.array(True)
    have_repeated = jnp.array(False)

    for lvl in range(n_levels - 1, min_level - 1, -1):
        max_it = MAX_ITERS_PER_LEVEL[min(lvl, len(MAX_ITERS_PER_LEVEL) - 1)]

        def run(T, aff, lvl=lvl, max_it=max_it):
            return track_level(
                pyramid_new[lvl], templates[lvl], T, aff, ref_aff, exposures,
                intrinsics[lvl], max_it, coarse_cutoff_th, huber, fix_a, fix_b,
            )

        T1, aff1, rms, cut_rep, ft, frt = run(T, aff)
        # repeat the level once if the cutoff was raised (first time only)
        do_rep = (cut_rep > 1.0) & ~have_repeated
        have_repeated = have_repeated | do_rep
        T1, aff1, rms, _, ft, frt = jax.lax.cond(
            do_rep,
            lambda: run(T1, aff1),
            lambda: (T1, aff1, rms, cut_rep, ft, frt),
        )

        # abort gate vs best-so-far from other hypotheses
        bound = min_res_for_abort[lvl]
        lvl_ok = jnp.isnan(bound) | (rms <= 1.5 * bound)
        good = good & lvl_ok & jnp.isfinite(rms)

        upd = lambda a, b_: jnp.where(good, a, b_)
        T = jnp.where(good, T1, T)
        aff = upd(aff1, aff)
        residuals = residuals.at[lvl].set(jnp.where(good, rms, jnp.nan))
        if lvl == 0:
            flow = jnp.stack([upd(ft, flow[0]), upd(frt, flow[1])])

    # affine sanity gates (CoarseTracker.cpp:531-549), assuming a,b optimized
    rel = aff_from_to(exposures[0], exposures[1], ref_aff, aff)
    good = good & (jnp.abs(aff[0]) < 1.2) & (jnp.abs(aff[1]) < 200.0)
    good = good & jnp.all(jnp.isfinite(T))

    return dict(T=T, aff=aff, residuals=residuals, flow=flow, good=good)


def track_hypotheses(
    pyramid_new,
    templates,
    T_inits: jnp.ndarray,    # (K, 4, 4)
    aff_init: jnp.ndarray,
    ref_aff: jnp.ndarray,
    exposures: jnp.ndarray,
    intrinsics,
    n_levels: int,
    min_level: int = 0,
    **kw,
):
    """vmap over motion hypotheses (replaces the ~80 sequential re-tries of
    FullSystem::trackNewCoarse, FullSystem.cpp:188-270)."""
    fn = lambda T0: track_newest_coarse(
        pyramid_new, templates, T0, aff_init, ref_aff, exposures,
        jnp.full((6,), jnp.nan), tuple(intrinsics), n_levels,
        min_level=min_level, **kw,
    )
    return jax.vmap(fn)(T_inits)
