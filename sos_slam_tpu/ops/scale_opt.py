"""Stereo 1-DoF metric-scale optimization.

JAX rebuild of ScaleOptimizer (src/FullSystem/ScaleOptimizer.cpp:
120-437) and the FullSystem::optimizeScale driver (src/FullSystem/
FullSystem.cpp:1117-1180).

The left keyframe's semi-dense template (the same one the coarse tracker
uses) is warped into the right camera at p1 = s * R01 K0^-1 x + t01 * id;
a coarse-to-fine 1-DoF LM solves for the scale s. The multi-guess
initialization {0.1, 0.2, 0.5, 1, 2, 5, 10} is one vmap.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from sos_slam_tpu.ops.image import interp_bilinear
from sos_slam_tpu.ops.tracker import LevelTemplate, MAX_ITERS_PER_LEVEL, \
    LAMBDA_EXTRAPOLATION_LIMIT

SCALE_GUESSES = (0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0)   # FullSystem.cpp:1135


def res_and_hb_scale(
    dI_right: jnp.ndarray,      # (H,W,3) right image at this level
    tmpl: LevelTemplate,        # left template at this level
    scale: jnp.ndarray,
    R01: jnp.ndarray,           # (3,3) left->right rotation
    t01: jnp.ndarray,           # (3,)
    intr0: Tuple[float, float, float, float],   # left K at this level
    intr1: Tuple[float, float, float, float],   # right K at this level
    cutoff: jnp.ndarray,
    huber: float,
):
    fx0, fy0, cx0, cy0 = intr0
    fx1, fy1, cx1, cy1 = intr1
    h, w = dI_right.shape[0], dI_right.shape[1]

    xn = jnp.stack([(tmpl.u - cx0) / fx0, (tmpl.v - cy0) / fy0,
                    jnp.ones_like(tmpl.u)], -1)
    rKx = xn @ R01.T                           # (N,3) R01 K0^-1 x
    pt = scale * rKx + t01[None, :] * tmpl.idepth[:, None]
    u_ = pt[:, 0] / pt[:, 2]
    v_ = pt[:, 1] / pt[:, 2]
    Ku = fx1 * u_ + cx1
    Kv = fy1 * v_ + cy1
    new_idepth = tmpl.idepth / pt[:, 2]

    inb = tmpl.valid & (Ku > 2) & (Kv > 2) & (Ku < w - 3) & (Kv < h - 3) \
        & (new_idepth > 0)
    hit = interp_bilinear(dI_right, Ku, Kv)
    inb &= jnp.isfinite(hit[:, 0])

    r = hit[:, 0] - tmpl.color
    abs_r = jnp.abs(r)
    hw = jnp.where(abs_r < huber, 1.0, huber / jnp.maximum(abs_r, 1e-9))
    saturated = inb & (abs_r > cutoff)
    active = inb & ~saturated
    max_energy = 2.0 * huber * cutoff - huber * huber
    E = jnp.sum(jnp.where(saturated, max_energy, 0.0)
                + jnp.where(active, hw * r * r * (2.0 - hw), 0.0))
    num_in = jnp.sum(inb)
    num_sat = jnp.sum(saturated)

    # dr/ds with rx = R K^-1 x / id (calcGSSSEScale, ScaleOptimizer.cpp:
    # 232-271): du/ds = (rx0*tz - rx2*tx) / (s*rx2 + tz)^2, analogous for v.
    rx = rKx / jnp.maximum(tmpl.idepth, 1e-12)[:, None]
    denom = scale * rx[:, 2] + t01[2]
    deno = 1.0 / jnp.maximum(denom * denom, 1e-18)
    xno = rx[:, 0] * t01[2] - rx[:, 2] * t01[0]
    yno = rx[:, 1] * t01[2] - rx[:, 2] * t01[1]
    J = hit[:, 1] * fx1 * deno * xno + hit[:, 2] * fy1 * deno * yno

    wts = jnp.where(active, hw, 0.0)
    n_act = jnp.maximum(jnp.sum(active).astype(jnp.float32), 1.0)
    H = jnp.sum(wts * J * J) / n_act
    b = jnp.sum(wts * J * r) / n_act
    return dict(E=E, num_in=num_in, num_sat=num_sat, H=H, b=b)


def scale_level(dI_right, tmpl, scale0, R01, t01, intr0, intr1, max_iters,
                coarse_cutoff_th, huber):
    """1-DoF LM at one level with the cutoff-doubling loop."""

    def res(s, cutoff):
        return res_and_hb_scale(dI_right, tmpl, s, R01, t01, intr0, intr1,
                                cutoff, huber)

    r0 = res(scale0, jnp.asarray(coarse_cutoff_th))
    sat0 = r0["num_sat"] / jnp.maximum(r0["num_in"], 1)

    def c_cond(c):
        rep, sat = c
        return (sat > 0.6) & (rep < 50.0)

    def c_body(c):
        rep, _ = c
        rep = rep * 2.0
        rr = res(scale0, coarse_cutoff_th * rep)
        return rep, rr["num_sat"] / jnp.maximum(rr["num_in"], 1)

    cutoff_rep, _ = jax.lax.while_loop(c_cond, c_body, (jnp.float32(1.0), sat0))
    cutoff = coarse_cutoff_th * cutoff_rep
    r0 = res(scale0, cutoff)

    def lm_cond(s):
        return (s["it"] < max_iters) & ~s["done"]

    def lm_body(s):
        Hl = s["H"] * (1.0 + s["lam"])
        inc = -s["b"] / jnp.where(jnp.abs(Hl) < 1e-18, 1e-18, Hl)
        extrap = jnp.where(
            s["lam"] < LAMBDA_EXTRAPOLATION_LIMIT,
            jnp.sqrt(jnp.sqrt(LAMBDA_EXTRAPOLATION_LIMIT
                              / jnp.maximum(s["lam"], 1e-12))), 1.0)
        inc = inc * extrap
        inc = jnp.where(jnp.isfinite(inc) & (jnp.abs(inc) <= s["scale"]),
                        inc, 0.0)
        s_new = s["scale"] + inc
        rn = res(s_new, cutoff)
        mean_new = jnp.where(rn["num_in"] > 0, rn["E"] / rn["num_in"], jnp.nan)
        mean_old = jnp.where(s["num"] > 0, s["E"] / s["num"], jnp.nan)
        accept = mean_new < mean_old
        sel = lambda a, b_: jnp.where(accept, a, b_)
        return dict(
            it=s["it"] + 1,
            scale=sel(s_new, s["scale"]),
            E=sel(rn["E"], s["E"]), num=sel(rn["num_in"], s["num"]),
            H=sel(rn["H"], s["H"]), b=sel(rn["b"], s["b"]),
            lam=jnp.where(accept, s["lam"] * 0.5,
                          jnp.maximum(s["lam"] * 4.0,
                                      LAMBDA_EXTRAPOLATION_LIMIT)),
            done=~(inc > 1e-3),
        )

    init = dict(it=jnp.int32(0), scale=scale0, E=r0["E"], num=r0["num_in"],
                H=r0["H"], b=r0["b"], lam=jnp.float32(0.01),
                done=jnp.array(False))
    s = jax.lax.while_loop(lm_cond, lm_body, init)
    rms = jnp.sqrt(jnp.where(s["num"] > 0, s["E"] / jnp.maximum(s["num"], 1),
                             jnp.nan))
    return s["scale"], rms, cutoff_rep


@functools.partial(jax.jit, static_argnames=("intr0", "intr1", "n_levels",
                                             "coarse_cutoff_th", "huber"))
def optimize_scale(
    pyr_right: Tuple[jnp.ndarray, ...],
    templates: Tuple[LevelTemplate, ...],
    scale_init: jnp.ndarray,
    R01: jnp.ndarray, t01: jnp.ndarray,
    intr0: Tuple, intr1: Tuple,
    n_levels: int,
    coarse_cutoff_th: float = 20.0,
    huber: float = 9.0,
):
    """Coarse-to-fine scale LM (ScaleOptimizer::optimizeScale).
    Returns (scale, rms_level0)."""
    scale = scale_init
    rms0 = jnp.float32(jnp.nan)
    have_rep = jnp.array(False)
    for lvl in range(n_levels - 1, -1, -1):
        max_it = MAX_ITERS_PER_LEVEL[min(lvl, len(MAX_ITERS_PER_LEVEL) - 1)]

        def run(s, lvl=lvl, max_it=max_it):
            return scale_level(pyr_right[lvl], templates[lvl], s, R01, t01,
                               intr0[lvl], intr1[lvl], max_it,
                               coarse_cutoff_th, huber)

        scale, rms, cut_rep = run(scale)
        do_rep = (cut_rep > 1.0) & ~have_rep
        have_rep |= do_rep
        scale, rms, _ = jax.lax.cond(
            do_rep, lambda: run(scale), lambda: (scale, rms, cut_rep))
        if lvl == 0:
            rms0 = rms
    return scale, rms0


def optimize_scale_multi_guess(pyr_right, templates, R01, t01, intr0, intr1,
                               n_levels, **kw):
    """The untrapped multi-guess initialization (FullSystem.cpp:1135-1147):
    run all guesses batched, return (best_scale, best_error)."""
    guesses = jnp.asarray(SCALE_GUESSES)
    fn = lambda s0: optimize_scale(pyr_right, templates, s0, R01, t01,
                                   tuple(intr0), tuple(intr1), n_levels, **kw)
    scales, errs = jax.vmap(fn)(guesses)
    errs = jnp.where(jnp.isfinite(errs) & (errs > 0), errs, jnp.inf)
    i = jnp.argmin(errs)
    return scales[i], errs[i]
