"""Window/pool bookkeeping helpers: fixed-shape slot allocation and the
coarse-tracker template builder.

These replace the reference's dynamic vectors-of-pointers bookkeeping
(frameHessians / pointHessians / immaturePoints push_back/erase): everything
is scatter into padded pools.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from sos_slam_tpu.ops import ba as B
from sos_slam_tpu.ops import selector
from sos_slam_tpu.ops.tracker import LevelTemplate
from sos_slam_tpu.utils.config import PATTERN_OFFSETS


def scatter_into_free_slots(valid: jnp.ndarray, ok_new: jnp.ndarray):
    """Assign each ok_new candidate a free slot index.

    valid: (P,) current occupancy. ok_new: (M,) candidate mask.
    Returns (slot_idx (M,), accepted (M,)): slot for each accepted candidate.
    """
    P = valid.shape[0]
    free_order = jnp.argsort(valid.astype(jnp.int32), stable=True)  # free first
    n_free = jnp.sum(~valid)
    rank = jnp.cumsum(ok_new.astype(jnp.int32)) - 1            # (M,)
    accepted = ok_new & (rank < n_free)
    slot = free_order[jnp.clip(rank, 0, P - 1)]
    return slot, accepted


def template_level(idm: jnp.ndarray, wm: jnp.ndarray, color: jnp.ndarray,
                   diag: bool) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One template level's tail (CoarseTracker.cpp:100-230): a single
    dilation pass of the scattered idepth/weight maps (8-neighborhood
    `diag` pattern on levels 0-1, 4-neighborhood on coarser ones), then the
    normalized idepth map (-1 where empty) and the usable-pixel mask (2-px
    border, positive idepth, finite color). Returns (idn, good)."""
    rolls = [(1, 1), (-1, -1), (1, -1), (-1, 1)] if diag else \
            [(0, 1), (0, -1), (1, 0), (-1, 0)]
    s = jnp.zeros_like(idm)
    c = jnp.zeros_like(wm)
    n = jnp.zeros_like(wm)
    for dy, dx in rolls:
        wn = jnp.roll(wm, (dy, dx), (0, 1))
        idn = jnp.roll(idm, (dy, dx), (0, 1))
        has = wn > 0
        s = s + jnp.where(has, idn, 0.0)
        c = c + jnp.where(has, wn, 0.0)
        n = n + has
    fill = (wm <= 0) & (n > 0)
    idm = jnp.where(fill, s / jnp.maximum(n, 1), idm)
    wm = jnp.where(fill, c / jnp.maximum(n, 1), wm)

    hl, wl = idm.shape
    yi = jnp.arange(hl)
    xi = jnp.arange(wl)
    border = ((xi >= 2) & (xi < wl - 2))[None, :] & \
             ((yi >= 2) & (yi < hl - 2))[:, None]
    idn = jnp.where(wm > 0, idm / jnp.maximum(wm, 1e-12), -1.0)
    good = border & (idn > 0) & jnp.isfinite(color)
    return idn, good


@functools.partial(jax.jit, static_argnames=("n_levels", "sizes", "w", "h"))
def build_track_template(
    ba: B.BAState,
    HdiF: jnp.ndarray,            # (P,) point idepth-hessian inverses
    pyr_ref: Tuple[jnp.ndarray, ...],  # reference KF pyramid levels (H_l,W_l,3)
    n_levels: int,
    sizes: Tuple[int, ...],       # template slots per level
    w: int, h: int,
):
    """makeCoarseDepthL0 (reference CoarseTracker.cpp:56-230).

    Projects all points with an active residual into the newest frame,
    scatter-adds weighted idepth into a level-0 map, box-downsamples, dilates
    (one 8-neighborhood pass on levels 0-1, one 4-neighborhood pass on
    coarser levels), then extracts fixed-size per-level point lists.

    Also returns the level-0 (u, v, idepth) cloud mask for the loop-closure
    'imitated lidar' extraction (CoarseTracker.cpp:76).
    """
    newest = jnp.sum(ba.frame_valid) - 1
    fx, fy, cx, cy = B.calib_real(ba)

    # host->newest relative transforms, directly: the full make_precalc
    # builds all F^2 pairs + adjoints, and everything but the newest
    # column would be discarded here
    from sos_slam_tpu.utils import lie as _lie
    T_cw = B.state_to_pose(ba.T_cw_eval, ba.state)        # (F,4,4)
    T_wc_new = _lie.se3_inv(T_cw[newest])                 # (4,4)
    rel = jnp.einsum("ij,hjk->hik", T_wc_new, T_cw,
                     precision=jax.lax.Precision.HIGHEST)  # (F,4,4)
    onehot = jax.nn.one_hot(ba.host, ba.F, dtype=jnp.float32)
    relp = jnp.einsum("ph,hxy->pxy", onehot, rel,
                      precision=jax.lax.Precision.HIGHEST)
    Rc = relp[:, :3, :3]            # (P,3,3)
    tc = relp[:, :3, 3]
    KliP = jnp.stack([(ba.u - cx) / fx, (ba.v - cy) / fy, jnp.ones_like(ba.u)],
                     -1)
    ptp = jnp.einsum("pij,pj->pi", Rc, KliP) + tc * ba.idepth[:, None]
    drescale = 1.0 / ptp[:, 2]
    new_idepth = ba.idepth * drescale
    Ku = ptp[:, 0] * drescale * fx + cx
    Kv = ptp[:, 1] * drescale * fy + cy

    has_res = ba.res_exist[jnp.arange(ba.P), newest] & ba.pt_valid
    ok = has_res & (drescale > 0) & (Ku > 1) & (Kv > 1) & (Ku < w - 2) & (Kv < h - 2)

    ui = jnp.clip((Ku + 0.5).astype(jnp.int32), 0, w - 1)
    vi = jnp.clip((Kv + 0.5).astype(jnp.int32), 0, h - 1)
    wgt = jnp.sqrt(1e-3 / (HdiF + 1e-12)) * ok

    # per-level maps by scattering the SAME level-0 cells with floor-div
    # coordinates: the 2x box downsample (*4, i.e. a plain 2x2 block sum)
    # of a scatter-add map is EXACTLY the scatter-add at ui>>1 — six tiny
    # (P,) scatters replace a chain of ten full-map convolutions.
    # EXACTNESS requires every level dimension to halve cleanly (odd dims
    # would let ui>>lvl land outside h>>lvl and drop points silently)
    assert h % (1 << (n_levels - 1)) == 0 and w % (1 << (n_levels - 1)) == 0, \
        (h, w, n_levels)
    id_maps, w_maps = [], []
    for lvl in range(n_levels):
        hl, wl = h >> lvl, w >> lvl
        ul, vl = ui >> lvl, vi >> lvl
        id_maps.append(jnp.zeros((hl, wl)).at[vl, ul].add(new_idepth * wgt))
        w_maps.append(jnp.zeros((hl, wl)).at[vl, ul].add(wgt))

    templates = []
    pc_l0 = None
    for lvl in range(n_levels):
        color = pyr_ref[lvl][..., 0]
        hl, wl = color.shape
        idn, good = template_level(id_maps[lvl], w_maps[lvl], color,
                                   diag=(lvl < 2))

        flat_good = good.reshape(-1)
        idx, sel_ok = selector.compact_mask_indices(flat_good, sizes[lvl])
        u_t = (idx % wl).astype(jnp.float32)
        v_t = (idx // wl).astype(jnp.float32)
        templates.append(LevelTemplate(
            u=u_t, v=v_t,
            idepth=idn.reshape(-1)[idx],
            color=color.reshape(-1)[idx],
            valid=sel_ok,
        ))
        if lvl == 0:
            pc_l0 = (u_t, v_t, idn.reshape(-1)[idx], sel_ok)

    return tuple(templates), pc_l0


@functools.partial(jax.jit, static_argnames=())
def insert_frame(ba: B.BAState, T_cw_new: jnp.ndarray, aff_new: jnp.ndarray,
                 exposure: jnp.ndarray, prior_row: jnp.ndarray) -> B.BAState:
    """Append a frame at the first free slot (EF insertFrame + the new
    cross-residual creation of makeKeyFrame, FullSystem.cpp:820-834)."""
    slot = jnp.sum(ba.frame_valid)
    sel = jnp.arange(ba.F) == slot
    aff_state = aff_new / B.STATE8_SCALE[6:8]
    state_new = jnp.where(sel[:, None],
                          jnp.concatenate([jnp.zeros(6), aff_state])[None, :],
                          ba.state)
    # new residuals: every existing valid point gets a residual to the slot
    res_new = ba.res_exist.at[:, :].set(
        jnp.where(sel[None, :],
                  (ba.pt_valid & (ba.host != slot))[:, None],
                  ba.res_exist))
    return ba._replace(
        frame_valid=ba.frame_valid | sel,
        T_cw_eval=jnp.where(sel[:, None, None], T_cw_new, ba.T_cw_eval),
        state=state_new,
        state_zero=state_new,
        exposure=jnp.where(sel, exposure, ba.exposure),
        energy_th=jnp.where(sel, ba.energy_th[jnp.maximum(slot - 1, 0)],
                            ba.energy_th),
        prior=jnp.where(sel[:, None], prior_row[None, :], ba.prior),
        res_exist=res_new,
        res_state=jnp.where(sel[None, :], B.RES_IN, ba.res_state).astype(jnp.int8),
        # expand the marg prior with zero rows for the new frame slot: HM/bM
        # are indexed by slot and the new slot's rows are already zero.
    )


def insert_points(ba: B.BAState, slot_idx, accepted, host, u, v, color,
                  weight, idepth, prior_w) -> B.BAState:
    """Scatter accepted candidate points into free point slots."""
    P = ba.P
    si = jnp.where(accepted, slot_idx, P)  # out-of-range drops the scatter

    def put(arr, vals):
        return arr.at[si].set(vals, mode="drop")

    newest = jnp.sum(ba.frame_valid) - 1
    res_row = (jnp.arange(ba.F)[None, :] != host[:, None]) & ba.frame_valid[None, :]

    return ba._replace(
        pt_valid=ba.pt_valid.at[si].set(True, mode="drop"),
        host=put(ba.host, host.astype(jnp.int32)),
        u=put(ba.u, u), v=put(ba.v, v),
        color=put(ba.color, color), weight=put(ba.weight, weight),
        idepth=put(ba.idepth, idepth), idepth_zero=put(ba.idepth_zero, idepth),
        pt_prior=put(ba.pt_prior, prior_w),
        res_exist=ba.res_exist.at[si].set(res_row, mode="drop"),
        res_state=ba.res_state.at[si].set(B.RES_IN, mode="drop"),
    )
