"""Gradient-based pixel selection on the device.

Replaces the reference PixelSelector (src/FullSystem/PixelSelector2.{h,cpp})
with masked hierarchical block-argmax:

  * `block_thresholds`: 32x32-block gradient-magnitude quantile thresholds,
    3x3-smoothed then squared (makeHists, PixelSelector2.cpp:69-145). The
    reference quantile over an integer histogram (bins = clip(int(sqrt(g)),
    0, 48)) equals picking sorted_valid[int(n_valid*cut + 0.5)] of the
    integer-floored magnitudes — computed here by per-block sort.
  * `select`: the 3-tier potential-grid selection (select,
    PixelSelector2.cpp:284-424). A pot-block yields a level-0 pick (status 1)
    at the eligible pixel maximizing |grad . dir| for a per-block random
    direction; a 2pot-block yields a level-1 pick (status 2) only if no pixel
    in it is level-0 eligible; a 4pot-block yields level-2 (status 4) only if
    nothing is level-0/1 eligible. This is exactly the reference's
    bestIdx3/-2 suppression cascade, without the sequential scan.
    (Per-block random directions are iid here rather than drawn from the
    reference's shared deterministic LCG stream — behaviorally equivalent.)
  * `adapt_potential` + `make_maps`: the host-side density adaptation loop
    (makeMaps, PixelSelector2.cpp:146-283) including random sub-sampling when
    over-selected. Each distinct pot compiles once (few small ints).

Selection runs on full (H, W) elementwise arrays and returns a status
map plus a dense score used for deterministic top-K point extraction.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from sos_slam_tpu.utils.config import Settings


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def compact_mask_indices(mask_flat: jnp.ndarray, K: int):
    """Indices of the first K true entries of a flat bool mask, padded with
    the first false entries — exactly `lax.top_k(mask.astype(f32), K)`'s
    (stable) index output, computed as cumsum + searchsorted
    (O(N + K log N)) instead of a full N-element sort. Returns
    (idx (K,) int32, ok (K,) bool). Requires K <= mask_flat.size."""
    cum_t = jnp.cumsum(mask_flat.astype(jnp.int32))
    n_t = cum_t[-1]
    j = jnp.arange(1, K + 1, dtype=jnp.int32)
    idx_t = jnp.searchsorted(cum_t, j, side="left")
    cum_f = jnp.cumsum(jnp.logical_not(mask_flat).astype(jnp.int32))
    idx_f = jnp.searchsorted(cum_f, jnp.maximum(j - n_t, 1), side="left")
    ok = jnp.arange(K) < n_t
    return jnp.where(ok, idx_t, idx_f).astype(jnp.int32), ok


@functools.partial(jax.jit, static_argnames=("cut", "add"))
def block_thresholds(
    absgrad0: jnp.ndarray,
    cut: float,
    add: float,
) -> jnp.ndarray:
    """Per-32x32-block smoothed squared thresholds (H//32, W//32).

    Matches makeHists: per-block `cut`-quantile of clip(floor(sqrt(g)), 0, 48)
    over interior pixels, + `add`, 3x3 box-smoothed, squared.
    """
    h, w = absgrad0.shape
    h32, w32 = h // 32, w // 32
    g = jnp.clip(jnp.floor(jnp.sqrt(jnp.maximum(absgrad0, 0.0))), 0, 48)

    # interior-pixel validity (reference skips it<1, it>w-2, jt<1, jt>h-2)
    xi = jnp.arange(w)
    yi = jnp.arange(h)
    valid = ((xi >= 1) & (xi <= w - 2))[None, :] & ((yi >= 1) & (yi <= h - 2))[:, None]

    g = g[: h32 * 32, : w32 * 32]
    valid = valid[: h32 * 32, : w32 * 32]
    gb = g.reshape(h32, 32, w32, 32).transpose(0, 2, 1, 3).reshape(h32, w32, 1024)
    vb = valid.reshape(h32, 32, w32, 32).transpose(0, 2, 1, 3).reshape(h32, w32, 1024)

    # the reference's integer histogram quantile (values are already
    # floor()ed ints in [0,48]): the k-th smallest valid value is the first
    # bin whose cumulative count exceeds k — a (50-bin) histogram + cumsum
    # instead of sorting 1024 elements per block
    gbi = jnp.where(vb, gb, 49.0).astype(jnp.int32)       # invalid -> bin 49
    counts = jnp.sum(
        (gbi[..., None] == jnp.arange(49, dtype=jnp.int32)).astype(jnp.int32),
        axis=2,
    )  # (h32, w32, 49)
    cum = jnp.cumsum(counts, axis=-1)
    n_valid = vb.sum(axis=-1)
    k = (n_valid.astype(jnp.float32) * cut + 0.5).astype(jnp.int32)
    found = cum > k[..., None]
    ths = jnp.argmax(found, axis=-1).astype(jnp.float32)
    # no valid pixel in the block: the sort form picked the 1e9 sentinel,
    # clamped to 48 below
    ths = jnp.where(jnp.any(found, axis=-1), ths, 48.0) + add

    # 3x3 box smoothing with edge-aware counts (same as reference's sum/num)
    ones = jnp.ones_like(ths)
    ker = jnp.ones((3, 3), ths.dtype)
    pad_sum = jax.scipy.signal.convolve2d(ths, ker, mode="same")
    pad_cnt = jax.scipy.signal.convolve2d(ones, ker, mode="same")
    sm = pad_sum / pad_cnt
    return sm * sm


def _block_pick(score: jnp.ndarray, blk: int) -> jnp.ndarray:
    """One-hot (H, W) bool of the per-(blk x blk)-block argmax where max > 0.

    score: (H, W) with ineligible pixels <= 0. H, W divisible by blk.
    """
    h, w = score.shape
    hb, wb = h // blk, w // blk
    sb = score.reshape(hb, blk, wb, blk).transpose(0, 2, 1, 3).reshape(hb, wb, blk * blk)
    best = jnp.argmax(sb, axis=-1)
    has = jnp.max(sb, axis=-1) > 0.0
    onehot = (jnp.arange(blk * blk) == best[..., None]) & has[..., None]
    return (
        onehot.reshape(hb, wb, blk, blk)
        .transpose(0, 2, 1, 3)
        .reshape(h, w)
    )


def _block_any(mask: jnp.ndarray, blk: int) -> jnp.ndarray:
    """Broadcast per-(blk x blk)-block `any` back to pixel resolution."""
    h, w = mask.shape
    hb, wb = h // blk, w // blk
    mb = mask.reshape(hb, blk, wb, blk).any(axis=(1, 3))
    return jnp.repeat(jnp.repeat(mb, blk, axis=0), blk, axis=1)


@functools.partial(jax.jit, static_argnames=("pot",))
def select(
    dI0: jnp.ndarray,          # (H, W, 3) level-0 [I, dx, dy]
    absgrad0: jnp.ndarray,     # (H, W)
    absgrad1: jnp.ndarray,     # (H/2, W/2)
    absgrad2: jnp.ndarray,     # (H/4, W/4)
    ths_smoothed: jnp.ndarray, # (H//32, W//32)
    pot: int,
    th_factor: float,
    down_weight: float,
    key: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Hierarchical 3-tier selection. Returns (status (H,W) int8, score (H,W)).

    status: 0 none, 1 level-0 pick, 2 level-1 pick, 4 level-2 pick.
    """
    h, w = absgrad0.shape
    P = 4 * pot
    hp, wp = _cdiv(h, P) * P, _cdiv(w, P) * P

    xi = jnp.arange(w)
    yi = jnp.arange(h)
    # reference border exclusion: xf<4 || xf>=w-5 || yf<4 || yf>h-4
    border = ((xi >= 4) & (xi < w - 5))[None, :] & ((yi >= 4) & (yi <= h - 4))[:, None]

    # per-pixel thresholds from the 32-blocks. No advanced-indexing
    # gathers for these regular upsamplings: a (H,W) outer-product gather
    # is a scattered load per pixel, while block/2x/4x replication is an
    # exact repeat (+edge clamp for the partial last block) that XLA
    # fuses.
    def _upsample(a, fac):
        r = jnp.repeat(jnp.repeat(a, fac, 0), fac, 1)
        if r.shape[0] < h or r.shape[1] < w:   # clamp-to-last-block tail
            r = jnp.pad(r, ((0, max(h - r.shape[0], 0)),
                            (0, max(w - r.shape[1], 0))), mode="edge")
        return r[:h, :w]

    th0 = _upsample(ths_smoothed, 32)
    dw1 = down_weight
    dw2 = dw1 * dw1

    # eligibility per tier: the reference's nearest sampling of the coarser
    # absgrads at (x*0.5+0.25, ...) is exactly floor(x/2) / floor(x/4)
    ag1 = _upsample(absgrad1, 2)
    ag2 = _upsample(absgrad2, 4)

    elig0 = (absgrad0 > th0 * th_factor) & border
    elig1 = (ag1 > th0 * dw1 * th_factor) & border
    elig2 = (ag2 > th0 * dw1 * dw2 * th_factor) & border

    # random unit directions per block at each tier
    def block_dirs(key, blk):
        nby, nbx = _cdiv(hp, blk), _cdiv(wp, blk)
        ang = jax.random.uniform(key, (nby, nbx)) * jnp.pi
        d = jnp.stack([jnp.cos(ang), jnp.sin(ang)], -1)
        return jnp.repeat(jnp.repeat(d, blk, 0), blk, 1)[:hp, :wp]

    k1, k2, k3 = jax.random.split(key, 3)
    grad = dI0[..., 1:]  # (H, W, 2)

    def pad(a):
        return jnp.pad(a, ((0, hp - h), (0, wp - w)))

    def dir_score(dirs, elig):
        s = jnp.abs(grad[..., 0] * dirs[:h, :w, 0] + grad[..., 1] * dirs[:h, :w, 1])
        return pad(jnp.where(elig, jnp.maximum(s, 1e-20), 0.0))

    d2 = block_dirs(k1, pot)
    d3 = block_dirs(k2, 2 * pot)
    d4 = block_dirs(k3, 4 * pot)

    s0 = dir_score(d2, elig0)
    s1 = dir_score(d3, elig1)
    s2 = dir_score(d4, elig2)

    e0p = pad(elig0)
    e1p = pad(elig1)

    sel0 = _block_pick(s0, pot)
    sup1 = _block_any(e0p, 2 * pot)          # suppress tier-1 where tier-0 exists
    sel1 = _block_pick(jnp.where(sup1, 0.0, s1), 2 * pot)
    sup2 = _block_any(e0p | e1p, 4 * pot)    # suppress tier-2 where tier-0/1 exist
    sel2 = _block_pick(jnp.where(sup2, 0.0, s2), 4 * pot)

    status = (
        sel0.astype(jnp.int8) * 1 + sel1.astype(jnp.int8) * 2 + sel2.astype(jnp.int8) * 4
    )[:h, :w]
    score = jnp.maximum(jnp.maximum(s0, s1), s2)[:h, :w]
    return status, score


@functools.partial(jax.jit, static_argnames=("n_slots",))
def extract_points(status: jnp.ndarray, n_slots: int):
    """Gather selected pixels (status != 0) into a fixed-size point list.

    Returns (u (n,), v (n,), my_type (n,) int32 with 0 = empty slot).
    Selection order is flat row-major (deterministic).
    """
    h, w = status.shape
    flat = (status != 0).reshape(-1)
    idx, sel_ok = compact_mask_indices(flat, n_slots)
    u = (idx % w).astype(jnp.float32)
    v = (idx // w).astype(jnp.float32)
    my_type = jnp.where(sel_ok, status.reshape(-1)[idx].astype(jnp.int32), 0)
    return u, v, my_type


@functools.partial(jax.jit, static_argnames=("pot",))
def grid_max_selection(dI: jnp.ndarray, pot: int, th: float) -> jnp.ndarray:
    """Coarse-level selection (gridMaxSelection, PixelSelector.h:111-253):
    per pot-block argmax of |gx|, |gy|, |gx-gy|, |gx+gy| among pixels whose
    squared gradient exceeds th^2. Returns bool map (H, W)."""
    h, w = dI.shape[:2]
    gx, gy = dI[..., 1], dI[..., 2]
    sq = gx * gx + gy * gy
    ok = sq > th * th
    # border: reference scans x,y in [1, dim-pot)
    xi = jnp.arange(w)
    yi = jnp.arange(h)
    ok &= ((xi >= 1) & (xi < w - 1))[None, :] & ((yi >= 1) & (yi < h - 1))[:, None]

    hp, wp = _cdiv(h, pot) * pot, _cdiv(w, pot) * pot
    out = jnp.zeros((hp, wp), bool)
    for ch in (jnp.abs(gx), jnp.abs(gy), jnp.abs(gx - gy), jnp.abs(gx + gy)):
        s = jnp.pad(jnp.where(ok, jnp.maximum(ch, 1e-12), 0.0),
                    ((0, hp - h), (0, wp - w)))
        out |= _block_pick(s, pot)
    return out[:h, :w]


def make_pixel_status(dI: jnp.ndarray, desired: float, min_use_grad: float = 10.0,
                      recursions: int = 5) -> Tuple[jnp.ndarray, int]:
    """Adaptive-sparsity coarse selection (makePixelStatus,
    PixelSelector.h:188-253). Host loop over jitted grid_max_selection."""
    sparsity = 4
    th_fac = 1.0
    for rec in range(recursions + 1):
        m = grid_max_selection(dI, max(sparsity, 1),
                               th_fac * min_use_grad * 0.75)
        n = int(jnp.sum(m))
        quotia = n / max(desired, 1.0)
        new_sparsity = _snap_pot(max(int(sparsity * quotia ** 0.5 + 0.7), 1))
        old_th = th_fac
        if new_sparsity == 1 and sparsity == 1:
            th_fac = 0.5
        if (abs(new_sparsity - sparsity) < 1 and th_fac == old_th) or \
                (quotia > 0.8 and quotia < 1.25) or rec == recursions:
            return m, n
        sparsity = new_sparsity
    return m, n


# pot values are STATIC jit arguments: each distinct value costs a full XLA
# compile of `select`. Snap the
# adaptive potential to this ladder so the program count stays bounded.
POT_LADDER = (1, 2, 3, 4, 6, 8, 12, 16)


def _snap_pot(pot: int) -> int:
    return min(POT_LADDER, key=lambda p: abs(p - pot))


def pot_step(pot: int, up: bool) -> int:
    """Adjacent ladder rung. The density adaptation moves ONE rung per
    keyframe instead of jumping straight to the ideal potential: every
    rung is a full XLA program variant of the fused keyframe chain (a
    long compile), so the reachable-rung set must stay small and
    prewarmable. Convergence takes a couple of keyframes instead of one."""
    i = POT_LADDER.index(_snap_pot(pot))
    j = min(i + 1, len(POT_LADDER) - 1) if up else max(i - 1, 0)
    return POT_LADDER[j]


def make_maps(
    dI0,
    absgrads,
    settings: Settings,
    density: float,
    key,
    current_potential: int = 3,
    recursions: int = 1,
    th_factor: float = 2.0,
) -> Tuple[jnp.ndarray, int, int]:
    """Density-adaptive selection (host loop over jitted `select`).

    Returns (status_map (H,W) int8, n_selected, new_potential). Mirrors
    makeMaps (PixelSelector2.cpp:146-283): adapt pot by the K/(pot+1)^2 model,
    re-select up to `recursions` times, then randomly sub-sample if >5% over.
    """
    ths = block_thresholds(
        absgrads[0], settings.min_grad_hist_cut, settings.min_grad_hist_add
    )
    pot = _snap_pot(current_potential)
    for it in range(recursions + 1):
        status, _ = select(
            dI0, absgrads[0], absgrads[1], absgrads[2], ths, pot,
            th_factor, settings.grad_downweight_per_level,
            jax.random.fold_in(key, it),
        )
        n_have = int(jnp.sum(status != 0))
        quotia = density / max(n_have, 1)
        K = n_have * (pot + 1) ** 2
        ideal = _snap_pot(max(int((K / density) ** 0.5) - 1, 1))
        if it < recursions and quotia > 1.25 and pot > 1:
            pot = _snap_pot(min(ideal, pot - 1))
        elif it < recursions and quotia < 0.25:
            pot = _snap_pot(max(ideal, pot + 1))
        else:
            break
    if quotia < 0.95:
        keep = jax.random.uniform(jax.random.fold_in(key, 99), status.shape) < quotia
        status = jnp.where(keep, status, 0)
        n_have = int(jnp.sum(status != 0))
    return status, n_have, ideal
