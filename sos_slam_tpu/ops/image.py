"""Image pyramid, gradients, and bilinear sampling — the per-frame hot path.

JAX rebuild of FrameHessian::makeImages (reference:
src/FullSystem/HessianBlocks.cpp:121-176) and the bilinear interpolation
helpers (src/util/globalFuncs.h getInterpolatedElement*).

Behavioral parity:
  * level l>0 intensity = 2x2 box average of level l-1 (exact, not gaussian);
  * gradients = central differences 0.5*(I[x+1]-I[x-1]) per level, zero on the
    first/last row (the reference only fills idx in [w, w*(h-1)));
  * abs_sq_grad = dx^2 + dy^2, optionally gamma-weighted by the photometric
    response derivative.

Layout: each pyramid level is an (H, W, 3) array [intensity, dx, dy] — one
fused gather serves intensity + both gradients during warping, exactly like
the reference's Vector3f* dI. A pyramid is a tuple of levels (shapes differ).

All functions are jit-friendly; shapes are static per calibration.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp


def downsample2x(img: jnp.ndarray) -> jnp.ndarray:
    """2x2 box-average downsample of (H, W); H, W must be even."""
    h, w = img.shape
    return img.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))


def image_gradients(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Central-difference gradients with zeroed borders.

    Matches the reference loop over idx in [w, w*(h-1)): interior rows only;
    left/right column neighbors wrap in the reference's flat indexing, but
    those pixels are never sampled (pattern padding ≥ 2), so we zero them.
    """
    dx = jnp.zeros_like(img)
    dy = jnp.zeros_like(img)
    dx = dx.at[:, 1:-1].set(0.5 * (img[:, 2:] - img[:, :-2]))
    dy = dy.at[1:-1, :].set(0.5 * (img[2:, :] - img[:-2, :]))
    # reference fills rows 1..h-2 only (flat range); zero top/bottom rows of dx
    dx = dx.at[0, :].set(0.0).at[-1, :].set(0.0)
    return dx, dy


@functools.partial(jax.jit, static_argnames=("n_levels",))
def build_pyramid(
    image: jnp.ndarray,
    n_levels: int,
    gamma_grad: Optional[jnp.ndarray] = None,
) -> Tuple[Tuple[jnp.ndarray, ...], Tuple[jnp.ndarray, ...]]:
    """Build the intensity+gradient pyramid.

    Args:
      image: (H, W) float32 irradiance image (already photometrically
        corrected by the undistorter, like the reference's ImageAndExposure).
      n_levels: static level count from the calib pyramid.
      gamma_grad: optional (256,) table of dG/dI of the camera response used
        to weight abs_sq_grad back into raw-color space
        (HessianBlocks.cpp:169-174). None = no weighting.

    Returns:
      (levels, abs_sq_grads): levels[l] is (H_l, W_l, 3) [I, dx, dy];
      abs_sq_grads[l] is (H_l, W_l).
    """
    levels = []
    absgrads = []
    cur = image.astype(jnp.float32)
    for lvl in range(n_levels):
        if lvl > 0:
            cur = downsample2x(cur)
        dx, dy = image_gradients(cur)
        levels.append(jnp.stack([cur, dx, dy], axis=-1))
        asg = dx * dx + dy * dy
        if gamma_grad is not None:
            idx = jnp.clip(cur.astype(jnp.int32), 0, 255)
            gw = gamma_grad[idx]
            asg = asg * gw * gw
        absgrads.append(asg)
    return tuple(levels), tuple(absgrads)


def interp_bilinear(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample img (H, W) or (H, W, C) at continuous (u, v) = (x, y).

    Matches getInterpolatedElement* (globalFuncs.h). Out-of-bounds coordinates
    are clamped; callers mask validity separately (masked-lane convention).

    u, v may have any shape; the result broadcasts accordingly (adds a trailing
    C axis for multi-channel images).
    """
    h, w = img.shape[0], img.shape[1]
    x0 = jnp.clip(jnp.floor(u), 0, w - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(v), 0, h - 2).astype(jnp.int32)
    dx = jnp.clip(u - x0, 0.0, 1.0)
    dy = jnp.clip(v - y0, 0.0, 1.0)

    flat = img.reshape(h * w, -1)  # (H*W, C)
    idx = y0 * w + x0
    # one stacked-corner take (see interp_bilinear_frames)
    idx4 = jnp.stack([idx, idx + 1, idx + w, idx + w + 1], 0)
    c = jnp.take(flat, idx4, axis=0)

    dxe = dx[..., None]
    dye = dy[..., None]
    out = (
        c[0] * (1 - dxe) * (1 - dye)
        + c[1] * dxe * (1 - dye)
        + c[2] * (1 - dxe) * dye
        + c[3] * dxe * dye
    )
    if img.ndim == 2:
        return out[..., 0]
    return out


def interp_bilinear_blin(img: jnp.ndarray, u: jnp.ndarray,
                         v: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample of an intensity plane (H, W) returning
    (color, gx, gy) stacked on a trailing axis — the reference's
    getInterpolatedElement33BiLin (globalFuncs.h:162-182): the gradients are
    FORWARD differences of the bilinear cell (gx = rightInt - leftInt), NOT
    interpolations of the central-difference gradient channels. Used only by
    the ImmaturePoint constructor (ImmaturePoint.cpp:40)."""
    h, w = img.shape[0], img.shape[1]
    x0 = jnp.clip(jnp.floor(u), 0, w - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(v), 0, h - 2).astype(jnp.int32)
    dx = jnp.clip(u - x0, 0.0, 1.0)
    dy = jnp.clip(v - y0, 0.0, 1.0)

    flat = img.reshape(h * w)
    idx = y0 * w + x0
    c = jnp.take(flat, jnp.stack([idx, idx + 1, idx + w, idx + w + 1], 0),
                 axis=0)
    tl, tr, bl, br = c[0], c[1], c[2], c[3]
    top = dx * tr + (1 - dx) * tl
    bot = dx * br + (1 - dx) * bl
    left = dy * bl + (1 - dy) * tl
    right = dy * br + (1 - dy) * tr
    color = dx * right + (1 - dx) * left
    return jnp.stack([color, right - left, bot - top], -1)


def interp_bilinear_frames(dI: jnp.ndarray, Ku: jnp.ndarray,
                           Kv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear-sample stacked frames dI (F,H,W[,C]) at positions Ku/Kv of
    shape (..., F, K) — frame axis second-to-last. Returns (..., F, K[, C]).

    ONE fused 4-corner gather over the flattened (F*H*W, C) plane, bitwise
    identical to a per-frame `interp_bilinear`. Do not vmap interp_bilinear
    over the frame axis instead: XLA lowers that to a batched gather, which
    was far slower than this single flat take on the accelerator the code
    was first tuned for (not yet re-measured on the GPU)."""
    F, H, W = dI.shape[0], dI.shape[1], dI.shape[2]
    flat = dI.reshape(F * H * W, -1)
    x0 = jnp.clip(jnp.floor(Ku), 0, W - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(Kv), 0, H - 2).astype(jnp.int32)
    dx = jnp.clip(Ku - x0, 0.0, 1.0)[..., None]
    dy = jnp.clip(Kv - y0, 0.0, 1.0)[..., None]
    fofs = (jnp.arange(F, dtype=jnp.int32) * (H * W))[:, None]   # (F,1)
    idx = fofs + y0 * W + x0
    # ONE take with the 4 corner index planes stacked in front: same element
    # count as four separate takes, but a single gather op
    idx4 = jnp.stack([idx, idx + 1, idx + W, idx + W + 1], 0)
    c = jnp.take(flat, idx4, axis=0)        # (4, ..., F, K, C)
    out = (
        c[0] * (1 - dx) * (1 - dy)
        + c[1] * dx * (1 - dy)
        + c[2] * (1 - dx) * dy
        + c[3] * dx * dy
    )
    if dI.ndim == 3:
        return out[..., 0]
    return out


def in_bounds(u: jnp.ndarray, v: jnp.ndarray, w: int, h: int,
              pad: float = 2.0) -> jnp.ndarray:
    """Validity mask for sampling with `pad` pixels of border margin."""
    return (u > pad) & (u < w - pad - 1) & (v > pad) & (v < h - pad - 1)


def interp_bilinear_nfk(dI: jnp.ndarray, Ku: jnp.ndarray, Kv: jnp.ndarray,
                        patch: int = 16):
    """Bilinear-sample (F,H,W,C) at (N,F,K) positions via per-(point,frame)
    patches — an alternative to scattered gathers when the K
    positions of each (point, frame) are clustered (a projected residual
    pattern: spread of a few pixels).

    One (patch,patch,C) dynamic-slice per (n,f) is a coherent load; the
    K taps then resolve as two hat-weight contractions (f32). Positions
    whose cluster exceeds the patch (extreme projective stretch) clamp to
    the patch border — callers must mask those via `spread_ok`.

    Returns (samples (N,F,K,C), spread_ok (N,F))."""
    N, F, K = Ku.shape
    H, W, C = dI.shape[1], dI.shape[2], dI.shape[3]
    P = patch
    lo_x = jnp.min(Ku, axis=2)
    lo_y = jnp.min(Kv, axis=2)
    spread_ok = (
        (jnp.max(Ku, axis=2) - lo_x < P - 3)
        & (jnp.max(Kv, axis=2) - lo_y < P - 3)
    )
    ox = jnp.clip(jnp.floor(lo_x) - 1, 0, W - P).astype(jnp.int32)
    oy = jnp.clip(jnp.floor(lo_y) - 1, 0, H - P).astype(jnp.int32)
    fi = jnp.broadcast_to(jnp.arange(F, dtype=jnp.int32)[None, :], (N, F))

    def slice_one(f, y, x):
        return jax.lax.dynamic_slice(dI, (f, y, x, 0), (1, P, P, C))[0]

    patches = jax.vmap(jax.vmap(slice_one))(fi, oy, ox)     # (N,F,P,P,C)

    lx = jnp.clip(Ku - ox[..., None], 0.0, P - 2.0)
    ly = jnp.clip(Kv - oy[..., None], 0.0, P - 2.0)
    ii = jnp.arange(P, dtype=jnp.float32)
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(lx[..., None] - ii))  # (N,F,K,P)
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(ly[..., None] - ii))
    t = jnp.einsum("nfijc,nfkj->nfkic", patches, wx)
    out = jnp.einsum("nfkic,nfki->nfkc", t, wy)
    return out, spread_ok
