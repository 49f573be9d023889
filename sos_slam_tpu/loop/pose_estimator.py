"""Loop-candidate relative pose: direct alignment + small ICP.

JAX rebuild of src/LoopClosure/PoseEstimator.{h,cpp}:
  * `estimate`: coarse-to-fine direct photometric alignment of the matched
    keyframe's 3-D points + per-level intensities against the current
    keyframe's pyramid — the same 8-dim SE(3)+affine machinery as the coarse
    tracker, with externally supplied points (PoseEstimator.cpp:288-494).
    Acceptance: residual < setting_loop_direct_thres, inlier fraction > 90%,
    sane affine.
  * `icp`: fixed-iteration point-to-point ICP with masked correspondences
    (replaces PCL IterativeClosestPoint, PoseEstimator.cpp:518-542).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from sos_slam_tpu.ops import tracker as TK
from sos_slam_tpu.ops.image import interp_bilinear
from sos_slam_tpu.utils import lie


def estimate_direct(
    pyr_cur,                      # tuple of (H_l,W_l,3) current KF pyramid
    pts_cam: jnp.ndarray,         # (N,3) matched KF camera-frame points
    intensities: jnp.ndarray,     # (N,L) per-level intensities
    pts_valid: jnp.ndarray,       # (N,)
    T_cur_matched_init: jnp.ndarray,   # (4,4)
    intrinsics, n_levels: int,
    direct_thres: float,
):
    """Direct alignment via the coarse-tracker kernel with an external
    template. Returns (T_cur_matched, ok, rms)."""
    # Build per-level templates: the matched points expressed as
    # (u, v, idepth) in the MATCHED camera at each level's intrinsics.
    templates = []
    for lvl in range(n_levels):
        fx, fy, cx, cy = intrinsics[lvl]
        z = jnp.maximum(pts_cam[:, 2], 1e-6)
        u = pts_cam[:, 0] / z * fx + cx
        v = pts_cam[:, 1] / z * fy + cy
        templates.append(TK.LevelTemplate(
            u=u, v=v, idepth=1.0 / z,
            color=intensities[:, min(lvl, intensities.shape[1] - 1)],
            valid=pts_valid,
        ))

    out = TK.track_newest_coarse(
        tuple(pyr_cur), tuple(templates), T_cur_matched_init,
        jnp.zeros(2), jnp.zeros(2), jnp.ones(2), jnp.full((6,), jnp.nan),
        tuple(intrinsics), n_levels,
    )
    rms = out["residuals"][0]
    # acceptance gates (PoseEstimator.cpp:451-493): sane affine, low
    # residual AND > INNER_PERCENT=90% of the template in-bounds at the
    # final level-0 pose (lastInners[0] / pts.size())
    r0 = TK.res_and_hb(pyr_cur[0], templates[0], out["T"],
                       jnp.zeros(2), 0.0, intrinsics[0],
                       jnp.float32(20.0), 9.0)
    n_pts = jnp.maximum(jnp.sum(pts_valid), 1)
    inlier_frac = r0["num_in"] / n_pts
    ok = out["good"] & jnp.isfinite(rms) & (rms < direct_thres) \
        & (jnp.abs(out["aff"][0]) < 1.2) & (jnp.abs(out["aff"][1]) < 200.0) \
        & (inlier_frac > 0.9)
    return out["T"], ok, rms


@functools.partial(jax.jit, static_argnames=("n_iters",))
def icp(
    pts_ref: jnp.ndarray,     # (M,3) matched frame points (padded)
    ref_valid: jnp.ndarray,   # (M,)
    pts_cur: jnp.ndarray,     # (N,3) current frame points (padded)
    cur_valid: jnp.ndarray,   # (N,)
    T_init: jnp.ndarray,      # (4,4) cur <- matched initial guess
    max_dist: float = 2.0,
    n_iters: int = 5,
):
    """Point-to-point ICP: transform ref points by T, find nearest current
    point, solve the weighted Umeyama alignment. Returns (T, ok, mean_err)."""

    def body(it, T):
        p = lie.transform_points(T, pts_ref)              # (M,3)
        d2 = jnp.sum((p[:, None, :] - pts_cur[None, :, :]) ** 2, -1)
        d2 = jnp.where(cur_valid[None, :], d2, jnp.inf)
        nn = jnp.argmin(d2, -1)
        dmin = jnp.sqrt(jnp.min(d2, -1))
        w = (ref_valid & (dmin < max_dist)).astype(jnp.float32)
        q = pts_cur[nn]

        wsum = jnp.maximum(jnp.sum(w), 1e-6)
        mu_p = jnp.sum(p * w[:, None], 0) / wsum
        mu_q = jnp.sum(q * w[:, None], 0) / wsum
        P = (p - mu_p) * w[:, None]
        Q = (q - mu_q)
        S = P.T @ Q
        U, _, Vt = jnp.linalg.svd(S)
        d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
        D = jnp.diag(jnp.array([1.0, 1.0, 1.0]) .at[2].set(d))
        R = Vt.T @ D @ U.T
        t = mu_q - R @ mu_p
        dT = jnp.eye(4).at[:3, :3].set(R).at[:3, 3].set(t)
        return dT @ T

    T = jax.lax.fori_loop(0, n_iters, body, T_init)

    # final residual
    p = lie.transform_points(T, pts_ref)
    d2 = jnp.sum((p[:, None, :] - pts_cur[None, :, :]) ** 2, -1)
    d2 = jnp.where(cur_valid[None, :], d2, jnp.inf)
    dmin = jnp.sqrt(jnp.min(d2, -1))
    w = ref_valid & (dmin < max_dist)
    err = jnp.sum(jnp.where(w, dmin, 0.0)) / jnp.maximum(jnp.sum(w), 1)
    ok = (jnp.sum(w) > 0.5 * jnp.maximum(jnp.sum(ref_valid), 1)) \
        & jnp.isfinite(err)
    return T, ok, err
