"""Synthetic multi-view-consistent scenes for tests and benchmarks.

The reference has no unit tests (SURVEY.md §4); we build the missing test
pyramid on analytic scenes: a textured 3-D plane rendered from arbitrary
camera poses. Images from different poses are exactly photometrically
consistent (same continuous texture evaluated at the ray/plane intersection),
with analytic ground-truth depth — ideal for validating direct alignment,
epipolar tracing, and bundle adjustment without datasets.

World convention: camera looks along +z; the plane is z = plane_z (world).
Texture = sum of smooth sinusoids (band-limited, so bilinear sampling of a
rendered image approximates the analytic value well).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sos_slam_tpu.utils import lie
from sos_slam_tpu.utils.camera import CalibPyramid, make_calib_pyramid


def default_calib(w: int = 640, h: int = 480) -> CalibPyramid:
    return make_calib_pyramid(w, h, fx=0.7 * w, fy=0.7 * w, cx=w / 2 - 0.5,
                              cy=h / 2 - 0.5)


def texture(xy: jnp.ndarray, seed: int = 0) -> jnp.ndarray:
    """Continuous texture T(x, y) in [0, 255], band-limited sinusoid mix."""
    rng = np.random.RandomState(seed)
    n_waves = 24
    freqs = rng.uniform(0.5, 12.0, (n_waves, 2)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, n_waves).astype(np.float32)
    amps = (rng.uniform(0.3, 1.0, n_waves) / np.sqrt(n_waves)).astype(np.float32)
    x, y = xy[..., 0], xy[..., 1]
    acc = jnp.zeros_like(x)
    for i in range(n_waves):
        acc = acc + amps[i] * jnp.sin(freqs[i, 0] * x + freqs[i, 1] * y + phases[i])
    return 128.0 + 100.0 * acc


def render_plane(
    calib: CalibPyramid,
    cam_to_world: jnp.ndarray,
    plane_z: float = 2.0,
    seed: int = 0,
    lvl: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Render (image, idepth) for a camera at `cam_to_world` viewing plane z=plane_z.

    Returns image (H, W) in [0, 255] and inverse depth (H, W) in camera frame.
    Pixels whose ray doesn't hit the plane in front get idepth 0 and intensity
    of the clamped intersection (rare for small motions).
    """
    w, h = calib.widths[lvl], calib.heights[lvl]
    fx, fy, cx, cy = calib.intrinsics(lvl)
    u = jnp.arange(w, dtype=jnp.float32)
    v = jnp.arange(h, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, v)
    # ray in camera frame
    rc = jnp.stack([(uu - cx) / fx, (vv - cy) / fy, jnp.ones_like(uu)], -1)
    R = cam_to_world[:3, :3]
    t = cam_to_world[:3, 3]
    rw = rc @ R.T  # world-frame ray dirs
    # intersect z = plane_z: t_z + s * rw_z = plane_z
    s = (plane_z - t[2]) / jnp.where(jnp.abs(rw[..., 2]) < 1e-6, 1e-6, rw[..., 2])
    s = jnp.maximum(s, 1e-3)
    pw = t + s[..., None] * rw
    img = texture(pw[..., :2], seed)
    # camera-frame depth of the intersection
    pc = (pw - t) @ R  # = R^T (pw - t)
    z = jnp.maximum(pc[..., 2], 1e-3)
    idepth = 1.0 / z
    return img, idepth


def render_two_planes(
    calib: CalibPyramid,
    cam_to_world: jnp.ndarray,
    z_near: float = 2.0,
    z_far: float = 6.0,
    seed: int = 0,
    lvl: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two textured planes with a vertical depth discontinuity at world x=0
    (x<0 -> z_near, x>=0 -> z_far): multi-view consistent imagery WITH 3-D
    structure (occlusion-free for small lateral motions on the +x side).
    Returns (image, idepth)."""
    w, h = calib.widths[lvl], calib.heights[lvl]
    fx, fy, cx, cy = calib.intrinsics(lvl)
    u = jnp.arange(w, dtype=jnp.float32)
    v = jnp.arange(h, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, v)
    rc = jnp.stack([(uu - cx) / fx, (vv - cy) / fy, jnp.ones_like(uu)], -1)
    R = cam_to_world[:3, :3]
    t = cam_to_world[:3, 3]
    rw = rc @ R.T

    def hit(plane_z):
        s = (plane_z - t[2]) / jnp.where(jnp.abs(rw[..., 2]) < 1e-6, 1e-6,
                                         rw[..., 2])
        s = jnp.maximum(s, 1e-3)
        return t + s[..., None] * rw

    p_near = hit(z_near)
    p_far = hit(z_far)
    use_near = p_near[..., 0] < 0.0
    pw = jnp.where(use_near[..., None], p_near, p_far)
    img = jnp.where(use_near, texture(p_near[..., :2], seed),
                    texture(p_far[..., :2], seed + 1))
    pc = (pw - t) @ R
    idepth = 1.0 / jnp.maximum(pc[..., 2], 1e-3)
    return img, idepth


def make_sequence(
    calib: CalibPyramid,
    n_frames: int,
    twist_per_frame=(0.02, 0.01, 0.015, 0.001, 0.002, 0.001),
    plane_z: float = 2.0,
    seed: int = 0,
):
    """Constant-twist trajectory: returns (images (N,H,W), idepths, poses (N,4,4))."""
    xi = jnp.array(twist_per_frame, jnp.float32)
    imgs, idepths, poses = [], [], []
    T = jnp.eye(4, dtype=jnp.float32)
    for _ in range(n_frames):
        img, idp = render_plane(calib, T, plane_z, seed)
        imgs.append(img)
        idepths.append(idp)
        poses.append(T)
        T = (T @ lie.se3_exp(xi)).astype(jnp.float32)
    return jnp.stack(imgs), jnp.stack(idepths), jnp.stack(poses)


def make_ba_window(w: int, h: int, n_slots: int, n_frames: int,
                   n_points: int, p_slots: int, pose_noise: float = 0.0,
                   idepth_noise: float = 0.0, n_hosts: int = 1,
                   seed: int = 0):
    """A filled BA window over the textured plane: `n_frames` of
    `n_slots` frame slots, `n_points` of `p_slots` point slots on a grid,
    hosted round-robin-at-random in the first `n_hosts` frames, with
    Gaussian pose / relative idepth noise. Every point gets a residual to
    every valid frame but its host; every 17th point's residuals start OOB.
    Returns (BAState, dI (n_slots, h, w, 3))."""
    from sos_slam_tpu.ops import ba as B
    from sos_slam_tpu.ops import image as imops
    from sos_slam_tpu.utils.config import PATTERN_OFFSETS, default_settings

    settings = default_settings()
    calib = default_calib(w, h)
    fx, fy, cx, cy = calib.intrinsics(0)
    twist = jnp.array([0.04, 0.02, 0.03, 0.004, 0.008, 0.004]) \
        * (192.0 / w)
    imgs, idepths, poses = make_sequence(calib, n_frames,
                                         twist_per_frame=twist, seed=seed)
    dI = jnp.zeros((n_slots, h, w, 3), jnp.float32)
    for i in range(n_frames):
        lv, _ = imops.build_pyramid(imgs[i], 1)
        dI = dI.at[i].set(lv[0])

    key = jax.random.PRNGKey(seed)
    gw = int(np.ceil(np.sqrt(n_points)))
    uu, vv = jnp.meshgrid(jnp.linspace(8, w - 9, gw),
                          jnp.linspace(8, h - 9, gw))
    pad = (0, p_slots - n_points)
    u = jnp.pad(uu.reshape(-1)[:n_points], pad)
    v = jnp.pad(vv.reshape(-1)[:n_points], pad)
    pt_valid = jnp.arange(p_slots) < n_points
    host = jax.random.randint(jax.random.fold_in(key, 1), (p_slots,), 0,
                              n_hosts)
    host = jnp.where(pt_valid, host, 0)
    # each point's pattern colour and true idepth in its own host frame
    pat = jnp.asarray(PATTERN_OFFSETS)
    color = jax.vmap(lambda hh, uu_, vv_: imops.interp_bilinear(
        dI[hh][..., 0], uu_ + pat[:, 0], vv_ + pat[:, 1]))(host, u, v)
    idp = jax.vmap(lambda hh, uu_, vv_: imops.interp_bilinear(
        idepths[hh], uu_, vv_))(host, u, v)
    idp = idp * (1.0 + idepth_noise * jax.random.normal(
        jax.random.fold_in(key, 2), (p_slots,))) * pt_valid

    T_eval = jnp.stack([jnp.eye(4)] * n_slots)
    for i in range(n_frames):
        noise = pose_noise * jax.random.normal(jax.random.fold_in(key, 10 + i),
                                               (6,))
        if i == 0:
            noise = jnp.zeros(6)
        T_eval = T_eval.at[i].set(lie.se3_exp(noise) @ poses[i])

    frame_valid = jnp.arange(n_slots) < n_frames
    prior = jnp.zeros((n_slots, 8))
    prior = prior.at[0, 0:3].set(settings.initial_trans_prior)
    prior = prior.at[0, 3:6].set(settings.initial_rot_prior)
    prior = prior.at[0, 6].set(settings.initial_aff_a_prior)
    prior = prior.at[0, 7].set(settings.initial_aff_b_prior)
    prior = prior.at[1:, 6].set(settings.affine_opt_mode_a)
    prior = prior.at[1:, 7].set(settings.affine_opt_mode_b)
    prior = prior * frame_valid[:, None]
    res_exist = (pt_valid[:, None] & frame_valid[None, :]
                 & (jnp.arange(n_slots)[None, :] != host[:, None]))
    res_state = jnp.where(
        (jnp.arange(p_slots)[:, None] % 17 == 0) & res_exist,
        jnp.int8(B.RES_OOB), jnp.int8(B.RES_IN))
    c = jnp.array([fx, fy, cx, cy]) / B.CALIB_SCALE
    D = 4 + 8 * n_slots
    ba = B.BAState(
        frame_valid=frame_valid, T_cw_eval=T_eval,
        state=jnp.zeros((n_slots, 8)), state_zero=jnp.zeros((n_slots, 8)),
        exposure=jnp.ones(n_slots),
        energy_th=jnp.full((n_slots,), 12.0 * 12.0 * 8.0),
        prior=prior, c=c, c_zero=c,
        pt_valid=pt_valid, host=host.astype(jnp.int32), u=u, v=v,
        color=color, weight=jnp.ones((p_slots, 8)),
        idepth=idp, idepth_zero=idp,
        pt_prior=settings.idepth_fix_prior * jnp.ones(p_slots) * pt_valid,
        res_exist=res_exist, res_state=res_state,
        HM=jnp.zeros((D, D)), bM=jnp.zeros(D),
    )
    return ba, dI
