"""SO(3) / SE(3) / Sim(3) Lie groups in pure JAX.

JAX replacement for the vendored Sophus headers the reference uses for
all pose algebra (reference: thirdparty/Sophus/sophus/{so3,se3,sim3}.hpp,
typedefs in src/util/NumType.h:41-43).

Conventions (matching Sophus, which the reference relies on):
  * Group elements are homogeneous matrices: SO3 -> (3,3), SE3/Sim3 -> (4,4).
    Sim3 stores `s*R` in the rotation block.
  * Tangent vectors put translation first: se3 = [v(3), w(3)],
    sim3 = [v(3), w(3), sigma(1)] with scale s = exp(sigma).
  * All functions are pure, fully differentiable, batch-friendly under `vmap`,
    and f32-safe via Taylor fallbacks near theta = 0.

Everything here runs as tiny fused elementwise/matmul graphs; these
ops are never a bottleneck, so clarity > micro-optimization.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-6  # small-angle switch; sq errors ~theta^4 < f32 ulp below this


def _where_safe(pred, a, b):
    return jnp.where(pred, a, b)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def so3_hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of w (…,3) -> (…,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], -1),
            jnp.stack([wz, z, -wx], -1),
            jnp.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def so3_vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of so3_hat: (…,3,3) -> (…,3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _sinc_cosc(theta2):
    """Return A = sin(t)/t and B = (1-cos(t))/t^2 with Taylor fallbacks."""
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    small = theta2 < _EPS
    A = _where_safe(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = _where_safe(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, 1e-24))
    return A, B


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Exponential map R = exp([w]_x), Rodrigues with Taylor fallback."""
    theta2 = jnp.sum(w * w, -1)
    A, B = _sinc_cosc(theta2)
    W = so3_hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map (…,3,3) -> (…,3). Safe for theta in [0, pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    theta2 = theta * theta
    # w = theta/(2 sin theta) * vee(R - R^T); Taylor: 0.5*(1 + theta^2/6)
    sin_t = jnp.sin(theta)
    small = theta2 < _EPS
    fac = _where_safe(
        small,
        0.5 + theta2 / 12.0,
        theta / jnp.maximum(2.0 * sin_t, 1e-24),
    )
    w = fac[..., None] * so3_vee(R - jnp.swapaxes(R, -1, -2))
    # near theta = pi the vee formula degenerates; fall back to axis extraction
    near_pi = cos_t < -0.99999
    # axis from largest diagonal of (R + I)/2
    M = (R + jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)) * 0.5
    diag = jnp.stack([M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]], -1)
    k = jnp.argmax(diag, -1)
    col = jnp.take_along_axis(M, k[..., None, None].repeat(3, -2), axis=-1)[..., 0]
    axis = col / jnp.maximum(jnp.linalg.norm(col, axis=-1, keepdims=True), 1e-24)
    w_pi = axis * theta[..., None]
    return _where_safe(near_pi[..., None], w_pi, w)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def _se3_V(w: jnp.ndarray) -> jnp.ndarray:
    """Left Jacobian V of SO(3): integrates translation under rotation."""
    theta2 = jnp.sum(w * w, -1)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    small = theta2 < _EPS
    A, B = _sinc_cosc(theta2)
    # C = (1 - A)/theta^2, Taylor: 1/6 - theta^2/120
    C = _where_safe(
        small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / jnp.maximum(theta2, 1e-24)
    )
    W = so3_hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + B[..., None, None] * W + C[..., None, None] * (W @ W)


def _se3_Vinv(w: jnp.ndarray) -> jnp.ndarray:
    """Inverse of the left Jacobian V."""
    theta2 = jnp.sum(w * w, -1)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    small = theta2 < _EPS
    half = theta * 0.5
    # k = (1 - A/(2B)) / theta^2  with A=sin/theta, B=(1-cos)/theta^2
    # equivalently (1 - (theta/2) cot(theta/2)) / theta^2
    cot_term = half * jnp.cos(half) / jnp.maximum(jnp.sin(half), 1e-24)
    k = _where_safe(
        small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - cot_term) / jnp.maximum(theta2, 1e-24)
    )
    W = so3_hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I - 0.5 * W + k[..., None, None] * (W @ W)


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """exp: (…,6) [v,w] -> (…,4,4)."""
    v, w = xi[..., :3], xi[..., 3:6]
    R = so3_exp(w)
    t = (_se3_V(w) @ v[..., None])[..., 0]
    return _compose_rt(R, t)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """log: (…,4,4) -> (…,6) [v,w]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    v = (_se3_Vinv(w) @ t[..., None])[..., 0]
    return jnp.concatenate([v, w], -1)


def _compose_rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    shape = R.shape[:-2]
    T = jnp.zeros(shape + (4, 4), R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def se3_inv(T: jnp.ndarray) -> jnp.ndarray:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return _compose_rt(Rt, -(Rt @ t[..., None])[..., 0])


def se3_adj(T: jnp.ndarray) -> jnp.ndarray:
    """Adjoint of SE(3), (…,6,6) acting on [v,w] tangents.

    Adj = [[R, [t]x R], [0, R]]. Used for host/target adjoint transfer in the
    BA (reference: EnergyFunctional::setAdjointsF, EnergyFunctional.cpp:42-103).
    """
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    shape = T.shape[:-2]
    A = jnp.zeros(shape + (6, 6), T.dtype)
    A = A.at[..., :3, :3].set(R)
    A = A.at[..., :3, 3:].set(so3_hat(t) @ R)
    A = A.at[..., 3:, 3:].set(R)
    return A


# ---------------------------------------------------------------------------
# Sim(3)  (pose graph with scale; replaces g2o Sim3 vertices)
# ---------------------------------------------------------------------------

def sim3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """exp: (…,7) [v,w,sigma] -> (…,4,4) with sR in the rotation block."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = so3_exp(w)
    Wmat = _sim3_W(w, sigma)
    t = (Wmat @ v[..., None])[..., 0]
    return _compose_rt(s[..., None, None] * R, t)


def sim3_log(T: jnp.ndarray) -> jnp.ndarray:
    """log: (…,4,4) with sR block -> (…,7) [v,w,sigma]."""
    sR = T[..., :3, :3]
    t = T[..., :3, 3]
    s = jnp.cbrt(jnp.linalg.det(sR))
    R = sR / s[..., None, None]
    w = so3_log(R)
    sigma = jnp.log(s)
    # invert the W matrix numerically (3x3 solve — cheap and robust)
    xi_rw = jnp.concatenate([w, sigma[..., None]], -1)
    Wmat = _sim3_W(w, sigma)
    v = jnp.linalg.solve(Wmat, t[..., None])[..., 0]
    return jnp.concatenate([v, xi_rw], -1)


def _sim3_W(w, sigma):
    """The translation integral matrix used by sim3_exp (factored for log)."""
    xi = jnp.concatenate(
        [jnp.zeros(w.shape[:-1] + (3,), w.dtype), w, sigma[..., None]], -1
    )
    # reuse sim3_exp structure: evaluate with v = e_i basis via jacobian-free
    # trick — call the coefficient path directly.
    v, w_, sig = xi[..., :3], xi[..., 3:6], xi[..., 6]
    del v
    s = jnp.exp(sig)
    W = so3_hat(w_)
    theta2 = jnp.sum(w_ * w_, -1)
    th_safe = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    small_sig = jnp.abs(sig) < 1e-4
    small_th = theta2 < _EPS
    sig_safe = jnp.where(small_sig, 1.0, sig)  # only where /sigma appears
    # A = (e^sigma - 1)/sigma; Taylor 1 + sigma/2 near 0.
    A_ = jnp.where(small_sig, 1.0 + sig * 0.5, (s - 1.0) / sig_safe)
    # The theta != 0 closed form is regular at sigma = 0 — use true sigma here.
    s2t2 = sig * sig + theta2
    a = s * jnp.sin(th_safe)
    b = s * jnp.cos(th_safe)
    B_full = (a * sig + (1.0 - b) * th_safe) / (th_safe * jnp.maximum(s2t2, 1e-24))
    C_full = (A_ - ((b - 1.0) * sig + a * th_safe) / jnp.maximum(s2t2, 1e-24)) / jnp.maximum(
        theta2, 1e-24
    )
    # theta -> 0 limits (with their own sigma -> 0 fallbacks)
    B_small = jnp.where(
        small_sig,
        0.5 + sig / 3.0,
        ((sig_safe - 1.0) * s + 1.0) / jnp.maximum(sig_safe**2, 1e-24),
    )
    C_small = jnp.where(
        small_sig,
        1.0 / 6.0 + sig / 8.0,
        ((sig_safe - 2.0) * s + sig_safe + 2.0) / jnp.maximum(2.0 * sig_safe**3, 1e-24),
    )
    B = jnp.where(small_th, B_small, B_full)
    C = jnp.where(small_th, C_small, C_full)
    return A_[..., None, None] * I + B[..., None, None] * W + C[..., None, None] * (W @ W)


def sim3_inv(T: jnp.ndarray) -> jnp.ndarray:
    sR = T[..., :3, :3]
    t = T[..., :3, 3]
    s2 = jnp.cbrt(jnp.linalg.det(sR)) ** 2
    sRinv = jnp.swapaxes(sR, -1, -2) / s2[..., None, None]
    return _compose_rt(sRinv, -(sRinv @ t[..., None])[..., 0])


# ---------------------------------------------------------------------------
# Convenience
# ---------------------------------------------------------------------------

def se3_from_rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    return _compose_rt(R, t)


def transform_points(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply (4,4) transform(s) to (…,3) points."""
    return pts @ jnp.swapaxes(T[..., :3, :3], -1, -2) + T[..., :3, 3]


# ---------------------------------------------------------------------------
# NumPy twins for host-side control logic (every eager device op is a
# dispatch and a readback of its own; pose bookkeeping stays on the host)
# ---------------------------------------------------------------------------

def np_so3_exp(w):
    import numpy as np
    w = np.asarray(w, np.float64)
    th2 = float(w @ w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th2 < 1e-12:
        return np.eye(3) + W + 0.5 * (W @ W)
    th = np.sqrt(th2)
    return np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th2 * (W @ W)


def np_so3_log(R):
    import numpy as np
    R = np.asarray(R, np.float64)
    cos_t = np.clip((np.trace(R) - 1) * 0.5, -1.0, 1.0)
    th = np.arccos(cos_t)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if th < 1e-7:
        return 0.5 * v
    if cos_t < -0.99999:
        M = (R + np.eye(3)) * 0.5
        k = int(np.argmax(np.diag(M)))
        axis = M[:, k] / max(np.linalg.norm(M[:, k]), 1e-12)
        return axis * th
    return th / (2 * np.sin(th)) * v


def np_se3_exp(xi):
    import numpy as np
    xi = np.asarray(xi, np.float64)
    v, w = xi[:3], xi[3:]
    R = np_so3_exp(w)
    th2 = float(w @ w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th2 < 1e-12:
        V = np.eye(3) + 0.5 * W + (W @ W) / 6.0
    else:
        th = np.sqrt(th2)
        V = np.eye(3) + (1 - np.cos(th)) / th2 * W \
            + (th - np.sin(th)) / (th2 * th) * (W @ W)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def np_se3_log(T):
    import numpy as np
    T = np.asarray(T, np.float64)
    w = np_so3_log(T[:3, :3])
    th2 = float(w @ w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th2 < 1e-12:
        Vinv = np.eye(3) - 0.5 * W + (W @ W) / 12.0
    else:
        th = np.sqrt(th2)
        half = th * 0.5
        k = (1 - half * np.cos(half) / np.sin(half)) / th2
        Vinv = np.eye(3) - 0.5 * W + k * (W @ W)
    return np.concatenate([Vinv @ T[:3, 3], w])


def np_quat_to_rot(q):
    import numpy as np
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quat_to_rot(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (w,x,y,z) -> rotation matrix (…,3,3)."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )
