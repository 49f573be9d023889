"""The device stages against their float64 NumPy references
(sos_slam_tpu/utils/np_reference.py) — the same references chip_smoke.py
holds the GPU to at full width."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sos_slam_tpu.models import energy as E
from sos_slam_tpu.models import window as WIN
from sos_slam_tpu.ops import ba as B
from sos_slam_tpu.ops import image as imops
from sos_slam_tpu.ops import trace as T
from sos_slam_tpu.utils import np_reference as ref
from sos_slam_tpu.utils import synthetic
from sos_slam_tpu.utils.config import PATTERN_OFFSETS, default_settings

SETTINGS = default_settings()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b)))


@pytest.mark.parametrize("w,h", [(640, 480), (752, 480), (512, 512)])
def test_pyramid_matches_make_images(w, h):
    """Every level's [I, dx, dy] and |grad|^2 at the datasets' shapes
    (VGA, EuRoC, TUM-VI), to f32 rounding of 0-255 intensities."""
    n_levels = synthetic.default_calib(w, h).levels
    img = np.random.default_rng(w + h).uniform(0, 255, (h, w)
                                                ).astype(np.float32)
    levels, asg = imops.build_pyramid(jnp.asarray(img), n_levels)
    lv_r, asg_r = ref.make_images(img, n_levels)
    assert len(levels) == n_levels
    for lvl in range(n_levels):
        assert levels[lvl].shape == lv_r[lvl].shape
        assert _rel(levels[lvl], lv_r[lvl]) < 1e-6
        assert _rel(asg[lvl], asg_r[lvl]) < 1e-6


@pytest.mark.parametrize("diag", [True, False])
def test_template_level_matches_numpy(diag):
    rng = np.random.default_rng(7)
    h, w = 96, 128
    occ = rng.uniform(size=(h, w)) < 0.05
    wm = np.where(occ, rng.uniform(0.1, 1.1, (h, w)), 0.0).astype(np.float32)
    idm = np.where(occ, wm * rng.uniform(0.2, 2.0, (h, w)), 0.0
                   ).astype(np.float32)
    color = rng.uniform(0, 255, (h, w)).astype(np.float32)
    color[5, 7] = np.nan          # a non-finite colour is never usable
    idn, good = jax.jit(WIN.template_level, static_argnames="diag")(
        idm, wm, color, diag=diag)
    idn_r, good_r = ref.template_level(idm, wm, color, diag)
    np.testing.assert_array_equal(np.asarray(good), good_r)
    assert not good_r[5, 7]
    assert good_r.sum() > occ.sum()      # dilation filled empty pixels
    np.testing.assert_allclose(np.asarray(idn), idn_r, rtol=1e-6, atol=1e-6)


def _activation_case():
    """Traced immature points on the two-frame plane scene of
    tests/test_trace.py, with every point's residual to its host masked."""
    from tests.test_trace import SETTINGS as S, H as TH, W as TW, \
        make_points, setup_scene
    from sos_slam_tpu.utils import lie

    calib, dI_ref, dI_new, _, KRKi, Kt = setup_scene()
    imm = make_points(calib, dI_ref)
    imm = T.trace_points(imm, dI_new, KRKi[None], Kt[None],
                         jnp.array([[1.0, 0.0]]), TW, TH, S)
    fx, fy, cx, cy = calib.intrinsics(0)
    T_new = lie.se3_exp(jnp.array([0.06, 0, 0, 0, 0, 0], jnp.float32))
    rel = jnp.stack([jnp.stack([jnp.eye(4), lie.se3_inv(T_new)]),
                     jnp.stack([T_new, jnp.eye(4)])])
    n = imm.u.shape[0]
    pat = jnp.asarray(PATTERN_OFFSETS)
    KliP = jnp.stack([(imm.u[:, None] + pat[None, :, 0] - cx) / fx,
                      (imm.v[:, None] + pat[None, :, 1] - cy) / fy,
                      jnp.ones((n, 8))], -1)
    Rp = rel[imm.host][..., :3, :3]
    tp = rel[imm.host][..., :3, 3]
    ap = jnp.broadcast_to(jnp.array([1.0, 0.0]), (n, 2, 2))
    oob_in = jax.nn.one_hot(imm.host, 2, dtype=bool) | ~imm.valid[:, None]
    idepth = jnp.where(jnp.isfinite(imm.idepth_max),
                       0.5 * (imm.idepth_min + imm.idepth_max), 0.5)
    return (imm, Rp, tp, ap, KliP, jnp.stack([dI_ref, dI_new]), idepth,
            oob_in), (fx, fy, cx, cy), TW, TH, S


@pytest.mark.parametrize("clamp", [False, True])
def test_activation_pass_matches_float64(clamp):
    args, intr, w, h, s = _activation_case()
    fn = jax.jit(functools.partial(T.activation_pass, clamp=clamp, intr=intr,
                                   w=w, h=h, huber_th=s.huber_th))
    e_res, oob, eN, HN, bN = jax.tree.map(np.asarray, fn(*args))
    imm, Rp, tp, ap, KliP, dI, idepth, oob_in = args
    r = ref.activation_pass(imm.color, imm.weights, imm.energy_th, Rp, tp,
                            ap, KliP, dI, idepth, oob_in, clamp, intr, w, h,
                            s.huber_th)
    np.testing.assert_array_equal(oob, r[1])
    live = ~oob
    assert live.sum() > 100
    assert _rel(e_res[live], r[0][live]) < 1e-4
    assert _rel(eN, r[2]) < 1e-4
    assert _rel(HN, r[3]) < 1e-4
    # b is a signed sum of r * d_id: the f32 rounding of r (a difference of
    # ~128-level intensities, ~1e-5) times |d_id| (1e2..1e3) is not
    # cancelled with the terms themselves
    assert _rel(bN, r[4]) < 5e-3


@pytest.fixture(scope="module")
def gn_window():
    """The mixed-host window: points spread over 3 host frames, pose and
    idepth noise, every 17th point's residuals OOB."""
    ba, dI = synthetic.make_ba_window(192, 128, 4, 4, 128, 160,
                                      pose_noise=0.02, idepth_noise=0.3,
                                      n_hosts=3, seed=3)
    pre = B.make_precalc(ba)
    q = E._iter_quants(ba, pre, dI, SETTINGS, 192, 128)
    lin = B.linearize(ba, pre, dI, SETTINGS, 192, 128)
    dense = ref.dense_ba_system(
        lin.X, lin.Jpdd, lin.resF, lin.JIdx, lin.JabF, lin.active, ba.host,
        pre.adHost, pre.adTarget, ba.pt_prior, ba.idepth, ba.idepth_zero)
    return q, dense, lin


def test_iter_quants_top_matches_dense(gn_window):
    q, (H_top, b_top, _, _, _), lin = gn_window
    n_act = int(np.sum(np.asarray(lin.active)))
    assert 50 < n_act == int(q["n_active"])
    assert _rel(q["Htop"], H_top) < 2e-5
    assert _rel(q["btop"], b_top) < 2e-5
    np.testing.assert_allclose(np.asarray(q["Htop"]),
                               np.asarray(q["Htop"]).T, rtol=1e-5, atol=1e-2)


def test_iter_quants_schur_matches_dense(gn_window):
    q, (_, _, H_sc, b_sc, HdiF), _ = gn_window
    assert _rel(q["HdiF"], HdiF) < 1e-5
    assert _rel(q["Hsc"], H_sc) < 2e-5
    assert _rel(q["bsc"], b_sc) < 2e-5
