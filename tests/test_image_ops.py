"""Tests for pyramid/gradient/interpolation and pixel selection."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from sos_slam_tpu.ops import image as imops
from sos_slam_tpu.ops import selector
from sos_slam_tpu.utils import synthetic
from sos_slam_tpu.utils.camera import make_calib_pyramid, num_pyramid_levels
from sos_slam_tpu.utils.config import default_settings

# fast, pure-host subset: run with pytest -m smoke (seconds, no big jits)
pytestmark = pytest.mark.smoke


KEY = jax.random.PRNGKey(0)


class TestCalibPyramid:
    def test_level_count_rule(self):
        # 640x480: 640/2^k... area>5000 → levels: 640x480,320x240,160x120,
        # 80x60(4800<5000 stop after adding? rule: halve while area>5000)
        assert num_pyramid_levels(640, 480) == 4
        assert num_pyramid_levels(1024, 1024) == 5  # 64x64 = 4096 < 5000 stops
        assert num_pyramid_levels(2048, 2048) == 6  # capped at PYR_LEVELS

    def test_synthetic_k(self):
        c = make_calib_pyramid(640, 480, 460, 460, 319.5, 239.5)
        assert c.widths == (640, 320, 160, 80)
        np.testing.assert_allclose(c.fx[1], 230.0)
        np.testing.assert_allclose(c.cx[1], (319.5 + 0.5) / 2 - 0.5)


class TestPyramid:
    def test_downsample_box(self):
        img = jnp.arange(16.0).reshape(4, 4)
        d = imops.downsample2x(img)
        np.testing.assert_allclose(d[0, 0], (0 + 1 + 4 + 5) / 4)

    def test_gradients_linear_ramp(self):
        # I = 3x + 2y → dx = 3, dy = 2 everywhere in the interior
        x, y = jnp.meshgrid(jnp.arange(32.0), jnp.arange(32.0))
        img = 3 * x + 2 * y
        dx, dy = imops.image_gradients(img)
        np.testing.assert_allclose(dx[2:-2, 2:-2], 3.0, atol=1e-5)
        np.testing.assert_allclose(dy[2:-2, 2:-2], 2.0, atol=1e-5)
        # borders zeroed
        assert float(jnp.abs(dx[:, 0]).max()) == 0.0

    def test_build_pyramid_shapes(self):
        img = jax.random.uniform(KEY, (64, 64)) * 255
        levels, asg = imops.build_pyramid(img, 3)
        assert levels[0].shape == (64, 64, 3)
        assert levels[2].shape == (16, 16, 3)
        assert asg[1].shape == (32, 32)
        # intensity channel of level1 == downsample of level0
        np.testing.assert_allclose(
            levels[1][..., 0], imops.downsample2x(img), atol=1e-4
        )


class TestInterp:
    def test_integer_coords(self):
        img = jax.random.uniform(KEY, (16, 16))
        u = jnp.array([3.0, 7.0])
        v = jnp.array([2.0, 9.0])
        out = imops.interp_bilinear(img, u, v)
        np.testing.assert_allclose(out, img[jnp.array([2, 9]), jnp.array([3, 7])],
                                   atol=1e-6)

    def test_half_coords(self):
        img = jnp.array([[0.0, 1.0], [2.0, 3.0]])
        out = imops.interp_bilinear(img, jnp.array([0.5]), jnp.array([0.5]))
        np.testing.assert_allclose(out, [1.5], atol=1e-6)

    def test_multichannel(self):
        img = jax.random.uniform(KEY, (16, 16, 3))
        out = imops.interp_bilinear(img, jnp.array([4.25]), jnp.array([5.75]))
        assert out.shape == (1, 3)

    def test_matches_analytic_texture(self):
        """Bilinear sample of a rendered image ≈ analytic texture value."""
        calib = synthetic.default_calib(128, 96)
        img, _ = synthetic.render_plane(calib, jnp.eye(4))
        # sample at an off-grid pixel; compare against rendering at that ray
        u, v = 40.3, 30.7
        fx, fy, cx, cy = calib.intrinsics(0)
        x = (u - cx) / fx * 2.0  # plane_z = 2, identity pose
        y = (v - cy) / fy * 2.0
        analytic = float(synthetic.texture(jnp.array([x, y])))
        sampled = float(imops.interp_bilinear(img, jnp.array([u]), jnp.array([v]))[0])
        assert abs(analytic - sampled) < 2.0  # band-limited texture


class TestSelector:
    def test_density_and_spread(self):
        calib = synthetic.default_calib(320, 256)
        img, _ = synthetic.render_plane(calib, jnp.eye(4))
        levels, asg = imops.build_pyramid(img, 3)
        s = default_settings()
        status, n, pot = selector.make_maps(
            levels[0], asg, s, density=800.0, key=KEY, recursions=2
        )
        # adaptive: should land within a reasonable factor of the target
        assert 300 < n < 1600, n
        # spread: points in all four quadrants
        ys, xs = np.nonzero(np.asarray(status))
        assert (xs < 160).any() and (xs >= 160).any()
        assert (ys < 128).any() and (ys >= 128).any()

    def test_flat_image_selects_nothing(self):
        img = jnp.full((128, 128), 100.0)
        levels, asg = imops.build_pyramid(img, 3)
        ths = selector.block_thresholds(asg[0], 0.5, 7.0)
        status, _ = selector.select(
            levels[0], asg[0], asg[1], asg[2], ths, 3, 2.0, 0.75, KEY
        )
        assert int(jnp.sum(status != 0)) == 0

    def test_statuses_disjoint(self):
        calib = synthetic.default_calib(256, 192)
        img, _ = synthetic.render_plane(calib, jnp.eye(4))
        levels, asg = imops.build_pyramid(img, 3)
        ths = selector.block_thresholds(asg[0], 0.5, 7.0)
        status, _ = selector.select(
            levels[0], asg[0], asg[1], asg[2], ths, 3, 2.0, 0.75, KEY
        )
        vals = set(np.unique(np.asarray(status)).tolist())
        assert vals.issubset({0, 1, 2, 4})


class TestTwoPlanes:
    def test_depth_discontinuity(self):
        from sos_slam_tpu.utils.synthetic import default_calib, render_two_planes
        import jax.numpy as jnp
        calib = default_calib(128, 96)
        img, idp = render_two_planes(calib, jnp.eye(4))
        left = np.asarray(idp[:, :40])
        right = np.asarray(idp[:, -40:])
        assert abs(left.mean() - 0.5) < 0.05      # z_near = 2
        assert abs(right.mean() - 1.0 / 6.0) < 0.05  # z_far = 6
        assert np.isfinite(np.asarray(img)).all()


class TestFusedGatherPrimitives:
    """Exact-equivalence tests for the fused gather/compaction forms
    that replaced vmapped gathers and sorts on the hot path."""

    def test_interp_bilinear_frames_matches_per_frame(self):
        rng = np.random.default_rng(0)
        F, H, W = 4, 40, 56
        dI = jnp.asarray(rng.normal(size=(F, H, W, 3)).astype(np.float32))
        Ku = jnp.asarray(rng.uniform(0, W - 1, size=(17, F, 8))
                         .astype(np.float32))
        Kv = jnp.asarray(rng.uniform(0, H - 1, size=(17, F, 8))
                         .astype(np.float32))
        fused = imops.interp_bilinear_frames(dI, Ku, Kv)
        ref = jax.vmap(
            lambda d, u, v: imops.interp_bilinear(d, u, v),
            in_axes=(0, 1, 1), out_axes=1)(dI, Ku, Kv)
        np.testing.assert_array_equal(np.asarray(fused), np.asarray(ref))

    def test_interp_bilinear_frames_single_channel(self):
        rng = np.random.default_rng(1)
        F, H, W = 3, 24, 32
        dI = jnp.asarray(rng.normal(size=(F, H, W)).astype(np.float32))
        Ku = jnp.asarray(rng.uniform(0, W - 1, size=(9, F, 2))
                         .astype(np.float32))
        Kv = jnp.asarray(rng.uniform(0, H - 1, size=(9, F, 2))
                         .astype(np.float32))
        fused = imops.interp_bilinear_frames(dI, Ku, Kv)
        ref = jax.vmap(
            lambda d, u, v: imops.interp_bilinear(d, u, v),
            in_axes=(0, 1, 1), out_axes=1)(dI, Ku, Kv)
        np.testing.assert_array_equal(np.asarray(fused), np.asarray(ref))

    def test_compact_mask_indices_matches_topk(self):
        rng = np.random.default_rng(2)
        for n, k, p in [(100, 16, 0.5), (500, 64, 0.05), (64, 64, 0.9),
                        (300, 32, 0.0), (300, 32, 1.0)]:
            mask = jnp.asarray(rng.uniform(size=n) < p)
            idx, ok = selector.compact_mask_indices(mask, k)
            _, idx_ref = jax.lax.top_k(mask.astype(jnp.float32), k)
            ok_ref = mask[idx_ref]
            np.testing.assert_array_equal(np.asarray(idx),
                                          np.asarray(idx_ref))
            np.testing.assert_array_equal(np.asarray(ok), np.asarray(ok_ref))

    def test_block_thresholds_matches_sort_quantile(self):
        rng = np.random.default_rng(3)
        h, w = 96, 128
        absgrad = jnp.asarray((rng.uniform(size=(h, w)) * 2500.0)
                              .astype(np.float32))
        cut, add = 0.5, 7.0
        ths = np.asarray(selector.block_thresholds(absgrad, cut, add))

        # reference form: per-block sort quantile of the integer-floored
        # magnitudes (the pre-histogram implementation)
        g = np.clip(np.floor(np.sqrt(np.maximum(np.asarray(absgrad), 0.0))),
                    0, 48)
        xi, yi = np.arange(w), np.arange(h)
        valid = ((xi >= 1) & (xi <= w - 2))[None, :] \
            & ((yi >= 1) & (yi <= h - 2))[:, None]
        h32, w32 = h // 32, w // 32
        gb = g[:h32 * 32, :w32 * 32].reshape(h32, 32, w32, 32) \
            .transpose(0, 2, 1, 3).reshape(h32, w32, 1024)
        vb = valid[:h32 * 32, :w32 * 32].reshape(h32, 32, w32, 32) \
            .transpose(0, 2, 1, 3).reshape(h32, w32, 1024)
        gb = np.where(vb, gb, 1e9)
        gb_sorted = np.sort(gb, axis=-1)
        n_valid = vb.sum(-1)
        th_idx = np.clip((n_valid * cut + 0.5).astype(int), 0, 1023)
        raw = np.take_along_axis(gb_sorted, th_idx[..., None], -1)[..., 0]
        raw = np.minimum(raw, 48.0) + add
        ker = np.ones((3, 3))
        from scipy.signal import convolve2d
        sm = convolve2d(raw, ker, mode="same") / \
            convolve2d(np.ones_like(raw), ker, mode="same")
        np.testing.assert_allclose(ths, sm * sm, rtol=1e-6)
