"""color_neus_torch.ops.rays against the JAX package on the CPU.

Deterministic functions are compared on the same numpy inputs: near/far
to 1e-6 and ray origins bitwise; ray directions to 1e-6 (the JAX package
rotates with a HIGHEST-precision einsum, the port with an elementwise
product and sum); sample_pdf(det) with the tolerance its test explains.
The pixel samplers draw from different RNGs, so they are compared by
distribution, and the exact-count sampler by its exact in-mask count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from color_neus_tpu.ops import rays as jrays

from color_neus_torch import pin_precision
from color_neus_torch.ops import rays

torch.set_num_threads(1)
pin_precision()


def _rays(n=64, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (-2.2 * d + 0.1 * rng.randn(n, 3)).astype(np.float32)
    return o, d


def test_near_far_matches_jax():
    o, d = _rays()
    n_j, f_j = jrays.near_far_from_sphere(jnp.asarray(o), jnp.asarray(d))
    n_t, f_t = rays.near_far_from_sphere(torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-6, rtol=0)


@pytest.mark.parametrize("normalize,opengl", [(True, False), (False, True)])
def test_rays_for_pixels_matches_jax(normalize, opengl):
    rng = np.random.RandomState(1)
    R, H, W = 50, 24, 32
    c2w = np.tile(np.eye(4, dtype=np.float32), (R, 1, 1))
    q, _ = np.linalg.qr(rng.randn(R, 3, 3))
    c2w[:, :3, :3] = q.astype(np.float32)
    c2w[:, :3, 3] = rng.randn(R, 3).astype(np.float32)
    focal = np.array([30.0, 28.0], np.float32)
    px = rng.randint(0, W, R).astype(np.int32)
    py = rng.randint(0, H, R).astype(np.int32)
    o_j, d_j = jrays.rays_for_pixels(jnp.asarray(c2w), jnp.asarray(focal), jnp.asarray(px),
                                     jnp.asarray(py), H, W, normalize, opengl)
    o_t, d_t = rays.rays_for_pixels(torch.from_numpy(c2w), torch.from_numpy(focal),
                                    torch.from_numpy(px).long(), torch.from_numpy(py).long(),
                                    H, W, normalize, opengl)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6, rtol=0)
    ao_j, ad_j = jrays.all_rays_for_camera(jnp.asarray(c2w[0]), jnp.asarray(focal), H, W,
                                           normalize, opengl)
    ao_t, ad_t = rays.all_rays_for_camera(torch.from_numpy(c2w[0]), torch.from_numpy(focal),
                                          H, W, normalize, opengl)
    np.testing.assert_array_equal(ao_t.numpy(), np.asarray(ao_j))
    np.testing.assert_allclose(ad_t.numpy(), np.asarray(ad_j), atol=1e-6, rtol=0)


def test_sample_pdf_det_matches_jax():
    rng = np.random.RandomState(2)
    R, M, K = 40, 33, 16
    bins = np.sort(rng.uniform(0.5, 3.5, (R, M)), axis=1).astype(np.float32)
    w = rng.uniform(0, 1, (R, M - 1)).astype(np.float32)
    w[:5] = 0.0                       # degenerate rows: the 1e-5 floor
    w[5:10, 10:] = 0.0                # mass in a prefix only
    got = rays.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), K, det=True)
    want = jrays.sample_pdf(jnp.asarray(bins), jnp.asarray(w), K, det=True)
    # the cdfs agree to f32 rounding (the two libraries sum in another
    # order); z = b + (u - cdf_b)/(cdf_a - cdf_b) * width multiplies a
    # one-ulp cdf difference by width / cdf step (up to ~1e2 in the
    # 1e-5-floor rows), hence rtol 1e-5 on z
    wt = torch.from_numpy(w) + 1e-5
    cdf_t = torch.cumsum(wt / wt.sum(-1, keepdim=True), -1).numpy()
    wj = jnp.asarray(w) + 1e-5
    cdf_j = np.asarray(jnp.cumsum(wj / jnp.sum(wj, -1, keepdims=True), -1))
    np.testing.assert_allclose(cdf_t, cdf_j, atol=4e-7, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
    assert bool(torch.all(got[:, 1:] >= got[:, :-1]))


def test_searchsorted_right_is_the_counting_form():
    """torch.searchsorted(cdf, u, right=True) == #(cdf <= u), the JAX
    package's counting form (rays.py:205), ties included."""
    rng = np.random.RandomState(4)
    cdf = np.concatenate([np.zeros((30, 1)), np.cumsum(rng.uniform(0, 1, (30, 20)), 1)], 1)
    cdf = (cdf / cdf[:, -1:]).astype(np.float32)
    u = np.concatenate([rng.uniform(0, 1, (30, 12)), cdf[:, 3:7]], 1).astype(np.float32)
    got = torch.searchsorted(torch.from_numpy(cdf), torch.from_numpy(u), right=True).numpy()
    want = np.sum(cdf[:, :, None] <= u[:, None, :], axis=1)
    np.testing.assert_array_equal(got, want)


def _masks(B=4, H=16, W=16):
    yy, xx = np.mgrid[0:H, 0:W]
    m = (((yy - 7.5) ** 2 + (xx - 7.5) ** 2) < 25).astype(np.float32)
    masks = np.tile(m[None], (B, 1, 1))
    masks[1] = 0.0                    # one camera with an empty mask
    return masks


def test_masked_exact_count_and_no_replacement():
    masks = _masks()
    flat = masks.reshape(-1) > 0.5
    n_rays = 256
    g = torch.Generator().manual_seed(0)
    for rate in (np.float32(0.5), np.float32(0.67), np.float32(0.8)):
        cam, py, px, sel = rays.sample_pixels_masked_exact(g, torch.from_numpy(masks), n_rays, rate)
        *_, sel_j = jrays.sample_pixels_masked_exact(jax.random.PRNGKey(0), jnp.asarray(masks),
                                                     n_rays, jnp.float32(rate))
        n_in = int(rate * n_rays)
        assert int(sel.sum()) == int(np.asarray(sel_j).sum()) == n_in
        idx = (cam * 16 * 16 + py * 16 + px).numpy()
        np.testing.assert_array_equal(sel.numpy(), flat[idx].astype(np.float32))
        assert len(np.unique(idx[:n_in])) == n_in                     # without replacement
        assert len(np.unique(idx[n_in:])) == n_rays - n_in
        assert not np.any(cam.numpy()[:n_in] == 1)                    # empty mask: never in


def test_masked_exact_is_uniform_over_the_mask():
    """Each in-mask pixel is drawn with probability n_in / m_in per call."""
    masks = _masks()
    m_in = int((masks > 0.5).sum())
    g = torch.Generator().manual_seed(1)
    counts = np.zeros(masks.size)
    n_calls, n_rays, rate = 400, 64, 0.5
    for _ in range(n_calls):
        cam, py, px, _ = rays.sample_pixels_masked_exact(g, torch.from_numpy(masks), n_rays, rate)
        idx = (cam * 256 + py * 16 + px).numpy()[: int(rate * n_rays)]
        np.add.at(counts, idx, 1)
    inside = counts[masks.reshape(-1) > 0.5]
    expect = n_calls * int(rate * n_rays) / m_in
    # binomial spread: each count ~ N(expect, expect); 5 sigma over all pixels
    assert np.all(np.abs(inside - expect) < 5 * np.sqrt(expect) + 1)


def test_masked_bernoulli_rate_matches_jax():
    masks = _masks()
    n_rays, rate = 4096, 0.7
    *_, sel = rays.sample_pixels_masked(torch.Generator().manual_seed(2),
                                        torch.from_numpy(masks), n_rays, rate)
    *_, sel_j = jrays.sample_pixels_masked(jax.random.PRNGKey(2), jnp.asarray(masks),
                                           n_rays, rate)
    sd = np.sqrt(rate * (1 - rate) / n_rays)
    assert abs(float(sel.mean()) - rate) < 5 * sd
    assert abs(float(np.asarray(sel_j).mean()) - rate) < 5 * sd


def test_uniform_sampler_distribution_and_quirk():
    g = torch.Generator().manual_seed(3)
    cam, py, px = rays.sample_pixels_uniform(g, 4, 8, 8, 8192)
    cam_j, py_j, px_j = jrays.sample_pixels_uniform(jax.random.PRNGKey(3), 4, 8, 8, 8192)
    for a, b, n in ((cam, cam_j, 4), (py, py_j, 8), (px, px_j, 8)):
        h_t = np.bincount(a.numpy(), minlength=n) / 8192
        h_j = np.bincount(np.asarray(b), minlength=n) / 8192
        np.testing.assert_allclose(h_t, 1.0 / n, atol=5 * np.sqrt(1.0 / n / 8192))
        np.testing.assert_allclose(h_j, 1.0 / n, atol=5 * np.sqrt(1.0 / n / 8192))
    cam0, *_ = rays.sample_pixels_uniform(g, 4, 8, 8, 256, first_image_only=True)
    assert bool(torch.all(cam0 == 0))
