"""Unit tests: JAX kernels vs NumPy transliterations of the C semantics."""

import numpy as np
import pytest

import jax.numpy as jnp

from faldoi_tpu import ops
from tests import ref_numpy as ref

rng = np.random.RandomState(0)


def rand(h, w):
    return rng.rand(h, w).astype(np.float32)


@pytest.mark.parametrize("h,w", [(7, 9), (16, 16), (33, 17)])
def test_forward_gradient(h, w):
    f = rand(h, w)
    fx, fy = ops.forward_gradient(jnp.asarray(f))
    rx, ry = ref.forward_gradient(f)
    np.testing.assert_allclose(fx, rx, atol=1e-7)
    np.testing.assert_allclose(fy, ry, atol=1e-7)


@pytest.mark.parametrize("h,w", [(7, 9), (16, 16)])
def test_backward_gradient(h, w):
    f = rand(h, w)
    fx, fy = ops.backward_gradient(jnp.asarray(f))
    rx, ry = ref.backward_gradient(f)
    np.testing.assert_allclose(fx, rx, atol=1e-7)
    np.testing.assert_allclose(fy, ry, atol=1e-7)


@pytest.mark.parametrize("h,w", [(7, 9), (16, 16), (33, 17)])
def test_centered_gradient(h, w):
    f = rand(h, w)
    dx, dy = ops.centered_gradient(jnp.asarray(f))
    rx, ry = ref.centered_gradient(f)
    np.testing.assert_allclose(dx, rx, atol=1e-7)
    np.testing.assert_allclose(dy, ry, atol=1e-7)


@pytest.mark.parametrize("h,w", [(7, 9), (16, 16), (33, 17)])
def test_divergence(h, w):
    v1, v2 = rand(h, w), rand(h, w)
    d = ops.divergence(jnp.asarray(v1), jnp.asarray(v2))
    r = ref.divergence(v1, v2)
    np.testing.assert_allclose(d, r, atol=1e-7)


@pytest.mark.parametrize("ph,pw", [(11, 11), (11, 7), (5, 11), (3, 3)])
def test_forward_gradient_patch(ph, pw):
    P = 11
    f = rand(P, P)
    fx, fy = ops.forward_gradient_patch(jnp.asarray(f), ph, pw)
    # oracle: run the image-version on the (ph, pw) subarray
    rx, ry = ref.forward_gradient(f[:ph, :pw])
    np.testing.assert_allclose(np.asarray(fx)[:ph, :pw], rx, atol=1e-7)
    np.testing.assert_allclose(np.asarray(fy)[:ph, :pw], ry, atol=1e-7)
    assert np.all(np.asarray(fx)[ph:, :] == 0) and np.all(np.asarray(fx)[:, pw:] == 0)


@pytest.mark.parametrize("ph,pw", [(11, 11), (11, 7), (5, 11), (3, 3)])
def test_divergence_patch(ph, pw):
    P = 11
    v1, v2 = rand(P, P), rand(P, P)
    d = ops.divergence_patch(jnp.asarray(v1), jnp.asarray(v2), ph, pw)
    r = ref.divergence(v1[:ph, :pw], v2[:ph, :pw])
    np.testing.assert_allclose(np.asarray(d)[:ph, :pw], r, atol=1e-7)
    assert np.all(np.asarray(d)[ph:, :] == 0) and np.all(np.asarray(d)[:, pw:] == 0)


@pytest.mark.parametrize("sigma", [0.9, 0.6, 1.7])
def test_gaussian(sigma):
    f = rand(24, 31) * 255.0
    out = ops.gaussian_smooth(jnp.asarray(f), sigma)
    r = ref.gaussian(f, sigma)
    np.testing.assert_allclose(out, r, atol=2e-4)


def test_normalization_pair():
    a, b = rand(8, 8) * 200, rand(8, 8) * 90 + 30
    na, nb = ops.image_normalization(jnp.asarray(a), jnp.asarray(b))
    mn = min(a.min(), b.min())
    mx = max(a.max(), b.max())
    np.testing.assert_allclose(na, (a - mn) / (mx - mn), rtol=1e-6)
    np.testing.assert_allclose(nb, (b - mn) / (mx - mn), rtol=1e-6)


def test_normalization_3_quirk():
    i1, i2, i0 = rand(8, 8) * 100 + 50, rand(8, 8) * 100, rand(8, 8) * 100 + 20
    n1, n2, n0 = ops.image_normalization_3(
        jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(i0)
    )
    mx = max(i0.max(), i1.max(), i2.max())
    mn = max(i2.min(), min(i0.min(), i1.min()))  # reference quirk
    np.testing.assert_allclose(n1, (i1 - mn) / (mx - mn), rtol=1e-6)


@pytest.mark.parametrize("border_out", [True, False])
def test_bicubic_warp(border_out):
    h, w = 13, 17
    img = rand(h, w)
    u = (rng.rand(h, w).astype(np.float32) - 0.5) * 8
    v = (rng.rand(h, w).astype(np.float32) - 0.5) * 8
    out = ops.bicubic_warp(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v), border_out)
    r = ref.bicubic_warp(img, u, v, border_out)
    np.testing.assert_allclose(out, r, atol=1e-5)


def test_bicubic_identity():
    img = rand(9, 9)
    z = np.zeros_like(img)
    out = ops.bicubic_warp(jnp.asarray(img), jnp.asarray(z), jnp.asarray(z), False)
    np.testing.assert_allclose(out, img, atol=1e-6)


def test_flo_roundtrip(tmp_path):
    from faldoi_tpu.io import read_flo, write_flo

    flow = rng.randn(5, 7, 2).astype(np.float32)
    flow[0, 0] = np.nan
    p = str(tmp_path / "t.flo")
    write_flo(p, flow)
    back = read_flo(p)
    np.testing.assert_array_equal(
        np.nan_to_num(back, nan=12345.0), np.nan_to_num(flow, nan=12345.0)
    )


def test_flo_reads_reference_gt():
    f = read_gt()
    assert f.shape == (436, 1024, 2)
    assert np.isfinite(f).all()


def read_gt():
    from faldoi_tpu.io import read_flo

    import os

    return read_flo(os.path.join(os.path.dirname(__file__), "golden",
                                 "gt_easy.flo"))
