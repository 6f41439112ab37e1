"""The sweep's patch crop, the bicubic gather warps and the candidate
selection against NumPy references, at the frame widths the pipeline meets
(64 .. 1035 = 1024 columns + the 11-px crop pad)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from faldoi_tpu.core.local_step import select_candidates
from faldoi_tpu.core.patch_solver import crop_padded
from faldoi_tpu.ops.bicubic import (
    bicubic_interp_at, bicubic_warp, bicubic_warp_stack,
)
from tests import ref_numpy as ref

WIDTHS = [64, 97, 128, 200, 1035]
P = 11


def _patch_coords(rng, h, w, n, spread):
    """(n, P, P) sample positions of patches at the corner, the far edge
    and random origins, displaced by up to ``spread`` px."""
    oy = np.r_[0, h - P, rng.randint(0, h - P + 1, n - 2)]
    ox = np.r_[0, w - P, rng.randint(0, w - P + 1, n - 2)]
    ar = np.arange(P, dtype=np.float32)
    uu = ox[:, None, None] + ar[None, None, :] + (
        rng.rand(n, P, P).astype(np.float32) - 0.5) * 2 * spread
    vv = oy[:, None, None] + ar[None, :, None] + (
        rng.rand(n, P, P).astype(np.float32) - 0.5) * 2 * spread
    return uu.astype(np.float32), vv.astype(np.float32)


@pytest.mark.parametrize("w", WIDTHS)
def test_crop_padded_is_an_exact_copy(w):
    """Crops of the channels-last state stack equal NumPy slicing bit for
    bit, NaN cells included, at origins up to the last column."""
    rng = np.random.RandomState(w)
    h, c = 23, 5
    planes = rng.randn(h, w, c).astype(np.float32)
    planes[rng.rand(h, w) < 0.3, :2] = np.nan
    stack = np.pad(planes, ((0, P), (0, P), (0, 0)), mode="edge")
    oy = np.r_[0, h - 1, rng.randint(0, h, 30)]
    ox = np.r_[0, w - 1, rng.randint(0, w, 30)]
    got = np.asarray(jax.vmap(lambda a, b: crop_padded(
        jnp.asarray(stack), a, b, P))(oy, ox))
    ar = np.arange(P)
    want = stack[oy[:, None, None] + ar[None, :, None],
                 ox[:, None, None] + ar[None, None, :]]
    assert got.shape == (len(oy), P, P, c)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("border_out", [True, False])
@pytest.mark.parametrize("w", WIDTHS)
def test_patch_warp_matches_reference(w, border_out):
    """One 4x4x3 gather per sample equals the float64 reference stencil
    on every plane, and each plane equals its own single-plane warp."""
    rng = np.random.RandomState(w + border_out)
    h = 19
    planes = rng.rand(h, w, 3).astype(np.float32)
    uu, vv = _patch_coords(rng, h, w, 16, spread=8.0)
    got = np.asarray(bicubic_interp_at(jnp.asarray(planes), uu, vv,
                                       border_out))
    assert got.shape == uu.shape + (3,)
    for c in range(3):
        want = ref.bicubic_at_vec(planes[..., c], uu, vv, border_out)
        np.testing.assert_allclose(got[..., c], want, atol=1e-5)
        one = bicubic_interp_at(jnp.asarray(planes[..., c]), uu, vv,
                                border_out)
        np.testing.assert_allclose(got[..., c], one, atol=1e-6)


@pytest.mark.parametrize("border_out", [True, False])
def test_vectorised_reference_matches_scalar_oracle(border_out):
    """The float64 vectorised stencil (used for whole-frame checks) agrees
    with the loop-for-loop transliteration, far outside the image too."""
    rng = np.random.RandomState(3)
    img = rng.rand(13, 17).astype(np.float32)
    uu = rng.uniform(-6, 23, 200).astype(np.float32)
    vv = rng.uniform(-6, 19, 200).astype(np.float32)
    vec = ref.bicubic_at_vec(img, uu, vv, border_out)
    loop = [ref.bicubic_at(img, u, v, border_out) for u, v in zip(uu, vv)]
    np.testing.assert_allclose(vec, loop, atol=1e-5)


@pytest.mark.parametrize("border_out", [True, False])
def test_warp_stack_matches_reference(border_out):
    """The whole-image warp of stacked planes equals the reference warp of
    each plane."""
    rng = np.random.RandomState(5)
    h, w = 50, 70
    planes = rng.rand(3, h, w).astype(np.float32)
    u = (rng.rand(h, w).astype(np.float32) - 0.5) * 30
    v = (rng.rand(h, w).astype(np.float32) - 0.5) * 30
    out = np.asarray(bicubic_warp_stack(jnp.asarray(planes), jnp.asarray(u),
                                        jnp.asarray(v), border_out))
    assert out.shape == planes.shape
    for c in range(3):
        np.testing.assert_allclose(out[c], ref.bicubic_warp(
            planes[c], u, v, border_out), atol=1e-5)


def test_warp_far_outside_clamps_like_reference():
    """Samples far outside the image (beyond any window) clamp to the
    Neumann border exactly as the reference does."""
    rng = np.random.RandomState(7)
    img = rng.rand(40, 56).astype(np.float32)
    uu = np.linspace(-150.0, 210.0, 49, dtype=np.float32).reshape(7, 7)
    vv = np.linspace(-90.0, 130.0, 49, dtype=np.float32).reshape(7, 7)
    got = np.asarray(bicubic_interp_at(jnp.asarray(img), uu, vv, False))
    want = [[ref.bicubic_at(img, u, v, False) for u, v in zip(ru, rv)]
            for ru, rv in zip(uu, vv)]
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_warp_nan_reaches_only_its_stencils():
    """A NaN image cell poisons exactly the samples whose 4x4 stencil reads
    it; every other sample is finite and unchanged."""
    rng = np.random.RandomState(11)
    img = rng.rand(30, 40).astype(np.float32)
    bad = img.copy()
    bad[15, 20] = np.nan
    vv, uu = np.mgrid[10:20:0.37, 14:26:0.41].astype(np.float32)
    clean = np.asarray(bicubic_interp_at(jnp.asarray(img), uu, vv, False))
    got = np.asarray(bicubic_interp_at(jnp.asarray(bad), uu, vv, False))
    iu = np.trunc(uu).astype(int)
    iv = np.trunc(vv).astype(int)
    reads = (np.abs(20 - iu - 0.5) <= 2) & (np.abs(15 - iv - 0.5) <= 2)
    assert np.isnan(got[reads]).any()
    assert not np.isnan(got[~reads]).any()
    np.testing.assert_array_equal(got[~np.isnan(got)], clean[~np.isnan(got)])


def test_bicubic_warp_identity_on_channels():
    """Zero flow returns every plane unchanged."""
    rng = np.random.RandomState(2)
    planes = rng.rand(9, 9, 3).astype(np.float32)
    z = np.zeros((9, 9), np.float32)
    for c in range(3):
        np.testing.assert_allclose(
            bicubic_warp(jnp.asarray(planes[..., c]), z, z, False),
            planes[..., c], atol=1e-6)


@pytest.mark.parametrize("k", [1, 64, 512])
def test_select_candidates_matches_argsort(k):
    """The k lowest eligible energies with their indices, ascending; inf
    (ineligible) never outranks a finite energy."""
    rng = np.random.RandomState(k)
    n = 5000
    e = np.round(rng.rand(n), 3).astype(np.float32)   # many ties
    e[rng.rand(n) < 0.4] = np.inf
    e_pop, idx = select_candidates(jnp.asarray(e), k)
    e_pop, idx = np.asarray(e_pop), np.asarray(idx)
    want = np.sort(e)[:k]
    np.testing.assert_array_equal(e_pop, want)
    np.testing.assert_array_equal(e[idx], e_pop)
    strict = set(np.nonzero(e < want[-1])[0].tolist())
    assert strict <= set(idx.tolist())


def test_select_candidates_short_queue():
    """With fewer eligible pixels than slots, every eligible pixel is
    selected and the rest of the batch is inf."""
    e = np.full(300, np.inf, np.float32)
    e[[5, 17, 250]] = [0.3, 0.1, 0.2]
    e_pop, idx = select_candidates(jnp.asarray(e), 8)
    np.testing.assert_array_equal(np.asarray(idx)[:3], [17, 250, 5])
    assert np.isinf(np.asarray(e_pop)[3:]).all()
