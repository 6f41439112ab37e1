"""The seeded Sintel-shape pair and the NumPy-only frame formats the smoke
run writes."""

import numpy as np
import pytest

import jax.numpy as jnp

from faldoi_tpu.core.sparse import sparse_flow_from_matches
from faldoi_tpu.io.image import (
    read_image_split, save_image_float, save_image_int, write_netpbm,
)
from faldoi_tpu.ops.bicubic import bicubic_warp
from faldoi_tpu.synthetic import epe, make_pair, write_matches

CROP = (150, 300, 48, 64)


@pytest.fixture(scope="module")
def pair():
    return make_pair(0, CROP)


def test_known_flow_warps_i1_onto_i0(pair):
    """I1 warped by the known flow reproduces I0 far better than I1 does:
    the flow runs from I0 to I1 in the pipeline's convention."""
    i0 = pair.i0.mean(axis=0)
    i1 = pair.i1.mean(axis=0)
    warped = np.asarray(bicubic_warp(jnp.asarray(i1), pair.flow[..., 0],
                                     pair.flow[..., 1], False))
    inner = np.s_[8:-8, 12:-8]
    assert np.abs(warped - i0)[inner].mean() < 0.1 * np.abs(i1 - i0)[
        inner].mean()


def test_crop_is_a_window_of_the_full_pair(pair):
    full = make_pair(0)
    y0, x0, h, w = CROP
    np.testing.assert_array_equal(pair.i0, full.i0[:, y0:y0 + h, x0:x0 + w])
    np.testing.assert_array_equal(pair.i1, full.i1[:, y0:y0 + h, x0:x0 + w])
    assert full.i0.shape == (3, 436, 1024) and len(full.matches_fwd) == 1703


def test_seeds_carry_the_known_flow(pair):
    fin = np.isfinite(pair.seeds_fwd[..., 0])
    assert fin.sum() == len(pair.matches_fwd) > 0
    np.testing.assert_allclose(pair.seeds_fwd[fin], pair.flow[fin],
                               atol=1e-5)
    # backward seeds: the negated flow, at the displaced positions
    h, w = pair.flow.shape[:2]
    src = pair.matches_fwd[:, :2].astype(int)
    dst = np.floor(pair.matches_bwd[:, :2]).astype(int)
    ok = (dst[:, 0] >= 0) & (dst[:, 0] < w) & (dst[:, 1] >= 0) & (
        dst[:, 1] < h)
    assert ok.sum() > 0
    got = pair.seeds_bwd[dst[ok, 1], dst[ok, 0]]
    want = -pair.flow[src[ok, 1], src[ok, 0]]
    assert epe(got[None], want[None]) < 1e-4


def test_match_files_round_trip(pair, tmp_path):
    from faldoi_tpu.core.sparse import sparse_flow

    p = str(tmp_path / "m.txt")
    write_matches(p, pair.matches_bwd)
    h, w = pair.flow.shape[:2]
    got = sparse_flow(p, w, h)
    want = sparse_flow_from_matches(pair.matches_bwd, w, h)
    np.testing.assert_array_equal(np.nan_to_num(got, nan=9.0),
                                  np.nan_to_num(want, nan=9.0))


def test_netpbm_and_pfm_round_trip(pair, tmp_path):
    rgb = pair.i0.transpose(1, 2, 0)
    write_netpbm(str(tmp_path / "f.ppm"), rgb)
    np.testing.assert_array_equal(read_image_split(str(tmp_path / "f.ppm")),
                                  pair.i0)
    save_image_int(str(tmp_path / "m.pgm"), (pair.i1[0] > 128).astype(int))
    np.testing.assert_array_equal(read_image_split(str(tmp_path / "m.pgm"))[0],
                                  (pair.i1[0] > 128).astype(np.float32))
    ene = np.random.RandomState(0).randn(*rgb.shape[:2]).astype(np.float32)
    save_image_float(str(tmp_path / "e.pfm"), ene)
    np.testing.assert_array_equal(read_image_split(str(tmp_path / "e.pfm"))[0],
                                  ene)
