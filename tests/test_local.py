"""Local-step machinery tests: Poisson fill vs the C oracle, patch solver
behaviour, sparse rasterisation, and a small end-to-end growing."""

import numpy as np
import pytest

import jax.numpy as jnp

from faldoi_tpu.ops.poisson import poisson_fill_batch
from tests import ref_numpy as ref

rng = np.random.RandomState(1)


@pytest.mark.parametrize("ph,pw", [(11, 11), (11, 7), (3, 3)])
def test_poisson_fill_close_to_reference(ph, pw):
    P = 11
    x = np.full((P, P), np.nan, np.float32)
    # a few data points inside the valid box
    pts = [(0, 0), (ph - 1, pw - 1), (ph // 2, pw // 2)]
    for (j, i) in pts:
        x[j, i] = rng.rand() * 4 - 2
    out = np.asarray(
        poisson_fill_batch(
            jnp.asarray(x)[None], jnp.asarray([ph]), jnp.asarray([pw])
        )
    )[0]
    want = ref.elap_recursive(x[:ph, :pw].copy(), 0.4, 3, 7)
    # anti-diagonal wavefront == raster GS exactly (see ops/poisson._relax)
    assert np.isfinite(out[:ph, :pw]).all()
    np.testing.assert_allclose(out[:ph, :pw], want, atol=1e-5)
    # data points must be preserved exactly
    for (j, i) in pts:
        assert out[j, i] == x[j, i]
    # outside the box is zero
    assert np.all(out[ph:, :] == 0) and np.all(out[:, pw:] == 0)


def test_poisson_fill_constant_from_single_seed():
    P = 3
    x = np.full((P, P), np.nan, np.float32)
    x[1, 1] = 2.5
    out = np.asarray(
        poisson_fill_batch(jnp.asarray(x)[None], jnp.asarray([3]), jnp.asarray([3]))
    )[0]
    assert out[1, 1] == 2.5
    assert np.all(np.abs(out - 2.5) < 2.5)  # pulled toward the seed


def test_sparse_flow_matches_reference_binary_fixture(tmp_path):
    from faldoi_tpu.core.sparse import sparse_flow

    p = tmp_path / "m.txt"
    p.write_text("1.2 0.7 3.2 2.7\n0 0 1 1\n")
    out = sparse_flow(str(p), 3, 2)
    assert out[0, 1, 0] == 2.0 and out[0, 1, 1] == 2.0
    assert out[0, 0, 0] == 1.0 and out[0, 0, 1] == 1.0
    assert np.isnan(out[1, 2, 0])


def test_patch_solver_keeps_good_flow():
    """A patch initialised with the GT flow should keep energy low and not
    drift much after the PD iterations."""
    from faldoi_tpu.core.preprocess import prepare_pair
    from faldoi_tpu.core.patch_solver import PatchBatch, solve_patch_batch
    from faldoi_tpu.ops.stencils import centered_gradient
    from tests import seeded

    i0, i1, gt = seeded.pair((100, 300, 64, 64))
    a, b = prepare_pair(i0, i1)
    i1x, i1y = centered_gradient(b)

    P = 11
    oy, ox = 20, 20
    u1 = jnp.asarray(gt[oy : oy + P, ox : ox + P, 0])[None]
    u2 = jnp.asarray(gt[oy : oy + P, ox : ox + P, 1])[None]
    batch = PatchBatch(
        oy=jnp.asarray([oy]), ox=jnp.asarray([ox]),
        ph=jnp.asarray([P]), pw=jnp.asarray([P]),
        u1=u1, u2=u2,
    )
    su, sv, ener = solve_patch_batch(b, i1x, i1y, a, batch)
    assert np.isfinite(float(ener[0]))
    assert float(ener[0]) < 5.0
    drift = np.abs(np.asarray(su)[0] - np.asarray(u1)[0]).mean()
    assert drift < 0.5


def test_matchlist_roundtrip(tmp_path):
    from faldoi_tpu.matchers import cut_deep_list, delete_outliers

    raw = tmp_path / "m.txt"
    raw.write_text("1 2 3 4 0.5 0\n5 6 7 8 0.01 1\n")
    out = delete_outliers(str(raw), 0.045)
    kept = open(out).read().strip().splitlines()
    assert len(kept) == 1 and kept[0].startswith("1 2 3 4")
    cut = cut_deep_list(out)
    assert open(cut).read().strip() == "1 2 3 4"
