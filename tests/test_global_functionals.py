"""Global-step property tests for the non-TVL1 functionals (small crops,
reduced iterations — full-iteration parity lives in scripts/run_parity.py
and tests/golden/)."""

import numpy as np
import pytest

import jax.numpy as jnp

from faldoi_tpu.core.preprocess import prepare_pair, prepare_quad
from tests import seeded

CROP = (100, 300, 64, 96)


@pytest.fixture(scope="module")
def scene():
    i0, i1, gt = seeded.pair(CROP)
    a, b = prepare_pair(i0, i1)
    rng = np.random.RandomState(0)
    u1 = jnp.asarray(gt[:, :, 0] + rng.randn(*a.shape).astype(np.float32) * 0.5)
    u2 = jnp.asarray(gt[:, :, 1] + rng.randn(*a.shape).astype(np.float32) * 0.5)
    return i0, a, b, gt, u1, u2


def _epe(r1, r2, gt):
    return float(np.hypot(np.asarray(r1) - gt[:, :, 0],
                          np.asarray(r2) - gt[:, :, 1]).mean())


def test_nltvl1_global_refines(scene):
    from faldoi_tpu.core.global_step_nltv import nltvl1_global

    i0, a, b, gt, u1, u2 = scene
    r1, r2 = nltvl1_global(a, b, i0, u1, u2, 2.0, 0.3, 0.1, 2, max_iters=60)
    assert np.isfinite(np.asarray(r1)).all()
    assert _epe(r1, r2, gt) < 0.75 * _epe(u1, u2, gt)


def test_tvcsad_global_refines(scene):
    from faldoi_tpu.core.global_step_csad import tvcsad_global

    i0, a, b, gt, u1, u2 = scene
    r1, r2 = tvcsad_global(a, b, u1, u2, 0.85, 0.3, 0.125, 0.01, 2,
                           max_iters=60)
    assert np.isfinite(np.asarray(r1)).all()
    assert _epe(r1, r2, gt) < 0.6 * _epe(u1, u2, gt)


def test_nltvcsad_global_refines(scene):
    from faldoi_tpu.core.global_step_csad import nltvcsad_global

    i0, a, b, gt, u1, u2 = scene
    r1, r2 = nltvcsad_global(a, b, i0, u1, u2, 0.85, 0.3, 0.1, 2, max_iters=60)
    assert np.isfinite(np.asarray(r1)).all()
    assert _epe(r1, r2, gt) < 0.8 * _epe(u1, u2, gt)


def test_occ_global_refines_and_binarizes():
    from faldoi_tpu.core.occlusion import tvl2_occ_global
    from faldoi_tpu import params as P

    *pl, gt = seeded.quad(CROP)
    i0n, i1n, i_1n, i2n = prepare_quad(*pl)
    rng = np.random.RandomState(0)
    u1 = jnp.asarray(gt[:, :, 0] + rng.randn(*i0n.shape).astype(np.float32) * 0.3)
    u2 = jnp.asarray(gt[:, :, 1] + rng.randn(*i0n.shape).astype(np.float32) * 0.3)
    prm = P.Parameters()
    prm.warps = 1
    prm.iterations_of = 15
    r1, r2, chi = tvl2_occ_global(i0n, i1n, i_1n, u1, u2, None, prm)
    assert np.isfinite(np.asarray(r1)).all()
    assert set(np.unique(np.asarray(chi))) <= {0.0, 1.0}
    assert _epe(r1, r2, gt) < _epe(u1, u2, gt)
