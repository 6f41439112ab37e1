"""Global-step solver tests: self-consistency on crops (fast) and exact
parity vs the reference binary's output (slow, opt-in via FALDOI_SLOW_TESTS)."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from faldoi_tpu.io import read_flo
from faldoi_tpu.io.image import read_image_split
from faldoi_tpu.core.preprocess import prepare_pair, prepare_triple
from faldoi_tpu.core.global_step import tvl2_global

BASE = "/root/reference/example_data/clean/easy/"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load_crop(crop=(100, 300, 128, 192)):
    from tests import seeded

    return seeded.pair(crop)


def test_global_tvl1_refines_noisy_gt():
    i0, i1, gt = _load_crop()
    a, b = prepare_pair(i0, i1)
    rng = np.random.RandomState(0)
    u1 = jnp.asarray(gt[:, :, 0] + rng.randn(*gt.shape[:2]).astype(np.float32) * 0.5)
    u2 = jnp.asarray(gt[:, :, 1] + rng.randn(*gt.shape[:2]).astype(np.float32) * 0.5)
    r1, r2 = tvl2_global(a, b, u1, u2)
    epe0 = np.hypot(np.asarray(u1) - gt[:, :, 0], np.asarray(u2) - gt[:, :, 1]).mean()
    epe1 = np.hypot(np.asarray(r1) - gt[:, :, 0], np.asarray(r2) - gt[:, :, 1]).mean()
    assert np.isfinite(np.asarray(r1)).all()
    assert epe1 < 0.6 * epe0  # refinement must substantially denoise


def test_global_tvl1_zero_flow_identical_frames():
    i0, _, _ = _load_crop()
    a, b = prepare_pair(i0, i0)
    z = jnp.zeros(a.shape, jnp.float32)
    r1, r2 = tvl2_global(a, b, z, z)
    # identical frames + zero init => flow stays ~0
    assert float(jnp.abs(r1).max()) < 1e-3
    assert float(jnp.abs(r2).max()) < 1e-3


@pytest.mark.skipif(
    not os.environ.get("FALDOI_SLOW_TESTS"),
    reason="full-image parity vs reference binary (slow; set FALDOI_SLOW_TESTS=1)",
)
def test_global_tvl1_parity_with_reference_binary():
    i0 = read_image_split(BASE + "frame_0002.png")
    i1 = read_image_split(BASE + "frame_0003.png")
    gt = read_flo(BASE + "gt/frame_0002.flo")
    golden = read_flo(os.path.join(GOLDEN, "global_tvl1_from_gt.flo"))
    a, b, _ = prepare_triple(i0, i1, i1)
    r1, r2 = tvl2_global(a, b, jnp.asarray(gt[:, :, 0]), jnp.asarray(gt[:, :, 1]))
    d = np.hypot(np.asarray(r1) - golden[:, :, 0], np.asarray(r2) - golden[:, :, 1])
    assert d.mean() < 1e-4 and d.max() < 5e-3
