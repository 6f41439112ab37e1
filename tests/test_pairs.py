"""Multi-pair throughput mode (``match_growing_pairs``) and the chunked
production path's parity smoke.

The pairs mode grows N frame pairs as 2N unrolled lanes per sweep
program.  Lanes are independent, so with the rung ladder pinned to a
single rung (no shared adaptation schedule) every pair's
result must be BIT-IDENTICAL to its own single-pair ``match_growing``
run — that is the correctness contract these tests gate.

``test_tiny_chunked_parity`` additionally keeps one CHUNKED-path parity
smoke in the fast tier (the fused-path tiny parity tests are
fast-tier, but the chunked dispatch path was
only exercised in the slow tier).
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from faldoi_tpu.io import read_flo
from faldoi_tpu.io.image import read_image_split
from faldoi_tpu.core.preprocess import prepare_pair
from faldoi_tpu.core.match_growing import match_growing, match_growing_pairs
from faldoi_tpu.core.global_step import tvl2_global
from faldoi_tpu import params as P

BASE = "/root/reference/example_data/clean/easy/"
GOLD = "tests/golden/"
SL = np.s_[150:198, 300:364]  # the 48x64 "tiny" crop (run_parity.py)


def _epe(a, b):
    fin = np.isfinite(a[..., 0]) & np.isfinite(b[..., 0])
    return float(np.hypot(a[..., 0] - b[..., 0],
                          a[..., 1] - b[..., 1])[fin].mean())


def _tiny_inputs():
    i0 = read_image_split(BASE + "frame_0002.png")[:, SL[0], SL[1]]
    i1 = read_image_split(BASE + "frame_0003.png")[:, SL[0], SL[1]]
    go = read_flo(GOLD + "deep_mt_1.flo")[SL[0], SL[1]]
    ba = read_flo(GOLD + "deep_mt_2.flo")[SL[0], SL[1]]
    a, b = prepare_pair(i0, i1)
    return go, ba, a, b


def _prm():
    prm = P.Parameters()
    prm.val_method = P.M_TVL1
    prm.iterations_of = P.LOCAL_ITER
    prm.epsilon = P.FB_TOL
    return prm


def test_tiny_chunked_parity(monkeypatch):
    """Fast-tier parity smoke through the CHUNKED production path (the
    dispatch mode bench.py uses), vs the committed reference-binary
    goldens on the tiny crop."""
    monkeypatch.setenv("FALDOI_GROW_PREWARM", "0")
    go, ba, a, b = _tiny_inputs()
    rg, _, _ = match_growing(go, ba, a, b, _prm(), bsz=256, mode="chunked")
    u1, u2 = tvl2_global(a, b, jnp.nan_to_num(jnp.asarray(rg[..., 0])),
                         jnp.nan_to_num(jnp.asarray(rg[..., 1])))
    var = np.stack([np.asarray(u1), np.asarray(u2)], axis=-1)
    assert np.isfinite(rg).all()
    assert _epe(var, read_flo(GOLD + "tiny/m0_var.flo")) <= 0.05
    assert _epe(rg, read_flo(GOLD + "tiny/m0_rg.flo")) <= 0.15


@pytest.mark.slow
def test_pairs_equals_single(monkeypatch):
    """N=1 and N=2 pairs-mode results must equal the single-pair chunked
    path bit-for-bit when the rung ladder is pinned (lanes independent)."""
    monkeypatch.setenv("FALDOI_GROW_LADDER", "256")
    monkeypatch.setenv("FALDOI_GROW_LEAN", "0")
    monkeypatch.setenv("FALDOI_GROW_PREWARM", "0")
    go, ba, a, b = _tiny_inputs()
    prm = _prm()
    prm.iterations_of = 1

    # second pair: a shifted crop of the same frames (different content)
    SL2 = np.s_[100:148, 200:264]
    i0b = read_image_split(BASE + "frame_0002.png")[:, SL2[0], SL2[1]]
    i1b = read_image_split(BASE + "frame_0003.png")[:, SL2[0], SL2[1]]
    go2 = read_flo(GOLD + "deep_mt_1.flo")[SL2[0], SL2[1]]
    ba2 = read_flo(GOLD + "deep_mt_2.flo")[SL2[0], SL2[1]]
    a2, b2 = prepare_pair(i0b, i1b)

    f_single0, _, _ = match_growing(go, ba, a, b, prm, bsz=256,
                                    mode="chunked")
    f_single1, _, _ = match_growing(go2, ba2, a2, b2, prm, bsz=256,
                                    mode="chunked")

    outs1 = match_growing_pairs([(go, ba)], [(a, b)], prm, bsz=256)
    np.testing.assert_array_equal(np.nan_to_num(outs1[0][0]),
                                  np.nan_to_num(f_single0))

    outs2 = match_growing_pairs([(go, ba), (go2, ba2)], [(a, b), (a2, b2)],
                                prm, bsz=256)
    np.testing.assert_array_equal(np.nan_to_num(outs2[0][0]),
                                  np.nan_to_num(f_single0))
    np.testing.assert_array_equal(np.nan_to_num(outs2[1][0]),
                                  np.nan_to_num(f_single1))


@pytest.mark.slow
def test_reference_exact_dials_crop(monkeypatch):
    """Pin the reference-semantics dial setting (full-patch working-flow
    scatter with max-energy arbitration), so silent drift of the exact
    path is caught.  Gates: the r3-era baseline at this crop (rg 0.3452
    measured under the default dials; the exact dials measured tighter)."""
    monkeypatch.setenv("FALDOI_WSCATTER_R", "5")
    monkeypatch.setenv("FALDOI_WSCATTER", "exact")
    monkeypatch.setenv("FALDOI_GROW_PREWARM", "0")
    i0 = read_image_split(BASE + "frame_0002.png")[:, 120:312, 300:556]
    i1 = read_image_split(BASE + "frame_0003.png")[:, 120:312, 300:556]
    go = read_flo(GOLD + "deep_mt_1.flo")[120:312, 300:556]
    ba = read_flo(GOLD + "deep_mt_2.flo")[120:312, 300:556]
    a, b = prepare_pair(i0, i1)
    rg, _, _ = match_growing(go, ba, a, b, _prm(), bsz=2048, mode="chunked")
    u1, u2 = tvl2_global(a, b, jnp.nan_to_num(jnp.asarray(rg[..., 0])),
                         jnp.nan_to_num(jnp.asarray(rg[..., 1])))
    var = np.stack([np.asarray(u1), np.asarray(u2)], axis=-1)
    e_rg = _epe(rg, read_flo(GOLD + "crop/m0_rg.flo"))
    e_var = _epe(var, read_flo(GOLD + "crop/m0_var.flo"))
    print(f"reference-exact dials crop: rg={e_rg:.4f} var={e_var:.4f}")
    assert e_var <= 0.05
    assert e_rg <= 0.36, "reference-exact dial path regressed"
