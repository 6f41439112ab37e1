"""Crop-scale rg regression gate.

``tests/golden/crop/m0_{rg,var}.flo`` are the rebuilt reference binaries'
outputs (local_faldoi + global_faldoi, method 0, default params) on the
192x256 clean/easy crop ([120:312, 300:556], run_parity.py "crop") with
the cached DeepMatching seeds.  The tiny 48x64 e2e test is too small to
see the ordering-frontier regressions that matter at full scale (seed-
sparse corridors, multi-front arbitration); this crop contains both.

Gates: var <= 0.05 (the BASELINE.md parity gate) and rg <= 0.45 (the
shipping ordering frontier's regression bound — measured r4 baseline at
this crop: rg 0.3452 / var 0.0273 with the shipping config; full-scale
shipping rg is ~0.25.  The crop is seed-sparser than full scale, so its
ordering drift runs higher.  The bound catches regressions of the class
that took rg past 0.5 pre-seedfix without blessing the current frontier,
PARITY.md deviation #1)."""

import numpy as np
import pytest

from faldoi_tpu.io import read_flo
from faldoi_tpu.io.image import read_image_split
from faldoi_tpu.core.preprocess import prepare_pair
from faldoi_tpu.core.match_growing import match_growing
from faldoi_tpu.core.global_step import tvl2_global
from faldoi_tpu import params as P

import jax.numpy as jnp

BASE = "/root/reference/example_data/clean/easy/"
GOLD = "tests/golden/"
SL = np.s_[120:312, 300:556]  # run_parity.py "crop"


def _epe(a, b):
    fin = np.isfinite(a[..., 0]) & np.isfinite(b[..., 0])
    return float(np.hypot(a[..., 0] - b[..., 0],
                          a[..., 1] - b[..., 1])[fin].mean())


@pytest.mark.slow
def test_crop_rg_and_var_regression(monkeypatch):
    monkeypatch.setenv("FALDOI_GROW_MODE", "chunked")
    monkeypatch.setenv("FALDOI_GROW_PREWARM", "0")
    i0 = read_image_split(BASE + "frame_0002.png")[:, SL[0], SL[1]]
    i1 = read_image_split(BASE + "frame_0003.png")[:, SL[0], SL[1]]
    go = read_flo(GOLD + "deep_mt_1.flo")[SL[0], SL[1]]
    ba = read_flo(GOLD + "deep_mt_2.flo")[SL[0], SL[1]]
    a, b = prepare_pair(i0, i1)
    prm = P.Parameters()
    prm.val_method = P.M_TVL1
    prm.iterations_of = P.LOCAL_ITER
    prm.epsilon = P.FB_TOL
    # shipping config (match_growing defaults: delta 0.05, delta_rel 0.5,
    # floor_scale 64, warm band 10, adaptive ladder)
    rg, _, _ = match_growing(go, ba, a, b, prm, bsz=2048)
    u1, u2 = tvl2_global(a, b, jnp.nan_to_num(jnp.asarray(rg[..., 0])),
                         jnp.nan_to_num(jnp.asarray(rg[..., 1])))
    var = np.stack([np.asarray(u1), np.asarray(u2)], axis=-1)

    e_rg = _epe(rg, read_flo(GOLD + "crop/m0_rg.flo"))
    e_var = _epe(var, read_flo(GOLD + "crop/m0_var.flo"))
    print(f"crop regression: rg={e_rg:.4f} var={e_var:.4f}")
    assert e_var <= 0.05, "crop var EPE vs reference binaries"
    assert e_rg <= 0.45, "crop rg EPE regression bound (ordering frontier)"
