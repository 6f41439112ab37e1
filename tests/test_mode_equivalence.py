"""Fused / chunked / step dispatch modes must produce identical growings.

The three modes run the same ``_sweep_body`` math at different dispatch
granularity (one device program / bounded chunks / one sweep per launch), so
their outputs must match exactly.  Any divergence is a knob-threading bug —
round 2 shipped two of exactly this class (grow_chunk silently dropped
delta_rel/floor_scale, grow_step dropped block), which no test caught.
"""

import numpy as np
import pytest

from faldoi_tpu.io import read_flo
from faldoi_tpu.io.image import read_image_split
from faldoi_tpu.core.preprocess import prepare_pair
from faldoi_tpu.core.match_growing import match_growing
from faldoi_tpu import params as P

BASE = "/root/reference/example_data/clean/easy/"
GOLD = "tests/golden/"
SL = np.s_[150:198, 300:364]  # 48x64 tiny crop (run_parity.py "tiny")


@pytest.fixture(scope="module")
def fixture():
    i0 = read_image_split(BASE + "frame_0002.png")[:, SL[0], SL[1]]
    i1 = read_image_split(BASE + "frame_0003.png")[:, SL[0], SL[1]]
    go = read_flo(GOLD + "deep_mt_1.flo")[SL[0], SL[1]]
    ba = read_flo(GOLD + "deep_mt_2.flo")[SL[0], SL[1]]
    a, b = prepare_pair(i0, i1)
    prm = P.Parameters()
    prm.val_method = P.M_TVL1
    # one outer iteration + the final drain hits every code path (drain,
    # prune, requeue, re-drain) at a third of LOCAL_ITER's cost
    prm.iterations_of = 1
    prm.epsilon = P.FB_TOL
    return go, ba, a, b, prm


def _grow(fixture, mode, **kw):
    go, ba, a, b, prm = fixture
    flow, ene, _ = match_growing(go, ba, a, b, prm, bsz=256, mode=mode, **kw)
    return flow, ene


@pytest.mark.slow
@pytest.mark.parametrize("knobs", [
    # the production config PLUS block-local bands: block>0 exercises the
    # widest knob plumbing (the class of bug this test exists to catch)
    dict(delta=0.01, delta_rel=0.5, floor_scale=64, fill="patch", block=16),
], ids=["block16"])
def test_modes_equivalent(fixture, monkeypatch, knobs):
    # hermetic: env knobs must not override the explicit arguments
    for var in ("FALDOI_GROW_MODE", "FALDOI_GROW_DELTA", "FALDOI_GROW_BSZ",
                "FALDOI_GROW_FLOOR", "FALDOI_GROW_DELTA_REL",
                "FALDOI_GROW_FLOOR_SCALE", "FALDOI_GROW_BLOCK",
                "FALDOI_GROW_CHUNK", "FALDOI_GROW_FILL"):
        monkeypatch.delenv(var, raising=False)

    flows = {}
    enes = {}
    for mode in ("fused", "chunked", "step"):
        flows[mode], enes[mode] = _grow(fixture, mode, **knobs)

    for mode in ("chunked", "step"):
        for ch in range(2):
            a = flows["fused"][..., ch]
            b = flows[mode][..., ch]
            assert np.array_equal(np.isnan(a), np.isnan(b)), (
                f"{mode} vs fused: different unfixed sets ({knobs})"
            )
            fin = np.isfinite(a)
            np.testing.assert_allclose(
                a[fin], b[fin], rtol=0, atol=1e-5,
                err_msg=f"{mode} vs fused flow ch{ch} ({knobs})",
            )


@pytest.mark.slow
def test_ordering_dials_enter_jit_key(fixture, monkeypatch):
    """An ordering-dial env knob flipped IN-PROCESS must retrace the sweep
    programs, not silently reuse the cached no-dial compile.

    Caught live: FALDOI_GROW_EXACTMIN
    set after a prior growing had compiled the sweep programs produced
    bit-identical outputs to the cached no-exactmin program — the knob was
    read at trace time without being part of the jit cache key.  The dials
    now travel as a static argument (local_step.ordering_dials)."""
    monkeypatch.delenv("FALDOI_GROW_EXACTMIN", raising=False)
    base, _ = _grow(fixture, "chunked")
    monkeypatch.setenv("FALDOI_GROW_EXACTMIN", "11")
    em, _ = _grow(fixture, "chunked")
    assert not np.allclose(np.nan_to_num(base), np.nan_to_num(em)), (
        "EXACTMIN=11 output is bit-identical to the default — the env dial "
        "did not invalidate the jit cache"
    )
