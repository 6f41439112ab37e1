"""End-to-end growing + global refinement vs COMMITTED reference outputs.

tests/golden/tiny/m0_{rg,var}.flo are the rebuilt reference binaries'
outputs (local_faldoi + global_faldoi, method 0, default params) on the
48x64 clean/easy crop with the cached DeepMatching seeds — captured once by
scripts/run_parity.py (see its docstring for the rebuild recipe).  This test
asserts the production-config pipeline stays within the parity gate WITHOUT
needing the binaries, so CI catches growing/solver regressions.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from faldoi_tpu.io import read_flo
from faldoi_tpu.io.image import read_image_split
from faldoi_tpu.core.preprocess import prepare_pair
from faldoi_tpu.core.match_growing import match_growing
from faldoi_tpu.core.global_step import tvl2_global
from faldoi_tpu import params as P

BASE = "/root/reference/example_data/clean/easy/"
GOLD = "tests/golden/"
SL = np.s_[150:198, 300:364]  # run_parity.py "tiny"


def _epe(a, b):
    fin = np.isfinite(a[..., 0]) & np.isfinite(b[..., 0])
    return float(np.hypot(a[..., 0] - b[..., 0],
                          a[..., 1] - b[..., 1])[fin].mean())


@pytest.fixture(scope="module")
def pipeline_out():
    i0 = read_image_split(BASE + "frame_0002.png")[:, SL[0], SL[1]]
    i1 = read_image_split(BASE + "frame_0003.png")[:, SL[0], SL[1]]
    go = read_flo(GOLD + "deep_mt_1.flo")[SL[0], SL[1]]
    ba = read_flo(GOLD + "deep_mt_2.flo")[SL[0], SL[1]]
    a, b = prepare_pair(i0, i1)
    prm = P.Parameters()
    prm.val_method = P.M_TVL1
    prm.iterations_of = P.LOCAL_ITER
    prm.epsilon = P.FB_TOL
    rg, _, _ = match_growing(go, ba, a, b, prm, bsz=256, mode="fused")
    u1, u2 = tvl2_global(a, b, jnp.nan_to_num(jnp.asarray(rg[..., 0])),
                         jnp.nan_to_num(jnp.asarray(rg[..., 1])))
    var = np.stack([np.asarray(u1), np.asarray(u2)], axis=-1)
    return rg, var


def test_var_matches_reference_binaries(pipeline_out):
    _, var = pipeline_out
    ref = read_flo(GOLD + "tiny/m0_var.flo")
    assert _epe(var, ref) <= 0.05, "final var EPE vs reference binaries"


def test_rg_close_to_reference_binaries(pipeline_out):
    rg, _ = pipeline_out
    ref = read_flo(GOLD + "tiny/m0_rg.flo")
    # rg-level gate: wavefront-vs-serial ordering still costs ~0.1 px at
    # this crop (PARITY.md "Known deviations"); this bound catches
    # regressions while the ordering work continues
    assert _epe(rg, ref) <= 0.15, "rg EPE vs reference binaries"


def test_growing_fills_every_pixel():
    """Property from SURVEY §4: the growing must fill 100% of pixels (the
    reference's local_growing drains the queue until every pixel pops).
    Run on the seeded pair's tiny crop with its DeepMatching-position
    seeds."""
    from faldoi_tpu.synthetic import make_pair

    pair = make_pair(0, (SL[0].start, SL[1].start, 48, 64))
    a, b = prepare_pair(pair.i0, pair.i1)
    prm = P.Parameters()
    prm.val_method = P.M_TVL1
    prm.iterations_of = P.LOCAL_ITER
    prm.epsilon = P.FB_TOL
    rg, _, _ = match_growing(pair.seeds_fwd, pair.seeds_bwd, a, b, prm,
                             bsz=256, mode="fused")
    assert np.isfinite(rg).all(), "unfilled pixels in the growing output"


@pytest.mark.slow
@pytest.mark.parametrize("method", [4, 5, 6, 7])
def test_csad_family_e2e_vs_reference_binaries(method, tmp_path,
                                               monkeypatch):
    """CSAD-family (m4-m7) end-to-end local+global vs COMMITTED reference
    binary outputs (tests/golden/tiny/m{4..7}_{rg,var}.flo, captured by
    scripts/run_parity.py from the rebuilt binaries — tvcsad_model.cpp:265,
    tvcsadw_model.cpp:276, nltvcsad_model.cpp:297, nltvcsadw_model.cpp:299).
    Runs the production CLI path (method dispatch, inert-TV quirk, exact
    raster-GS fill) on the 48x64 tiny crop with the cached DeepMatching
    seeds.

    GATES — chaos-informed, NOT the 0.05 px m0 gate (r4 finding, measured
    by scripts/csad_chaos_probe.py): the CSAD local solvers are data-prox-
    only in practice (inert-TV quirk), so the serial pop ORDER passes
    straight into the output, and the order is decided by float-LSB energy
    comparisons.  The REFERENCE BINARIES THEMSELVES, fed seeds perturbed
    by +-1e-5 px, move their own output by rg 0.363 / var 0.167 mean EPE
    on this exact crop (m0 contrast: 0.020 / 0.002).  A 0.05 var gate is
    therefore ~3x below the reference's own reproducibility floor for
    this family.  We gate on (a) staying within the measured chaos
    envelope (var <= 0.25, rg <= 0.50) and (b) GT-quality equivalence
    (|ours-vs-GT − ref-vs-GT| <= 0.05) — the two properties that ARE
    stable functions of the input."""
    from PIL import Image

    from faldoi_tpu.io import write_flo
    from faldoi_tpu.cli import local_faldoi as lcli
    from faldoi_tpu.cli import global_faldoi as gcli

    # chunked dispatch: the CSAD methods' exact raster-GS fill makes the
    # single-program fused growing a multi-hour compile on this 1-core
    # host; the chunked programs are half the size and compile-cached.
    # Single-rung ladder: otherwise 4 rungs x 2 first_iter variants of
    # the heavy program would compile per method (the accept rule is
    # rung-invariant — the rank floor pins to the nominal bsz).
    monkeypatch.setenv("FALDOI_GROW_MODE", "chunked")
    monkeypatch.setenv("FALDOI_GROW_PREWARM", "0")
    monkeypatch.setenv("FALDOI_GROW_LADDER", "4096")

    names = []
    for k, f in enumerate(["frame_0002.png", "frame_0003.png"]):
        im = np.asarray(Image.open(BASE + f))[SL[0], SL[1]]
        p = str(tmp_path / f"f{k}.png")
        Image.fromarray(im).save(p)
        names.append(p)
    ims = str(tmp_path / "ims.txt")
    open(ims, "w").write("\n".join(names) + "\n")
    seeds = []
    for k in (1, 2):
        f = read_flo(GOLD + f"deep_mt_{k}.flo")[SL[0], SL[1]]
        p = str(tmp_path / f"mt_{k}.flo")
        write_flo(p, f)
        seeds.append(p)

    rg_p = str(tmp_path / "rg.flo")
    var_p = str(tmp_path / "var.flo")
    m = str(method)
    assert lcli.main([ims, seeds[0], seeds[1], rg_p,
                      str(tmp_path / "sim.tiff"), "-m", m]) == 0
    assert gcli.main([ims, rg_p, var_p, "-m", m]) == 0

    var = read_flo(var_p)
    rg = read_flo(rg_p)
    ref_var = read_flo(GOLD + f"tiny/m{method}_var.flo")
    ref_rg = read_flo(GOLD + f"tiny/m{method}_rg.flo")
    gt = read_flo(BASE + "gt/frame_0002.flo")[SL[0], SL[1]]
    e_var = _epe(var, ref_var)
    e_rg = _epe(rg, ref_rg)
    ours_gt = _epe(var, gt)
    ref_gt = _epe(ref_var, gt)
    print(f"m{method} tiny e2e: var={e_var:.4f} rg={e_rg:.4f} "
          f"ours-gt={ours_gt:.4f} ref-gt={ref_gt:.4f}")
    assert e_var <= 0.25, (
        f"m{method} var EPE {e_var:.3f} outside the reference's own "
        "chaos envelope (0.167 measured, csad_chaos_probe.py)")
    assert e_rg <= 0.50, (
        f"m{method} rg EPE {e_rg:.3f} outside the chaos envelope (0.363)")
    assert abs(ours_gt - ref_gt) <= 0.05, (
        f"m{method} GT-quality not equivalent: ours {ours_gt:.3f} vs "
        f"reference {ref_gt:.3f}")
