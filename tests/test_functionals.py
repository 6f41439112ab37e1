"""Canvas-solver tests for the functional family (methods 0-8).

Full-growing tests for every method are too compile-heavy for the CPU
tier; we cover each solver at the canvas level on the seeded pair (finite,
plausible energy, known-flow stability) and reserve whole-pipeline parity
for the golden scripts.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from faldoi_tpu.core.preprocess import prepare_pair, prepare_quad
from faldoi_tpu.core.functionals import SOLVERS, make_solver_consts
from faldoi_tpu.core.patch_solver import pad_for_crops
from faldoi_tpu.ops.stencils import centered_gradient
from faldoi_tpu import params as P
from tests import seeded

CROP = (150, 300, 48, 64)
WR = 5
CANVAS = 2 * WR + 1


@pytest.fixture(scope="module")
def scene():
    i0, i1, gt = seeded.pair(CROP)
    a, b = prepare_pair(i0, i1)
    i1x, i1y = centered_gradient(b)
    return i0, i1, gt, a, b, i1x, i1y


@pytest.mark.parametrize("method", [P.M_TVL1, P.M_TVL1_W, P.M_NLTVL1,
                                    P.M_TVCSAD, P.M_NLTVCSAD_W])
def test_canvas_solver_finite_and_stable(scene, method):
    i0, i1, gt, a, b, i1x, i1y = scene
    from faldoi_tpu.models import method_local_params

    lam, theta, tau = method_local_params(method, WR)
    sc = make_solver_consts(method, pad_for_crops(a, CANVAS), b, i1x, i1y,
                            lam, theta, tau, 0.01, wr=WR, i0_planes=i0,
                            p=CANVAS)
    solver = SOLVERS[method]
    # interior patch initialised with GT flow
    oy, ox = 18, 20
    u1 = jnp.asarray(gt[oy : oy + CANVAS, ox : ox + CANVAS, 0])
    u2 = jnp.asarray(gt[oy : oy + CANVAS, ox : ox + CANVAS, 1])
    chi = jnp.zeros_like(u1)
    # full interior box and a clamped corner box
    for (o_y, o_x, ph, pw) in [(oy, ox, CANVAS, CANVAS), (0, 0, 6, 6)]:
        r1, r2, rc, e = solver(sc, o_x + 1, o_y + 1, o_y, o_x, ph, pw,
                               u1, u2, chi, CANVAS, 1, 4, WR)
        box1 = np.asarray(r1)[:ph, :pw]
        assert np.isfinite(box1).all()
        assert np.isfinite(float(e)) and float(e) >= 0.0
        if ph == CANVAS:  # GT init should not drift far in 4 iterations
            drift = np.abs(box1 - np.asarray(u1)[:ph, :pw]).mean()
            assert drift < 1.0


def test_occ_canvas_solver(scene):
    *pl, gt = seeded.quad(CROP)
    i0n, i1n, i_1n, i2n = prepare_quad(*pl)
    i1x, i1y = centered_gradient(i1n)
    i_1x, i_1y = centered_gradient(i_1n)
    i0x, i0y = centered_gradient(i0n)
    from faldoi_tpu.core.occlusion import init_weight

    prm = P.Parameters()
    sc = make_solver_consts(P.M_TVL1_OCC, pad_for_crops(i0n, CANVAS), i1n,
                            i1x, i1y, prm.lambda_, prm.theta, prm.tau,
                            prm.tol_OF, wr=WR, p=CANVAS)
    sc = sc._replace(
        i_1=i_1n, i_1x=i_1x, i_1y=i_1y,
        gpad=pad_for_crops(init_weight(i0x, i0y), CANVAS),
        occ_prm=jnp.asarray([prm.alpha, prm.beta, prm.mu, prm.tau_u,
                             prm.tau_eta, prm.tau_chi], jnp.float32),
    )
    solver = SOLVERS[P.M_TVL1_OCC]
    oy, ox = 18, 20
    u1 = jnp.asarray(gt[oy : oy + CANVAS, ox : ox + CANVAS, 0])
    u2 = jnp.asarray(gt[oy : oy + CANVAS, ox : ox + CANVAS, 1])
    chi = jnp.zeros_like(u1)
    r1, r2, rc, e = solver(sc, ox + 1, oy + 1, oy, ox, CANVAS, CANVAS,
                           u1, u2, chi, CANVAS, 1, 3, WR)
    assert np.isfinite(np.asarray(r1)).all()
    assert float(e) >= 0.0
    assert set(np.unique(np.asarray(rc))) <= {0.0, 1.0}  # binarised chi


def test_native_io_roundtrip(tmp_path):
    pytest.importorskip("faldoi_tpu.native.faldoi_io")
    from faldoi_tpu.native import faldoi_io

    f = np.random.RandomState(0).randn(4, 6, 2).astype("<f4")
    p = str(tmp_path / "n.flo")
    faldoi_io.write_flo(p, f.tobytes(), 6, 4)
    payload, w, h = faldoi_io.read_flo(p)
    assert (w, h) == (6, 4)
    assert np.array_equal(np.frombuffer(payload, "<f4").reshape(4, 6, 2), f)

    m = tmp_path / "m.txt"
    m.write_text("1.2 0.7 3.2 2.7\n0 0 1 1\njunk\n")
    rows, n = faldoi_io.parse_matches(str(m), 4)
    assert n == 2
    flow = np.frombuffer(
        faldoi_io.rasterize_matches(rows, n, 3, 2), "<f4"
    ).reshape(2, 3, 2)
    assert flow[0, 1, 0] == 2.0 and flow[0, 0, 0] == 1.0
    assert np.isnan(flow[1, 2, 0])
