"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def test_devices_available():
    assert len(jax.devices()) >= 8


def test_dp_global_refine_sharded():
    from faldoi_tpu.parallel import dp_global_refine, make_mesh

    mesh = make_mesh(4, 1)
    rng = np.random.RandomState(0)
    b, h, w = 4, 16, 32
    i0 = rng.rand(b, h, w).astype(np.float32)
    i1 = rng.rand(b, h, w).astype(np.float32)
    z = np.zeros((b, h, w), np.float32)
    r1, r2 = dp_global_refine(mesh, i0, i1, z, z, warps=1, iters=3)
    assert r1.shape == (b, h, w)
    assert np.isfinite(np.asarray(r1)).all()


def test_spatial_sharding_matches_single_device():
    """The halo-exchange PD solve (frames sharded, warp from the halo band
    — no replicated planes) must agree with the unsharded solver, including
    a nonzero initial flow that makes the warp cross shard boundaries."""
    from faldoi_tpu.parallel import make_mesh, spatial_tvl2_global
    from faldoi_tpu.core.global_step import tvl2_global

    rng = np.random.RandomState(1)
    h, w = 32, 64
    i0 = jnp.asarray(rng.rand(h, w).astype(np.float32))
    i1 = jnp.asarray(rng.rand(h, w).astype(np.float32))
    yy = jnp.broadcast_to(jnp.linspace(-1.5, 1.5, h)[:, None], (h, w))
    u0 = 0.8 * jnp.sin(yy)          # |u| < 1
    v0 = yy                         # |v| <= 1.5 crosses the 8-row shards
    z = jnp.zeros((h, w), jnp.float32)

    mesh = make_mesh(1, 4)
    # warps=2 locks the dual-carry-across-warps semantics (tvl2OF never
    # re-zeroes xi inside the warp loop).  The warps=2 tolerance is looser:
    # float32 differences in the warped planes are amplified through the
    # second warp by these random-noise images' O(0.5) gradients.
    for u_init, v_init, wrp, atol in ((z, z, 1, 2e-5), (u0, v0, 2, 1e-3)):
        s1, s2 = spatial_tvl2_global(mesh, i0, i1, u_init, v_init,
                                     iters=20, warps=wrp, max_disp=4)
        r1, r2 = tvl2_global(i0, i1, u_init, v_init, warps=wrp, max_iters=20,
                             tol=0.0)
        np.testing.assert_allclose(np.asarray(s1), np.asarray(r1), atol=atol)
        np.testing.assert_allclose(np.asarray(s2), np.asarray(r2), atol=atol)


def test_pipeline_train_step():
    from faldoi_tpu.parallel import make_mesh, pipeline_train_step

    mesh = make_mesh(2, 1)
    rng = np.random.RandomState(2)
    b, h, w = 2, 16, 32
    i0 = rng.rand(b, h, w).astype(np.float32)
    i1 = rng.rand(b, h, w).astype(np.float32)
    seeds = np.full((b, h, w, 2), np.nan, np.float32)
    seeds[:, ::4, ::4] = rng.randn(b, 4, 8, 2).astype(np.float32) * 0.5
    out = pipeline_train_step(mesh, i0, i1, seeds)
    assert out.shape == (b, h, w, 2)
    assert np.isfinite(np.asarray(out)).all()

@pytest.mark.slow
def test_spatial_local_growing():
    """The row-sharded local growing (per-shard top-k, global pmin band,
    halo-merged candidate/working scatters) must track the unsharded
    growing within the parity gate on a REAL Sintel crop with the cached
    DeepMatching seeds (measured with 3 outer iterations: 0.022 px vs
    unsharded; both land ~0.07-0.08 px from the reference binary)."""
    from faldoi_tpu.io import read_flo
    from faldoi_tpu.io.image import read_image_split
    from faldoi_tpu.core.preprocess import prepare_pair
    from faldoi_tpu.parallel import make_mesh
    from faldoi_tpu.parallel.spatial_grow import spatial_match_growing
    from faldoi_tpu.core.match_growing import match_growing
    from faldoi_tpu import params as P

    BASE = "/root/reference/example_data/clean/easy/"
    SL = np.s_[150:198, 300:364]  # 48x64 "tiny" crop
    i0 = read_image_split(BASE + "frame_0002.png")[:, SL[0], SL[1]]
    i1 = read_image_split(BASE + "frame_0003.png")[:, SL[0], SL[1]]
    go = read_flo("tests/golden/deep_mt_1.flo")[SL[0], SL[1]]
    ba = read_flo("tests/golden/deep_mt_2.flo")[SL[0], SL[1]]
    a, b = prepare_pair(i0, i1)

    prm = P.Parameters()
    prm.val_method = P.M_TVL1
    prm.iterations_of = 1  # it0 + final drain: every sharded code path
    prm.epsilon = P.FB_TOL

    kw = dict(bsz=256, delta=0.01, delta_rel=0.5, floor_scale=64)
    ref, _, _ = match_growing(go, ba, a, b, prm, mode="fused",
                              fill="patch", relax=False, **kw)
    mesh = make_mesh(1, 2)
    got, _, _ = spatial_match_growing(mesh, go, ba, a, b, prm,
                                      halo=8, **kw)
    fin = np.isfinite(ref[..., 0]) & np.isfinite(got[..., 0])
    assert fin.mean() > 0.95
    epe = np.hypot(got[..., 0] - ref[..., 0],
                   got[..., 1] - ref[..., 1])[fin].mean()
    # the acceptance order differs only through per-shard floors and
    # one-sweep-late cross-boundary donations
    assert epe < 0.05, epe


def _tiny_fixture():
    from faldoi_tpu.io import read_flo
    from faldoi_tpu.io.image import read_image_split
    from faldoi_tpu.core.preprocess import prepare_pair
    from faldoi_tpu import params as P

    BASE = "/root/reference/example_data/clean/easy/"
    SL = np.s_[150:198, 300:364]
    i0 = read_image_split(BASE + "frame_0002.png")[:, SL[0], SL[1]]
    i1 = read_image_split(BASE + "frame_0003.png")[:, SL[0], SL[1]]
    go = read_flo("tests/golden/deep_mt_1.flo")[SL[0], SL[1]]
    ba = read_flo("tests/golden/deep_mt_2.flo")[SL[0], SL[1]]
    a, b = prepare_pair(i0, i1)
    prm = P.Parameters()
    prm.val_method = P.M_TVL1
    prm.iterations_of = 1
    prm.epsilon = P.FB_TOL
    return go, ba, a, b, prm


@pytest.mark.slow
def test_spatial_local_growing_space4_production():
    """space=4 (12-row shards, every shard has TWO interior boundaries)
    with the SHIPPING config — warm drains, adaptive rung ladder, late
    floor scale all active on the sharded path (r4: the twin became the
    production path)."""
    from faldoi_tpu.parallel import make_mesh
    from faldoi_tpu.parallel.spatial_grow import spatial_match_growing
    from faldoi_tpu.core.match_growing import match_growing

    go, ba, a, b, prm = _tiny_fixture()
    kw = dict(bsz=256, delta=0.05, delta_rel=0.5, floor_scale=64)
    ref, _, _ = match_growing(go, ba, a, b, prm, mode="chunked",
                              fill="patch", relax=False, **kw)
    mesh = make_mesh(1, 4)
    got, _, _ = spatial_match_growing(mesh, go, ba, a, b, prm,
                                      halo=8, **kw)
    fin = np.isfinite(ref[..., 0]) & np.isfinite(got[..., 0])
    assert fin.mean() > 0.95
    epe = np.hypot(got[..., 0] - ref[..., 0],
                   got[..., 1] - ref[..., 1])[fin].mean()
    assert epe < 0.06, epe


@pytest.mark.slow
def test_spatial_local_growing_ordering_dials(monkeypatch):
    """exactmin + defer dials on the SHARDED path: their window reductions
    are shard-local approximations (local_step.py) — this pins that they
    (a) run at all under shard_map and (b) stay near the unsharded result
    with the same dials at a boundary-heavy space=4."""
    from faldoi_tpu.parallel import make_mesh
    from faldoi_tpu.parallel.spatial_grow import spatial_match_growing
    from faldoi_tpu.core.match_growing import match_growing

    monkeypatch.setenv("FALDOI_GROW_EXACTMIN", "11")
    monkeypatch.setenv("FALDOI_GROW_EXACTMIN_BAND", "2")
    monkeypatch.setenv("FALDOI_GROW_DEFER", "0.5")
    go, ba, a, b, prm = _tiny_fixture()
    kw = dict(bsz=256, delta=0.05, delta_rel=0.5, floor_scale=64)
    ref, _, _ = match_growing(go, ba, a, b, prm, mode="chunked",
                              fill="patch", relax=False, **kw)
    mesh = make_mesh(1, 4)
    got, _, _ = spatial_match_growing(mesh, go, ba, a, b, prm,
                                      halo=8, **kw)
    fin = np.isfinite(ref[..., 0]) & np.isfinite(got[..., 0])
    assert fin.mean() > 0.95
    epe = np.hypot(got[..., 0] - ref[..., 0],
                   got[..., 1] - ref[..., 1])[fin].mean()
    # shard-local exactmin/defer windows: divergence allowed at shard
    # boundaries, bounded well under the parity gate's scale
    assert epe < 0.10, epe
