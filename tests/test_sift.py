"""Built-in SIFT matcher sanity: a translated pattern must yield matches
recovering the translation."""

import numpy as np


def test_sift_matches_translation():
    from faldoi_tpu.matchers.sift import match_descriptors, sift_keypoints

    rng = np.random.RandomState(0)
    base = np.zeros((96, 128), np.float32)
    yy, xx = np.mgrid[0:96, 0:128]
    for _ in range(40):  # high-contrast blobs of varied sizes
        cy, cx = rng.randint(6, 90), rng.randint(6, 122)
        r = rng.uniform(1.5, 4.0)
        base += rng.uniform(80, 255) * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r)
        )
    base = np.clip(base, 0, 255)
    dx, dy = 3, 2
    img0 = base[8:72, 8:104]
    img1 = base[8 - dy : 72 - dy, 8 - dx : 104 - dx]

    p0, d0 = sift_keypoints(img0, nspo=3)
    p1, d1 = sift_keypoints(img1, nspo=3)
    # the detector is conservative (FALDOI needs few seeds); require a
    # handful of keypoints and consistent matches
    assert len(p0) >= 3 and len(p1) >= 3

    m = match_descriptors(p0, d0, p1, d1)
    assert len(m) >= 2
    flow = m[:, 2:4] - m[:, 0:2]
    med = np.median(flow, axis=0)
    # matched displacement must recover (dx, dy) to within a pixel
    assert abs(med[0] - dx) < 1.0 and abs(med[1] - dy) < 1.0


import pytest


@pytest.mark.slow
def test_builtin_sift_e2e_epe_vs_gt():
    """SIFT-fallback parity evidence: the built-in
    matcher is the de-facto L4 on hosts where the vendored sift_cli cannot
    run (libpng12).  Runs the pipeline on the 192x256 clean/easy crop
    seeded by the built-in matcher (full scale measured EPE-vs-GT 0.2276
    from 202 built-in seeds vs 0.2272 DeepMatching-seeded).  Crop-scale
    gate calibrated from a full-size measurement: 0.3561."""
    import numpy as np
    import jax.numpy as jnp

    from faldoi_tpu.core.global_step import tvl2_global
    from faldoi_tpu.core.match_growing import match_growing
    from faldoi_tpu.core.preprocess import prepare_pair
    from faldoi_tpu.core.sparse import sparse_flow
    from faldoi_tpu.io import read_flo
    from faldoi_tpu.io.image import read_image_split
    from faldoi_tpu.matchers.sift import sift_matches_files
    from faldoi_tpu import params as P

    base = "/root/reference/example_data/clean/easy/"
    im0, im1 = base + "frame_0002.png", base + "frame_0003.png"
    m1, m2 = "/tmp/sift_e2e_mt_1.txt", "/tmp/sift_e2e_mt_2.txt"
    sift_matches_files(im0, im1, m1, m2, nspo=5)
    i0 = read_image_split(im0)
    i1 = read_image_split(im1)
    h, w = i0.shape[1:]
    go = sparse_flow(m1, w, h)
    ba = sparse_flow(m2, w, h)
    assert np.isfinite(go[..., 0]).sum() >= 150, "too few SIFT seeds"
    SL = np.s_[120:312, 300:556]
    a, b = prepare_pair(i0[:, SL[0], SL[1]], i1[:, SL[0], SL[1]])
    prm = P.Parameters()
    prm.val_method = P.M_TVL1
    prm.iterations_of = P.LOCAL_ITER
    prm.epsilon = 0.45  # optimal SIFT epsilon (scripts_python/README.txt)
    rg, _, _ = match_growing(go[SL], ba[SL], a, b, prm, bsz=2048)
    u1, u2 = tvl2_global(a, b, jnp.nan_to_num(jnp.asarray(rg[..., 0])),
                         jnp.nan_to_num(jnp.asarray(rg[..., 1])))
    gt = read_flo(base + "gt/frame_0002.flo")[SL]
    epe = float(np.hypot(np.asarray(u1) - gt[..., 0],
                         np.asarray(u2) - gt[..., 1]).mean())
    print(f"builtin-SIFT crop e2e EPE vs GT: {epe:.4f}")
    assert epe <= 0.45, "built-in SIFT e2e quality regressed"
