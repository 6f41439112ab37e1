"""DeepMatching confidence rescoring — "Algorithm 3" part 1.

Reimplementation of ``scripts_python/rescore_prunning.py`` (code originally
by P. Weinzaepfel): the confidence of a match is the square root of the
smaller eigenvalue of the Gaussian-integrated structure tensor of I0 at the
match position.  The reference script breaks on modern NumPy (its
``from numpy import *`` shadows ``max`` so ``max(0, x)`` becomes
``np.max(0, axis=x)``); this version reproduces its math with explicit
imports.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage


def _smooth2(img, sigma):
    tmp = scipy.ndimage.gaussian_filter1d(
        img.astype(np.float32), sigma, axis=0, order=0, mode="nearest"
    )
    return scipy.ndimage.gaussian_filter1d(tmp, sigma, axis=1, order=0, mode="nearest")


def small_eigen_map(img0: np.ndarray) -> np.ndarray:
    """Smaller eigenvalue of the structure tensor of img0 (h, w, 3)
    (rescore_prunning.py:6-33)."""
    sigma_image = 0.8
    sigma_matrix = 1.0
    derivfilter = np.array([-0.5, 0, 0.5], np.float32)

    img0_smooth = _smooth2(img0, sigma_image)
    img0_dx = scipy.ndimage.convolve1d(img0_smooth, derivfilter, axis=0, mode="nearest")
    img0_dy = scipy.ndimage.convolve1d(img0_smooth, derivfilter, axis=1, mode="nearest")

    dx2 = np.sum(img0_dx * img0_dx, axis=2)
    dxy = np.sum(img0_dx * img0_dy, axis=2)
    dy2 = np.sum(img0_dy * img0_dy, axis=2)

    dx2 = _smooth2(dx2, sigma_matrix)
    dxy = _smooth2(dxy, sigma_matrix)
    dy2 = _smooth2(dy2, sigma_matrix)

    tmp = 0.5 * (dx2 + dy2)
    disc = np.maximum(0.0, tmp * tmp + dxy * dxy - dx2 * dy2)
    return tmp - np.sqrt(disc)


def score_from_autocorr(img0, img1, corres):
    """Per-match sqrt(max(0, small eigenvalue)) (rescore_prunning.py:50-57)."""
    small = small_eigen_map(img0)
    res = []
    for pos0, pos1, _ in corres:
        p0 = tuple(pos0)[::-1]  # (y, x) numpy order
        res.append((pos0, pos1, np.sqrt(max(0.0, float(small[p0])))))
    return res


def confidence_values(i0_path: str, i1_path: str, match_path: str, dest_dir: str) -> str:
    """Score a DeepMatching 6-column output file; writes the 5-column
    ``*_saliency.txt`` next to ``dest_dir`` (rescore_prunning.py:60-84)."""
    from PIL import Image

    img0 = np.asarray(Image.open(i0_path).convert("RGB"))
    img1 = np.asarray(Image.open(i1_path).convert("RGB"))
    ty0, tx0 = img0.shape[:2]
    ty1, tx1 = img1.shape[:2]

    def rint(s):
        return int(0.5 + float(s))

    corres_name = match_path.split(".")[-2].split("/")[-1]
    dest = dest_dir + corres_name + "_saliency.txt"

    retained = []
    with open(match_path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or len(parts) != 6 or not parts[0][0].isdigit():
                continue
            x0, y0, x1, y1, _score, _idx = parts
            retained.append(
                (
                    (min(tx0 - 1, rint(x0)), min(ty0 - 1, rint(y0))),
                    (min(tx1 - 1, rint(x1)), min(ty1 - 1, rint(y1))),
                    0,
                )
            )
    with open(dest, "w") as out:
        for p0, p1, score in score_from_autocorr(img0, img1, retained):
            out.write("%s %s %s %s %f\n" % (p0[0], p0[1], p1[0], p1[1], score))
    return dest
