"""Frame preprocessing shared by the local and global steps.

Mirrors ``energy_model.cpp:276-688`` (prepare_stuff) and the global binary's
main (``global_faldoi.cpp:2049-2068``): RGB -> gray (ITU 601), joint min-max
normalization, Gaussian presmoothing sigma=0.9.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from faldoi_tpu.io.image import read_image_split, rgb_to_gray
from faldoi_tpu.ops import (
    gaussian_smooth,
    image_normalization,
    image_normalization_3,
    image_normalization_4,
)
from faldoi_tpu.params import PRESMOOTHING_SIGMA


def to_gray(planes: np.ndarray) -> np.ndarray:
    return planes[0] if planes.shape[0] == 1 else rgb_to_gray(planes)


@jax.jit
def _normalize_smooth_pair(a, b):
    a, b = image_normalization(a, b)
    return (gaussian_smooth(a, PRESMOOTHING_SIGMA),
            gaussian_smooth(b, PRESMOOTHING_SIGMA))


def prepare_pair(i0_planes: np.ndarray, i1_planes: np.ndarray):
    """Gray + joint-normalize + presmooth a frame pair (local/global TVL1
    path; energy_model.cpp:660-687).  One jitted program — eager, the
    normalization/smoothing glue compiles ~10 single-op programs per
    process."""
    a = jnp.asarray(to_gray(i0_planes))
    b = jnp.asarray(to_gray(i1_planes))
    return _normalize_smooth_pair(a, b)


def prepare_triple(i0_planes, i1_planes, i_1_planes):
    """The global binary's 3-frame preprocessing (global_faldoi.cpp:2049-2068):
    normalization_3 called as (i0, i1, i_1) with its min quirk."""
    i0 = jnp.asarray(to_gray(i0_planes))
    i1 = jnp.asarray(to_gray(i1_planes))
    i_1 = jnp.asarray(to_gray(i_1_planes))
    i0, i1, i_1 = image_normalization_3(i0, i1, i_1)
    i0 = gaussian_smooth(i0, PRESMOOTHING_SIGMA)
    i1 = gaussian_smooth(i1, PRESMOOTHING_SIGMA)
    i_1 = gaussian_smooth(i_1, PRESMOOTHING_SIGMA)
    return i0, i1, i_1


def prepare_quad(i0_planes, i1_planes, i_1_planes, i2_planes):
    """4-frame preprocessing for the occlusion functional
    (energy_model.cpp:609-658)."""
    i0 = jnp.asarray(to_gray(i0_planes))
    i1 = jnp.asarray(to_gray(i1_planes))
    i_1 = jnp.asarray(to_gray(i_1_planes))
    i2 = jnp.asarray(to_gray(i2_planes))
    i0, i1, i_1, i2 = image_normalization_4(i0, i1, i_1, i2)
    sm = lambda x: gaussian_smooth(x, PRESMOOTHING_SIGMA)
    return sm(i0), sm(i1), sm(i_1), sm(i2)


def read_frame_list(path: str):
    """Read the ims.txt frame list: 2 frames (I0, I1) or 4 (I0, I1, I-1, I2)
    (local_faldoi.cpp:1826-1860).

    Relative entries that don't resolve from the CWD are resolved against
    the list file's directory and a few of its ancestors: the reference's
    stock lists (e.g. `example_data/clean/sintel_one_frame_easy.txt`) hold
    `../example_data/...` paths that assume the drivers run from
    `scripts_python/` — ancestor resolution keeps them working from any CWD
    without breaking absolute or genuinely CWD-relative paths."""
    import os

    with open(path) as fh:
        names = [ln.strip() for ln in fh if ln.strip()]
    if len(names) == 3:
        raise ValueError("3 images given; expected 2 (I0, I1) or 4 (I0, I1, I-1, I2)")
    bases = [os.path.dirname(os.path.abspath(path))]
    for _ in range(3):
        parent = os.path.dirname(bases[-1])
        if parent == bases[-1]:
            break
        bases.append(parent)
    out = []
    for f in names:
        if not os.path.isabs(f) and not os.path.exists(f):
            for b in bases:
                alt = os.path.normpath(os.path.join(b, f))
                if os.path.exists(alt):
                    f = alt
                    break
        out.append(f)
    return out


def load_frames(list_path: str):
    """Load all frames from an ims.txt as planar float arrays."""
    names = read_frame_list(list_path)
    return [read_image_split(n) for n in names], names
