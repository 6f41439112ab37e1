"""Full-width kernel checks on the GPU — the same functions as phase b of
``chip_smoke.py``.  They skip where JAX finds no GPU; run them on the card
with ``python -m pytest -m gpu tests/``."""

import pytest

import chip_smoke


@pytest.fixture
def gpu():
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: these checks run at production width on the "
                    "card")


@pytest.mark.gpu
def test_crop_bit_exact(gpu):
    diff, _ = chip_smoke.check_crop()
    assert diff == 0


@pytest.mark.gpu
def test_patch_warp_within_tolerance(gpu):
    assert chip_smoke.check_patch_warp() <= chip_smoke.WARP_TOL


@pytest.mark.gpu
def test_image_warp_within_tolerance(gpu):
    assert chip_smoke.check_image_warp() <= chip_smoke.WARP_TOL


@pytest.mark.gpu
def test_topk_matches_argsort(gpu):
    assert chip_smoke.check_topk() == 0
