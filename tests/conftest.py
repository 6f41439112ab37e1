"""Test configuration.

The platform comes from the command line: the CPU tier runs with
``JAX_PLATFORMS=cpu``; ``-m gpu`` runs the full-width checks on a card.
The CPU backend gets 8 virtual devices so the multi-device sharding paths
run without a multi-device host."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

from faldoi_tpu.profiling import enable_compile_cache  # noqa: E402

enable_compile_cache()


def pytest_collection_modifyitems(config, items):
    """Two test tiers: tests marked ``slow`` are skipped unless
    FALDOI_SLOW_TESTS=1 or an explicit ``-m slow`` selection asks for
    them."""
    import pytest

    if os.environ.get("FALDOI_SLOW_TESTS"):
        return
    if "slow" in (config.getoption("-m") or ""):
        return
    skip = pytest.mark.skip(
        reason="slow tier (set FALDOI_SLOW_TESTS=1 or -m slow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
