"""Zoom, dataset utils, and snapshot-hook coverage."""

import numpy as np

import jax.numpy as jnp


def test_zoom_roundtrip_shapes():
    from faldoi_tpu.ops.zoom import zoom_in, zoom_out, zoom_size

    rng = np.random.RandomState(0)
    img = jnp.asarray(rng.rand(32, 48).astype(np.float32))
    small = zoom_out(img, 0.5)
    assert small.shape == (zoom_size(32, 0.5), zoom_size(48, 0.5))
    back = zoom_in(small, 32, 48)
    assert back.shape == (32, 48)
    # smooth image survives the round trip approximately
    smooth = jnp.asarray(np.outer(np.linspace(0, 1, 32),
                                  np.linspace(0, 1, 48)).astype(np.float32))
    rt = zoom_in(zoom_out(smooth, 0.5), 32, 48)
    assert float(jnp.abs(rt - smooth).mean()) < 0.02


def test_list_images_dataset(tmp_path):
    from faldoi_tpu.utils import list_images_dataset

    d = tmp_path / "clean" / "alley_9"
    d.mkdir(parents=True)
    for k in (1, 2, 3):
        (d / f"frame_{k:04d}.png").write_bytes(b"")
    pairs = list_images_dataset(str(tmp_path), "sintel", "clean")
    assert len(pairs) == 2
    assert pairs[0][0].endswith("frame_0001.png")
    assert pairs[1][1].endswith("frame_0003.png")


def test_compile_cache_dir(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and no other path
    is configured; unset, the cache is the checkout's fixed .jax_cache."""
    import os

    import jax

    from faldoi_tpu import profiling

    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert profiling.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    want = os.path.join(checkout, ".jax_cache")
    try:
        assert profiling.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
