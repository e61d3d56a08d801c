"""Halo-exchange sharded remap == global remap (8-dev mesh)."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import fixtures
from livevisionkit_tpu.models.homography import Homography
from livevisionkit_tpu.models.warp_field import WarpField
from livevisionkit_tpu.ops import remap as remap_ops
from livevisionkit_tpu.parallel import spatial

pytestmark = pytest.mark.slow  # whole module: sharded/jit-compile dominated


def _mesh(n=8):
    return Mesh(np.asarray(jax.devices()[:n]), ("tile",))


def test_sharded_remap_matches_global_translation(rng):
    img = jnp.stack([fixtures.make_texture(96, 512, rng) for _ in range(3)])
    h = Homography.from_similarity(
        jnp.float32(1.0), jnp.float32(0.0), jnp.float32(37.0), jnp.float32(-12.0)
    )
    smap = h.sample_map((96, 512))
    ref = remap_ops.remap(img, smap, fill=0.25)
    got = spatial.remap_sharded(img, smap, _mesh(), fill=0.25, halo=48)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_sharded_remap_matches_global_field(rng):
    img = fixtures.make_texture(64, 512, rng)[None]
    off = np.zeros((2, 5, 9), np.float32)
    off[0] = 0.02 * np.sin(np.linspace(0, 3, 5))[:, None]
    off[1] = 0.03 * np.cos(np.linspace(0, 2, 9))[None, :]
    f = WarpField(offsets=jnp.asarray(off))
    smap = f.sample_map((64, 512))
    ref = remap_ops.remap(img, smap, fill=0.0)
    got = spatial.remap_sharded(img, smap, _mesh(), fill=0.0, halo=32)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_sharded_remap_under_jit(rng):
    img = fixtures.make_texture(32, 256, rng)[None]
    h = Homography.from_similarity(
        jnp.float32(1.0), jnp.float32(0.01), jnp.float32(5.0), jnp.float32(3.0)
    )
    smap = h.sample_map((32, 256))
    mesh = _mesh(4)
    got = jax.jit(
        lambda i, m: spatial.remap_sharded(i, m, mesh, fill=0.1, halo=24)
    )(img, smap)
    ref = remap_ops.remap(img, smap, fill=0.1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_sharded_remap_easu_matches_global(rng):
    """filter_mode="easu" (reference-parity sampling, FSR.cl:362-403) on the
    sharded axis == the global XLA oracle, including the global
    nearest-neighbour border ring on the outermost stripes."""
    img = jnp.stack([fixtures.make_texture(96, 512, rng) for _ in range(3)])
    h = Homography.from_similarity(
        jnp.float32(1.002), jnp.float32(0.004), jnp.float32(7.0),
        jnp.float32(-3.0),
    )
    smap = h.sample_map((96, 512))
    ref = remap_ops.remap(img, smap, fill=0.25, filter_mode="easu")
    got = spatial.remap_sharded(
        img, smap, _mesh(), fill=0.25, halo=48, filter_mode="easu"
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)
