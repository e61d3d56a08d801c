"""The XLA paths that replaced the hand-written kernels, the pytree helper,
compile-cache placement and the pinned matmul precision."""

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest

from livevisionkit_tpu.ops import easu, rcas
from livevisionkit_tpu.types import PixelFormat
from livevisionkit_tpu.utils import compile_cache, pytree


# ------------------------------------------------------------- easu_scale 2x


def _scale_map(ih, iw, oh, ow):
    """easu_scale's half-pixel sample positions as an easu_remap map."""
    yy = (jnp.arange(oh, dtype=jnp.float32)[:, None] + 0.5) * (ih / oh) - 0.5
    xx = (jnp.arange(ow, dtype=jnp.float32)[None, :] + 0.5) * (iw / ow) - 0.5
    return jnp.stack([
        jnp.broadcast_to(jnp.clip(yy, 0, ih - 1.0), (oh, ow)),
        jnp.broadcast_to(jnp.clip(xx, 0, iw - 1.0), (oh, ow)),
    ])


@pytest.mark.parametrize("h,w,fmt", [
    (32, 34, PixelFormat.YUV),   # even
    (34, 64, PixelFormat.YUV),
    (48, 130, PixelFormat.YUV),  # wider than one 128-lane tile
    (130, 32, PixelFormat.YUV),  # taller than one tile
    (62, 98, PixelFormat.YUV),
    (33, 47, PixelFormat.YUV),   # odd extents
    (45, 61, PixelFormat.YUV),
    (64, 64, PixelFormat.RGB),   # synthetic-luma path
])
def test_easu_scale_2x_matches_easu_remap(rng, h, w, fmt):
    """The polyphase 2x upscale == the gather-based EASU on the equivalent
    scale map, borders included (FSR.cl:324-358 vs :362-403)."""
    img = jnp.asarray(rng.uniform(0, 1, (3, h, w)).astype(np.float32))
    got = jax.jit(lambda x: easu.easu_scale(x, (2 * h, 2 * w), fmt=fmt))(img)
    ref = jax.jit(lambda x, m: easu.easu_remap(x, m, fmt=fmt))(
        img, _scale_map(h, w, 2 * h, 2 * w)
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------------- rcas


def _rcas_numpy(img: np.ndarray, sharpness: float) -> np.ndarray:
    """Per-pixel RCAS straight from FSR.cl:460-537, in float64."""
    c, h, w = img.shape
    out = img.astype(np.float64).copy()
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            e = img[:, y, x].astype(np.float64)
            b, hh = img[:, y - 1, x], img[:, y + 1, x]
            d, f = img[:, y, x - 1], img[:, y, x + 1]
            mn4 = np.minimum(np.minimum(b, d), np.minimum(f, hh))
            mx4 = np.maximum(np.maximum(b, d), np.maximum(f, hh))
            hit_min = np.minimum(mn4, e) / (4.0 * np.maximum(mx4, 1e-6))
            hit_max = (1.0 - np.maximum(mx4, e)) / np.minimum(4.0 * mn4 - 4.0, -1e-6)
            lobe = np.clip(np.max(np.maximum(-hit_min, hit_max)), -0.1875, 0.0)
            lobe *= sharpness
            out[:, y, x] = ((b + d + f + hh) * lobe + e) / (4.0 * lobe + 1.0)
    return out


@pytest.mark.parametrize("shape,sharpness", [
    ((3, 20, 30), 0.8),
    ((1, 17, 23), 0.5),
    ((2, 9, 40), 1.0),
])
def test_rcas_matches_numpy_reference(rng, shape, sharpness):
    img = rng.uniform(0, 1, shape).astype(np.float32)
    got = np.asarray(rcas.rcas(jnp.asarray(img), sharpness))
    np.testing.assert_allclose(got, _rcas_numpy(img, sharpness), atol=1e-5)


# ----------------------------------------------------------- pytree helper


class _Node(pytree.PyTreeNode):
    a: jax.Array
    b: tuple
    tag: str = pytree.field(static=True, default="x")


def test_pytree_flatten_unflatten_static_field():
    node = _Node(a=jnp.ones(3), b=(jnp.zeros(2), 5), tag="t")
    leaves, treedef = jax.tree_util.tree_flatten(node)
    assert len(leaves) == 3  # a, b[0], b[1]; the static tag is not a leaf
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, _Node) and back.tag == "t"
    assert jax.tree_util.tree_structure(_Node(jnp.ones(3), (1, 2), "u")) != treedef


def test_pytree_replace_is_functional():
    node = _Node(a=jnp.ones(2), b=())
    new = node.replace(a=jnp.zeros(2), tag="y")
    assert float(node.a.sum()) == 2.0 and node.tag == "x"
    assert float(new.a.sum()) == 0.0 and new.tag == "y"
    with pytest.raises(AttributeError):
        node.a = jnp.zeros(2)  # frozen


def test_pytree_as_jit_argument():
    traces = []

    @jax.jit
    def f(node):
        traces.append(node.tag)
        return node.replace(a=node.a * 2)

    out = f(_Node(a=jnp.ones(2), b=()))
    f(_Node(a=jnp.ones(2) + 2.0, b=()))  # same structure: cached
    f(_Node(a=jnp.ones(2), b=(), tag="z"))  # static field: retraces
    assert traces == ["x", "z"]
    np.testing.assert_allclose(np.asarray(out.a), 2.0)


# ------------------------------------------------------------ compile cache


@pytest.mark.parametrize("environ,want,from_env", [
    ({"JAX_COMPILATION_CACHE_DIR": "/cache/dir"}, "/cache/dir", True),
    ({}, "REPO/.cache/jax", False),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, "REPO/.cache/jax", False),
])
def test_compile_cache_dir(tmp_path, environ, want, from_env):
    """The environment's directory wins; otherwise <repo>/.cache/jax, in a
    checkout without .git too (tmp_path has none)."""
    assert not (tmp_path / ".git").exists()
    path, env = compile_cache.cache_dir(environ, repo=str(tmp_path))
    assert path == want.replace("REPO", str(tmp_path))
    assert env == from_env


# ------------------------------------------------------- matmul precision


def _dot_precisions(closed):
    """Precision of every dot_general in a jaxpr, sub-jaxprs included."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    if isinstance(sub, jax.extend.core.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jax.extend.core.Jaxpr):
                        walk(sub)

    walk(closed.jaxpr)
    return found


def _lk_case():
    from livevisionkit_tpu.config import OpticalFlowSettings
    from livevisionkit_tpu.vision import optical_flow

    s = OpticalFlowSettings()
    pyr = optical_flow.Pyramid.build(jnp.zeros((64, 96)), s.pyramid_levels)
    pts = jnp.full((8, 2), 30.0)
    return lambda p, q: optical_flow.track(p, q, pts, jnp.ones(8, bool), s), (pyr, pyr)


def _ransac_case():
    from livevisionkit_tpu.config import MotionEstimationSettings
    from livevisionkit_tpu.vision import ransac

    s = MotionEstimationSettings(hypotheses=8)
    pts = jnp.ones((16, 2))
    return (lambda a, b: ransac.estimate(a, b, jnp.ones(16, bool),
                                         jax.random.key(0), s), (pts, pts))


def _colour_case():
    from livevisionkit_tpu.ops import color

    return (lambda x: (color.convert(x, PixelFormat.BGR, PixelFormat.YUV),
                       color.convert(x, PixelFormat.YUV, PixelFormat.RGB),
                       color.luma(x, PixelFormat.RGB)), (jnp.ones((3, 4, 4)),))


def _mesh_case():
    from livevisionkit_tpu.vision import mesh_motion

    idx = jnp.zeros((8, 4), jnp.int32)
    return (lambda m, w: mesh_motion._sample(m, idx, w),
            (jnp.ones((2, 3, 3)), jnp.ones((8, 4))))


def _homography_case():
    from livevisionkit_tpu.models.homography import Homography

    return (lambda m, p: ((Homography(m) @ Homography(m)).m,
                          Homography(m).transform(p)),
            (jnp.eye(3), jnp.ones((5, 2))))


def _smoother_case():
    from livevisionkit_tpu.data.stream_buffer import StreamBuffer

    buf = StreamBuffer.create(jnp.zeros((2, 2, 2)), 5)
    return lambda b, w: b.convolve(w), (buf, jnp.ones(5))


@pytest.mark.parametrize("case", [
    _lk_case, _ransac_case, _colour_case, _mesh_case, _homography_case,
    _smoother_case,
])
def test_stabilizer_dot_generals_pin_highest(case):
    """Every f32 contraction on the stabilizer path carries HIGHEST itself,
    so a TF32 default (the GPU's) cannot reach the one-hot LK selection,
    the DLT/IRLS normal equations, colour conversion or the smoother."""
    fn, args = case()
    with jax.default_matmul_precision("default"):
        precisions = _dot_precisions(jax.make_jaxpr(fn)(*args))
    assert precisions, "no dot_general traced"
    highest = (jax.lax.Precision.HIGHEST,) * 2
    assert all(p == highest for p in precisions), precisions


# ------------------------------------------------------ sharded EASU warp


def test_remap_sharded_easu_matches_global_at_integer_ties(rng):
    """Coordinates a hair below an integer: `x - x0` on the first stripe
    (x0 = -halo) rounds up to the integer in f32, and EASU's tap set jumps
    there.  The sharded warp must still equal the global one."""
    from jax.sharding import Mesh

    from livevisionkit_tpu.ops import remap
    from livevisionkit_tpu.parallel import spatial

    h, w = 32, 256
    img = jnp.asarray(rng.uniform(0, 1, (1, h, w)).astype(np.float32))
    below = np.float32(1.0 - 2.0**-19)
    xs = np.broadcast_to(np.arange(w, dtype=np.float32) + below, (h, w))
    ys = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None] + 0.25, (h, w))
    smap = jnp.asarray(np.stack([ys, np.minimum(xs, w - 1)]))
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("tile",))
    got = spatial.remap_sharded(img, smap, mesh, fill=0.0, halo=16,
                                filter_mode="easu", fmt=PixelFormat.GRAY)
    ref = remap.remap(img, smap, fill=0.0, filter_mode="easu",
                      fmt=PixelFormat.GRAY)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-6)
