"""Pallas dense nearest-hit kernel (Triton route) vs the XLA sweep.

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``,
passed only by tests); production CPU programs take the XLA sweep. The
compiled kernel is checked on the card by ``chip_smoke.py`` and by the
``gpu``-marked test below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import scene_path
from raytracing_course_2024_tpu.ops import scene_intersect as SI
from raytracing_course_2024_tpu.ops.pallas_intersect import (
    BLK,
    pallas_dense_nearest,
)
from raytracing_course_2024_tpu.ops.vec import Vec3
from raytracing_course_2024_tpu.scene import (
    PLANE,
    PrimitiveDesc,
    build_scene_arrays,
    load_scene,
)


def _cornell(with_plane: bool = False):
    desc = load_scene(scene_path("cornell_box.gltf"), 16, 16, 1)
    if with_plane:  # a mirror plane just below the floor, tilted a little
        desc.planes.append(PrimitiveDesc(
            ptype=PLANE, p0=np.array([0.0, 1.0, 0.0]),
            position=np.array([0.0, -0.05, 0.0]),
            rotation=np.array([0.05, 0.0, 0.0, 0.99875]),
            color=np.array([0.5, 0.5, 0.5]),
        ))
    arrays, statics = build_scene_arrays(desc)
    assert arrays.tri_pack is not None  # 36 tris, all-triangle -> eligible
    return jax.tree.map(jnp.asarray, arrays), statics


def _rays(rng, b):
    o = rng.uniform(-1, 1, (b, 3)) + np.array([0, 1, 0])
    d = rng.normal(size=(b, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro = Vec3(*[jnp.asarray(o[:, i], jnp.float32) for i in range(3)])
    rd = Vec3(*[jnp.asarray(d[:, i], jnp.float32) for i in range(3)])
    return ro, rd


def _kernel_hit(ro, rd, arrays, statics, interpret):
    """The kernel's SceneHit, with planes folded in as production does."""
    t, idx = pallas_dense_nearest(ro, rd, arrays.tri_pack, interpret=interpret)
    hit = SI.SceneHit(t, idx, jnp.zeros_like(idx, bool), jnp.isfinite(t))
    if statics.num_planes > 0:
        hit = SI._fold_in_planes(ro, rd, arrays, hit, 0.0)
    return hit


def _assert_agree(hk, hx):
    """The chip_smoke.py criteria: equal valid masks, t within f32
    rounding of the two formula orders, and >= 99.9% equal indices over
    valid lanes (an exact tie may pick either triangle)."""
    valid = np.asarray(hx.valid)
    assert np.array_equal(valid, np.asarray(hk.valid))
    assert np.array_equal(np.asarray(hx.is_plane), np.asarray(hk.is_plane))
    assert np.allclose(
        np.asarray(hk.t)[valid], np.asarray(hx.t)[valid], rtol=2e-5, atol=2e-5
    )
    ids_match = np.asarray(hk.idx) == np.asarray(hx.idx)
    assert ids_match[valid].mean() >= 0.999


@pytest.mark.parametrize("with_plane", [False, True], ids=["tris", "planes"])
@pytest.mark.parametrize("b", [3000, 4 * BLK], ids=["ragged", "blocks"])
def test_pallas_matches_xla_sweep(rng, b, with_plane):
    """Interpret-mode kernel == XLA sweep, for a ray count that is and one
    that is not a multiple of the block (padding path), with and without an
    infinite plane folded in after the kernel."""
    arrays, statics = _cornell(with_plane)
    ro, rd = _rays(rng, b)
    hk = _kernel_hit(ro, rd, arrays, statics, interpret=True)
    hx = SI.nearest_hit_dense(ro, rd, arrays, statics)  # CPU: XLA sweep
    assert np.asarray(hk.is_plane).any() == with_plane
    _assert_agree(hk, hx)


def test_cpu_dense_path_never_interprets(rng, monkeypatch):
    """Production CPU programs take the XLA sweep: neither a jitted
    nearest-hit query nor a Renderer frame of a kernel-eligible scene
    reaches the kernel wrapper, so interpret mode cannot be reached."""
    import raytracing_course_2024_tpu.ops.pallas_intersect as PI

    def forbidden(*a, **k):
        raise AssertionError("kernel reached from a CPU program")

    monkeypatch.setattr(PI, "pallas_dense_nearest", forbidden)
    arrays, statics = _cornell()
    ro, rd = _rays(rng, 512)
    hx = jax.jit(lambda o, d: SI.nearest_hit_dense(o, d, arrays, statics))(
        ro, rd
    )
    assert np.asarray(hx.valid).mean() > 0.5

    from raytracing_course_2024_tpu.runtime.render import Renderer

    r = Renderer(load_scene(scene_path("cornell_box.gltf"), 8, 6, 2))
    assert r.backend == "dense" and r.arrays.tri_pack is not None
    img = r.render_radiance(seed=0)
    assert np.isfinite(img).all() and img.max() > 0.0


def test_kernel_lowers_through_triton():
    """The wrapper lowers for CUDA through Pallas' Triton route (this runs
    the Triton lowering on the host; compiling the emitted IR needs the
    card)."""
    from jax import export

    from raytracing_course_2024_tpu.ops.pallas_intersect import _run

    b = 4 * BLK
    args = [jax.ShapeDtypeStruct((b,), jnp.float32)] * 6 + [
        jax.ShapeDtypeStruct((9, 36), jnp.float32)
    ]
    fn = jax.jit(lambda *a: _run(*a, tmin=0.0, interpret=False))
    exp = export.export(
        fn, platforms=["cuda"],
        disabled_checks=[
            export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(*args)
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_sweep(gpu, rng):
    """On the card: the compiled kernel against the XLA sweep."""
    arrays, statics = _cornell()
    ro, rd = _rays(rng, 1 << 16)
    hk = jax.jit(lambda o, d: SI.nearest_hit_dense(o, d, arrays, statics))(
        ro, rd
    )
    no_pack = arrays._replace(tri_pack=None)
    hx = jax.jit(lambda o, d: SI.nearest_hit_dense(o, d, no_pack, statics))(
        ro, rd
    )
    _assert_agree(hk, hx)


@pytest.mark.slow
@pytest.mark.gpu
def test_pallas_used_in_renderer(gpu):
    """On the card, the Cornell box's renderer routes through the kernel."""
    from raytracing_course_2024_tpu.runtime.render import Renderer

    r = Renderer(load_scene(scene_path("cornell_box.gltf"), 32, 18, 2))
    assert r.arrays.tri_pack is not None
    hlo = r._render_batch.lower(
        np.uint32(0), np.int32(0), np.int32(0), r.arrays,
        samples=2, batch=32 * 18, replicas=1, with_stats=True,
    ).as_text()
    assert "xla.gpu.triton" in hlo
    img = r.render_radiance(seed=0)
    assert np.isfinite(img).all() and img.max() > 0.01
