"""BVH build + traversal tests.

* containment invariants (the reference's validate_bvh, src/bvh.rs:299-322)
* exact agreement between the dense sweep and the BVH traversal (same
  reordered table, so nearest-hit indices must match where t is unique)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import scene_path
from raytracing_course_2024_tpu.ops.bvh import (
    attach_bvh,
    build_bvh,
    primitive_aabbs,
    validate_bvh,
    validate_treelets,
)
from raytracing_course_2024_tpu.ops.scene_intersect import nearest_hit_dense
from raytracing_course_2024_tpu.ops.traverse import nearest_hit_bvh
from raytracing_course_2024_tpu.ops.vec import Vec3
from raytracing_course_2024_tpu.scene import build_scene_arrays, load_scene
from raytracing_course_2024_tpu.scene.types import TRI, PrimitiveDesc


def _soup_desc(rng, n=500, emissive_every=50):
    """Random triangle soup in [-5, 5]^3."""
    prims = []
    for i in range(n):
        a = rng.uniform(-5, 5, 3)
        b = a + rng.normal(0, 0.4, 3)
        c = a + rng.normal(0, 0.4, 3)
        nrm = np.cross(b - a, c - a)
        nrm /= max(np.linalg.norm(nrm), 1e-12)
        prims.append(
            PrimitiveDesc(
                ptype=TRI,
                p0=a,
                p1=b,
                p2=c,
                sn0=nrm,
                sn1=nrm,
                sn2=nrm,
                color=rng.uniform(0, 1, 3),
                emission=(
                    rng.uniform(1, 2, 3) if i % emissive_every == 0 else np.zeros(3)
                ),
            )
        )
    from raytracing_course_2024_tpu.scene.types import (
        CameraDesc,
        RenderSettings,
        SceneDesc,
    )

    settings = RenderSettings(
        width=8,
        height=8,
        samples=1,
        ray_depth=2,
        bg_color=(0, 0, 0),
        camera=CameraDesc(
            position=np.array([0.0, 0.0, 12.0]),
            right=np.array([1.0, 0.0, 0.0]),
            up=np.array([0.0, 1.0, 0.0]),
            forward=np.array([0.0, 0.0, -1.0]),
            fov_x=1.0,
            fov_y=1.0,
        ),
    )
    return SceneDesc(settings=settings, primitives=prims, planes=[])


def _rand_rays(rng, b):
    o = rng.uniform(-8, 8, (b, 3))
    d = rng.normal(size=(b, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ov = Vec3(*[jnp.asarray(o[:, i], jnp.float32) for i in range(3)])
    dv = Vec3(*[jnp.asarray(d[:, i], jnp.float32) for i in range(3)])
    return ov, dv


def test_build_and_validate(rng):
    desc = _soup_desc(rng, n=777)
    arrays, statics = build_scene_arrays(desc)
    amin, amax = primitive_aabbs(arrays)
    host = build_bvh(amin, amax)
    validate_bvh(host, amin, amax)
    arrays2 = attach_bvh(arrays, statics)
    validate_treelets(arrays2, statics)
    # light indices still point at emissive prims after reorder + padding
    em = np.asarray(arrays2.emission)[np.asarray(arrays2.light_idx)]
    assert (np.linalg.norm(em, axis=1) > 1e-5).all()


def test_bvh_matches_dense_soup(rng):
    desc = _soup_desc(rng, n=900)
    arrays, statics = build_scene_arrays(desc)
    arrays = attach_bvh(arrays, statics)
    arrays_j = jax.tree.map(jnp.asarray, arrays)
    ro, rd = _rand_rays(rng, 4096)
    hd = nearest_hit_dense(ro, rd, arrays_j, statics)
    hb = nearest_hit_bvh(ro, rd, arrays_j, statics)
    assert np.array_equal(np.asarray(hd.valid), np.asarray(hb.valid))
    tb, td = np.asarray(hb.t), np.asarray(hd.t)
    both = np.asarray(hd.valid)
    assert np.allclose(tb[both], td[both], rtol=1e-5, atol=1e-5)
    # indices match wherever the hit is unique (ties can differ)
    close_ids = np.asarray(hd.idx) == np.asarray(hb.idx)
    assert (close_ids | ~both).mean() > 0.995


def test_bvh_matches_dense_cornell(scenes_dir, rng):
    desc = load_scene(scene_path("cornell_box.gltf"), 16, 16, 1)
    arrays, statics = build_scene_arrays(desc)
    arrays = attach_bvh(arrays, statics)
    validate_treelets(arrays, statics)
    arrays_j = jax.tree.map(jnp.asarray, arrays)
    # rays from inside the box
    o = rng.uniform(-0.8, 0.8, (2048, 3)) * np.array([1, 1, 1]) + np.array(
        [0, 1, 0]
    )
    d = rng.normal(size=(2048, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro = Vec3(*[jnp.asarray(o[:, i], jnp.float32) for i in range(3)])
    rd = Vec3(*[jnp.asarray(d[:, i], jnp.float32) for i in range(3)])
    hd = nearest_hit_dense(ro, rd, arrays_j, statics)
    hb = nearest_hit_bvh(ro, rd, arrays_j, statics)
    both = np.asarray(hd.valid)
    assert np.array_equal(both, np.asarray(hb.valid))
    assert np.allclose(
        np.asarray(hb.t)[both], np.asarray(hd.t)[both], rtol=1e-5, atol=1e-5
    )


def test_bvh_mixed_shapes(rng):
    """BVH over rotated boxes/ellipsoids must agree with the dense sweep."""
    from raytracing_course_2024_tpu.scene import parse_text_scene

    blocks = []
    for i in range(200):
        kind = ["BOX", "ELLIPSOID"][i % 2]
        s = rng.uniform(0.2, 1.0, 3)
        pos = rng.uniform(-6, 6, 3)
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        blocks.append(
            f"NEW_PRIMITIVE\n{kind} {s[0]} {s[1]} {s[2]}\n"
            f"POSITION {pos[0]} {pos[1]} {pos[2]}\n"
            f"ROTATION {q[0]} {q[1]} {q[2]} {q[3]}\nCOLOR 1 1 1\n"
        )
    text = "DIMENSIONS 8 8\n" + "\n".join(blocks)
    arrays, statics = build_scene_arrays(parse_text_scene(text))
    arrays = attach_bvh(arrays, statics)
    validate_treelets(arrays, statics)
    arrays_j = jax.tree.map(jnp.asarray, arrays)
    ro, rd = _rand_rays(rng, 4096)
    hd = nearest_hit_dense(ro, rd, arrays_j, statics)
    hb = nearest_hit_bvh(ro, rd, arrays_j, statics)
    both = np.asarray(hd.valid)
    assert np.array_equal(both, np.asarray(hb.valid))
    assert np.allclose(
        np.asarray(hb.t)[both], np.asarray(hd.t)[both], rtol=1e-4, atol=1e-4
    )


@pytest.mark.slow
def test_bvh_big_scene(scenes_dir):
    desc = load_scene(scene_path("practice7_3.gltf"), 8, 8, 1)
    arrays, statics = build_scene_arrays(desc)
    import time

    t0 = time.perf_counter()
    arrays = attach_bvh(arrays, statics)
    dt = time.perf_counter() - t0
    assert dt < 120, f"BVH build too slow: {dt:.1f}s"
    treelets = np.asarray(arrays.bvh.aabb).shape[1]
    assert treelets > 500


def test_treelet_odd_batch(rng):
    """A non-multiple-of-128 batch takes the padding path and still equals
    the dense sweep."""
    desc = _soup_desc(rng, n=2100)
    arrays, statics = build_scene_arrays(desc)
    arrays = attach_bvh(arrays, statics)
    arrays_j = jax.tree.map(jnp.asarray, arrays)
    ro, rd = _rand_rays(rng, 4096)
    hd = nearest_hit_dense(ro, rd, arrays_j, statics)
    both = np.asarray(hd.valid)
    ro2 = Vec3(ro.x[:1000], ro.y[:1000], ro.z[:1000])
    rd2 = Vec3(rd.x[:1000], rd.y[:1000], rd.z[:1000])
    h2 = nearest_hit_bvh(ro2, rd2, arrays_j, statics)
    assert np.allclose(
        np.asarray(h2.t)[both[:1000]],
        np.asarray(hd.t)[:1000][both[:1000]],
        rtol=1e-5,
    )


def test_treelet_starved_waves(rng, monkeypatch):
    """RT_TREELET_R0=0 + a tiny straggler cap force EVERY ray through the
    treelet phase-2 wave loop across many waves; results must still equal
    the dense sweep (the wave marks its cap as done and loops)."""
    monkeypatch.setenv("RT_TREELET_R0", "0")
    monkeypatch.setenv("RT_TREELET_CAPDIV", "1000000")  # cap floor = 1024
    desc = _soup_desc(rng, n=2100)
    arrays, statics = build_scene_arrays(desc)
    arrays = attach_bvh(arrays, statics)
    arrays_j = jax.tree.map(jnp.asarray, arrays)
    ro, rd = _rand_rays(rng, 4096)
    hd = nearest_hit_dense(ro, rd, arrays_j, statics)
    hb = nearest_hit_bvh(ro, rd, arrays_j, statics)
    assert np.array_equal(np.asarray(hd.valid), np.asarray(hb.valid))
    both = np.asarray(hd.valid)
    assert np.allclose(
        np.asarray(hb.t)[both], np.asarray(hd.t)[both], rtol=1e-5, atol=1e-5
    )


def test_kd_partition_matches_dense(rng, monkeypatch):
    """The disjoint kd-cell partition (RT_PARTITION=kd, with triangle
    duplication) produces the same nearest hits on both backends."""
    monkeypatch.setenv("RT_PARTITION", "kd")
    desc = _soup_desc(rng, n=1500)
    arrays, statics = build_scene_arrays(desc)
    arrays = attach_bvh(arrays, statics)
    validate_treelets(arrays, statics)
    # duplication happened (some boundary triangle is in 2+ cells)
    assert arrays.ptype.shape[0] >= 1500
    arrays_j = jax.tree.map(jnp.asarray, arrays)
    ro, rd = _rand_rays(rng, 2048)
    hd = nearest_hit_dense(ro, rd, arrays_j, statics)
    hb = nearest_hit_bvh(ro, rd, arrays_j, statics)
    both = np.asarray(hd.valid)
    assert np.array_equal(both, np.asarray(hb.valid))
    assert np.allclose(
        np.asarray(hb.t)[both], np.asarray(hd.t)[both], rtol=1e-5, atol=1e-5
    )
