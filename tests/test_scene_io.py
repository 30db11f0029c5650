"""Scene ingestion tests: text grammar + glTF parity stats.

Golden numbers come from the reference's own printouts/data: practice7_1 is a
Cornell box with 36 triangles and 2 emissive ones ("Light" material, ceiling
quad), per SURVEY.md section 2.2 scene stats.
"""

import numpy as np
import pytest

from conftest import scene_path
from raytracing_course_2024_tpu.scene import (
    BOX,
    DIELECTRIC,
    ELLIPSOID,
    MIRROR,
    PBR,
    TRI,
    build_scene_arrays,
    load_scene,
    parse_text_scene,
)

SIMPLE = """
DIMENSIONS 64 48
RAY_DEPTH 3
SAMPLES 4
BG_COLOR 1 0.5 0.25
CAMERA_POSITION 0 2 0
CAMERA_RIGHT 1 0 0
CAMERA_UP 0 1 0
CAMERA_FORWARD 0 0 -1
CAMERA_FOV_X 1.5

NEW_PRIMITIVE
PLANE 0 1 0
COLOR 0.25 0.25 0.5

NEW_PRIMITIVE
ELLIPSOID 2 2 2
POSITION -3 2 -6
COLOR 0.5 0.25 0.25
EMISSION 1 2 3

NEW_PRIMITIVE
BOX 1 2 1
POSITION 3 2.5 -6
ROTATION 0 0.3826834 0 0.9238795
COLOR 0.25 0.5 0.25
METALLIC

NEW_PRIMITIVE
TRIANGLE 0 0 0  1 0 0  0 1 0
POSITION 0 0 -3
COLOR 1 1 1
DIELECTRIC
IOR 1.5
"""


def test_text_grammar():
    desc = parse_text_scene(SIMPLE)
    s = desc.settings
    assert (s.width, s.height, s.samples, s.ray_depth) == (64, 48, 4, 3)
    assert s.bg_color == (1.0, 0.5, 0.25)
    assert abs(s.camera.fov_x - 1.5) < 1e-12
    # fov_y from aspect: tan(fy/2) = tan(fx/2) * h/w
    import math

    assert abs(math.tan(s.camera.fov_y / 2) - math.tan(0.75) * 48 / 64) < 1e-12

    assert len(desc.planes) == 1
    assert len(desc.primitives) == 3
    ell, box, tri = desc.primitives
    assert ell.ptype == ELLIPSOID and ell.is_emissive
    assert box.ptype == BOX and box.mkind == MIRROR
    assert np.allclose(box.rotation, [0, 0.3826834, 0, 0.9238795], atol=1e-6)
    assert tri.ptype == TRI and tri.mkind == DIELECTRIC and tri.ior == 1.5


def test_text_build_arrays():
    desc = parse_text_scene(SIMPLE)
    arrays, statics = build_scene_arrays(desc)
    assert statics.num_prims == 3
    assert statics.num_planes == 1
    assert statics.num_lights == 1
    assert statics.any_nontri and statics.any_rotation
    # triangle transform baked into world space vertices
    tri_row = 2
    assert np.allclose(arrays.p0[tri_row], [0, 0, -3], atol=1e-6)
    assert np.allclose(arrays.position[tri_row], 0)
    # ellipsoid light inv_area = 1/(4 pi)
    assert np.isclose(arrays.light_inv_area[0], 1 / (4 * np.pi), atol=1e-7)


def test_all_course_text_scenes_parse(scenes_dir):
    import glob
    import os

    paths = sorted(glob.glob(os.path.join(scenes_dir, "*.txt")))
    if not paths:
        pytest.skip("the course's text scenes are not available")
    totals = dict(prims=0, planes=0)
    for path in paths:
        desc = load_scene(path)
        assert desc.settings.width > 0 and desc.settings.height > 0
        totals["prims"] += len(desc.primitives)
        totals["planes"] += len(desc.planes)
    # census from SURVEY.md section 2.2: 1408 primitives, 22 of them planes
    assert totals["prims"] + totals["planes"] == 1408
    assert totals["planes"] == 22


def test_gltf_cornell_box(scenes_dir):
    desc = load_scene(scene_path("cornell_box.gltf"), 128, 72, 4)
    assert len(desc.primitives) == 36  # SURVEY.md: Cornell box, 36 tris
    lights = [p for p in desc.primitives if p.is_emissive]
    assert len(lights) == 2  # the "Light" quad = 2 triangles
    assert all(p.mkind == PBR for p in desc.primitives)
    assert all(p.ptype == TRI for p in desc.primitives)
    s = desc.settings
    assert (s.width, s.height, s.samples, s.ray_depth) == (128, 72, 4, 6)
    assert s.bg_color == (0.0, 0.0, 0.0)
    # camera basis should be orthonormal-ish for the course scenes
    c = s.camera
    assert abs(np.dot(c.right, c.forward)) < 1e-5
    assert abs(np.dot(c.up, c.forward)) < 1e-5
    # roughness clamp (reference gltf_to_scene.rs:221)
    assert all(p.roughness >= 0.03 for p in desc.primitives)


def test_gltf_big_scene_counts(scenes_dir):
    desc = load_scene(scene_path("practice7_2.gltf"), 64, 64, 1)
    assert len(desc.primitives) == 144_058  # SURVEY.md section 2.2


def test_gltf_emissive_strength(scenes_dir):
    desc = load_scene(scene_path("cornell_box.gltf"), 64, 64, 1)
    lights = [p for p in desc.primitives if p.is_emissive]
    # KHR_materials_emissive_strength multiplies emissive_factor; Cornell
    # lights are much brighter than 1
    assert max(np.max(p.emission) for p in lights) > 1.0


def test_orphaned_bin_rejected(scenes_dir):
    """A raw .bin buffer is refused by its extension, before any read."""
    import os

    with pytest.raises(ValueError, match="raw glTF buffer"):
        load_scene(os.path.join(scenes_dir, "practice6_1.bin"), 8, 8, 1)


def test_practice6_1_reconstructed_wrapper(scenes_dir):
    """The reconstructed wrapper (repo scenes/, see scenes/gen_practice6_1.py)
    must segment the orphaned reference .bin byte-exactly: ground quad +
    torus + cube + Suzanne = 16910 world triangles, with both stand-in area
    lights emissive and the camera present."""
    import os

    scene_path("practice6_1.bin")  # the course buffer; skips when absent
    repo_scenes = os.path.join(os.path.dirname(__file__), "..", "scenes")
    path = os.path.join(repo_scenes, "practice6_1.gltf")
    desc = load_scene(path, 64, 48, 1)
    assert len(desc.primitives) == 2 + 1152 + 12 + 15744
    lights = [p for p in desc.primitives if p.is_emissive]
    assert len(lights) == 1152 + 12  # torus + cube are the lights
    assert max(np.max(p.emission) for p in lights) > 1.0
    assert desc.settings.camera is not None
    # accessor layout consumes the buffer byte-exactly (the proof the
    # segmentation is complete -- PARITY.md round 5)
    import json

    with open(path) as f:
        doc = json.load(f)
    total = sum(bv["byteLength"] for bv in doc["bufferViews"])
    assert total == doc["buffers"][0]["byteLength"] == 1183700


def test_stand_in_generator(tmp_path):
    """scenes/gen_stand_ins.py is deterministic, its Cornell box is the
    committed file, and both scenes load through load_scene at their
    recorded shapes: 36 all-triangle primitives with one emitter (the
    two-triangle ceiling quad), and a mesh above the BVH threshold."""
    import importlib.util
    import os

    from raytracing_course_2024_tpu.runtime.render import BVH_THRESHOLD

    repo_scenes = os.path.join(os.path.dirname(__file__), "..", "scenes")
    spec = importlib.util.spec_from_file_location(
        "gen_stand_ins", os.path.join(repo_scenes, "gen_stand_ins.py")
    )
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    paths = gen.write(str(tmp_path), seed=0)
    with open(paths["cornell_box.gltf"]) as a, open(
        os.path.join(repo_scenes, "cornell_box.gltf")
    ) as b:
        assert a.read() == b.read()

    desc = load_scene(paths["cornell_box.gltf"], 32, 18, 1)
    assert len(desc.primitives) == 36 and not desc.planes
    assert all(p.ptype == TRI for p in desc.primitives)
    lights = [p for p in desc.primitives if p.is_emissive]
    assert len(lights) == 2
    ys = np.concatenate([[p.p0[1], p.p1[1], p.p2[1]] for p in lights])
    assert np.allclose(ys, 1.98)  # one quad just under the ceiling

    big = load_scene(paths["mesh_bvh.gltf"], 32, 18, 1)
    assert len(big.primitives) == 12 + 20 * 4 ** 6 > BVH_THRESHOLD
    assert sum(p.is_emissive for p in big.primitives) == 2
    other = gen.mesh_bvh(seed=1)
    assert other["buffers"] != gen.mesh_bvh(seed=0)["buffers"]
