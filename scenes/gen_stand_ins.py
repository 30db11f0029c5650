"""Generate the two in-repo glTF scenes the renderer's main paths run on.

    python scenes/gen_stand_ins.py [--seed N] [--out DIR]

writes ``cornell_box.gltf`` and ``mesh_bvh.gltf`` (glTF 2.0, one embedded
base64 buffer each) into DIR (default: this directory). Only numpy and the
standard library are used; the output depends on nothing but ``--seed``.

These are STAND-INS for the course's practice7_1 and practice7_3 scene
files, built to their recorded shape -- they are not copies of them, and
images of them are not comparable with images of the course files.

* ``cornell_box.gltf`` (practice7_1's shape: 36 triangles, one emissive
  ceiling quad; the dense backend and the batch engine):
  - room: x in [-1, 1], y in [0, 2], z in [-1, 1], open towards +z;
  - left wall (x = -1) red metallic: base (0.80, 0.10, 0.10), metallic 1,
    roughness 0.3; right wall (x = +1) blue metallic: base
    (0.10, 0.10, 0.80), metallic 1, roughness 0.3;
  - back wall, floor and ceiling white diffuse: base 0.8, metallic 0,
    roughness 1;
  - light: a 0.5 x 0.5 quad at y = 1.98, emissive (1, 1, 1) x strength 12;
  - two grey boxes (base 0.6, metallic 0, roughness 0.8), rotated about
    y, 12 triangles each; their bottoms float 2 mm above the floor so that
    no two faces are coplanar (a coplanar pair is a tie for every ray that
    hits it, and nearest-hit indices could not be compared);
  - camera: perspective, yfov 0.7, aspect 16:9, at (0, 1, 3.4) looking
    down -z.
  Faces carry no NORMAL accessor, so the loader uses flat normals.
* ``mesh_bvh.gltf`` (practice7_3's scale, above the BVH threshold; the BVH
  backend, the treelet traversal and the wavefront engine): the room, light
  and camera above without the two boxes, around an icosphere of
  subdivision 6 (81,920 triangles, 40,962 vertices), radius 0.55, centred
  at (0, 0.75, 0). Each vertex is pushed along its direction by
  ``0.08 * sum_k a_k sin(f_k (u . d_k) + phi_k)`` over 6 random waves whose
  directions, frequencies in [3, 9), phases and weights are drawn from
  ``numpy.random.default_rng(seed)``. Smooth per-vertex normals (area-
  weighted face normals) ride a NORMAL accessor. Material: base
  (0.75, 0.70, 0.60), metallic 0.2, roughness 0.5.
"""

from __future__ import annotations

import argparse
import base64
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

WHITE = {"baseColorFactor": [0.8, 0.8, 0.8, 1.0], "metallicFactor": 0.0,
         "roughnessFactor": 1.0}
MATERIALS = [
    {"name": "white", "pbrMetallicRoughness": WHITE},
    {"name": "red_metal", "pbrMetallicRoughness": {
        "baseColorFactor": [0.8, 0.1, 0.1, 1.0], "metallicFactor": 1.0,
        "roughnessFactor": 0.3}},
    {"name": "blue_metal", "pbrMetallicRoughness": {
        "baseColorFactor": [0.1, 0.1, 0.8, 1.0], "metallicFactor": 1.0,
        "roughnessFactor": 0.3}},
    {"name": "light", "pbrMetallicRoughness": {
        "baseColorFactor": [0.0, 0.0, 0.0, 1.0], "metallicFactor": 0.0,
        "roughnessFactor": 1.0},
     "emissiveFactor": [1.0, 1.0, 1.0],
     "extensions": {"KHR_materials_emissive_strength": {
         "emissiveStrength": 12.0}}},
    {"name": "grey", "pbrMetallicRoughness": {
        "baseColorFactor": [0.6, 0.6, 0.6, 1.0], "metallicFactor": 0.0,
        "roughnessFactor": 0.8}},
    {"name": "subject", "pbrMetallicRoughness": {
        "baseColorFactor": [0.75, 0.7, 0.6, 1.0], "metallicFactor": 0.2,
        "roughnessFactor": 0.5}},
]
WHITE_M, RED_M, BLUE_M, LIGHT_M, GREY_M, SUBJECT_M = range(6)


def _quad(a, b, c, d):
    """Two triangles (a, b, c), (a, c, d) of a planar quad."""
    v = np.array([a, b, c, d], np.float64)
    return v, np.array([[0, 1, 2], [0, 2, 3]])


def _room():
    """(name, material, verts, faces) of the five walls and the light."""
    walls = [
        ("floor", WHITE_M, _quad([-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1])),
        ("ceiling", WHITE_M, _quad([-1, 2, -1], [-1, 2, 1], [1, 2, 1], [1, 2, -1])),
        ("back", WHITE_M, _quad([-1, 0, -1], [-1, 2, -1], [1, 2, -1], [1, 0, -1])),
        ("left", RED_M, _quad([-1, 0, -1], [-1, 0, 1], [-1, 2, 1], [-1, 2, -1])),
        ("right", BLUE_M, _quad([1, 0, -1], [1, 2, -1], [1, 2, 1], [1, 0, 1])),
        ("light", LIGHT_M, _quad([-0.25, 1.98, -0.25], [-0.25, 1.98, 0.25],
                                 [0.25, 1.98, 0.25], [0.25, 1.98, -0.25])),
    ]
    return [(n, m, v, f) for n, m, (v, f) in walls]


def _box(center, half, yaw):
    """12-triangle box around ``center`` turned by ``yaw`` radians about
    +y."""
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float64,
    ) * np.asarray(half, np.float64)
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    verts = corners @ rot.T + np.asarray(center, np.float64)
    # corner index = 4*ix + 2*iy + iz
    faces = np.array([
        [0, 1, 3], [0, 3, 2],  # -x
        [4, 6, 7], [4, 7, 5],  # +x
        [0, 4, 5], [0, 5, 1],  # -y
        [2, 3, 7], [2, 7, 6],  # +y
        [0, 2, 6], [0, 6, 4],  # -z
        [1, 5, 7], [1, 7, 3],  # +z
    ])
    return verts, faces


def _icosphere(subdiv: int):
    """Unit icosphere: (V, 3) verts, (20 * 4**subdiv, 3) faces."""
    p = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([
        [-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
        [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
        [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1],
    ], np.float64)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ])
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(subdiv):
        e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        e.sort(axis=1)
        uniq, inv = np.unique(e, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = len(v) + inv.reshape(3, -1)  # (3, F): mids of edges 01, 12, 20
        v = np.concatenate([v, mid])
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.concatenate([
            np.stack([a, m[0], m[2]], 1), np.stack([b, m[1], m[0]], 1),
            np.stack([c, m[2], m[1]], 1), np.stack([m[0], m[1], m[2]], 1),
        ])
    return v, f


def _vertex_normals(v, f):
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v)
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    return n / np.linalg.norm(n, axis=1, keepdims=True)


def displaced_icosphere(seed: int, subdiv: int = 6):
    """(verts, faces, normals) of the seeded displaced sphere (docstring)."""
    rng = np.random.default_rng(seed)
    u, f = _icosphere(subdiv)
    dirs = rng.normal(size=(6, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    freq = rng.uniform(3.0, 9.0, 6)
    phase = rng.uniform(0.0, 2 * np.pi, 6)
    amp = rng.uniform(0.5, 1.0, 6)
    amp /= amp.sum()
    disp = (amp * np.sin((u @ dirs.T) * freq + phase)).sum(axis=1)
    v = u * (0.55 * (1.0 + 0.08 * disp))[:, None] + np.array([0.0, 0.75, 0.0])
    return v, f, _vertex_normals(v, f)


def _gltf(meshes) -> dict:
    """meshes: [(name, material, verts, faces, normals or None)] -> glTF
    dict with one embedded buffer, one node per mesh, plus the camera."""
    blob = bytearray()
    views, accessors, gl_meshes, nodes = [], [], [], []

    def add(arr, target, ctype, typ):
        raw = np.ascontiguousarray(arr).tobytes()
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(raw), "target": target})
        acc = {"bufferView": len(views) - 1, "componentType": ctype,
               "count": int(arr.shape[0]), "type": typ}
        if typ == "VEC3":
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        accessors.append(acc)
        blob.extend(raw)
        blob.extend(b"\0" * (-len(blob) % 4))
        return len(accessors) - 1

    for name, mat, verts, faces, normals in meshes:
        attrs = {"POSITION": add(verts.astype(np.float32), 34962, 5126, "VEC3")}
        if normals is not None:
            attrs["NORMAL"] = add(normals.astype(np.float32), 34962, 5126, "VEC3")
        idx = add(faces.astype(np.uint32).reshape(-1), 34963, 5125, "SCALAR")
        gl_meshes.append({"name": name, "primitives": [
            {"attributes": attrs, "indices": idx, "material": mat}]})
        nodes.append({"name": name, "mesh": len(gl_meshes) - 1})
    nodes.append({"name": "camera", "camera": 0, "translation": [0.0, 1.0, 3.4]})
    return {
        "asset": {"version": "2.0", "generator": "scenes/gen_stand_ins.py"},
        "extensionsUsed": ["KHR_materials_emissive_strength"],
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": gl_meshes,
        "materials": MATERIALS,
        "cameras": [{"type": "perspective", "perspective": {
            "yfov": 0.7, "aspectRatio": 16.0 / 9.0, "znear": 0.1}}],
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{
            "byteLength": len(blob),
            "uri": "data:application/octet-stream;base64,"
            + base64.b64encode(bytes(blob)).decode("ascii"),
        }],
    }


def cornell_box() -> dict:
    meshes = [(n, m, v, f, None) for n, m, v, f in _room()]
    meshes.append(("tall_box", GREY_M) + _box([-0.35, 0.602, -0.3],
                                              [0.3, 0.6, 0.3], 0.3) + (None,))
    meshes.append(("short_box", GREY_M) + _box([0.4, 0.302, 0.35],
                                               [0.3, 0.3, 0.3], -0.3) + (None,))
    return _gltf(meshes)


def mesh_bvh(seed: int) -> dict:
    meshes = [(n, m, v, f, None) for n, m, v, f in _room()]
    meshes.append(("subject", SUBJECT_M) + displaced_icosphere(seed))
    return _gltf(meshes)


def write(out_dir: str = HERE, seed: int = 0) -> dict:
    """Write both scenes into ``out_dir``; returns {name: path}."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, doc in (("cornell_box.gltf", cornell_box()),
                      ("mesh_bvh.gltf", mesh_bvh(seed))):
        paths[name] = os.path.join(out_dir, name)
        with open(paths[name], "w") as fh:
            json.dump(doc, fh, indent=1)
    return paths


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=HERE)
    args = ap.parse_args()
    for p in write(args.out, args.seed).values():
        print("wrote", p)
