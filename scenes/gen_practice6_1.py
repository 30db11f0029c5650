"""Generate scenes/practice6_1.gltf -- a reconstructed JSON wrapper for the
orphaned /root/reference/scenes/practice6_1.bin (SURVEY.md section 2.2: the
reference snapshot ships the 1.18 MB Blender-exported buffer but not its
.gltf).

What is RECOVERED (exact, from the buffer): four meshes in the standard
Khronos Blender I/O layout (POSITION/NORMAL/TEXCOORD_0/indices-u16 per
primitive, byte-exactly consuming the file):
  @0       ground quad   V=4     T=2
  @140     torus         V=2304  T=1152  (major r=1, tube r=0.0625)
  @80780   cube          V=24    T=12    (unit half-extent)
  @81620   Suzanne       V=31488 T=15744 (Blender monkey proportions)

What is NOT in the buffer (provably -- zero bytes remain): node transforms,
materials, camera, lights. Those lived only in the lost JSON. This wrapper
supplies course-convention stand-ins for the light-sampling practice: the
cube and torus are small emissive area lights (the scene the MIS/NEE
distributions chapter needs), Suzanne is the diffuse subject, the quad is
the ground. Geometry parity with the original is exact; appearance parity
is unknowable from the snapshot (documented in PARITY.md).
"""

import json
import os

SECTIONS = [  # (name, byte_start, V, I)
    ("plane", 0, 4, 6),
    ("torus", 140, 2304, 3456),
    ("cube", 80780, 24, 36),
    ("suzanne", 81620, 31488, 47232),
]

doc = {
    "asset": {
        "version": "2.0",
        "generator": "practice6_1 wrapper reconstruction (see gen_practice6_1.py)",
    },
    "scene": 0,
    "extensionsUsed": ["KHR_materials_emissive_strength"],
    "buffers": [{"uri": "practice6_1.bin", "byteLength": 1183700}],
    "bufferViews": [],
    "accessors": [],
    "meshes": [],
    "materials": [
        {
            "name": "ground",
            "pbrMetallicRoughness": {
                "baseColorFactor": [0.68, 0.68, 0.68, 1.0],
                "metallicFactor": 0.0,
                "roughnessFactor": 1.0,
            },
        },
        {
            "name": "torus_light",
            "pbrMetallicRoughness": {
                "baseColorFactor": [0.0, 0.0, 0.0, 1.0],
                "metallicFactor": 0.0,
                "roughnessFactor": 1.0,
            },
            "emissiveFactor": [1.0, 0.62, 0.3],
            "extensions": {
                "KHR_materials_emissive_strength": {"emissiveStrength": 16.0}
            },
        },
        {
            "name": "cube_light",
            "pbrMetallicRoughness": {
                "baseColorFactor": [0.0, 0.0, 0.0, 1.0],
                "metallicFactor": 0.0,
                "roughnessFactor": 1.0,
            },
            "emissiveFactor": [1.0, 1.0, 1.0],
            "extensions": {
                "KHR_materials_emissive_strength": {"emissiveStrength": 30.0}
            },
        },
        {
            "name": "suzanne",
            "pbrMetallicRoughness": {
                "baseColorFactor": [0.78, 0.55, 0.35, 1.0],
                "metallicFactor": 0.0,
                "roughnessFactor": 0.8,
            },
        },
    ],
    "nodes": [],
    "scenes": [{"nodes": []}],
    "cameras": [
        {
            "type": "perspective",
            "perspective": {"yfov": 0.8, "aspectRatio": 1.3333333, "znear": 0.1},
        }
    ],
}

for mi, (name, b, V, I) in enumerate(SECTIONS):
    bv0 = len(doc["bufferViews"])
    acc0 = len(doc["accessors"])
    doc["bufferViews"] += [
        {"buffer": 0, "byteOffset": b, "byteLength": 12 * V, "target": 34962},
        {"buffer": 0, "byteOffset": b + 12 * V, "byteLength": 12 * V, "target": 34962},
        {"buffer": 0, "byteOffset": b + 24 * V, "byteLength": 8 * V, "target": 34962},
        {"buffer": 0, "byteOffset": b + 32 * V, "byteLength": 2 * I, "target": 34963},
    ]
    doc["accessors"] += [
        {"bufferView": bv0, "componentType": 5126, "count": V, "type": "VEC3"},
        {"bufferView": bv0 + 1, "componentType": 5126, "count": V, "type": "VEC3"},
        {"bufferView": bv0 + 2, "componentType": 5126, "count": V, "type": "VEC2"},
        {"bufferView": bv0 + 3, "componentType": 5123, "count": I, "type": "SCALAR"},
    ]
    doc["meshes"].append(
        {
            "name": name,
            "primitives": [
                {
                    "attributes": {
                        "POSITION": acc0,
                        "NORMAL": acc0 + 1,
                        "TEXCOORD_0": acc0 + 2,
                    },
                    "indices": acc0 + 3,
                    "material": mi,
                }
            ],
        }
    )

doc["nodes"] = [
    {"name": "ground", "mesh": 0, "scale": [6.0, 1.0, 6.0]},
    {
        "name": "torus_light",
        "mesh": 1,
        "translation": [-1.7, 1.35, -0.3],
        "rotation": [0.3826834, 0.0, 0.1913417, 0.9045085],
        "scale": [0.55, 0.55, 0.55],
    },
    {
        "name": "cube_light",
        "mesh": 2,
        "translation": [1.3, 2.2, 1.7],
        "scale": [0.12, 0.12, 0.12],
    },
    # Suzanne's exported local +z is the face side (bbox +z 0.82 vs -z
    # -0.78: brow/snout protrude) -- identity rotation faces the camera
    {"name": "suzanne", "mesh": 3, "translation": [0.0, 0.975, 0.0]},
    {
        "name": "camera",
        "camera": 0,
        "translation": [0.0, 1.7, 4.4],
        # look slightly down at Suzanne: pitch -9 deg about x
        "rotation": [-0.0784591, 0.0, 0.0, 0.9969173],
    },
]
doc["scenes"][0]["nodes"] = list(range(len(doc["nodes"])))

out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "practice6_1.gltf")
with open(out, "w") as f:
    json.dump(doc, f, indent=1)
print("wrote", out)
