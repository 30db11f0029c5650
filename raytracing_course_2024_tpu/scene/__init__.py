"""Scene ingestion: text-format and glTF parsers -> SoA device arrays.

Reference analog: src/gltf_to_scene.rs (glTF), the dropped text parser
(grammar per SURVEY.md section 2.2), and src/scene.rs (data model).
"""

from __future__ import annotations

import os

from .build import build_scene_arrays
from .gltf import load_gltf_scene
from .text_format import load_text_scene, parse_text_scene
from .types import (
    BOX,
    DIELECTRIC,
    DIFFUSE,
    ELLIPSOID,
    EPS,
    MIRROR,
    PBR,
    PLANE,
    TRI,
    BvhArrays,
    CameraDesc,
    PrimitiveDesc,
    RenderSettings,
    SceneArrays,
    SceneDesc,
    SceneStatics,
)

# Default scene directory: the checkout's scenes/ (the generated stand-ins,
# scenes/gen_stand_ins.py). Override with RT_SCENES_DIR.
SCENES_DIR = os.environ.get(
    "RT_SCENES_DIR",
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "scenes",
    ),
)


def load_scene(path: str, width: int = 0, height: int = 0, samples: int = 0):
    """Dispatch on extension. For .txt, width/height/samples come from the
    file (argv values, if nonzero, override -- matching the reference CLI
    contract where glTF gets them from argv, src/main.rs:37-43)."""
    if path.endswith(".bin"):
        raise ValueError(
            f"{path} is a raw glTF buffer, not a scene: its .gltf JSON "
            "wrapper is required (the course snapshot's practice6_1.bin is "
            "orphaned -- no loader, including the reference's, can ingest it)"
        )
    if path.endswith(".gltf") or path.endswith(".glb"):
        if not (width and height and samples):
            raise ValueError("glTF scenes require width/height/samples")
        return load_gltf_scene(path, width, height, samples)
    desc = load_text_scene(path)
    if width:
        desc.settings.width = width
    if height:
        desc.settings.height = height
    if samples:
        desc.settings.samples = samples
    return desc


__all__ = [
    "BOX",
    "DIELECTRIC",
    "DIFFUSE",
    "ELLIPSOID",
    "EPS",
    "MIRROR",
    "PBR",
    "PLANE",
    "TRI",
    "BvhArrays",
    "CameraDesc",
    "PrimitiveDesc",
    "RenderSettings",
    "SceneArrays",
    "SceneDesc",
    "SceneStatics",
    "SCENES_DIR",
    "build_scene_arrays",
    "load_gltf_scene",
    "load_scene",
    "load_text_scene",
    "parse_text_scene",
]
