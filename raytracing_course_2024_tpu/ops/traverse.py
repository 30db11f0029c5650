"""Accelerated nearest-hit backend for big scenes.

One device traversal serves the host-built SAH BVH (ops/bvh.py),
replacing the reference's recursive per-ray walk (src/bvh.rs:231-297):
``ops.treelet`` -- a nearest-first treelet wavefront with per-ray block
gathers, handling every table (incl. boxes/ellipsoids/rotations from
text scenes).

A second backend -- the sorted-pair *grouped* traversal, where
(ray, treelet) pairs were grouped by treelet with one payload-carrying
``lax.sort`` so geometry moved once per 128-pair block -- was DELETED
after its A/Bs on the accelerator this program was first tuned on: it
lost end-to-end in every configuration, including with the regenerating
wavefront engine. Its fixed sort/cull cost per bounce never amortized
against the treelet loop's adaptive cost, which shrinks with live-lane
count. The full implementation (ops/grouped.py, ops/pallas_cull.py,
ops/pallas_grouped.py, RT_K1/K2/K2B tiers, RT_MT_PRECISION splits) is
recoverable at commit ``a7d8d95^``.

A classic batched per-ray BVH stack walk was tried first, on an
accelerator without per-lane random access; see git history.
"""

from __future__ import annotations

from ..scene.types import SceneArrays, SceneStatics
from .treelet import nearest_hit_treelet
from .vec import Vec3


def nearest_hit_bvh(
    ro: Vec3, rd: Vec3, scn: SceneArrays, statics: SceneStatics, tmin=0.0
):
    return nearest_hit_treelet(ro, rd, scn, statics, tmin)
