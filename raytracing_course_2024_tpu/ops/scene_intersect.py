"""Scene-level nearest-hit queries and surface shading data.

Two-phase design: a cheap *t-only* sweep finds the nearest
primitive per ray (dense over the SoA table, chunked through a ``lax.scan``
so peak memory is B x CHUNK regardless of scene size), then a *detail* pass
re-intersects only the winning primitive per ray to produce normals and
material data. The reference instead returns full ``Intersection`` structs
from every BVH leaf test (src/bvh.rs:264-277); recomputing details once per
ray is far cheaper than materializing them per candidate.

The dense sweep is the brute-force backend for small scenes (practice3 text
scenes, practice7_1's 36 triangles); ops.traverse supplies the BVH backend
for the 100k+ triangle scenes and reuses ``surface_detail`` unchanged.

Scene = unified finite table + infinite planes, combined exactly like the
reference's ``intersect_ray_with_scene`` (src/rendering.rs:201-226): nearest
BVH hit, then a linear scan over infinite planes keeping the closer one.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..scene.types import BOX, ELLIPSOID, SceneArrays, SceneStatics
from .intersect import (
    INF,
    box_normal,
    ellipsoid_normal,
    normal_to_world,
    ray_box_interval,
    ray_ellipsoid_interval,
    ray_plane_t,
    ray_triangle,
    to_local,
)
from .vec import Quat, Vec3, where3

DENSE_CHUNK = 1024  # prims per scan step in the dense sweep


class SceneHit(NamedTuple):
    t: jnp.ndarray  # (B,) f32, +inf on miss
    idx: jnp.ndarray  # (B,) i32 into finite table (or plane table)
    is_plane: jnp.ndarray  # (B,) bool
    valid: jnp.ndarray  # (B,) bool


class Surface(NamedTuple):
    """Shading data at a hit point (world space)."""

    t: jnp.ndarray
    point: Vec3  # EPS-backed-off hit point (src/rendering.rs:98)
    n_geom: Vec3  # geometric normal, flipped to face the ray
    n_shade: Vec3  # shading normal, flipped to face the ray
    is_outer: jnp.ndarray  # bool: ray entered from outside
    color: Vec3
    metallic: jnp.ndarray
    roughness: jnp.ndarray
    emission: Vec3
    ior: jnp.ndarray
    mkind: jnp.ndarray  # i32 material kind


def _v3(arr: jnp.ndarray) -> Vec3:
    return Vec3(arr[..., 0], arr[..., 1], arr[..., 2])


def _q4(arr: jnp.ndarray) -> Quat:
    return Quat(arr[..., 0], arr[..., 1], arr[..., 2], arr[..., 3])


def _expand(v: Vec3) -> Vec3:
    """(B,) components -> (B, 1) for broadcasting against (K,) prim axes."""
    return Vec3(v.x[:, None], v.y[:, None], v.z[:, None])


class PrimRef(NamedTuple):
    """Geometry of one (broadcastable batch of) primitive(s), SoA components.

    Built either from table columns (dense sweep: loop-invariant slices) or
    from a packed gather (BVH leaves) -- never from (B, 3) row gathers."""

    ptype: jnp.ndarray
    p0: Vec3
    p1: Vec3
    p2: Vec3
    pos: Vec3
    rot: Quat


def prim_ref_from_table(scn: SceneArrays, sl=slice(None)) -> PrimRef:
    return PrimRef(
        ptype=scn.ptype[sl],
        p0=_v3(scn.p0[sl]),
        p1=_v3(scn.p1[sl]),
        p2=_v3(scn.p2[sl]),
        pos=_v3(scn.position[sl]),
        rot=_q4(scn.rotation[sl]),
    )


def prim_ref_from_packed(g: jnp.ndarray) -> PrimRef:
    """g: (PrimCol.COUNT, ...) packed gather -> PrimRef of (...)-arrays."""
    from ..scene.types import PrimCol as PC

    def v3r(base):
        return Vec3(g[base], g[base + 1], g[base + 2])

    return PrimRef(
        ptype=g[PC.PTYPE],
        p0=v3r(PC.P0),
        p1=v3r(PC.P1),
        p2=v3r(PC.P2),
        pos=v3r(PC.POS),
        rot=Quat(g[PC.ROT], g[PC.ROT + 1], g[PC.ROT + 2], g[PC.ROT + 3]),
    )


def _prim_ts(ro_b: Vec3, rd_b: Vec3, prim: PrimRef, statics: SceneStatics,
             tmin) -> jnp.ndarray:
    """t matrix (B, K) for a batch of primitives; inf = miss.

    Picks the nearest *strictly > tmin* root, replicating the reference's
    first-of-all-points semantics (src/geometry.rs:51-58, 170-189)."""
    ro = ro_b
    rd = rd_b
    if statics.any_rotation:
        ro, rd = to_local(ro, rd, prim.pos, prim.rot, True)
    elif statics.any_nontri:
        ro = ro - prim.pos

    t_tri, _, _, v_tri = ray_triangle(ro_b, rd_b, prim.p0, prim.p1, prim.p2)
    t = jnp.where(v_tri & (t_tri > tmin), t_tri, INF)

    if statics.any_nontri:
        ib = ray_box_interval(ro, rd, prim.p0)
        ie = ray_ellipsoid_interval(ro, rd, prim.p0)

        def nearest_pos(iv):
            t1 = jnp.where(iv.valid & (iv.t1 > tmin), iv.t1, INF)
            t2 = jnp.where(iv.valid & (iv.t2 > tmin), iv.t2, INF)
            return jnp.minimum(t1, t2)

        t = jnp.where(prim.ptype == BOX, nearest_pos(ib), t)
        t = jnp.where(prim.ptype == ELLIPSOID, nearest_pos(ie), t)
    return t


def nearest_hit_dense(
    ro: Vec3, rd: Vec3, scn: SceneArrays, statics: SceneStatics, tmin=0.0
) -> SceneHit:
    """Brute-force nearest hit over the finite table + planes.

    Small all-triangle scenes (``scn.tri_pack`` set) take the fused Pallas
    kernel (ops/pallas_intersect.py) when the program is compiled for the
    GPU; everything else, and every CPU program, takes the chunked XLA
    sweep below."""
    n = scn.ptype.shape[0]

    if scn.tri_pack is not None and jax.default_backend() == "gpu":
        from .pallas_intersect import pallas_dense_nearest

        best_t, best_idx = pallas_dense_nearest(ro, rd, scn.tri_pack, tmin)
        hit = SceneHit(
            best_t, best_idx, jnp.zeros_like(best_idx, bool), jnp.isfinite(best_t)
        )
        if statics.num_planes > 0:
            hit = _fold_in_planes(ro, rd, scn, hit, tmin)
        return hit

    ro_b = _expand(ro)
    rd_b = _expand(rd)

    if n <= DENSE_CHUNK:
        t_mat = _prim_ts(ro_b, rd_b, prim_ref_from_table(scn), statics, tmin)
        best_idx = jnp.argmin(t_mat, axis=1).astype(jnp.int32)
        best_t = jnp.min(t_mat, axis=1)
    else:
        num_chunks = -(-n // DENSE_CHUNK)
        pad = num_chunks * DENSE_CHUNK - n

        def padded(a):
            widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, widths).reshape((num_chunks, DENSE_CHUNK) + a.shape[1:])

        base = prim_ref_from_table(scn)
        chunked = jax.tree.map(padded, base)

        def body(carry, chunk):
            best_t, best_idx, ci = carry
            t_mat = _prim_ts(ro_b, rd_b, chunk, statics, tmin)
            loc = jnp.argmin(t_mat, axis=1).astype(jnp.int32)
            tloc = jnp.min(t_mat, axis=1)
            take = tloc < best_t
            best_idx = jnp.where(take, ci * DENSE_CHUNK + loc, best_idx)
            best_t = jnp.minimum(best_t, tloc)
            return (best_t, best_idx, ci + 1), None

        b = ro.x.shape[0]
        init = (
            jnp.full((b,), INF),
            jnp.zeros((b,), jnp.int32),
            jnp.int32(0),
        )
        (best_t, best_idx, _), _ = jax.lax.scan(body, init, chunked)

    hit = SceneHit(best_t, best_idx, jnp.zeros_like(best_idx, bool), jnp.isfinite(best_t))
    if statics.num_planes > 0:
        hit = _fold_in_planes(ro, rd, scn, hit, tmin)
    return hit


def _fold_in_planes(ro: Vec3, rd: Vec3, scn: SceneArrays, hit: SceneHit, tmin) -> SceneHit:
    """Linear scan over infinite planes (src/rendering.rs:215-224)."""
    ro_b = _expand(ro)
    rd_b = _expand(rd)
    pos = _v3(scn.pl_position)
    rot = _q4(scn.pl_rotation)
    o, d = to_local(ro_b, rd_b, pos, rot, True)
    t, v = ray_plane_t(o, d, _v3(scn.pl_normal))
    t = jnp.where(v & (t > tmin) & scn.pl_mask, t, INF)  # (B, P)
    pidx = jnp.argmin(t, axis=1).astype(jnp.int32)
    pt = jnp.min(t, axis=1)
    closer = pt < hit.t
    return SceneHit(
        jnp.minimum(hit.t, pt),
        jnp.where(closer, pidx, hit.idx),
        jnp.where(closer, True, hit.is_plane),
        hit.valid | jnp.isfinite(pt),
    )


def surface_detail(
    ro: Vec3,
    rd: Vec3,
    hit: SceneHit,
    scn: SceneArrays,
    statics: SceneStatics,
    tmin=0.0,
    eps_backoff: float = 1e-4,
) -> Surface:
    """Re-intersect the winning primitive per ray to get normals + material.

    Normal orientation matches the reference: geometric and shading normals
    are flipped to face the incoming ray (src/geometry.rs:114-126 triangles;
    src/geometry.rs:170-189 box entry/exit).

    All per-ray attributes come from ONE packed-table gather
    (ops/gather.py) instead of one (B, 3) row gather per attribute."""
    from ..scene.types import PrimCol as PC
    from .gather import take_packed

    idx = jnp.clip(hit.idx, 0, scn.ptype.shape[0] - 1)
    g = take_packed(scn.packed, idx)  # (PrimCol.COUNT, B)

    def v3r(base):
        return Vec3(g[base], g[base + 1], g[base + 2])

    p0 = v3r(PC.P0)
    rot = Quat(g[PC.ROT], g[PC.ROT + 1], g[PC.ROT + 2], g[PC.ROT + 3])
    pos = v3r(PC.POS)
    o, d = to_local(ro, rd, pos, rot, statics.any_rotation)

    # --- triangle branch ---------------------------------------------------
    a, b, c = p0, v3r(PC.P1), v3r(PC.P2)
    t_tri, u, v, _ = ray_triangle(ro, rd, a, b, c)
    flat_n = (b - a).cross(c - a).normalize()
    tri_front = flat_n.dot(rd) < 0.0
    sn0, sn1, sn2 = v3r(PC.SN0), v3r(PC.SN1), v3r(PC.SN2)
    ns = (sn0 + (sn1 - sn0) * u + (sn2 - sn0) * v).normalize()
    sign_tri = jnp.where(tri_front, 1.0, -1.0)
    tri_ng = flat_n * sign_tri
    tri_ns = ns * sign_tri
    n_geom, n_shade, is_outer, t_best = tri_ng, tri_ns, tri_front, t_tri

    if statics.any_nontri:
        ptype = g[PC.PTYPE]
        # --- box ---
        ib = ray_box_interval(o, d, p0)
        box_outer = ib.valid & (ib.t1 > tmin)
        t_box = jnp.where(box_outer, ib.t1, ib.t2)
        p_loc = o + d * t_box
        bn = box_normal(p_loc, p0)
        bn = where3(box_outer, bn, -bn)
        bn = normal_to_world(bn, rot, statics.any_rotation)
        # --- ellipsoid ---
        ie = ray_ellipsoid_interval(o, d, p0)
        ell_outer = ie.valid & (ie.t1 > tmin)
        t_ell = jnp.where(ell_outer, ie.t1, ie.t2)
        p_ell = o + d * t_ell
        en = ellipsoid_normal(p_ell, p0)
        en = where3(ell_outer, en, -en)
        en = normal_to_world(en, rot, statics.any_rotation)

        is_box = ptype == BOX
        is_ell = ptype == ELLIPSOID
        t_best = jnp.where(is_box, t_box, jnp.where(is_ell, t_ell, t_tri))
        n_geom = where3(is_box, bn, where3(is_ell, en, tri_ng))
        n_shade = where3(is_box, bn, where3(is_ell, en, tri_ns))
        is_outer = jnp.where(
            is_box, box_outer, jnp.where(is_ell, ell_outer, tri_front)
        )

    color = v3r(PC.COLOR)
    metallic = g[PC.METALLIC]
    roughness = g[PC.ROUGHNESS]
    emission = v3r(PC.EMISSION)
    ior = g[PC.IOR]
    mkind = g[PC.MKIND]

    if statics.num_planes > 0:
        from ..scene.types import PlaneCol as PL

        pidx = jnp.clip(hit.idx, 0, scn.pl_normal.shape[0] - 1)
        gp = take_packed(scn.plane_packed, pidx)  # (PlaneCol.COUNT, B)

        def pv3(base):
            return Vec3(gp[base], gp[base + 1], gp[base + 2])

        prot = Quat(gp[PL.ROT], gp[PL.ROT + 1], gp[PL.ROT + 2], gp[PL.ROT + 3])
        ppos = pv3(PL.POS)
        po, pd = to_local(ro, rd, ppos, prot, True)
        pn_local = pv3(PL.NORMAL)
        pt, _ = ray_plane_t(po, pd, pn_local)
        pn_world = normal_to_world(pn_local.normalize(), prot, True)
        p_front = pn_world.dot(rd) < 0.0
        pn = pn_world * jnp.where(p_front, 1.0, -1.0)

        ip = hit.is_plane
        t_best = jnp.where(ip, pt, t_best)
        n_geom = where3(ip, pn, n_geom)
        n_shade = where3(ip, pn, n_shade)
        is_outer = jnp.where(ip, p_front, is_outer)
        color = where3(ip, pv3(PL.COLOR), color)
        metallic = jnp.where(ip, gp[PL.METALLIC], metallic)
        roughness = jnp.where(ip, gp[PL.ROUGHNESS], roughness)
        emission = where3(ip, pv3(PL.EMISSION), emission)
        ior = jnp.where(ip, gp[PL.IOR], ior)
        mkind = jnp.where(ip, gp[PL.MKIND], mkind)

    # miss lanes carry t = inf; clamp so downstream (masked) math never sees
    # inf/NaN coordinates
    t_final = jnp.where(hit.valid, hit.t, 1.0)
    point = ro + rd * (t_final - eps_backoff)
    return Surface(
        t=t_final,
        point=point,
        n_geom=n_geom,
        n_shade=n_shade,
        is_outer=is_outer,
        color=color,
        metallic=metallic,
        roughness=roughness,
        emission=emission,
        ior=ior,
        mkind=mkind,
    )
