"""Host-side BVH construction (vectorized numpy binned SAH) -> flat device arrays.

The reference builds a binary SAH BVH with a full-sweep over all 3 axes,
re-sorting the primitive slice per axis with a comparator that *recomputes
AABBs on every comparison* (src/bvh.rs:87-144) -- O(n log^2 n) with a huge
constant. SURVEY.md section 7 explicitly says not to copy that. Here:

* AABBs and centroids are precomputed once, vectorized (the reference's
  rotate-8-corners object AABB, src/aabb.rs:75-94, done for all prims at
  once);
* top-down build with 16-bin SAH per axis (classic binned SAH), leaf when
  n <= LEAF_SIZE or when the best split is no cheaper than the trivial
  leaf cost area*n (the reference's same leaf criterion, src/bvh.rs:88,127);
* output is a flat array pile (SceneArrays.bvh: BvhArrays) with leaves
  padded to exactly LEAF_SIZE primitive slots so the device traversal's
  leaf test is a fixed-shape dense intersection;
* the primitive table is reordered so leaf ranges are contiguous, and the
  light index list is remapped (the reference instead *owns* a reordered
  copy per tree, src/bvh.rs:20-24).

An optional C++ builder (native/bvh_builder.cpp, loaded via ctypes) provides
the same construction ~10x faster for the 100k+ triangle scenes; the numpy
path is the always-available fallback and the correctness oracle.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np

from ..scene.types import TRI, SceneArrays, SceneStatics

log = logging.getLogger("rt")

LEAF_SIZE = 4
NUM_BINS = 16
AABB_EPS = 1e-4  # pad, reference src/aabb.rs:53-65 pads by EPS
KD_CELL = 512  # disjoint kd cell size (duplication 1.28x on practice7_3)


def _rot_mat(q: np.ndarray) -> np.ndarray:
    """(M,4) xyzw quaternions -> (M,3,3) rotation matrices."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=1,
    )


def primitive_aabbs(scn: SceneArrays) -> tuple:
    """(aabb_min (N,3), aabb_max (N,3)) for the finite table, world space.

    Triangles: vertex min/max (verts are pre-baked world space).
    Box/ellipsoid: local AABB = +-s, rotated via all 8 corners + position
    (reference src/aabb.rs:75-94)."""
    p0 = np.asarray(scn.p0, np.float64)
    p1 = np.asarray(scn.p1, np.float64)
    p2 = np.asarray(scn.p2, np.float64)
    ptype = np.asarray(scn.ptype)
    n = p0.shape[0]

    amin = np.minimum(np.minimum(p0, p1), p2)
    amax = np.maximum(np.maximum(p0, p1), p2)

    nontri = ptype != TRI
    if nontri.any():
        s = p0[nontri]  # half extents / radii
        q = np.asarray(scn.rotation, np.float64)[nontri]
        pos = np.asarray(scn.position, np.float64)[nontri]
        rot = _rot_mat(q)  # (M,3,3)
        # 8 corners of [-s, s]
        signs = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            np.float64,
        )  # (8,3)
        corners = signs[None, :, :] * s[:, None, :]  # (M,8,3)
        world = np.einsum("mij,mkj->mki", rot, corners) + pos[:, None, :]
        amin[nontri] = world.min(axis=1)
        amax[nontri] = world.max(axis=1)

    return amin - AABB_EPS, amax + AABB_EPS


class _HostBvh(NamedTuple):
    node_min: np.ndarray
    node_max: np.ndarray
    node_left: np.ndarray
    node_right: np.ndarray
    node_is_leaf: np.ndarray
    prim_order: np.ndarray


def build_bvh(amin: np.ndarray, amax: np.ndarray) -> _HostBvh:
    """Binned-SAH binary BVH over the given AABBs. Root is node 0."""
    n = amin.shape[0]
    centroid = (amin + amax) * 0.5

    order = np.arange(n, dtype=np.int64)
    node_min, node_max = [], []
    node_left, node_right, node_is_leaf = [], [], []

    # worklist of (start, length, node_id); nodes appended breadth-ish
    def alloc():
        node_min.append(None)
        node_max.append(None)
        node_left.append(0)
        node_right.append(0)
        node_is_leaf.append(False)
        return len(node_min) - 1

    root = alloc()
    stack = [(0, n, root)]
    while stack:
        start, length, nid = stack.pop()
        ids = order[start : start + length]
        bmin = amin[ids].min(axis=0)
        bmax = amax[ids].max(axis=0)
        node_min[nid] = bmin
        node_max[nid] = bmax

        split = _find_split(amin, amax, centroid, ids, bmin, bmax)
        if split is None:
            node_is_leaf[nid] = True
            node_left[nid] = start
            node_right[nid] = length
            continue
        axis, thresh = split
        keys = centroid[ids, axis]
        left_mask = keys < thresh
        nl = int(left_mask.sum())
        if nl == 0 or nl == length:  # degenerate (all centroids equal): median
            perm = np.argsort(keys, kind="stable")
            order[start : start + length] = ids[perm]
            nl = length // 2
        else:
            order[start : start + length] = np.concatenate(
                [ids[left_mask], ids[~left_mask]]
            )
        lid = alloc()
        rid = alloc()
        node_left[nid] = lid
        node_right[nid] = rid
        stack.append((start, nl, lid))
        stack.append((start + nl, length - nl, rid))

    return _HostBvh(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        node_left=np.asarray(node_left, np.int32),
        node_right=np.asarray(node_right, np.int32),
        node_is_leaf=np.asarray(node_is_leaf, bool),
        prim_order=order.astype(np.int32),
    )


def _sah_area(dmin, dmax):
    d = np.maximum(dmax - dmin, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def _find_split(amin, amax, centroid, ids, bmin, bmax):
    """Best (axis, centroid threshold) by 16-bin SAH, or None for a leaf.

    Leaf criteria mirror the reference (src/bvh.rs:88-90,127-129):
    n <= LEAF_SIZE, or the trivial cost area*n beats the best split."""
    length = len(ids)
    if length <= LEAF_SIZE:
        return None

    best = (np.inf, None, None)
    cmin = centroid[ids]
    lo = cmin.min(axis=0)
    hi = cmin.max(axis=0)
    for axis in range(3):
        if hi[axis] - lo[axis] < 1e-12:
            continue
        scale = NUM_BINS * (1.0 - 1e-7) / (hi[axis] - lo[axis])
        bin_idx = ((cmin[:, axis] - lo[axis]) * scale).astype(np.int64)
        # per-bin counts and bounds
        counts = np.bincount(bin_idx, minlength=NUM_BINS)
        binmin = np.full((NUM_BINS, 3), np.inf)
        binmax = np.full((NUM_BINS, 3), -np.inf)
        np.minimum.at(binmin, bin_idx, amin[ids])
        np.maximum.at(binmax, bin_idx, amax[ids])
        # prefix/suffix sweeps
        lmin = np.minimum.accumulate(binmin, axis=0)
        lmax = np.maximum.accumulate(binmax, axis=0)
        rmin = np.minimum.accumulate(binmin[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(binmax[::-1], axis=0)[::-1]
        lcount = np.cumsum(counts)
        rcount = length - lcount
        # split after bin k (k = 0..NUM_BINS-2)
        cost = lcount[:-1] * _sah_area(lmin[:-1], lmax[:-1]) + rcount[:-1] * _sah_area(
            rmin[1:], rmax[1:]
        )
        k = int(np.argmin(cost))
        if cost[k] < best[0] and 0 < lcount[k] < length:
            thresh = lo[axis] + (k + 1) / scale
            best = (cost[k], axis, thresh)

    trivial = _sah_area(bmin, bmax) * length  # reference src/bvh.rs:127
    if best[1] is None or trivial < best[0]:
        return None
    return best[1], best[2]


def _reorder(a: np.ndarray, order: np.ndarray) -> np.ndarray:
    return np.asarray(a)[order]


def build_kd_cells(
    amin: np.ndarray,
    amax: np.ndarray,
    leaf_slots: int = 128,
    max_depth: int = 32,
):
    """DISJOINT median-kd space partition with triangle duplication.

    The SAH subtrees that ops/treelet.py cuts overlap heavily on organic
    meshes (practice7_3: a bounce ray's segment crosses p90=24 treelet
    AABBs), which defeats entry-distance pruning -- many treelets "enter"
    before the ray's first hit. Disjoint cells fix that: a primitive is
    assigned to EVERY cell its AABB touches (duplication instead of
    overlap), so the cell regions tile space and a hit inside one cell
    prunes every cell the ray enters later. Duplicate hits are benign:
    both rows carry identical geometry/material, the min picks either.

    Splits: median of AABB centers along the longest region axis (count-
    balanced); leaf when <= leaf_slots members, the split stops separating
    (every member crosses the plane), or max_depth.

    Returns (member_lists: list of int arrays, regions: list of (lo, hi)).
    """
    n = amin.shape[0]
    center = (amin + amax) * 0.5
    pad = 1e-6
    out_members, out_regions = [], []
    root_lo = amin.min(axis=0) - pad
    root_hi = amax.max(axis=0) + pad
    stack = [(root_lo, root_hi, np.arange(n, dtype=np.int64), 0)]
    while stack:
        lo, hi, ids, depth = stack.pop()
        if len(ids) <= leaf_slots or depth >= max_depth:
            out_members.append(ids)
            out_regions.append((lo, hi))
            continue
        ax = int(np.argmax(hi - lo))
        mid = float(np.median(center[ids, ax]))
        # keep the plane strictly inside the region
        mid = min(max(mid, float(lo[ax]) + pad), float(hi[ax]) - pad)
        left = ids[amin[ids, ax] <= mid]
        right = ids[amax[ids, ax] >= mid]
        if len(left) == len(ids) and len(right) == len(ids):
            out_members.append(ids)  # everything straddles: stop splitting
            out_regions.append((lo, hi))
            continue
        lhi = hi.copy()
        lhi[ax] = mid
        rlo = lo.copy()
        rlo[ax] = mid
        stack.append((lo, lhi, left, depth + 1))
        stack.append((rlo, hi, right, depth + 1))
    return out_members, out_regions


def attach_bvh(scn: SceneArrays, statics: SceneStatics,
               max_slots: int | None = None) -> SceneArrays:
    """Reorder+pad the finite table into fixed 128-slot treelet blocks and
    attach the device traversal arrays (ops/treelet.py).

    Two partitions:
    * all-triangle scenes: DISJOINT kd cells with duplication
      (``build_kd_cells``) -- entry-distance pruning then collapses the
      bounce-ray straggler tail; ``RT_PARTITION=sah`` forces the SAH cut
      for A/B comparison.
    * mixed-shape scenes: SAH subtree treelets (contiguous permutation;
      no duplication), built from the reference's SAH tree (binned here;
      the native C++ builder is tried first, numpy is the fallback).
    """
    import os

    from ..scene.build import build_packs
    from . import treelet as _tl
    from .treelet import TreeletArrays, _geom_cols, pad_to_slots, partition_treelets

    # RT_SLOTS: treelet capacity. Bigger treelets = fewer, bigger cells:
    # cull/extraction shrink ~linearly and incoherent rays cross far fewer
    # cells, at the cost of more (MXU-cheap) slot tests per visited cell.
    slots = max_slots or int(os.environ.get("RT_SLOTS", "0")) or _tl.TREELET_SLOTS

    amin, amax = primitive_aabbs(scn)
    n = amin.shape[0]

    # Disjoint kd cells were tried as the default for all-triangle scenes
    # and MEASURED WORSE on practice7_3 (grouped bounce rays 362 ms vs
    # 104 ms, treelet 265 ms vs 59 ms): the within-cell chunks span the
    # whole cell cross-section, so rays enter 2-3x more treelets than the
    # surface-hugging SAH subtrees. Kept behind RT_PARTITION=kd for A/B.
    use_kd = (not statics.any_nontri) and os.environ.get("RT_PARTITION") == "kd"
    if use_kd:
        # two levels: disjoint cells sized KD_CELL (duplication stays low),
        # then spatially-compact center-median chunks of <= slots inside
        # each cell (no duplication; a ray crossing the cell only enters
        # the chunks along its path, not all of them)
        members, regions = build_kd_cells(amin, amax, KD_CELL)
        center = ((amin + amax) * 0.5)

        def chunk_cell(ids):
            if len(ids) <= slots:
                return [ids]
            lo = amin[ids].min(axis=0)
            hi = amax[ids].max(axis=0)
            ax = int(np.argmax(hi - lo))
            order = np.argsort(center[ids, ax], kind="stable")
            half = (len(ids) + 1) // 2
            left, right = ids[order[:half]], ids[order[half:]]
            return chunk_cell(left) + chunk_cell(right)
        # each chunk's cull AABB = union of member AABBs clipped to the
        # (disjoint) cell region
        src_rows, tl_min_l, tl_max_l = [], [], []
        for ids, (lo, hi) in zip(members, regions):
            if len(ids) == 0:
                continue
            for chunk in chunk_cell(ids):
                row = np.full(slots, -1, np.int64)
                row[: len(chunk)] = chunk
                src_rows.append(row)
                tl_min_l.append(
                    np.maximum(amin[chunk].min(axis=0), lo) - AABB_EPS
                )
                tl_max_l.append(
                    np.minimum(amax[chunk].max(axis=0), hi) + AABB_EPS
                )
        src_row = np.concatenate(src_rows)  # (n_pad,), -1 = fill slot
        n_pad = src_row.shape[0]
        t = n_pad // slots
        tl_min = np.asarray(tl_min_l)
        tl_max = np.asarray(tl_max_l)
        dup = n_pad / max(n, 1)
        log.info("kd partition: %d cells/%d treelets, %.2fx slots", len(members), t, dup)

        safe = np.maximum(src_row, 0)
        fill = src_row < 0

        def place(a, fillv=0.0):
            a = np.asarray(a)
            out = a[safe].copy()
            out[fill] = fillv
            return out

        # lights: first padded occurrence of each original emissive row
        first_slot = np.full(n, n_pad, np.int64)
        np.minimum.at(first_slot, safe[~fill], np.nonzero(~fill)[0])
        light_idx = first_slot[np.asarray(scn.light_idx)].astype(np.int32)
    else:
        bvh = None
        try:
            from ..native import native_build_bvh

            bvh = native_build_bvh(amin, amax, LEAF_SIZE, NUM_BINS)
        except Exception as e:  # noqa: BLE001 -- any native failure -> numpy
            log.debug("native BVH builder unavailable (%s); using numpy", e)
        if bvh is None:
            bvh = build_bvh(amin, amax)

        order = bvh.prim_order  # old row of the prim in sorted position i
        ranges, tl_min, tl_max = partition_treelets(bvh, n, slots)
        slot_of_sorted, n_pad = pad_to_slots(ranges, n, slots)
        t = len(ranges)
        # old row -> padded slot
        slot_of_old = np.empty(n, np.int64)
        slot_of_old[order] = slot_of_sorted

        def place(a, fillv=0.0):
            a = np.asarray(a)
            out = np.full((n_pad,) + a.shape[1:], fillv, a.dtype)
            out[slot_of_old] = a
            return out

        light_idx = slot_of_old[np.asarray(scn.light_idx)].astype(np.int32)

    reordered = scn._replace(
        ptype=place(scn.ptype),  # fill rows: ptype=0 TRI with zero verts
        p0=place(scn.p0),
        p1=place(scn.p1),
        p2=place(scn.p2),
        sn0=place(scn.sn0),
        sn1=place(scn.sn1),
        sn2=place(scn.sn2),
        position=place(scn.position),
        rotation=place(scn.rotation),
        color=place(scn.color),
        metallic=place(scn.metallic),
        roughness=place(scn.roughness, 1.0),
        emission=place(scn.emission),
        ior=place(scn.ior, 1.5),
        mkind=place(scn.mkind),
        light_idx=light_idx,
        bvh=None,
    )
    reordered = build_packs(reordered)

    cols = _geom_cols(reordered, statics)
    blocks = np.stack(
        [np.asarray(c, np.float32).reshape(t, slots) for c in cols]
    )  # (Cg, T, SLOTS)
    aabb = np.ascontiguousarray(
        np.concatenate([tl_min.T, tl_max.T]).astype(np.float32)
    )  # (6, T)
    return reordered._replace(bvh=TreeletArrays(aabb=aabb, blocks=blocks))


def validate_bvh(host_bvh: _HostBvh, amin: np.ndarray, amax: np.ndarray) -> None:
    """Containment invariants on the host tree (the reference asserts these
    at the start of every render, src/bvh.rs:299-322 + rendering.rs:22; we
    check once at build/test time instead). amin/amax are in the ORIGINAL
    primitive order; host_bvh.prim_order maps sorted position -> old row."""
    nmin = np.asarray(host_bvh.node_min, np.float64)
    nmax = np.asarray(host_bvh.node_max, np.float64)
    left = np.asarray(host_bvh.node_left)
    right = np.asarray(host_bvh.node_right)
    leaf = np.asarray(host_bvh.node_is_leaf)
    order = np.asarray(host_bvh.prim_order)
    smin = amin[order]  # sorted order
    smax = amax[order]
    tol = 1e-5
    for nid in range(len(left)):
        if leaf[nid]:
            s, c = left[nid], right[nid]
            assert (smin[s : s + c] >= nmin[nid] - tol).all(), nid
            assert (smax[s : s + c] <= nmax[nid] + tol).all(), nid
        else:
            for ch in (left[nid], right[nid]):
                assert (nmin[ch] >= nmin[nid] - tol).all(), (nid, ch)
                assert (nmax[ch] <= nmax[nid] + tol).all(), (nid, ch)
    # the reorder must be a permutation covering every primitive
    assert (np.sort(order) == np.arange(len(order))).all()
    # leaves must tile [0, N) exactly
    covered = np.zeros(len(order), bool)
    for s, c in zip(left[leaf], right[leaf]):
        assert not covered[s : s + c].any()
        covered[s : s + c] = True
    assert covered.all()


def validate_treelets(scn: SceneArrays, statics: SceneStatics) -> None:
    """Treelet invariants on the padded device arrays.

    SAH partition (permutation): every real primitive's AABB is contained
    in its treelet's AABB and real slots == num_prims.
    kd partition (duplication): every real slot's AABB *intersects* its
    treelet's AABB (cell AABBs are clipped to the disjoint region, so a
    boundary triangle legitimately sticks out) and real slots >= num_prims
    with every light row real."""
    tl = scn.bvh
    aabb = np.asarray(tl.aabb, np.float64)  # (6, T)
    amin, amax = primitive_aabbs(scn)
    n_pad = amin.shape[0]
    t = aabb.shape[1]
    assert n_pad % t == 0
    slots = n_pad // t
    # fill rows are zero-vert triangles: detect via degenerate extent
    extent = (amax - amin).max(axis=1)
    real = extent > 3e-4  # fill rows have extent == 2*AABB_EPS
    tol = 1e-4
    n_real = int(real.sum())
    duplicated = n_real > statics.num_prims
    for ti in range(t):
        rows = slice(ti * slots, (ti + 1) * slots)
        r = real[rows]
        if not r.any():
            continue
        if duplicated:
            assert (amax[rows][r] >= aabb[:3, ti] - tol).all(), ti
            assert (amin[rows][r] <= aabb[3:, ti] + tol).all(), ti
        else:
            assert (amin[rows][r] >= aabb[:3, ti] - tol).all(), ti
            assert (amax[rows][r] <= aabb[3:, ti] + tol).all(), ti
    if duplicated:
        assert n_real >= statics.num_prims
    else:
        # the SAH cut is a pure permutation: spurious duplicate/extra real
        # rows must fail, not pass under the kd partition's >= relaxation
        assert n_real == statics.num_prims, (n_real, statics.num_prims)
    em = np.asarray(scn.emission)[np.asarray(scn.light_idx)]
    if statics.num_lights:
        assert (np.linalg.norm(em, axis=1) > 1e-5).all()
