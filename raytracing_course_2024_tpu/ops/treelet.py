"""Treelet wavefront traversal -- the big-scene acceleration path.

This traversal was designed for an accelerator without per-lane random
access, where a per-ray BVH stack walk is a chain of narrow node gathers;
whether it beats a stack walk on the GPU is open (ROADMAP S5). The SAH tree
is cut into *treelets*:
maximal subtrees of <= TREELET_SLOTS primitives, which are CONTIGUOUS ranges
of the reordered primitive table (a property of the build -- every subtree
owns a contiguous range). Each treelet is padded to exactly TREELET_SLOTS
slots with degenerate never-hit primitives, giving fixed-shape blocks.

Traversal per bounce:

1. dense slab test of every treelet AABB: (B, T) entry distances -- pure
   VPU broadcasting, no gathers (T ~ N/128: 781 for practice7_3);
2. iterate: each ray picks its nearest unprocessed hit treelet (masked
   argmin over (B, T)), fetches that treelet's geometry with
   embedding-style wide-row gathers (jnp.take of (T, 128) component
   rows), dense-tests all 128
   slots, updates its best hit, and marks the treelet processed;
3. stop when every ray's remaining treelets start beyond its best hit
   (the reference's pruning rule, src/bvh.rs:258-262, applied wavefront).

Replaces the reference's recursive nearest-hit walk (src/bvh.rs:231-297)
with identical results; ordering/termination match because treelets are
processed strictly nearest-first per ray.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.types import SceneArrays, SceneStatics
from .intersect import INF, ray_aabb
from .scene_intersect import SceneHit, _expand, _fold_in_planes, _prim_ts, PrimRef
from .vec import Quat, Vec3

TREELET_SLOTS = 128


class TreeletArrays(NamedTuple):
    aabb: "jnp.ndarray"  # (6, T) f32: minx,miny,minz,maxx,maxy,maxz
    blocks: "jnp.ndarray"  # (Cg, T, SLOTS) f32 geometry column planes; one
    # embedding gather per plane per round. (A single packed (T, Cg*SLOTS)
    # gather was measured 14% slower in the full trace -- separate planes
    # fuse better with their consumers.) Cg = 9 (tri verts) all-triangle,
    # 17 (+ptype, pos, rot) mixed.


def _geom_cols(scn_np, statics) -> list:
    """Component columns needed by _prim_ts, in PrimRef order."""
    p0 = np.asarray(scn_np.p0, np.float32)
    p1 = np.asarray(scn_np.p1, np.float32)
    p2 = np.asarray(scn_np.p2, np.float32)
    cols = [p0[:, 0], p0[:, 1], p0[:, 2],
            p1[:, 0], p1[:, 1], p1[:, 2],
            p2[:, 0], p2[:, 1], p2[:, 2]]
    if statics.any_nontri:
        ptype = np.asarray(scn_np.ptype, np.float32)
        pos = np.asarray(scn_np.position, np.float32)
        rot = np.asarray(scn_np.rotation, np.float32)
        cols = [ptype] + cols + [pos[:, 0], pos[:, 1], pos[:, 2],
                                 rot[:, 0], rot[:, 1], rot[:, 2], rot[:, 3]]
    return cols


def _prim_ref_from_blocks(rows, statics) -> PrimRef:
    """rows: list of (B, SLOTS) arrays in _geom_cols order -> PrimRef."""
    if statics.any_nontri:
        ptype = rows[0]
        v = rows[1:10]
        pos = Vec3(rows[10], rows[11], rows[12])
        rot = Quat(rows[13], rows[14], rows[15], rows[16])
    else:
        ptype = None
        v = rows[0:9]
        zero = rows[0] * 0.0
        pos = Vec3(zero, zero, zero)
        rot = Quat(zero, zero, zero, zero + 1.0)
    return PrimRef(
        ptype=ptype if ptype is not None else (v[0] * 0.0),
        p0=Vec3(v[0], v[1], v[2]),
        p1=Vec3(v[3], v[4], v[5]),
        p2=Vec3(v[6], v[7], v[8]),
        pos=pos,
        rot=rot,
    )


def partition_treelets(host_bvh, n: int, max_slots: int = TREELET_SLOTS):
    """Cut the host binary BVH into maximal subtrees of <= max_slots prims.

    Returns a list of (start, count) ranges in the reordered prim table (the
    build guarantees subtree ranges are contiguous) plus each treelet's AABB.
    """
    left = host_bvh.node_left
    right = host_bvh.node_right
    leaf = host_bvh.node_is_leaf

    # compute each node's (start, count): leaves store them; internal nodes
    # span their children
    m = len(left)
    start = np.zeros(m, np.int64)
    count = np.zeros(m, np.int64)

    def fill(nid):
        stack = [(nid, False)]
        while stack:
            node, done = stack.pop()
            if leaf[node]:
                start[node] = left[node]
                count[node] = right[node]
                continue
            if done:
                l, r = left[node], right[node]
                start[node] = min(start[l], start[r])
                count[node] = count[l] + count[r]
            else:
                stack.append((node, True))
                stack.append((left[node], False))
                stack.append((right[node], False))

    fill(0)

    ranges = []
    stack = [0]
    while stack:
        node = stack.pop()
        if count[node] <= max_slots or leaf[node]:
            ranges.append((int(start[node]), int(count[node]), node))
        else:
            stack.append(int(left[node]))
            stack.append(int(right[node]))
    ranges.sort()
    aabb_min = host_bvh.node_min[[r[2] for r in ranges]]
    aabb_max = host_bvh.node_max[[r[2] for r in ranges]]
    return [(s, c) for s, c, _ in ranges], aabb_min, aabb_max


def pad_to_slots(ranges, n: int, max_slots: int = TREELET_SLOTS):
    """Slot map: old reordered row -> padded row. Returns (slot_of_old (n,),
    n_padded). Fill slots hold no primitive (degenerate rows)."""
    t = len(ranges)
    slot_of_old = np.zeros(n, np.int64)
    for ti, (s, c) in enumerate(ranges):
        slot_of_old[s : s + c] = ti * max_slots + np.arange(c)
    return slot_of_old, t * max_slots


def _test_treelet(tl, tid, ro_b, rd_b, statics, tmin, best_t, best_idx, active):
    """Fetch treelet ``tid`` per ray (one embedding gather per geometry
    plane) and dense-test its slots; returns updated (best_t, best_idx)."""
    n_rows = tl.blocks.shape[0]
    slots = tl.blocks.shape[2]
    rows = [jnp.take(tl.blocks[k], tid, axis=0) for k in range(n_rows)]
    prim = _prim_ref_from_blocks(rows, statics)
    ts = _prim_ts(ro_b, rd_b, prim, statics, tmin)  # (B, SLOTS)
    slot = jnp.argmin(ts, axis=1).astype(jnp.int32)
    t_hit = jnp.min(ts, axis=1)
    better = active & (t_hit < best_t)
    best_idx = jnp.where(better, tid * slots + slot, best_idx)
    best_t = jnp.where(better, t_hit, best_t)
    return best_t, best_idx


def _tid_bits(t_count: int) -> int:
    bits = 1
    while (1 << bits) < t_count:
        bits += 1
    return bits


def nearest_hit_treelet(
    ro: Vec3, rd: Vec3, scn: SceneArrays, statics: SceneStatics, tmin=0.0
) -> SceneHit:
    """Nearest-first treelet iteration via key-packed min-extraction.

    Per-ray ordering without sorts or (B, T) write-backs: each treelet's
    entry distance is packed into an int32 key (monotonic f32 bits truncated
    by TID_BITS, treelet id in the low bits -- unique per treelet). Each
    loop round takes, per ray, the minimum key STRICTLY GREATER than the
    last processed key: one fused read-only (B, T) pass. Front-to-back
    pruning compares keys against an *inflated* best-hit key, so truncation
    can only cause extra work, never a missed nearer hit. Measured: rays
    hit only ~2-8 treelet AABBs, so the loop runs that many rounds.
    """
    tl: TreeletArrays = scn.bvh  # stored in the bvh slot
    t_count = tl.aabb.shape[1]
    b = ro.x.shape[0]
    bits = _tid_bits(max(t_count, 2))
    assert bits <= 16, "treelet count exceeds key capacity"

    bmin = Vec3(tl.aabb[0], tl.aabb[1], tl.aabb[2])  # (T,) rows (tiny)
    bmax = Vec3(tl.aabb[3], tl.aabb[4], tl.aabb[5])
    iv = ray_aabb(_expand(ro), _expand(rd), bmin, bmax)  # (B, T)
    # entry distance for ordering; inside-the-box counts as 0 (must visit)
    t_enter = jnp.maximum(iv.t1, 0.0)
    hit = iv.valid & (iv.t2 > 0.0)

    max_key = jnp.int32(2**31 - 1)

    def key_of(t):  # positive-f32 bits are order-preserving as int
        ib = jax.lax.bitcast_convert_type(jnp.maximum(t, 0.0), jnp.int32)
        return jax.lax.shift_left(jax.lax.shift_right_logical(ib, bits), bits)

    tid_iota = jax.lax.broadcasted_iota(jnp.int32, (b, t_count), 1)
    keys = jnp.where(hit, key_of(t_enter) | tid_iota, max_key)  # (B, T)

    ro_b = _expand(ro)
    rd_b = _expand(rd)
    tid_mask = jnp.int32((1 << bits) - 1)

    def best_key_bound(best_t):
        # inflate so truncation never skips a treelet entering before best_t
        return key_of(best_t * (1.0 + 1.0 / (1 << (23 - bits - 1)))) | tid_mask

    def make_round(keys_mat, ro_v, rd_v):
        def next_key(last_key):  # ONE fused read-only (B', T) pass
            return jnp.min(
                jnp.where(keys_mat > last_key[:, None], keys_mat, max_key), axis=1
            )

        def active_of(carry):
            nxt, best_t, _ = carry
            return (nxt < max_key) & (nxt <= best_key_bound(best_t))

        def body(carry):
            nxt, best_t, best_idx = carry
            active = active_of(carry)
            tid = nxt & tid_mask
            best_t, best_idx = _test_treelet(
                tl, jnp.where(active, tid, 0), _expand(ro_v), _expand(rd_v),
                statics, tmin, best_t, best_idx, active,
            )
            nxt = jnp.where(active, next_key(nxt), max_key)
            return nxt, best_t, best_idx

        return next_key, active_of, body

    next_key, active_of, round_body = make_round(keys, ro, rd)

    # init derived from traced inputs so carries keep a consistent
    # device-varying type under shard_map (jax >= 0.9 vma rules)
    zeros = ro.x * 0.0
    init = (
        next_key(zeros.astype(jnp.int32) - 1),
        zeros + INF,
        zeros.astype(jnp.int32),
    )

    # --- phase 1: up to R0 full-batch rounds (covers ~p95 of rays) ---
    import os as _os

    # R0/CAPDIV defaults: starting values from a sweep on the accelerator
    # this program was first tuned on, awaiting a re-sweep on the GPU
    # (ROADMAP S5). One extra full round drains most stragglers, and the
    # remaining few drain cheaper through narrower waves.
    R0 = int(_os.environ.get("RT_TREELET_R0", "4"))

    def p1_cond(carry):
        k, state = carry
        return (k < R0) & jnp.any(active_of(state))

    def p1_body(carry):
        k, state = carry
        return k + 1, round_body(state)

    _, (nxt, best_t, best_idx) = jax.lax.while_loop(
        p1_cond, p1_body, (jnp.int32(0), init)
    )

    # --- phase 2: straggler waves. Rays still active after R0 rounds (long
    # incoherent rays crossing many treelet boxes; p99 visits ~13 vs mean
    # ~2.4) drain through repeated cap-width compactions: each wave gathers
    # up to ``cap`` stragglers, finishes them COMPLETELY in a compacted
    # inner loop, and marks them done; leftover stragglers take the next
    # wave. Late rounds therefore charge cap lanes, never the whole
    # wavefront, at ANY straggler count (the round-3 single-compaction
    # design fell back to full-width rounds when stragglers exceeded
    # cap). ---
    cap = max(b // int(_os.environ.get("RT_TREELET_CAPDIV", "32")), 1024)

    def waves_left(st):
        nxt, best_t, _ = st
        return jnp.any((nxt < max_key) & (nxt <= best_key_bound(best_t)))

    def wave(st):
        nxt, best_t, best_idx = st
        act = (nxt < max_key) & (nxt <= best_key_bound(best_t))
        # fill index = b: out of range, dropped by the scatters below
        idx = jnp.nonzero(act, size=cap, fill_value=b)[0]
        safe = jnp.minimum(idx, b - 1)
        sub_ro = Vec3(ro.x[safe], ro.y[safe], ro.z[safe])
        sub_rd = Vec3(rd.x[safe], rd.y[safe], rd.z[safe])
        sub_keys = keys[safe]  # (cap, T) row gather
        s_next, s_active_of, s_body = make_round(sub_keys, sub_ro, sub_rd)
        live = idx < b
        sub_init = (
            jnp.where(live, nxt[safe], max_key),
            best_t[safe],
            best_idx[safe],
        )
        _, s_t, s_i = jax.lax.while_loop(
            lambda c: jnp.any(s_active_of(c)), s_body, sub_init
        )
        best_t = best_t.at[idx].set(s_t, mode="drop")
        best_idx = best_idx.at[idx].set(s_i, mode="drop")
        nxt = nxt.at[idx].set(max_key, mode="drop")  # wave done
        return nxt, best_t, best_idx

    _, best_t, best_idx = jax.lax.while_loop(
        waves_left, wave, (nxt, best_t, best_idx)
    )

    out = SceneHit(
        best_t, best_idx, jnp.zeros_like(best_idx, bool), jnp.isfinite(best_t)
    )
    if statics.num_planes > 0:
        out = _fold_in_planes(ro, rd, scn, out, tmin)
    return out
