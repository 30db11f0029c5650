"""Persistent-wavefront path tracer with path regeneration.

The batch integrator (integrator/path.py) scans ``ray_depth`` bounces over a
fixed lane batch: lanes die as paths terminate, and across a depth-6 scan
mean occupancy collapses to ~20-25% of the lanes -- every
fixed-cost traversal pass still prices the FULL batch. This engine is the
BASELINE.json north-star "wavefront with persistent ray queues": one lane
batch lives for the whole frame, and dead lanes are refilled with fresh
(pixel, sample) work items so every traversal pass runs at ~100% occupancy.

Mechanics (all static shapes, one ``lax.while_loop``):

* a work item ``w`` of ``total_work = n_pix * samples`` maps arithmetically
  to (pixel, sample) -- no queues materialize, just a counter;
* per-work-item counter-based RNG (ops/rng.py) makes every path's sample
  stream independent of its lane and of every other path's lifetime: the
  rendered image is invariant to the lane count (pinned by
  tests/test_wavefront.py::test_lane_count_invariance) and to how the frame
  is sharded across devices;
* refills happen when >= half the lanes are dead (amortizing the cumsum
  rank assignment and the radiance scatter-add over several bounce rounds);
  completed paths keep their radiance in-lane until the next refill flushes
  it into the image accumulator with one masked scatter-add;
* per-lane bounce depth replaces the scan index: emission/background
  accumulate on every hit exactly like the batch path, a lane whose final
  depth is reached dies after collecting emission (the reference returns
  black at depth 0, src/rendering.rs:93-95), and the continuation rules are
  the shared ``_finish_bounce`` (mirror/dielectric/BRDF-weight semantics
  identical to the batch integrator).

The estimator is unchanged -- same mixture sampling, same bounded-rejection
contract, same signed-cos faithful mode -- only the RNG stream differs
(work-item-keyed hash vs lane-positional threefry), so wavefront and batch
renders agree within Monte-Carlo noise, not bitwise. Checkpoint semantics
are untouched: the engine is deterministic per (seed, work range), and spp
chunks simply shift ``samp_base``.

Replaces the reference's per-pixel recursion economics (src/rendering.rs:
43-62) for big scenes where traversal cost is batch-shaped, not per-ray.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.camera import CameraArrays, generate_rays_u
from ..ops.rng import uniform_ctr, work_key
from ..ops.sampling import sample_mixture
from ..ops.scene_intersect import surface_detail
from ..ops.vec import Vec3, where3
from ..scene.types import DIELECTRIC, MIRROR, SceneArrays, SceneStatics
from .path import TraceConfig, _nearest, _finish_bounce, _PathState

# draw-counter layout per work item: 0-1 camera jitter; per bounce d the
# block [2 + 64*d, 2 + 64*(d+1)) holds 7 sampler rows x max_tries candidates
# (7*8 = 56 max) then the dielectric split draw at offset 63
_CTR_BOUNCE0 = 2
_CTR_STRIDE = 64
_CTR_RR = 62
_CTR_DIEL = 63

# a dead lane's parked ray: far outside every scene, pointing away along
# the all-positive diagonal so slab/cull tests reject it with finite math
_PARK_ORIGIN = 1.0e30
_PARK_DIR = 0.5773502691896258  # 1/sqrt(3)

# probe-only (RT_WF_TRACE=1 + a hook): render_wavefront runs its round loop
# at python level and calls the hook with (round_i, post-refill state) --
# the exact per-round ray mix entering each bounce, for platform-
# independent crossing-count statistics. No effect on the production lax.while_loop path.
_TRACE_HOOK = None


class _WfState(NamedTuple):
    work: jnp.ndarray  # (B,) i32 work id; -1 = none (flushed or never used)
    alive: jnp.ndarray  # (B,) bool: mid-path
    depth: jnp.ndarray  # (B,) i32 bounces completed
    ro: Vec3
    rd: Vec3
    thr: Vec3
    rad: Vec3  # accumulated path radiance (flushed at refill)
    img_r: jnp.ndarray  # (n_pix,) radiance sums
    img_g: jnp.ndarray
    img_b: jnp.ndarray
    counter: jnp.ndarray  # scalar i32: next unassigned work id
    nverts: jnp.ndarray  # scalar f32: path vertices traced (bench metric)
    rnd: jnp.ndarray  # scalar i32: bounce-round index


def _make_bounce_core(cfg: TraceConfig, scn: SceneArrays, statics: SceneStatics):
    """One full bounce shared by both wavefront engines (counter refill and
    pixel-sticky). Returns ``core(keyl, depth, ro, rd, thr, rad, alive)`` ->
    (ro', rd', thr', rad', alive') where ``keyl`` is the per-lane u32 work
    key of the counter RNG and ``alive'`` already applies the per-lane
    final-depth death rule (the reference's depth-0 black return,
    src/rendering.rs:93-95); dead lanes' rays are parked."""
    k = cfg.max_tries

    def park(alive, ro2, rd2):
        zero = ro2.x * 0.0
        park_o = Vec3(zero + _PARK_ORIGIN, zero + _PARK_ORIGIN,
                      zero + _PARK_ORIGIN)
        park_d = Vec3(zero + _PARK_DIR, zero + _PARK_DIR, zero + _PARK_DIR)
        return where3(alive, ro2, park_o), where3(alive, rd2, park_d)

    def core(keyl, depth, ro, rd, thr, rad, alive):
        hit = _nearest(ro, rd, scn, statics, cfg)
        surf = surface_detail(ro, rd, hit, scn, statics)

        zero = ro.x * 0.0
        bg = Vec3(zero + cfg.bg_color[0], zero + cfg.bg_color[1],
                  zero + cfg.bg_color[2])
        miss = alive & ~hit.valid
        on_hit = alive & hit.valid
        add = where3(
            miss,
            thr.mul(bg),
            where3(on_hit, thr.mul(surf.emission), Vec3(zero, zero, zero)),
        )
        rad = rad + add

        cont = on_hit & (depth < cfg.ray_depth - 1)
        is_delta = (surf.mkind == MIRROR) | (surf.mkind == DIELECTRIC)
        need = cont & ~is_delta

        base = _CTR_BOUNCE0 + depth * _CTR_STRIDE  # (B,) per-lane
        u7 = [
            jnp.concatenate(
                [uniform_ctr(keyl, base + r * k + c) for c in range(k)]
            )
            for r in range(7)
        ]
        l_s, pdf, ok = sample_mixture(
            None, surf.point, surf.n_geom, surf.n_shade, -rd,
            surf.roughness, scn, statics, need=need, max_tries=k,
            faithful=cfg.faithful, uniforms=u7,
        )
        u_diel = uniform_ctr(keyl, base + _CTR_DIEL)
        rr_kw = {}
        if cfg.rr:
            from .path import RR_START

            rr_kw = dict(
                u_rr=uniform_ctr(keyl, base + _CTR_RR),
                rr_mask=depth >= RR_START,
            )
        ps = _finish_bounce(
            _PathState(ro=ro, rd=rd, throughput=thr, radiance=rad,
                       alive=cont),
            surf, l_s, pdf, ok, u_diel, cfg, **rr_kw,
        )
        ro2, rd2 = park(ps.alive, ps.ro, ps.rd)
        return ro2, rd2, ps.throughput, ps.radiance, ps.alive

    return core


def render_wavefront(
    seed32: jnp.ndarray,
    pix_base: jnp.ndarray,
    samp_base: jnp.ndarray,
    cam: CameraArrays,
    scn: SceneArrays,
    statics: SceneStatics,
    cfg: TraceConfig,
    width: int,
    height: int,
    n_pix: int,
    samples: int,
    lanes: int,
):
    """Render pixels [pix_base, pix_base + n_pix) (global row-major linear
    coords of the full width x height frame) at ``samples`` spp starting
    from global sample index ``samp_base``.

    Returns ((n_pix, 3) f32 mean radiance, path-vertex count scalar).

    ``seed32``/``pix_base``/``samp_base`` are traced scalars, so tiles and
    spp shards reuse one compiled program; RNG streams are keyed by GLOBAL
    (pixel, sample), so any tiling/sharding of a frame produces identical
    per-sample estimates (only fp accumulation order differs).
    """
    total_work = n_pix * samples
    b = lanes
    k = cfg.max_tries
    assert 7 * k < _CTR_RR, "max_tries exceeds the RNG counter block"
    frame_pix = width * height

    def wid_of(work):
        samp = samp_base + work // n_pix
        pixg = pix_base + work % n_pix
        return samp * frame_pix + pixg

    # --- refill: flush dead lanes' radiance, hand out fresh work ----------
    def refill(st: _WfState) -> _WfState:
        dead = ~st.alive
        flushable = dead & (st.work >= 0)
        pixl = jnp.maximum(st.work, 0) % n_pix
        idx = jnp.where(flushable, pixl, n_pix)  # n_pix = dropped
        img_r = st.img_r.at[idx].add(st.rad.x, mode="drop")
        img_g = st.img_g.at[idx].add(st.rad.y, mode="drop")
        img_b = st.img_b.at[idx].add(st.rad.z, mode="drop")
        zero = st.rad.x * 0.0
        rad = where3(dead, Vec3(zero, zero, zero), st.rad)

        rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
        new_id = st.counter + rank
        take = dead & (new_id < total_work)
        work = jnp.where(take, new_id, jnp.where(dead, -1, st.work))
        counter = st.counter + jnp.sum(take.astype(jnp.int32))

        pixg = pix_base + jnp.maximum(work, 0) % n_pix
        px = pixg % width
        py = jnp.minimum(pixg // width, height - 1)  # padded tile rows clamp
        keyl = work_key(seed32, wid_of(jnp.maximum(work, 0)))
        u0 = uniform_ctr(keyl, 0)
        u1 = uniform_ctr(keyl, 1)
        ro_n, rd_n = generate_rays_u(cam, px, py, width, height, u0, u1)
        one = zero + 1.0
        return st._replace(
            work=work,
            alive=st.alive | take,
            depth=jnp.where(take, 0, st.depth),
            ro=where3(take, ro_n, st.ro),
            rd=where3(take, rd_n, st.rd),
            thr=where3(take, Vec3(one, one, one), st.thr),
            rad=rad,
            img_r=img_r,
            img_g=img_g,
            img_b=img_b,
            counter=counter,
        )

    core = _make_bounce_core(cfg, scn, statics)

    # --- one bounce round at (near-)full occupancy ------------------------
    def bounce(st: _WfState) -> _WfState:
        nverts = st.nverts + jnp.sum(st.alive.astype(jnp.float32))
        rng = work_key(seed32, wid_of(jnp.maximum(st.work, 0)))
        ro2, rd2, thr, rad, alv = core(
            rng, st.depth, st.ro, st.rd, st.thr, st.rad, st.alive
        )
        return st._replace(
            alive=alv,
            depth=st.depth + 1,
            ro=ro2,
            rd=rd2,
            thr=thr,
            rad=rad,
            nverts=nverts,
            rnd=st.rnd + 1,
        )

    def cond(st: _WfState):
        return (st.counter < total_work) | jnp.any(st.alive)

    # refill threshold: traversal rounds price the FULL batch (static
    # shapes), so mean occupancy ~= 1 - frac/2 directly scales e2e
    # throughput; the cost of refilling more often is the cumsum + scatter
    # + camera math (~5 ms/262k). Default 1/8 dead (~94% mean occupancy).
    import os as _os

    frac = float(_os.environ.get("RT_WF_REFILL_FRAC", "0.125"))
    thresh = max(int(b * frac), 1)

    def body(st: _WfState):
        n_dead = jnp.sum((~st.alive).astype(jnp.int32))
        st = jax.lax.cond(
            n_dead >= thresh, refill, lambda s: s, st
        )
        return bounce(st)

    # init derived from traced scalars so every carry is device-varying
    # under shard_map (vma rules)
    i0 = jnp.asarray(pix_base, jnp.int32) * 0
    f0 = i0.astype(jnp.float32)
    lane_i = jnp.zeros((b,), jnp.int32) + i0
    lane_f = jnp.zeros((b,), jnp.float32) + f0
    img0 = jnp.zeros((n_pix,), jnp.float32) + f0
    zeros3 = Vec3(lane_f, lane_f, lane_f)
    init = _WfState(
        work=lane_i - 1,
        alive=lane_i > 0,
        depth=lane_i,
        ro=Vec3(lane_f + _PARK_ORIGIN, lane_f + _PARK_ORIGIN,
                lane_f + _PARK_ORIGIN),
        rd=Vec3(lane_f + _PARK_DIR, lane_f + _PARK_DIR, lane_f + _PARK_DIR),
        thr=zeros3,
        rad=zeros3,
        img_r=img0,
        img_g=img0,
        img_b=img0,
        counter=i0,
        nverts=f0,
        rnd=i0,
    )
    if _os.environ.get("RT_WF_TRACE") and _TRACE_HOOK is not None:
        # probe-only python-level round loop (see _TRACE_HOOK above)
        st = init
        i = 0
        while bool(jnp.any((st.counter < total_work) | st.alive)):
            if int(jnp.sum((~st.alive).astype(jnp.int32))) >= thresh:
                st = refill(st)
            _TRACE_HOOK(i, st)
            st = bounce(st)
            i += 1
        return _wf_finish(st, n_pix, samples)

    st = jax.lax.while_loop(cond, body, init)
    return _wf_finish(st, n_pix, samples)


def _wf_finish(st: _WfState, n_pix: int, samples: int):
    """Final flush: the loop exits with work exhausted and no lane alive,
    but the last completions still hold their radiance in-lane."""
    import os as _os

    flushable = st.work >= 0
    idx = jnp.where(flushable, jnp.maximum(st.work, 0) % n_pix, n_pix)
    img_r = st.img_r.at[idx].add(st.rad.x, mode="drop")
    img_g = st.img_g.at[idx].add(st.rad.y, mode="drop")
    img_b = st.img_b.at[idx].add(st.rad.z, mode="drop")

    inv = 1.0 / samples
    # channel-major (3, n_pix), like integrator/path.py render_pixels
    img = jnp.stack([img_r * inv, img_g * inv, img_b * inv], axis=0)
    if _os.environ.get("RT_WF_DEBUG"):  # probe-only: also report rounds
        return img, st.nverts, st.rnd
    return img, st.nverts


def render_wavefront_sticky(
    seed32: jnp.ndarray,
    pix_base: jnp.ndarray,
    samp_base: jnp.ndarray,
    cam: CameraArrays,
    scn: SceneArrays,
    statics: SceneStatics,
    cfg: TraceConfig,
    width: int,
    height: int,
    n_pix: int,
    samples: int,
    lanes: int,
):
    """Pixel-sticky regeneration wavefront: lane ``l`` owns pixels
    ``{l, l + lanes, l + 2*lanes, ...}`` and walks each owned pixel's
    ``samples`` paths sequentially, accumulating radiance IN-LANE.

    The counter engine above pays a (B,)-wide cumsum (rank assignment) plus
    a full-width scatter-add (radiance flush) at every refill. Sticky
    assignment removes ALL coordination: a dead lane restarts its next
    sample the very next round with pure per-lane arithmetic (no rank, no
    scatter -- the per-pixel accumulator lives at a fixed lane-indexed
    slot), so occupancy stays high at zero refill cost. The tradeoff is
    tail imbalance: lanes finish their sample budgets at slightly different
    times (path-length variance over ``samples`` paths), idling late lanes
    -- small for spp >= 4 by CLT.

    Same work-item RNG convention as the counter engine (global
    (pixel, sample) keys), so images are invariant to the lane count and
    identical across tilings. Returns ((3, n_pix) mean radiance,
    path-vertex count) exactly like ``render_wavefront``.
    """
    b = lanes
    core = _make_bounce_core(cfg, scn, statics)
    jmax = max(-(-n_pix // b), 1)  # owned pixels per lane (ceil)
    frame_pix = width * height

    # state: (alive, k_started, depth, ro, rd, thr, rad, acc, nverts, rnd)
    # acc = 3-tuple of jmax-tuples of (B,) per-owned-pixel radiance sums
    lane = jnp.arange(b, dtype=jnp.int32)
    n_owned = jnp.zeros((b,), jnp.int32)
    for j in range(jmax):
        n_owned = n_owned + (lane + j * b < n_pix).astype(jnp.int32)
    kmax = n_owned * samples

    def path_coords(k):
        """Current path index (k-1 for started paths) -> (pixl, samp)."""
        cur = jnp.maximum(k - 1, 0)
        j = cur // samples
        samp = cur % samples
        pixl = jnp.minimum(lane + j * b, n_pix - 1)
        return j, pixl, samp

    def wid_of(pixl, samp):
        return (samp_base + samp) * frame_pix + (pix_base + pixl)

    def restart(st):
        """Flush dead lanes' finished paths, start their next sample."""
        alive, k, depth, ro, rd, thr, rad, acc, nverts, rnd = st
        dead = ~alive
        flush = dead & (k > 0)
        jf, _, _ = path_coords(k)
        accx, accy, accz = acc
        acc = (
            tuple(
                jnp.where(flush & (jf == j), accx[j] + rad.x, accx[j])
                for j in range(jmax)
            ),
            tuple(
                jnp.where(flush & (jf == j), accy[j] + rad.y, accy[j])
                for j in range(jmax)
            ),
            tuple(
                jnp.where(flush & (jf == j), accz[j] + rad.z, accz[j])
                for j in range(jmax)
            ),
        )
        zero = rad.x * 0.0
        rad = where3(dead, Vec3(zero, zero, zero), rad)

        take = dead & (k < kmax)
        k = jnp.where(take, k + 1, k)
        _, pixl, samp = path_coords(k)
        pixg = pix_base + pixl
        px = pixg % width
        py = jnp.minimum(pixg // width, height - 1)
        keyl = work_key(seed32, wid_of(pixl, samp))
        u0 = uniform_ctr(keyl, 0)
        u1 = uniform_ctr(keyl, 1)
        ro_n, rd_n = generate_rays_u(cam, px, py, width, height, u0, u1)
        one = zero + 1.0
        return (
            alive | take,
            k,
            jnp.where(take, 0, depth),
            where3(take, ro_n, ro),
            where3(take, rd_n, rd),
            where3(take, Vec3(one, one, one), thr),
            rad,
            acc,
            nverts,
            rnd,
        )

    def body(st):
        st = restart(st)
        alive, k, depth, ro, rd, thr, rad, acc, nverts, rnd = st
        nverts = nverts + jnp.sum(alive.astype(jnp.float32))
        _, pixl, samp = path_coords(k)
        rng = work_key(seed32, wid_of(pixl, samp))
        ro2, rd2, thr2, rad2, alv = core(rng, depth, ro, rd, thr, rad, alive)
        return (alv, k, depth + 1, ro2, rd2, thr2, rad2, acc, nverts,
                rnd + 1)

    def cond(st):
        alive, k = st[0], st[1]
        return jnp.any(alive) | jnp.any(k < kmax)

    i0 = jnp.asarray(pix_base, jnp.int32) * 0
    f0 = i0.astype(jnp.float32)
    lane_i = jnp.zeros((b,), jnp.int32) + i0
    lane_f = jnp.zeros((b,), jnp.float32) + f0
    zeros3 = Vec3(lane_f, lane_f, lane_f)
    acc0 = tuple(tuple(lane_f for _ in range(jmax)) for _ in range(3))
    init = (
        lane_i > 0,  # alive
        lane_i,  # k
        lane_i,  # depth
        Vec3(lane_f + _PARK_ORIGIN, lane_f + _PARK_ORIGIN,
             lane_f + _PARK_ORIGIN),
        Vec3(lane_f + _PARK_DIR, lane_f + _PARK_DIR, lane_f + _PARK_DIR),
        zeros3,
        zeros3,
        acc0,
        f0,  # nverts
        i0,  # rnd
    )
    st = jax.lax.while_loop(cond, body, init)
    st = restart(st)  # final flush (loop exits with last paths unflushed)
    _, _, _, _, _, _, _, acc, nverts, _ = st

    inv = 1.0 / samples
    accx, accy, accz = acc
    img = jnp.stack(
        [
            jnp.concatenate(list(ch), axis=0)[:n_pix] * inv
            for ch in (accx, accy, accz)
        ],
        axis=0,
    )
    return img, nverts
