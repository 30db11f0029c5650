"""Importance-sampling distributions + one-sample MIS mixture.

Reference: src/distributions.rs. The estimator is the reference's exactly:
a uniform pick among {cosine-weighted, GGX-VNDF, light-surface} components
(MixDistribution, distributions.rs:187-202), with the mixture pdf = average
of component pdfs, and the *light* pdf evaluated geometrically along the
sampled ray -- summed over every light-primitive hit (distributions.rs:
160-184) -- rather than with shadow rays. Batch-first changes:

* counter-based threefry keys replace the per-row Xoshiro stream
  (src/rendering.rs:50-51);
* the all-hits light-BVH walk becomes a dense sweep over the (small) light
  table: identical sum, no divergent traversal;
* the unbounded rejection loop (src/rendering.rs:102-110) becomes a bounded
  ``lax.while_loop`` (max_tries); rays that never find pdf > 0 are killed --
  statistically negligible and lane-convergent (SURVEY.md section 7 hard
  part 3);
* ellipsoid lights (text scenes) use the uniform-sphere pullback pdf
  1/(4 pi |J|), |J| = sqrt((u_x r_y r_z)^2 + (r_x u_y r_z)^2 + (r_x r_y u_z)^2).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..scene.types import BOX, ELLIPSOID, SceneArrays, SceneStatics, TRI
from .intersect import (
    normal_to_world,
    ray_box_interval,
    ray_ellipsoid_interval,
    ray_triangle,
    to_local,
)
from .vec import Quat, Vec3, reflect, where3

PI = math.pi
_SAFE = 1e-9

# the reference's fixed tangent-frame seed vector (distributions.rs:265),
# pre-normalized as python floats (no traced module constants -- they would
# be "captured constants" inside Pallas kernel bodies)
_T_NORM = math.sqrt(0.234**2 + 0.1234**2 + 0.97686**2)
_T_SEED = (0.234 / _T_NORM, 0.1234 / _T_NORM, 0.97686 / _T_NORM)


def tangent_frame(n: Vec3):
    """Orthonormal (t1, t2, n) built exactly like the reference
    (distributions.rs:265-267): t1 = normalize(n x seed), t2 = normalize(n x t1)."""
    seed = Vec3(
        jnp.full_like(n.x, _T_SEED[0]),
        jnp.full_like(n.x, _T_SEED[1]),
        jnp.full_like(n.x, _T_SEED[2]),
    )
    t1 = n.cross(seed).normalize()
    t2 = n.cross(t1).normalize()
    return t1, t2


def to_frame_local(t1: Vec3, t2: Vec3, n: Vec3, v: Vec3) -> Vec3:
    """World -> tangent-local coordinates (m^T v)."""
    return Vec3(v.dot(t1), v.dot(t2), v.dot(n))


def from_frame_local(t1: Vec3, t2: Vec3, n: Vec3, v: Vec3) -> Vec3:
    """Tangent-local -> world (m v)."""
    return t1 * v.x + t2 * v.y + n * v.z


# ---------------------------------------------------------------------------
# cosine-weighted hemisphere (distributions.rs:53-68)
# ---------------------------------------------------------------------------


import os as _os

_RNG_BITS = int(_os.environ.get("RT_RNG_BITS", "32"))


def uniform_rows(key: jax.Array, rows: int, b: int):
    """``rows`` independent U(0,1) vectors of length b from ONE threefry
    sweep. Drawn flat and split with static 1-D slices -- contiguous and
    free, unlike row reads of a (rows, b) 2D array.

    RT_RNG_BITS=16 packs TWO 16-bit uniforms per threefry u32 (65536
    levels -- far below MC noise at any practical spp; verified bias-free
    at 256 spp). Full 32-bit draws stay the default; the 16-bit packing
    has not been measured on the GPU."""
    if _RNG_BITS >= 24:
        flat = jax.random.uniform(key, (rows * b,), jnp.float32)
        return [jax.lax.slice(flat, (i * b,), ((i + 1) * b,)) for i in range(rows)]
    n32 = (rows * b + 1) // 2
    bits = jax.random.bits(key, (n32,), jnp.uint32)
    lo = (bits & 0xFFFF).astype(jnp.float32)
    hi = (bits >> 16).astype(jnp.float32)
    flat = jnp.concatenate([lo, hi]) * jnp.float32(1.0 / 65536.0)
    return [jax.lax.slice(flat, (i * b,), ((i + 1) * b,)) for i in range(rows)]


def unit_sphere_from_uniforms(u1: jnp.ndarray, u2: jnp.ndarray) -> Vec3:
    """Uniform point on the unit sphere from two U(0,1) draws -- (z, phi)
    parameterization. Replaces the reference's normalized-gaussian trick
    (distributions.rs:34-40): identical distribution, no erf_inv."""
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = (2.0 * PI) * u2
    return Vec3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def sample_cosine_u(u1, u2, n: Vec3) -> Vec3:
    sph = unit_sphere_from_uniforms(u1, u2)
    return (sph + n).normalize(eps=1e-12)


def sample_cosine(key: jax.Array, n: Vec3) -> Vec3:
    u = uniform_rows(key, 2, n.x.shape[0])
    return sample_cosine_u(u[0], u[1], n)


def pdf_cosine(n: Vec3, l: Vec3) -> jnp.ndarray:
    return jnp.maximum(0.0, l.dot(n)) / PI


def sample_uniform_hemisphere(key: jax.Array, n: Vec3) -> Vec3:
    """SemisphereUniform (distributions.rs:32-46): uniform sphere point,
    flipped into n's hemisphere. Unused by the HEAD mixture (superseded by
    cosine weighting) but part of the reference's distribution set."""
    u = uniform_rows(key, 2, n.x.shape[0])
    sph = unit_sphere_from_uniforms(u[0], u[1])
    flip = jnp.where(sph.dot(n) > 0.0, 1.0, -1.0)
    return sph * flip


def pdf_uniform_hemisphere(n: Vec3, l: Vec3) -> jnp.ndarray:
    """1/(2 pi) over the hemisphere (distributions.rs:48-50)."""
    return jnp.where(l.dot(n) > 0.0, 1.0 / (2.0 * PI), 0.0)


# ---------------------------------------------------------------------------
# GGX visible-NDF (Heitz) (distributions.rs:204-298)
# ---------------------------------------------------------------------------


def _sample_ggx_vndf_local(u0, u1, v_local: Vec3, alpha: jnp.ndarray) -> Vec3:
    u = (u0, u1)
    vh = Vec3(alpha * v_local.x, alpha * v_local.y, v_local.z).normalize(eps=1e-20)
    lensq = vh.x * vh.x + vh.y * vh.y
    inv_len = jax.lax.rsqrt(jnp.maximum(lensq, 1e-20))
    has_xy = lensq > 1e-20
    t1 = where3(
        has_xy,
        Vec3(-vh.y * inv_len, vh.x * inv_len, jnp.zeros_like(vh.x)),
        Vec3(jnp.ones_like(vh.x), jnp.zeros_like(vh.x), jnp.zeros_like(vh.x)),
    )
    t2 = vh.cross(t1)
    r = jnp.sqrt(u[0])
    phi = 2.0 * PI * u[1]
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh.z)
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1)) + s * p2
    nh = t1 * p1 + t2 * p2 + vh * jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1 - p2 * p2))
    ne = Vec3(alpha * nh.x, alpha * nh.y, jnp.maximum(0.0, nh.z)).normalize(eps=1e-20)
    return ne


def sample_vndf_u(u0, u1, n: Vec3, v: Vec3, roughness: jnp.ndarray) -> Vec3:
    alpha = roughness * roughness
    t1, t2 = tangent_frame(n)
    v_local = to_frame_local(t1, t2, n, v)
    ne_local = _sample_ggx_vndf_local(u0, u1, v_local, alpha)
    ne = from_frame_local(t1, t2, n, ne_local)
    return reflect(v, ne)


def sample_vndf(key: jax.Array, n: Vec3, v: Vec3, roughness: jnp.ndarray) -> Vec3:
    u = uniform_rows(key, 2, n.x.shape[0])
    return sample_vndf_u(u[0], u[1], n, v, roughness)


def _ggx_d_local(m: Vec3, alpha: jnp.ndarray) -> jnp.ndarray:
    """Anisotropic-form GGX D in tangent-local coords (distributions.rs:245-252)."""
    a2 = alpha * alpha
    q = (m.x * m.x + m.y * m.y) / jnp.maximum(a2, 1e-20) + m.z * m.z
    return 1.0 / jnp.maximum(PI * a2 * q * q, 1e-20)


def _g1_local(v: Vec3, alpha: jnp.ndarray) -> jnp.ndarray:
    """Smith G1 in tangent-local coords (distributions.rs:236-243)."""
    z2 = jnp.maximum(v.z * v.z, 1e-20)
    under = 1.0 + alpha * alpha * (v.x * v.x + v.y * v.y) / z2
    lam = 0.5 * (jnp.sqrt(under) - 1.0)
    return 1.0 / (1.0 + lam)


def pdf_vndf(n: Vec3, l: Vec3, v: Vec3, roughness: jnp.ndarray) -> jnp.ndarray:
    """D_v(h) / (4 v.h), everything in the tangent frame
    (distributions.rs:255-260, 276-297)."""
    alpha = roughness * roughness
    t1, t2 = tangent_frame(n)
    vl = to_frame_local(t1, t2, n, v)
    ll = to_frame_local(t1, t2, n, l)
    h = (vl + ll).normalize(eps=1e-20)
    dv = (
        _g1_local(vl, alpha)
        * jnp.maximum(0.0, vl.dot(h))
        * _ggx_d_local(h, alpha)
        / jnp.where(jnp.abs(vl.z) > _SAFE, vl.z, _SAFE)
    )
    denom = 4.0 * vl.dot(h)
    pdf = dv / jnp.where(jnp.abs(denom) > _SAFE, denom, _SAFE)
    # h must be in the upper hemisphere: GGX D is symmetric in +-z, but the
    # sampler clamps Ne.z >= 0 (distributions.rs:232), so below-horizon half
    # vectors have zero true density -- without this the pdf integrates > 1.
    return jnp.where((vl.z > 0.0) & (denom > 0.0) & (h.z > 0.0), pdf, 0.0)


# ---------------------------------------------------------------------------
# light-surface sampling (distributions.rs:83-184)
# ---------------------------------------------------------------------------


class _LightGather(NamedTuple):
    ptype: jnp.ndarray
    p0: Vec3
    p1: Vec3
    p2: Vec3
    pos: Vec3
    rot: Quat


def _gather_light(lp: jnp.ndarray, li: jnp.ndarray) -> _LightGather:
    """One packed gather from the pre-gathered light table (build_packs) --
    no double indirection, no (B, 3) row gathers (ops/gather.py). ``lp`` is
    the (LightCol.COUNT, L) pack (passed directly so this also runs inside
    Pallas kernels, where SceneArrays is not available)."""
    from ..scene.types import LightCol as LC
    from .gather import take_packed

    g = take_packed(lp, li)  # (LightCol.COUNT, B)

    def v3r(base):
        return Vec3(g[base], g[base + 1], g[base + 2])

    return _LightGather(
        ptype=g[LC.PTYPE],
        p0=v3r(LC.P0),
        p1=v3r(LC.P1),
        p2=v3r(LC.P2),
        pos=v3r(LC.POS),
        rot=Quat(g[LC.ROT], g[LC.ROT + 1], g[LC.ROT + 2], g[LC.ROT + 3]),
    )


def sample_light_dir_u(
    u: list, point: Vec3, lp: jnp.ndarray, statics: SceneStatics
) -> Vec3:
    """Uniformly pick one emissive primitive, area-sample a surface point,
    return the unit direction from ``point`` toward it
    (distributions.rs:84-125, 151-158). ``u`` = six U(0,1) rows: the light
    pick + five shape-sampling draws."""
    li = jnp.minimum(
        (u[5] * statics.num_lights).astype(jnp.int32), statics.num_lights - 1
    )
    lg = _gather_light(lp, li)

    # --- box face sampling (distributions.rs:86-110) ---
    s = lg.p0
    wx = 4.0 * s.y * s.z
    wy = 4.0 * s.x * s.z
    wz = 4.0 * s.x * s.y
    w = wx + wy + wz
    x = u[0] * w
    sign = jnp.where(u[1] < 0.5, 1.0, -1.0)
    cu = (u[2] * 2.0 - 1.0)
    cv = (u[3] * 2.0 - 1.0)
    on_x = x < wx
    on_y = (~on_x) & (x < wx + wy)
    box_pt = where3(
        on_x,
        Vec3(s.x * sign, cu * s.y, cv * s.z),
        where3(
            on_y,
            Vec3(cu * s.x, s.y * sign, cv * s.z),
            Vec3(cu * s.x, cv * s.y, s.z * sign),
        ),
    )

    # --- triangle sampling with uv folding (distributions.rs:111-119) ---
    tu, tv = u[0], u[1]
    fold = tu + tv >= 1.0
    tu = jnp.where(fold, 1.0 - tu, tu)
    tv = jnp.where(fold, 1.0 - tv, tv)
    tri_pt = lg.p0 + (lg.p1 - lg.p0) * tu + (lg.p2 - lg.p0) * tv

    # --- ellipsoid: uniform unit sphere scaled by radii ---
    sph = unit_sphere_from_uniforms(u[2], u[4])
    ell_pt = Vec3(sph.x * s.x, sph.y * s.y, sph.z * s.z)

    local = where3(
        lg.ptype == BOX, box_pt, where3(lg.ptype == ELLIPSOID, ell_pt, tri_pt)
    )
    world = lg.rot.rotate(local) + lg.pos
    return (world - point).normalize(eps=1e-20)


def sample_light_dir(
    key: jax.Array, point: Vec3, scn: SceneArrays, statics: SceneStatics
) -> Vec3:
    u = uniform_rows(key, 6, point.x.shape[0])
    return sample_light_dir_u(u, point, scn.light_packed, statics)


def pdf_lights(
    point: Vec3, l: Vec3, scn: SceneArrays, statics: SceneStatics
) -> jnp.ndarray:
    return pdf_lights_lp(point, l, scn.light_packed, statics)


# above this many lights the per-light static unroll is replaced by one
# vectorized (B, L) sweep: unrolling an emissive mesh with hundreds of
# triangles would explode compile time (VERDICT r1 weak #4)
UNROLL_MAX_LIGHTS = 32


def _pdf_lights_vectorized(
    point: Vec3, l: Vec3, lp: jnp.ndarray, statics: SceneStatics
) -> jnp.ndarray:
    """(B, L) masked sweep over the whole light table -- one fused pass,
    compile time independent of the light count. Same sum as the unrolled
    path; used when num_lights > UNROLL_MAX_LIGHTS."""
    from ..scene.types import LightCol as LC
    from .intersect import box_normal, ellipsoid_normal

    L = lp.shape[1]

    def row(k):
        return lp[k][None, :]  # (1, L)

    def rv3(k):
        return Vec3(row(k), row(k + 1), row(k + 2))

    ptype = row(LC.PTYPE)
    inv_area = row(LC.INV_AREA)
    p0, p1, p2 = rv3(LC.P0), rv3(LC.P1), rv3(LC.P2)
    pos = rv3(LC.POS)
    rot = Quat(row(LC.ROT), row(LC.ROT + 1), row(LC.ROT + 2), row(LC.ROT + 3))
    real = jax.lax.broadcasted_iota(jnp.int32, (1, L), 1) < statics.num_lights

    pt = Vec3(point.x[:, None], point.y[:, None], point.z[:, None])
    lb = Vec3(l.x[:, None], l.y[:, None], l.z[:, None])
    any_rot = any(statics.light_rotated)

    def contrib(t, n_dot_l, local_pdf, valid):
        denom = jnp.maximum(jnp.abs(n_dot_l), _SAFE)
        return jnp.where(
            valid & real & (t > 0.0), local_pdf * t * t / denom, 0.0
        )

    # --- triangles (world-space verts; scene.build pre-bakes transforms) ---
    t_tri, _, _, v_tri = ray_triangle(pt, lb, p0, p1, p2)
    tri_n = (p1 - p0).cross(p2 - p0).normalize(eps=1e-20)
    total = jnp.where(
        ptype == TRI, contrib(t_tri, tri_n.dot(lb), inv_area, v_tri), 0.0
    )

    # --- boxes / ellipsoids (local frame; both roots) ---
    o, d = to_local(pt, lb, pos, rot, any_rot)
    s = p0
    ib = ray_box_interval(o, d, s)
    ie = ray_ellipsoid_interval(o, d, s)
    box_sum = jnp.zeros_like(total)
    ell_sum = jnp.zeros_like(total)
    for t_root in (ib.t1, ib.t2):
        p_loc = o + d * t_root
        n_w = normal_to_world(box_normal(p_loc, s), rot, any_rot)
        box_sum += contrib(t_root, n_w.dot(lb), inv_area, ib.valid)
    for t_root in (ie.t1, ie.t2):
        p_loc = o + d * t_root
        n_w = normal_to_world(ellipsoid_normal(p_loc, s), rot, any_rot)
        usph = p_loc.div(s)
        jac = jnp.sqrt(
            jnp.maximum(
                (usph.x * s.y * s.z) ** 2
                + (s.x * usph.y * s.z) ** 2
                + (s.x * s.y * usph.z) ** 2,
                1e-20,
            )
        )
        ell_sum += contrib(t_root, n_w.dot(lb), inv_area / jac, ie.valid)
    total = jnp.where(ptype == BOX, box_sum, total)
    total = jnp.where(ptype == ELLIPSOID, ell_sum, total)
    return jnp.sum(total, axis=1) / max(statics.num_lights, 1)


def pdf_lights_lp(
    point: Vec3, l: Vec3, lp: jnp.ndarray, statics: SceneStatics
) -> jnp.ndarray:
    """Mixture-light pdf: for the ray (point, l), sum the area->solid-angle
    converted pdf over EVERY light-primitive intersection, divided by the
    light count (distributions.rs:127-148, 160-184).

    Statically unrolled over the (few) lights -- each light compiles only
    its own shape kernel from scalar constants, so no (B, L) lane-padded
    intermediates are ever materialized (light counts in the course scenes:
    1-18). Above UNROLL_MAX_LIGHTS (emissive meshes) the vectorized (B, L)
    sweep takes over."""
    from ..scene.types import LightCol as LC

    if len(statics.light_types) > UNROLL_MAX_LIGHTS:
        return _pdf_lights_vectorized(point, l, lp, statics)

    total = point.x * 0.0

    def contrib(t, n_dot_l, local_pdf, valid):
        denom = jnp.maximum(jnp.abs(n_dot_l), _SAFE)
        return jnp.where(valid & (t > 0.0), local_pdf * t * t / denom, 0.0)

    for j, ptype in enumerate(statics.light_types):
        def c(k, j=j):
            return lp[k, j]  # scalar constants, folded at compile time

        def cv3(k, j=j):
            return Vec3(lp[k, j], lp[k + 1, j], lp[k + 2, j])

        inv_area = c(LC.INV_AREA)
        if ptype == TRI:
            # triangle verts are pre-baked world space (scene.build)
            p0, p1, p2 = cv3(LC.P0), cv3(LC.P1), cv3(LC.P2)
            t_tri, _, _, v_tri = ray_triangle(point, l, p0, p1, p2)
            tri_n = (p1 - p0).cross(p2 - p0).normalize(eps=1e-20)
            total += contrib(t_tri, tri_n.dot(l), inv_area, v_tri)
            continue

        pos = cv3(LC.POS)
        rot = Quat(c(LC.ROT), c(LC.ROT + 1), c(LC.ROT + 2), c(LC.ROT + 3))
        rotated = statics.light_rotated[j]
        o, d = to_local(point, l, pos, rot, rotated)
        s = cv3(LC.P0)
        if ptype == BOX:
            from .intersect import box_normal

            ib = ray_box_interval(o, d, s)
            for t_root in (ib.t1, ib.t2):
                p_loc = o + d * t_root
                n_loc = box_normal(p_loc, s)
                n_w = normal_to_world(n_loc, rot, rotated)
                total += contrib(t_root, n_w.dot(l), inv_area, ib.valid)
        else:  # ELLIPSOID: pullback pdf 1/(4 pi |J|)
            from .intersect import ellipsoid_normal

            ie = ray_ellipsoid_interval(o, d, s)
            for t_root in (ie.t1, ie.t2):
                p_loc = o + d * t_root
                n_loc = ellipsoid_normal(p_loc, s)
                n_w = normal_to_world(n_loc, rot, rotated)
                usph = p_loc.div(s)
                jac = jnp.sqrt(
                    jnp.maximum(
                        (usph.x * s.y * s.z) ** 2
                        + (s.x * usph.y * s.z) ** 2
                        + (s.x * s.y * usph.z) ** 2,
                        1e-20,
                    )
                )
                total += contrib(t_root, n_w.dot(l), inv_area / jac, ie.valid)

    return total / max(statics.num_lights, 1)


# ---------------------------------------------------------------------------
# one-sample MIS mixture with bounded rejection (rendering.rs:102-110,
# distributions.rs:187-202)
# ---------------------------------------------------------------------------


def sample_mixture(
    key: jax.Array,
    point: Vec3,
    n_geom: Vec3,
    n_shade: Vec3,
    v: Vec3,
    roughness: jnp.ndarray,
    scn: SceneArrays,
    statics: SceneStatics,
    need: jnp.ndarray,
    max_tries: int = 4,
    faithful: bool = False,
    uniforms: list | None = None,
):
    """Returns (l Vec3, pdf (B,), ok (B,)).

    Rejection contract per the reference: resample until pdf > 0 and
    l . n_shade > 0 (rendering.rs:102-110). Batch-first formulation: the
    reference's sequential retry loop becomes ``max_tries`` *parallel* iid
    candidates (flattened to a K*B lane batch -- one fused pass instead of
    K device loop trips); the first accepted candidate per lane is selected,
    which is distributionally identical to sequential retry. Lanes where all
    K candidates fail report ok=False and the path is killed (probability
    ~(1-p_accept)^K, negligible).

    ``faithful=False`` (default, fast): accept on l.n_geom > 0 (guarantees
    the cosine component of the mixture pdf > 0) -- a cheap per-candidate
    test that defers the mixture pdf to the single selected candidate.
    Deviation from the reference: candidates in {l.n_shade > 0,
    l.n_geom <= 0, vndf-or-light pdf > 0} are rejected here but accepted by
    the reference (rendering.rs:107), which then adds a NEGATIVE diffuse
    contribution (its cos term l.n_geom is signed, rendering.rs:122; its
    specular term is 0 below the horizon via chi+ in G1). The set is empty
    for flat normals and a thin silhouette band for smooth shading normals;
    tests/test_integrator.py::test_faithful_acceptance_deviation_bounded
    pins the measured image delta.

    ``faithful=True``: the reference's exact acceptance -- the full mixture
    pdf is evaluated for every candidate (K*B lanes) and acceptance is
    pdf > 0 and l.n_shade > 0. ~n_comp x more pdf math per bounce; used to
    quantify the deviation and available via TraceConfig(faithful=True).
    """
    n_comp = 3 if statics.num_lights > 0 else 2
    b = point.x.shape[0]
    k = max_tries

    def tile(x):
        return jnp.broadcast_to(x[None, :], (k,) + x.shape).reshape(k * b)

    def tile3(vec: Vec3) -> Vec3:
        return Vec3(tile(vec.x), tile(vec.y), tile(vec.z))

    point_t = tile3(point)
    n_t = tile3(n_geom)
    v_t = tile3(v)
    rough_t = tile(roughness)

    # --- draw K*B candidates in one pass; ONE threefry sweep for all the
    # uniforms this bounce needs. The component samplers are mutually
    # exclusive per candidate (one `which` each), so they can safely share
    # uniform rows: 7 rows instead of 11. ---
    # ``uniforms`` (7 rows of (K*B,), candidate-major like the reshape
    # below) lets the wavefront engine key draws by work item (ops/rng.py)
    u = uniforms if uniforms is not None else uniform_rows(key, 7, k * b)
    which = jnp.minimum((u[0] * n_comp).astype(jnp.int32), n_comp - 1)
    cand = sample_cosine_u(u[1], u[2], n_t)
    cand = where3(which == 1, sample_vndf_u(u[1], u[2], n_t, v_t, rough_t), cand)
    if statics.num_lights > 0:
        cand = where3(
            which == 2,
            sample_light_dir_u(u[1:7], point_t, scn.light_packed, statics),
            cand,
        )

    if faithful:
        # reference acceptance (rendering.rs:107): full mixture pdf per
        # candidate; accept on pdf > 0 and l.n_shade > 0
        pdf_t = pdf_cosine(n_t, cand) + pdf_vndf(n_t, cand, v_t, rough_t)
        if statics.num_lights > 0:
            pdf_t = pdf_t + pdf_lights_lp(
                point_t, cand, scn.light_packed, statics
            )
        pdf_t = pdf_t / n_comp
        ok = (cand.dot(tile3(n_shade)) > 0.0) & (pdf_t > _SAFE)  # (K*B,)
    else:
        # cheap acceptance: l.n_geom > 0 guarantees the cosine component
        # (hence the mixture pdf) is > 0, so the expensive pdf evaluation
        # can wait until after selection and run on B lanes instead of K*B.
        # See the docstring for the (test-pinned) deviation this implies.
        ok = (cand.dot(tile3(n_shade)) > 0.0) & (cand.dot(n_t) > 0.0)

    # --- first accepted candidate per lane, as a masked sum over the K
    # axis (no per-lane gather) ---
    ok2 = ok.reshape(k, b)
    is_first = ok2 & (jnp.cumsum(ok2.astype(jnp.int32), axis=0) == 1)
    w = is_first.astype(jnp.float32)

    def pick(x):
        return jnp.sum(x.reshape(k, b) * w, axis=0)

    l = Vec3(pick(cand.x), pick(cand.y), pick(cand.z))
    accepted = ok2.any(axis=0)

    if faithful:
        pdf = pick(pdf_t)
        return l, jnp.maximum(pdf, _SAFE), accepted & need

    # --- mixture pdf, selected candidates only (B lanes) ---
    pdf = pdf_cosine(n_geom, l) + pdf_vndf(n_geom, l, v, roughness)
    if statics.num_lights > 0:
        pdf = pdf + pdf_lights(point, l, scn, statics)
    pdf = pdf / n_comp
    accepted = accepted & (pdf > _SAFE)
    return l, jnp.maximum(pdf, _SAFE), accepted & need
