"""Iterative wavefront path tracer.

The reference's recursive estimator (src/rendering.rs:86-127) telescopes into
an iterative loop carrying (ray, throughput T, radiance L, alive):

    L += T * emission_at_hit          (every hit; lights are collected on hit,
                                       not with shadow rays -- one-sample MIS)
    T *= brdf(l,n,v) * (l.n) / pdf    (mixture-sampled lobe)
    L += T_prev * bg on miss, then the lane dies

run as a ``lax.scan`` over ``ray_depth - 1`` full bounces plus one final
intersect+emission epilogue (the reference's innermost call returns black at
depth 0, so its last sampled direction never contributes --
src/rendering.rs:93-95; skipping that wasted sample saves a whole
sampling+light-pdf pass).

Delta materials from the text scenes (absent in reference HEAD, required by
its inputs -- SURVEY.md section 2.2):

* MIRROR: l = reflect(v, n), T *= color.
* DIELECTRIC: Schlick reflect/refract split by a uniform draw; on refraction
  into the object (outer->inner), T *= color; total internal reflection
  falls back to reflection.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.brdf import eval_brdf
from ..ops.camera import CameraArrays, generate_rays
from ..ops.sampling import sample_mixture
from ..ops.scene_intersect import nearest_hit_dense, surface_detail
from ..ops.vec import Vec3, reflect, where3
from ..scene.types import DIELECTRIC, MIRROR, SceneArrays, SceneStatics


class TraceConfig(NamedTuple):
    """Static (compile-time) integrator parameters."""

    ray_depth: int
    bg_color: tuple  # (r, g, b)
    # parallel rejection-candidate count (ops.sampling.sample_mixture). 4
    # kills <0.4% of bounces in the worst case (vs the reference's unbounded
    # retry) -- well inside MC noise -- and is ~25% faster than 8.
    max_tries: int = 4
    backend: str = "dense"  # "dense" | "bvh"
    # reference-exact acceptance (pdf > 0 & l.n_shade > 0, signed cos term,
    # rendering.rs:107+122) instead of the fast l.n_geom > 0 test. Slower
    # (full mixture pdf on K*B candidate lanes); the image delta of the fast
    # default is test-pinned (test_faithful_acceptance_deviation_bounded).
    faithful: bool = False
    # Russian roulette from bounce RR_START on: survive with p =
    # clamp(max throughput channel, RR_MIN_P, 1), divide throughput by p.
    # Unbiased; OFF by default for reference parity (the reference HEAD
    # has none -- fixed depth, src/rendering.rs:93-95). RT_RR=1 /
    # Renderer(russian_roulette=True) opts in; with the regeneration
    # wavefront, killed lanes immediately refill with fresh work, so RR
    # converts low-throughput tail bounces into useful new paths.
    rr: bool = False


RR_START = 2  # first bounce index eligible for roulette
RR_MIN_P = 0.05


def _nearest(ro, rd, scn, statics, cfg: TraceConfig):
    if cfg.backend == "bvh" and scn.bvh is not None:
        from ..ops.traverse import nearest_hit_bvh

        return nearest_hit_bvh(ro, rd, scn, statics)
    return nearest_hit_dense(ro, rd, scn, statics)


class _PathState(NamedTuple):
    ro: Vec3
    rd: Vec3
    throughput: Vec3
    radiance: Vec3
    alive: jnp.ndarray


def _collect_hit(state: _PathState, scn, statics, cfg):
    """Intersect + accumulate emission/background. Returns (state', surf, hit)."""
    hit = _nearest(state.ro, state.rd, scn, statics, cfg)
    surf = surface_detail(state.ro, state.rd, hit, scn, statics)
    bg = Vec3(
        jnp.full_like(state.ro.x, cfg.bg_color[0]),
        jnp.full_like(state.ro.x, cfg.bg_color[1]),
        jnp.full_like(state.ro.x, cfg.bg_color[2]),
    )
    miss = state.alive & ~hit.valid
    on_hit = state.alive & hit.valid
    add = where3(
        miss,
        state.throughput.mul(bg),
        where3(on_hit, state.throughput.mul(surf.emission), Vec3.full(0.0, state.ro)),
    )
    radiance = state.radiance + add
    return state._replace(radiance=radiance, alive=on_hit), surf, hit


def _finish_bounce(
    state: _PathState,
    surf,
    l_s: Vec3,
    pdf: jnp.ndarray,
    ok: jnp.ndarray,
    u_diel: jnp.ndarray,
    cfg: TraceConfig,
    u_rr: jnp.ndarray | None = None,
    rr_mask: jnp.ndarray | bool = False,
) -> _PathState:
    """Post-sampling half of a bounce: BRDF weight, delta-material
    continuation rules, state update. Shared by the batch scan (``_bounce``)
    and the regeneration wavefront (integrator/wavefront.py); ``u_diel`` is
    the dielectric reflect/refract split draw, ``u_rr``/``rr_mask`` the
    roulette draw and per-lane eligibility when ``cfg.rr``."""
    alive = state.alive
    v = -state.rd  # rays are kept unit-length
    n = surf.n_geom
    is_mirror = surf.mkind == MIRROR
    is_diel = surf.mkind == DIELECTRIC
    is_delta = is_mirror | is_diel

    f = eval_brdf(l_s, n, v, surf.color, surf.metallic, surf.roughness, surf.mkind)
    # the reference's cos term is SIGNED l.n_geom (rendering.rs:122): below
    # the horizon the specular lobe is 0 (chi+ in G1) and the diffuse lobe
    # contributes negatively. The fast sampler never accepts such l, so the
    # clamp only guards its kill-path zeros; faithful mode keeps the sign.
    cos_l = l_s.dot(n) if cfg.faithful else jnp.maximum(l_s.dot(n), 0.0)
    inv_pdf = 1.0 / jnp.maximum(pdf, 1e-20)
    w_sampled = f * (cos_l * inv_pdf)

    # --- mirror ---
    l_mirror = reflect(v, n)
    w_mirror = surf.color

    # --- dielectric ---
    cos_i = jnp.clip(v.dot(n), 0.0, 1.0)
    eta = jnp.where(surf.is_outer, 1.0 / surf.ior, surf.ior)
    sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    r0 = jnp.square((eta - 1.0) / (eta + 1.0))
    refl_p = r0 + (1.0 - r0) * jnp.power(1.0 - cos_i, 5.0)
    do_reflect = tir | (u_diel < refl_p)
    l_refr = (state.rd * eta + n * (eta * cos_i - cos_t)).normalize(eps=1e-20)
    l_diel = where3(do_reflect, l_mirror, l_refr)
    one = Vec3.full(1.0, like=surf.color)
    w_diel = where3(do_reflect | ~surf.is_outer, one, surf.color)

    next_dir = where3(is_mirror, l_mirror, where3(is_diel, l_diel, l_s))
    weight = where3(is_mirror, w_mirror, where3(is_diel, w_diel, w_sampled))

    # Scattered/reflected rays restart from the EPS-backed-off point on the
    # incoming side (src/rendering.rs:98); *transmitted* rays must instead
    # continue from just past the surface or they re-hit it immediately.
    transmitted = is_diel & ~do_reflect
    point_back = state.ro + state.rd * (surf.t + 1e-4)
    next_origin = where3(transmitted, point_back, surf.point)

    new_alive = alive & (is_delta | ok)
    zero = Vec3.full(0.0, like=weight)
    throughput = state.throughput.mul(where3(new_alive, weight, zero))

    if cfg.rr and u_rr is not None:
        p = jnp.clip(
            jnp.maximum(jnp.maximum(throughput.x, throughput.y), throughput.z),
            RR_MIN_P,
            1.0,
        )
        roll = rr_mask & new_alive
        survive = u_rr < p
        new_alive = new_alive & (survive | ~roll)
        inv_p = jnp.where(roll & survive, 1.0 / p, 1.0)
        throughput = throughput * inv_p

    return _PathState(
        ro=next_origin,
        rd=next_dir,
        throughput=throughput,
        radiance=state.radiance,
        alive=new_alive,
    )


def _bounce(
    state: _PathState,
    key: jax.Array,
    scn: SceneArrays,
    statics: SceneStatics,
    cfg: TraceConfig,
    bounce_i=None,
) -> _PathState:
    state, surf, _hit = _collect_hit(state, scn, statics, cfg)
    alive = state.alive
    v = -state.rd  # rays are kept unit-length
    n = surf.n_geom

    is_mirror = surf.mkind == MIRROR
    is_diel = surf.mkind == DIELECTRIC
    is_delta = is_mirror | is_diel
    need_sample = alive & ~is_delta

    k_mix, k_diel = jax.random.split(key)
    l_s, pdf, ok = sample_mixture(
        k_mix,
        surf.point,
        n,
        surf.n_shade,
        v,
        surf.roughness,
        scn,
        statics,
        need=need_sample,
        max_tries=cfg.max_tries,
        faithful=cfg.faithful,
    )
    from ..ops.sampling import uniform_rows

    b = state.ro.x.shape[0]
    if cfg.rr and bounce_i is not None:
        u = uniform_rows(k_diel, 2, b)
        rr_mask = jnp.broadcast_to(bounce_i >= RR_START, (b,))
        return _finish_bounce(
            state, surf, l_s, pdf, ok, u[0], cfg, u_rr=u[1], rr_mask=rr_mask
        )
    u_diel = uniform_rows(k_diel, 1, b)[0]
    return _finish_bounce(state, surf, l_s, pdf, ok, u_diel, cfg)


def trace_paths(
    key: jax.Array,
    ro: Vec3,
    rd: Vec3,
    scn: SceneArrays,
    statics: SceneStatics,
    cfg: TraceConfig,
    with_stats: bool = False,
):
    """Radiance estimate for a batch of rays. Returns Vec3 of (B,), or
    (Vec3, rays_traced (B,)) when ``with_stats`` -- rays_traced counts path
    vertices (one scene intersection per live bounce), the unit behind the
    Mrays/s benchmark metric (SURVEY.md section 6)."""
    # init derived from traced inputs so device-varying types match the scan
    # body outputs under shard_map (jax >= 0.9 pvary rules)
    zeros = ro.x * 0.0
    ones = zeros + 1.0
    state = _PathState(
        ro=ro,
        rd=rd,
        throughput=Vec3(ones, ones, ones),
        radiance=Vec3(zeros, zeros, zeros),
        alive=zeros < 1.0,
    )
    rays = zeros

    if cfg.ray_depth > 1:

        def step(carry, i):
            st, cnt = carry
            cnt = cnt + st.alive.astype(jnp.float32)
            st = _bounce(
                st, jax.random.fold_in(key, i), scn, statics, cfg,
                bounce_i=i,
            )
            return (st, cnt), None

        (state, rays), _ = jax.lax.scan(
            step, (state, rays), jnp.arange(cfg.ray_depth - 1)
        )

    # final depth level: emission/background only (deeper recursion is black)
    rays = rays + state.alive.astype(jnp.float32)
    state, _, _ = _collect_hit(state, scn, statics, cfg)
    if with_stats:
        return state.radiance, rays
    return state.radiance


def render_pixels(
    key: jax.Array,
    pix_x: jnp.ndarray,
    pix_y: jnp.ndarray,
    cam: CameraArrays,
    scn: SceneArrays,
    statics: SceneStatics,
    cfg: TraceConfig,
    width: int,
    height: int,
    samples: int,
    with_stats: bool = False,
):
    """Average radiance over ``samples`` jittered rays per pixel.

    Returns (3, B) f32 SoA (plus total rays traced, scalar, when
    ``with_stats``). Channel-major keeps each channel a contiguous (B,)
    row; hosts transpose after the fetch (cheap numpy copy).

    Sample loop = lax.scan (sequential, accumulating), mirroring the
    reference's per-pixel sample loop (src/rendering.rs:52-62) but
    vectorized over the whole pixel batch.
    """

    def one_sample(carry, s):
        acc, nrays = carry
        k = jax.random.fold_in(key, s)
        k_cam, k_path = jax.random.split(k)
        ro, rd = generate_rays(cam, pix_x, pix_y, width, height, k_cam)
        rad, rays = trace_paths(
            k_path, ro, rd, scn, statics, cfg, with_stats=True
        )
        return (acc + rad, nrays + jnp.sum(rays)), None

    zeros = (pix_x + pix_y).astype(jnp.float32) * 0.0
    (total, nrays), _ = jax.lax.scan(
        one_sample, (Vec3(zeros, zeros, zeros), jnp.sum(zeros)), jnp.arange(samples)
    )
    avg = total * (1.0 / samples)
    out = jnp.stack([avg.x, avg.y, avg.z], axis=0)
    if with_stats:
        return out, nrays
    return out
