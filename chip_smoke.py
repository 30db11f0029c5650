"""Run the path tracer's main paths once on NVIDIA GPUs and check them.

    python chip_smoke.py              # phases a-e, one GPU
    python chip_smoke.py --four-gpus  # phase f only, four GPUs

Phases, one JSON record each on stdout:

a device   the card's name and power limit (nvidia-smi), JAX's device kind
           and version, the compile-cache directory in use.
b dense    ``runtime.cli.main`` renders scenes/cornell_box.gltf at
           1280x720, 256 spp (dense backend, batch engine): PPM and PNG
           agree, radiance is finite and nonzero; frame time with and
           without compilation, path vertices per second, and the device's
           busy time per bounce from a profiler trace.
c kernels  the Pallas nearest-hit kernel (Triton route, compiled) against
           the XLA sweep on 1,048,576 rays in the Cornell box: equal valid
           masks, t within rtol = atol = 2e-5, >= 99.9% equal indices over
           valid lanes (exact ties may differ); timed alone and inside the
           whole frame. ``take_packed`` against numpy, bit for bit.
d oracle   a 12x8 Cornell box at 384 spp (faithful acceptance, batch
           engine) against the float64 host oracle (tests/oracle_tracer.py)
           at 24 spp. The tolerance is statistical (Monte-Carlo z-scores),
           not a rounding bound.
e bvh      ``runtime.cli.main`` renders the generated mesh_bvh.gltf
           (81,932 triangles) at 1280x720, 16 spp (BVH backend, wavefront
           engine): which BVH builder ran, build, compile and render
           times; then a 12x8 render of it against the oracle as in d.
f 4 GPUs   ShardedRenderer over (2 tile x 2 spp) and (4 x 1) meshes for
           both scenes, against the one-GPU render of the same frame.

Before the last line it prints the card's name and power limit as nvidia-smi
gives them. The last line, {"ok": true, "device": {...}}, is printed only
when every phase passed; the script exits 1 without it when JAX's default
backend is not a GPU or a phase failed. One process drives the card(s).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "smoke")
CORNELL = os.path.join(ROOT, "scenes", "cornell_box.gltf")
MESH = os.path.join(ROOT, "scenes", "mesh_bvh.gltf")

W, H = 1280, 720
DENSE_SPP, BVH_SPP = 256, 16
KERNEL_RAYS = 1 << 20
ORACLE_W, ORACLE_H, ORACLE_SPP, PROD_SPP = 12, 8, 24, 384


def need(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def nvidia_smi() -> list[str]:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def _stand_ins():
    spec = importlib.util.spec_from_file_location(
        "gen_stand_ins", os.path.join(ROOT, "scenes", "gen_stand_ins.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_mesh_scene(seed: int = 0) -> str:
    """(Re)generate scenes/mesh_bvh.gltf from its seed; returns the path."""
    with open(MESH, "w") as fh:
        json.dump(_stand_ins().mesh_bvh(seed), fh)
    return MESH


def device_busy(trace_dir: str) -> dict:
    """Busy time of the first GPU in a jax.profiler trace: the union of the
    kernel intervals on its stream lines, plus the kernels that took most
    of it."""
    import glob

    from jax.profiler import ProfileData

    files = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    need(files, f"no trace written under {trace_dir}")
    pd = ProfileData.from_file(sorted(files)[-1])
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU:0")]
    need(planes, "no GPU plane in the trace")
    lines = list(planes[0].lines)
    streams = [ln for ln in lines if ln.name.startswith("Stream")] or lines
    spans, per_kernel = [], {}
    for ln in streams:
        for ev in ln.events:
            spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
            per_kernel[ev.name] = per_kernel.get(ev.name, 0.0) + ev.duration_ns
    need(spans, "no device events in the trace")
    spans.sort()
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = spans[-1][1] - spans[0][0]
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {
        "lines": sorted({ln.name for ln in lines}),
        "busy_s": busy * 1e-9,
        "window_s": window * 1e-9,
        "idle_share": 1.0 - busy / window if window > 0 else None,
        "kernels": len(spans),
        "top_kernels_ms": [[k[:80], v * 1e-6] for k, v in top],
    }


def _check_image(stem: str, h: int, w: int) -> None:
    from raytracing_course_2024_tpu.runtime.image_io import read_png, read_ppm

    ppm, png = read_ppm(stem + ".ppm"), read_png(stem + ".png")
    need(ppm.shape == (h, w, 3), f"PPM shape {ppm.shape}")
    need(np.array_equal(ppm, png), "PPM and PNG differ")
    need(ppm.max() > 0, "image is black")


def phase_device(ctx: dict) -> dict:
    import jax

    from raytracing_course_2024_tpu import enable_compile_cache

    ctx["smi"] = nvidia_smi()
    d = jax.devices()
    return {
        "nvidia_smi": ctx["smi"],
        "device_kind": d[0].device_kind,
        "device_count": len(d),
        "jax": jax.__version__,
        "compile_cache": enable_compile_cache(),
    }


def phase_dense(ctx: dict) -> dict:
    import jax

    from raytracing_course_2024_tpu.runtime import cli
    from raytracing_course_2024_tpu.runtime.render import Renderer
    from raytracing_course_2024_tpu.scene import load_scene

    w, h, spp = ctx["w"], ctx["h"], ctx["dense_spp"]
    stem = os.path.join(OUT, f"cornell_{w}x{h}_{spp}")
    rc, t_cli = timed(cli.main, [CORNELL, str(w), str(h), str(spp),
                                 stem + ".ppm", stem])
    need(rc == 0, f"cli.main returned {rc}")
    _check_image(stem, h, w)

    r = Renderer(load_scene(CORNELL, w, h, spp))
    need((r.backend, r.engine) == ("dense", "batch"), (r.backend, r.engine))
    (_, st0), t_first = timed(r.render_radiance, seed=0, with_stats=True)
    img, st = r.render_radiance(seed=1, with_stats=True)
    need(np.isfinite(img).all() and img.max() > 0, "radiance not finite/lit")
    ctx["dense_renderer"] = r

    trace_dir = os.path.join(OUT, "trace_dense")
    with jax.profiler.trace(trace_dir):
        r.render_frame_device(seed=2)
    busy = device_busy(trace_dir)
    depth = r.settings.ray_depth
    return {
        "scene": "cornell_box.gltf", "size": f"{w}x{h}", "spp": spp,
        "cli_seconds": t_cli,
        "first_frame_seconds_incl_compile": t_first,
        "frame_seconds": st.wall_seconds,
        "path_vertices": st.path_vertices,
        "mverts_per_s": st.mrays_per_sec,
        "avg_path_length": st.avg_path_length,
        "trace": busy,
        # spp x depth bounce steps: (depth - 1) full bounces and the final
        # emission-only hit per sample; camera rays are counted in
        "device_ms_per_bounce_step": busy["busy_s"] * 1e3 / (spp * depth),
    }


def _median_time(fn, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax_block(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def jax_block(x):
    import jax

    return jax.block_until_ready(x)


def phase_kernels(ctx: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from raytracing_course_2024_tpu.ops.gather import take_packed
    from raytracing_course_2024_tpu.ops.scene_intersect import nearest_hit_dense
    from raytracing_course_2024_tpu.ops.vec import Vec3
    from raytracing_course_2024_tpu.runtime.render import Renderer
    from raytracing_course_2024_tpu.scene import load_scene

    rec = {}
    rng = np.random.default_rng(0)
    r = ctx.get("dense_renderer") or Renderer(
        load_scene(CORNELL, ctx["w"], ctx["h"], ctx["dense_spp"]))
    arrays, statics = r.arrays, r.statics
    need(arrays.tri_pack is not None, "Cornell box is not kernel-eligible")
    b = ctx["kernel_rays"]
    o = rng.uniform(-1, 1, (b, 3)) + np.array([0, 1, 0])
    d = rng.normal(size=(b, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro = Vec3(*[jnp.asarray(o[:, i], jnp.float32) for i in range(3)])
    rd = Vec3(*[jnp.asarray(d[:, i], jnp.float32) for i in range(3)])
    sweep_arrays = arrays._replace(tri_pack=None)
    f_k = jax.jit(lambda o, d: nearest_hit_dense(o, d, arrays, statics))
    f_x = jax.jit(lambda o, d: nearest_hit_dense(o, d, sweep_arrays, statics))
    hlo = f_k.lower(ro, rd).as_text()
    rec["kernel_compiled_triton"] = "xla.gpu.triton" in hlo
    need(rec["kernel_compiled_triton"], "no compiled Triton call in the HLO")
    hk, hx = jax_block(f_k(ro, rd)), jax_block(f_x(ro, rd))
    valid = np.asarray(hx.valid)
    need(np.array_equal(valid, np.asarray(hk.valid)), "valid masks differ")
    tk, tx = np.asarray(hk.t)[valid], np.asarray(hx.t)[valid]
    rec["max_abs_t_diff"] = float(np.abs(tk - tx).max())
    need(np.allclose(tk, tx, rtol=2e-5, atol=2e-5), "t differs")
    rec["index_agreement"] = float(
        (np.asarray(hk.idx) == np.asarray(hx.idx))[valid].mean())
    need(rec["index_agreement"] >= 0.999, "indices differ")
    rec["valid_share"] = float(valid.mean())
    rec["kernel_ms"] = 1e3 * _median_time(lambda: f_k(ro, rd), 20)
    rec["xla_sweep_ms"] = 1e3 * _median_time(lambda: f_x(ro, rd), 20)

    # whole frame, kernel vs sweep, in turns: k x x k k x x k
    rx = Renderer(r.desc)
    rx.arrays = rx.arrays._replace(tri_pack=None)
    rx.render_frame_device(seed=0)  # compile
    frames = {"kernel": [], "xla_sweep": []}
    for who in ("kernel", "xla_sweep", "xla_sweep", "kernel") * 2:
        rr = r if who == "kernel" else rx
        _, dt = timed(rr.render_frame_device, seed=len(frames[who]))
        frames[who].append(dt)
    rec["frame_seconds"] = frames
    rec["frame_median_seconds"] = {k: float(np.median(v))
                                   for k, v in frames.items()}

    # take_packed is exact: tables TF32 or bf16 would round
    gathers = {}
    for n in (92, 1024, 4096):
        packed = rng.uniform(-4, 4, (36, n)).astype(np.float32)
        packed[0] = 1.0 + np.float32(2.0 ** -20) * np.arange(n)
        packed[1] = (2 ** 24 - 1) - np.arange(n)
        idx = rng.integers(0, n, b).astype(np.int32)
        f_g = jax.jit(take_packed)
        packed_d, idx_d = jnp.asarray(packed), jnp.asarray(idx)
        got = jax_block(f_g(packed_d, idx_d))
        exact = all(
            np.array_equal(np.asarray(g).view(np.uint32),
                           packed[ci][idx].view(np.uint32))
            for ci, g in enumerate(got)
        )
        need(exact, f"take_packed not bit-exact at n={n}")
        gathers[n] = 1e3 * _median_time(lambda: f_g(packed_d, idx_d), 10)
    rec["take_packed_bit_exact"] = True
    rec["take_packed_ms"] = gathers
    return rec


def _oracle_compare(path: str) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracle_tracer import Oracle, parity_ok, parity_stats

    from raytracing_course_2024_tpu.runtime.render import Renderer
    from raytracing_course_2024_tpu.scene import load_scene

    desc = load_scene(path, ORACLE_W, ORACLE_H, PROD_SPP)
    r = Renderer(desc, faithful=True, max_tries=16, engine="batch")
    p_img = r.render_radiance(seed=0, samples=PROD_SPP)
    need(np.isfinite(p_img).all(), "radiance not finite")
    (o_img, o_var), t_oracle = timed(
        Oracle(desc, seed=123).render, spp=ORACLE_SPP)
    st = parity_stats(p_img, o_img, o_var, ORACLE_SPP, PROD_SPP)
    rec = {
        "size": f"{ORACLE_W}x{ORACLE_H}", "backend": r.backend,
        "engine": r.engine, "prod_spp": PROD_SPP, "oracle_spp": ORACLE_SPP,
        "oracle_seconds": t_oracle,
        "tolerance": "statistical (Monte-Carlo z-scores against the "
                     "oracle's sample variance), not a rounding bound",
        **{k: (v.tolist() if isinstance(v, np.ndarray) else v)
           for k, v in st.items()},
    }
    need(parity_ok(st), f"oracle parity failed: {rec}")
    return rec


def phase_oracle(ctx: dict) -> dict:
    return {"scene": "cornell_box.gltf", **_oracle_compare(CORNELL)}


def phase_bvh(ctx: dict) -> dict:
    from raytracing_course_2024_tpu.native import load_native
    from raytracing_course_2024_tpu.runtime import cli
    from raytracing_course_2024_tpu.runtime.render import Renderer
    from raytracing_course_2024_tpu.scene import load_scene

    w, h, spp = ctx["w"], ctx["h"], ctx["bvh_spp"]
    write_mesh_scene()
    try:
        load_native()
        builder = "native"
    except Exception as e:  # noqa: BLE001 -- reported, numpy builds instead
        builder = f"numpy ({type(e).__name__}: {e})"

    stem = os.path.join(OUT, f"mesh_bvh_{w}x{h}_{spp}")
    rc, t_cli = timed(cli.main, [MESH, str(w), str(h), str(spp),
                                 stem + ".ppm", stem])
    need(rc == 0, f"cli.main returned {rc}")
    _check_image(stem, h, w)

    desc, t_load = timed(load_scene, MESH, w, h, spp)
    r, t_build = timed(Renderer, desc)
    need((r.backend, r.engine) == ("bvh", "wavefront"), (r.backend, r.engine))
    (_, st0), t_first = timed(r.render_radiance, seed=0, with_stats=True)
    img, st = r.render_radiance(seed=1, with_stats=True)
    need(np.isfinite(img).all() and img.max() > 0, "radiance not finite/lit")
    return {
        "scene": "mesh_bvh.gltf", "triangles": len(desc.primitives),
        "size": f"{w}x{h}", "spp": spp, "lanes": r.batch_size,
        "bvh_builder": builder,
        "cli_seconds": t_cli,
        "scene_load_seconds": t_load,
        "renderer_setup_seconds_incl_bvh_build": t_build,
        "first_frame_seconds_incl_compile": t_first,
        "frame_seconds": st.wall_seconds,
        "mverts_per_s": st.mrays_per_sec,
        "avg_path_length": st.avg_path_length,
        "oracle": _oracle_compare(MESH),
    }


def phase_four_gpus(ctx: dict) -> dict:
    import jax

    from raytracing_course_2024_tpu.parallel import make_mesh, render_frame_sharded
    from raytracing_course_2024_tpu.runtime.render import ShardedRenderer
    from raytracing_course_2024_tpu.scene import load_scene

    devs = jax.devices()
    need(len(devs) == 4, f"{len(devs)} devices visible, 4 needed")
    write_mesh_scene()
    w, h = ctx["w"], ctx["h"]
    rec = {}
    for name, path, engine, spp in (
        ("cornell_box.gltf", CORNELL, "batch", 8),
        ("mesh_bvh.gltf", MESH, "wavefront", 4),
    ):
        desc = load_scene(path, w, h, spp)
        one = ShardedRenderer(desc, mesh=make_mesh(1, 1, devs[:1]),
                              engine=engine)
        ref, t_one = timed(one.render_radiance, seed=0)
        need(np.isfinite(ref).all() and ref.max() > 0, f"{name}: 1-GPU frame")
        res = {"engine": engine, "spp": spp, "one_gpu_seconds": t_one}
        for shape in ((2, 2), (4, 1)):
            r = ShardedRenderer(desc, mesh=make_mesh(*shape), engine=engine)
            if engine == "batch":  # the compiled kernel runs under shard_map
                hlo = jax.jit(lambda k: render_frame_sharded(
                    k, r.arrays, r.statics, r.cam, r.cfg, w, h, spp, r.mesh,
                    engine=engine)).lower(jax.random.PRNGKey(0)).as_text()
                need("xla.gpu.triton" in hlo, "no Triton call under shard_map")
            r.render_radiance(seed=0)  # compile
            img, t = timed(r.render_radiance, seed=0)
            need(np.isfinite(img).all(), f"{name} {shape}: not finite")
            key = f"{shape[0]}x{shape[1]}"
            if engine == "wavefront":
                # global (pixel, sample) RNG keys: equal up to fp order
                err = float(np.abs(img - ref).max())
                need(np.allclose(img, ref, rtol=1e-4, atol=1e-5),
                     f"{name} {key}: max |diff| {err}")
            else:
                # mesh-coordinate keys: another stream, so the frame agrees
                # within Monte-Carlo noise on the mean and is deterministic
                again = r.render_radiance(seed=0)
                need(np.array_equal(img, again), f"{name} {key}: not deterministic")
                err = float(abs(img.mean() - ref.mean()) / max(ref.mean(), 1e-6))
                need(err < 0.12, f"{name} {key}: mean off by {err:.3f}")
            res[key] = {"seconds": t, "diff": err}
        rec[name] = res
    return rec


ONE_GPU = [("device", phase_device), ("dense", phase_dense),
           ("kernels", phase_kernels), ("oracle", phase_oracle),
           ("bvh", phase_bvh)]
FOUR_GPU = [("device", phase_device), ("four_gpus", phase_four_gpus)]


def run(phases, ctx: dict) -> bool:
    """Run every phase, print its record; True when all passed."""
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            rec = {"phase": name, "ok": True, **fn(ctx)}
        except Exception as e:  # noqa: BLE001 -- reported; the run fails
            traceback.print_exc()
            rec = {"phase": name, "ok": False,
                   "error": f"{type(e).__name__}: {e}"}
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec, default=str), flush=True)
        ok = ok and rec["ok"]
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-GPU phase (needs 4 visible GPUs)")
    args = ap.parse_args(argv)

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX's default backend is {backend!r}, not a GPU",
              file=sys.stderr)
        return 1
    from raytracing_course_2024_tpu import enable_compile_cache

    enable_compile_cache()
    os.makedirs(OUT, exist_ok=True)
    ctx = {"w": W, "h": H, "dense_spp": DENSE_SPP, "bvh_spp": BVH_SPP,
           "kernel_rays": KERNEL_RAYS}
    ok = run(FOUR_GPU if args.four_gpus else ONE_GPU, ctx)
    for line in ctx.get("smi") or ["nvidia-smi: not read"]:
        print(f"card: {line}")
    if not ok:
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
