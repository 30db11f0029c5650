"""Multi-chip rendering: shard_map over a (tile, spp) device mesh.

The reference's only parallelism is a rayon work-stealing loop over image
rows on one CPU (src/rendering.rs:43-47). The multi-device equivalents
(SURVEY.md section 2.3):

* **tile sharding** (data-parallel analog): image rows are split across the
  'tile' mesh axis; work is disjoint, results concatenate -- zero
  collectives, scales until rows < devices.
* **spp sharding** (gradient-psum analog): every device renders the *same*
  pixels with a device-decorrelated sample stream (threefry fold_in of the
  'spp' axis index) and radiance is averaged with ``jax.lax.pmean`` (an
  NCCL all-reduce over NVLink between the GPUs of one host) -- the direct
  analog of data-parallel gradient all-reduce. Used for
  the 1024-spp multi-chip benchmark configs (BASELINE.json:11).

Both compose in one ``shard_map`` over a 2D mesh; scene arrays and camera
are replicated (a 144k-triangle scene is ~20 MB -- trivial per-device
memory). Every GPU of a host reaches every other at the same NVLink rate,
so the mesh shape follows the algorithm (tiles x spp), not a topology.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..integrator.path import TraceConfig, render_pixels
from ..ops.camera import CameraArrays
from ..scene.types import SceneArrays, SceneStatics


def make_mesh(n_tiles: int, n_spp: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    need = n_tiles * n_spp
    assert len(devices) >= need, f"need {need} devices, have {len(devices)}"
    arr = np.asarray(devices[:need]).reshape(n_tiles, n_spp)
    return Mesh(arr, ("tile", "spp"))


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Multi-HOST orchestration: ``jax.distributed.initialize`` wiring.

    The reference's only parallel runtime is an in-process rayon pool
    (src/rendering.rs:43-47); the JAX equivalent of going beyond one host
    is a multi-controller JAX job where every host runs this same program
    and ``jax.devices()`` becomes the GLOBAL device list (SURVEY.md
    section 2.3/5). Call this once before any jax computation; arguments
    default to the standard JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID environment, so launchers only set env vars.

    Returns True when a multi-process runtime was initialized, False for
    the (common) single-process case. ``make_multihost_mesh`` then lays
    the tile axis across processes so each host renders its own row bands
    and the spp axis stays intra-host (pmean over NVLink, not the network).
    """
    import os

    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "0") or 0)
    if not addr or nproc <= 1:
        return False
    pid = (
        process_id
        if process_id is not None
        else int(os.environ.get("JAX_PROCESS_ID", "0"))
    )
    jax.distributed.initialize(
        coordinator_address=addr, num_processes=nproc, process_id=pid
    )
    return True


def make_multihost_mesh(n_tiles: int, n_spp: int, devices=None) -> Mesh:
    """Mesh for a multi-process runtime: the tile axis spans processes
    (disjoint row bands per host -- the network only carries the final
    gather) and the spp axis stays within a process (pmean rides NVLink).

    Works unchanged in a single process (== make_mesh); unit-tested by
    faking the process layout (tests/test_sharding.py), real multi-host
    validation deferred until hardware with >1 host exists."""
    devices = devices if devices is not None else jax.devices()
    need = n_tiles * n_spp
    assert len(devices) >= need, f"need {need} devices, have {len(devices)}"
    # order devices so consecutive tile rows sit on the same process:
    # sort by (process_index, device id) and lay out tile-major
    devs = sorted(devices, key=lambda d: (d.process_index, d.id))[:need]
    arr = np.asarray(devs).reshape(n_tiles, n_spp)
    # the intra-host guarantee is load-bearing: if n_spp does not divide the
    # per-process device count, a tile row spans two processes and the spp
    # pmean would ride the network -- fail loudly instead of silently
    # degrading
    for r in range(n_tiles):
        procs = {d.process_index for d in arr[r]}
        if len(procs) > 1:
            raise ValueError(
                f"tile row {r} spans processes {sorted(procs)}: n_spp={n_spp} "
                "must divide each process's device count so spp-pmean stays "
                "intra-host (NVLink); pick n_spp | devices-per-process"
            )
    return Mesh(arr, ("tile", "spp"))


WAVEFRONT_LANE_CAP = 262_144  # matches runtime.render.BVH_BATCH


def render_frame_sharded(
    key: jax.Array,
    arrays: SceneArrays,
    statics: SceneStatics,
    cam: CameraArrays,
    cfg: TraceConfig,
    width: int,
    height: int,
    samples: int,
    mesh: Mesh,
    engine: str = "batch",
) -> jnp.ndarray:
    """Full-frame mean radiance, CHANNEL-MAJOR (3, height, width), SPMD.

    Channel-major like integrator/path.py render_pixels; hosts transpose
    after np.asarray.

    ``height`` need not divide the tile count: rows are padded up to a
    multiple of n_tiles for the iteration only, each padded row re-renders
    the last real row (py clamped -- the camera NDC mapping always sees the
    TRUE image height), and the pad is cropped before returning.

    ``engine="wavefront"`` runs the regeneration wavefront
    (integrator/wavefront.py) per shard. Its RNG is keyed by GLOBAL
    (pixel, sample), so the sharded frame equals the single-device frame
    up to fp accumulation order regardless of the mesh factoring.
    """
    n_tiles = mesh.shape["tile"]
    n_spp = mesh.shape["spp"]
    assert samples % n_spp == 0, (samples, n_spp)
    rows_per = -(-height // n_tiles)  # ceil: pad rows, never the camera
    spp_per = samples // n_spp

    if engine in ("wavefront", "sticky"):
        from ..integrator import wavefront as _wf

        render_wavefront = (
            _wf.render_wavefront_sticky
            if engine == "sticky"
            else _wf.render_wavefront
        )
        n_pix = rows_per * width
        lanes = min(WAVEFRONT_LANE_CAP, n_pix * spp_per)

        def shard_fn_wf(key):
            ti = jax.lax.axis_index("tile")
            si = jax.lax.axis_index("spp")
            # both offsets varying over BOTH mesh axes so every while-loop
            # carry in the engine has one consistent varying type
            pix_base = jax.lax.pcast(ti * n_pix, ("spp",), to="varying")
            samp_base = jax.lax.pcast(si * spp_per, ("tile",), to="varying")
            kd = jax.random.key_data(key).astype(jnp.uint32)
            seed32 = jax.lax.pcast(
                kd[0] ^ (kd[1] * jnp.uint32(2654435761)),
                ("tile", "spp"),
                to="varying",
            )
            img, _ = render_wavefront(
                seed32, pix_base, samp_base, cam, arrays, statics, cfg,
                width, height, n_pix, spp_per, lanes,
            )
            img = jax.lax.pmean(img, axis_name="spp")  # (3, n_pix)
            return img.reshape(3, rows_per, width)

        fn = jax.shard_map(
            shard_fn_wf,
            mesh=mesh,
            in_specs=P(),
            out_specs=P(None, "tile", None),
            check_vma=True,
        )
        return fn(key)[:, :height]

    def shard_fn(key):
        ti = jax.lax.axis_index("tile")
        si = jax.lax.axis_index("spp")
        # decorrelate the sample stream per mesh coordinate
        k = jax.random.fold_in(jax.random.fold_in(key, ti), 977 + si)
        row0 = ti * rows_per
        lin = jnp.arange(rows_per * width, dtype=jnp.int32)
        # mark pixel coords as device-varying so every scan/while carry in
        # the integrator has a consistent varying type (jax >= 0.9 shard_map)
        px = jax.lax.pcast(lin % width, ("tile", "spp"), to="varying")
        py = jnp.minimum(row0 + lin // width, height - 1)  # varies over tile
        py = jax.lax.pcast(py, ("spp",), to="varying")
        rad = render_pixels(
            k, px, py, cam, arrays, statics, cfg, width, height, spp_per
        )  # (3, rows_per*width), mean over local spp
        rad = jax.lax.pmean(rad, axis_name="spp")
        return rad.reshape(3, rows_per, width)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P(),
        out_specs=P(None, "tile", None),
        check_vma=True,
    )
    return fn(key)[:, :height]


def compile_sharded_renderer(
    arrays, statics, cam, cfg, width, height, samples, mesh
):
    """jit-wrapped sharded frame renderer; scene arrays are closed over and
    replicated on every device."""
    rep = NamedSharding(mesh, P())
    arrays = jax.device_put(arrays, rep)

    @partial(jax.jit, static_argnums=())
    def run(key):
        return render_frame_sharded(
            key, arrays, statics, cam, cfg, width, height, samples, mesh
        )

    return run
