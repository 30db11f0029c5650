"""Single-host render orchestration.

Replaces the reference's rayon row-parallel frame loop
(src/rendering.rs:21-69) with: flatten pixels -> fixed-size ray batches ->
one jitted ``render_pixels`` program reused across batches (batch offsets are
traced arguments, so there is exactly one compile per (scene shape, spp)).

Multi-chip tiling/spp-sharding lives in ``parallel.shard``; this module is
the single-device engine it calls per shard.
"""

from __future__ import annotations

import logging
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..integrator.path import TraceConfig, render_pixels
from ..ops.camera import camera_arrays
from ..ops.tonemap import color_to_u8
from ..scene.build import build_scene_arrays
from ..scene.types import SceneDesc

log = logging.getLogger("rt")

# Lane and batch sizes: starting values carried over from the accelerator
# this program was first tuned on; they await a re-sweep on the GPU
# (ROADMAP S5).
DEFAULT_BATCH = 1_048_576  # batch engine: lanes per dispatched batch
BVH_BATCH = 262_144  # batch-ENGINE bvh renders: lanes per batch
WAVEFRONT_LANES = 16_384  # persistent-lane count of the wavefront/sticky
# engines; the treelet loop's whole-batch (B, T) round passes charge dead
# padding at large B
BVH_THRESHOLD = 2048  # finite prims above this use the BVH backend


class Renderer:
    """Compiles once per scene-shape; renders frames / tiles on demand."""

    def __init__(
        self,
        desc: SceneDesc,
        backend: str | None = None,
        batch_size: int = DEFAULT_BATCH,
        max_tries: int = 4,
        faithful: bool = False,
        engine: str | None = None,
        russian_roulette: bool | None = None,
    ):
        import os

        self.desc = desc
        self.settings = desc.settings
        arrays, statics = build_scene_arrays(desc)
        self.statics = statics
        if backend is None:
            backend = "bvh" if statics.num_prims > BVH_THRESHOLD else "dense"
        if backend == "bvh":
            from ..ops.bvh import attach_bvh

            arrays = attach_bvh(arrays, statics)
        self.arrays = jax.tree.map(jnp.asarray, arrays)
        self.backend = backend
        # engine: "batch" = fixed lane batches through the depth scan;
        # "wavefront" = persistent lanes with counter-coordinated path
        # regeneration (integrator/wavefront.py) -- the default for the BVH
        # backend, where traversal cost is batch-shaped and dead lanes are
        # pure waste; "sticky" = pixel-sticky regeneration (same module):
        # zero-coordination per-lane restarts, no cumsum/scatter refill
        # cost. RT_ENGINE overrides for A/B.
        engine = engine or os.environ.get("RT_ENGINE")
        if engine is None:
            engine = "wavefront" if backend == "bvh" else "batch"
        assert engine in ("batch", "wavefront", "sticky"), engine
        self.engine = engine
        if backend == "bvh" and batch_size == DEFAULT_BATCH:
            # engine-aware default: the lane engines run one jitted program
            # over a small persistent wavefront; the batch engine dispatches
            # one program per batch and wants them big
            batch_size = (
                WAVEFRONT_LANES if engine in ("wavefront", "sticky")
                else BVH_BATCH
            )
        self.batch_size = batch_size
        self.cam = camera_arrays(self.settings.camera)
        if russian_roulette is None:
            russian_roulette = os.environ.get("RT_RR") == "1"
        self.cfg = TraceConfig(
            ray_depth=self.settings.ray_depth,
            bg_color=tuple(self.settings.bg_color),
            max_tries=max_tries,
            backend=backend,
            faithful=faithful,
            rr=russian_roulette,
        )

        # ALL index math AND key derivation inside the jitted program, so a
        # frame is one executable and one host->device call per batch:
        # ``seed``/``batch_i`` arrive as plain host scalars.
        def _batch_body(key, offset, arrays, samples: int,
                        batch: int, replicas: int, with_stats: bool):
            # small frames underutilize the 1M-lane sweet spot: replicate
            # each pixel `replicas` times across the lane axis, give each
            # replica samples/replicas of the spp budget with a distinct
            # key, and average on device.
            w = self.settings.width
            total = self.settings.width * self.settings.height
            lin = jnp.arange(batch, dtype=jnp.int32)
            idx = jnp.minimum(lin + offset, total - 1)
            if replicas > 1:
                # replicas of a pixel sit at different lane positions, so the
                # positional threefry stream decorrelates them for free
                idx = jnp.tile(idx, replicas)
            out = render_pixels(
                key,
                idx % w,
                idx // w,
                self.cam,
                arrays,
                self.statics,
                self.cfg,
                self.settings.width,
                self.settings.height,
                samples // replicas,
                with_stats=with_stats,
            )
            nrays = jnp.float32(0)
            if with_stats:
                out, nrays = out
            if replicas > 1:  # out is channel-major (3, replicas*batch)
                out = out.reshape(3, replicas, batch).mean(axis=1)
            return out, nrays

        def _render_batch(seed, batch_i, offset, arrays, samples: int,
                          batch: int, replicas: int, with_stats: bool):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), batch_i)
            return _batch_body(
                key, offset, arrays, samples, batch, replicas, with_stats
            )

        self._render_batch = jax.jit(
            _render_batch,
            static_argnames=("samples", "batch", "replicas", "with_stats"),
        )

        def _render_chained(seed, arrays, samples: int, batch: int,
                            replicas: int, n_frames: int):
            # N whole frames serialized ON DEVICE in one dispatch: frame
            # i+1's RNG seed mixes a token derived from frame i's radiance
            # (always 0, but opaque to the compiler), so XLA can neither
            # overlap nor elide frames, and no per-dispatch host cost is
            # counted. Same per-frame program as _render_batch.
            def body(i, carry):
                acc, tok = carry
                key = jax.random.fold_in(
                    jax.random.PRNGKey(seed + tok), i
                )
                out, nrays = _batch_body(
                    key, jnp.int32(0), arrays, samples, batch, replicas, True
                )
                tok2 = (out[0, 0] * jnp.float32(0)).astype(jnp.uint32)
                return acc + nrays, tok2

            verts, _ = jax.lax.fori_loop(
                0, n_frames, body, (jnp.float32(0), jnp.uint32(0))
            )
            return verts

        self._render_chained = jax.jit(
            _render_chained,
            static_argnames=("samples", "batch", "replicas", "n_frames"),
        )

        def _render_wf(seed32, arrays, samples: int, n_pix: int, lanes: int):
            from ..integrator import wavefront as _wf

            render_wavefront = (
                _wf.render_wavefront_sticky
                if self.engine == "sticky"
                else _wf.render_wavefront
            )
            return render_wavefront(
                seed32, jnp.int32(0), jnp.int32(0), self.cam, arrays,
                self.statics, self.cfg, self.settings.width,
                self.settings.height, n_pix, samples, lanes,
            )

        self._render_wf = jax.jit(
            _render_wf, static_argnames=("samples", "n_pix", "lanes")
        )

    def _plan(self, total: int, samples: int):
        """Pick (batch, replicas): fill ~batch_size lanes, replicas | samples."""
        b = min(self.batch_size, total)
        replicas = 1
        if total < self.batch_size:
            budget = max(self.batch_size // total, 1)
            replicas = 1
            for c in range(min(budget, samples), 0, -1):
                if samples % c == 0:
                    replicas = c
                    break
        return b, replicas

    def render_frame_device(
        self, seed: int = 0, samples: int | None = None, progress: bool = False
    ):
        """Render the frame, leaving radiance ON DEVICE.

        Returns (device_outs, path_vertices): ``device_outs`` is a list of
        per-batch (3, B) channel-major device arrays (one entry for the
        wavefront engine). The path-vertex count is a host float, so the
        call SYNCS on render completion -- wall-clock around this method
        measures pure render throughput. The frame fetch is separate
        (``render_radiance``).
        """
        w, h = self.settings.width, self.settings.height
        samples = samples or self.settings.samples
        total = w * h

        if self.engine in ("wavefront", "sticky"):
            seed32 = np.uint32((seed * 2654435761) & 0xFFFFFFFF)
            lanes = min(self.batch_size, total * samples)
            img_flat, nverts = self._render_wf(
                seed32, self.arrays, samples, total, lanes
            )  # (3, n_pix) channel-major
            return [img_flat], float(nverts)

        b, replicas = self._plan(total, samples)
        num_batches = -(-total // b)
        outs = []
        nrays_total = 0.0
        for i in range(num_batches):
            out, nrays = self._render_batch(
                np.uint32(seed & 0xFFFFFFFF),
                np.int32(i),
                np.int32(i * b),
                self.arrays,
                samples,
                b,
                replicas,
                True,
            )
            outs.append(out)
            nrays_total += float(nrays)
            if progress:
                log.info("render progress: %d/%d batches", i + 1, num_batches)
        return outs, nrays_total

    def render_frames_chained(
        self, n_frames: int, seed: int = 0, samples: int | None = None
    ) -> float:
        """Render ``n_frames`` whole frames serialized in ONE dispatch.

        Returns the total path-vertex count (host float -- syncs on
        completion, so wall-clock around this call divided by ``n_frames``
        is the pure per-frame device time with no per-dispatch host cost).
        Batch engine with single-batch frames only: that is exactly the
        sub-0.1 s dense-family regime where dispatch latency dominates
        (the big-mesh wavefront frames run for seconds and don't need it).
        """
        w, h = self.settings.width, self.settings.height
        samples = samples or self.settings.samples
        total = w * h
        if self.engine != "batch":
            raise ValueError("chained frames are batch-engine only")
        b, replicas = self._plan(total, samples)
        if -(-total // b) != 1:
            raise ValueError("chained frames require a single-batch frame")
        verts = self._render_chained(
            np.uint32(seed & 0xFFFFFFFF), self.arrays, samples, b,
            replicas, n_frames,
        )
        return float(verts)

    def render_radiance(
        self,
        seed: int = 0,
        samples: int | None = None,
        progress: bool = False,
        with_stats: bool = False,
    ):
        """Full-frame mean radiance, (H, W, 3) f32 numpy.

        ``progress`` logs per-batch completion (the reference's indicatif
        bar analog, src/rendering.rs:46). ``with_stats`` additionally
        returns a RenderStats with exact path-vertex counts.
        """
        import time

        w, h = self.settings.width, self.settings.height
        samples = samples or self.settings.samples
        total = w * h

        t0 = time.perf_counter()
        outs, nrays_total = self.render_frame_device(seed, samples, progress)
        if len(outs) == 1:
            flat = np.asarray(outs[0])
        else:
            flat = np.concatenate([np.asarray(o) for o in outs], axis=1)
        img = np.ascontiguousarray(flat[:, :total].T).reshape(h, w, 3)
        if with_stats:
            from .profiling import RenderStats

            stats = RenderStats(
                width=w,
                height=h,
                samples=samples,
                ray_depth=self.settings.ray_depth,
                wall_seconds=time.perf_counter() - t0,
                path_vertices=nrays_total,
                primary_rays=total * samples,
            )
            return img, stats
        return img

    def render_u8(self, seed: int = 0, samples: int | None = None) -> np.ndarray:
        """Tonemapped (H, W, 3) u8 frame.

        Tonemap runs ON DEVICE and the fetch is u8, 4x smaller than the f32
        radiance. The reference's timed region ends at the u8 image buffer
        too (src/rendering.rs:21-69 + 228-262)."""
        w, h = self.settings.width, self.settings.height
        total = w * h
        outs, _ = self.render_frame_device(seed, samples)
        if not hasattr(self, "_tonemap_u8"):
            self._tonemap_u8 = jax.jit(color_to_u8)
        u8s = [np.asarray(self._tonemap_u8(o)) for o in outs]
        flat = u8s[0] if len(u8s) == 1 else np.concatenate(u8s, axis=1)
        return np.ascontiguousarray(flat[:, :total].T).reshape(h, w, 3)


def render_scene(desc: SceneDesc, seed: int = 0, **kw) -> np.ndarray:
    """One-shot render (reference ``render_scene``, src/rendering.rs:21).

    With more than one accelerator attached, the frame is rendered SPMD
    over a (tile x spp) mesh (parallel/shard.py); single-chip otherwise.
    """
    if jax.device_count() > 1:
        return _render_scene_sharded(desc, seed, **kw)
    r = Renderer(desc, **kw)
    t0 = time.perf_counter()
    img = r.render_u8(seed)
    dt = time.perf_counter() - t0
    s = desc.settings
    rays = s.width * s.height * s.samples
    log.info(
        "rendered %dx%d @ %d spp depth %d in %.2fs (%.1f Mprimary-rays/s)",
        s.width,
        s.height,
        s.samples,
        s.ray_depth,
        dt,
        rays / dt / 1e6,
    )
    return img


class ShardedRenderer:
    """Multi-chip frame renderer: rows over 'tile', samples over 'spp'.

    Mesh factoring (when ``mesh`` is not given): put up to 2 devices on the
    spp axis when samples allow (pmean merge over NVLink), the rest on
    disjoint row tiles. Estimator options (backend/max_tries/engine) mean
    the same thing as in ``Renderer``. Duck-type compatible with
    ``runtime.checkpoint.render_with_checkpoints`` (``.settings`` +
    ``.render_radiance(seed, samples)``), so long multi-chip contract
    frames (1024 spp, BASELINE.json:11) checkpoint/resume exactly like
    single-chip ones -- the chunk seeds are folded the same way, and the
    wavefront RNG is keyed by global (pixel, sample) so resumed chunks
    reproduce bit-for-bit on any mesh factoring.
    """

    def __init__(
        self,
        desc: SceneDesc,
        mesh=None,
        backend: str | None = None,
        max_tries: int = 4,
        engine: str | None = None,
    ):
        import os

        from ..ops.camera import camera_arrays
        from ..parallel import make_mesh
        from ..scene.build import build_scene_arrays

        self.desc = desc
        self.settings = s = desc.settings
        if mesh is None:
            ndev = jax.device_count()
            n_spp = 2 if ndev % 2 == 0 and s.samples % 2 == 0 else 1
            mesh = make_mesh(ndev // n_spp, n_spp)
        self.mesh = mesh

        arrays, statics = build_scene_arrays(desc)
        if backend is None:
            backend = "bvh" if statics.num_prims > BVH_THRESHOLD else "dense"
        engine = engine or os.environ.get("RT_ENGINE")
        if engine is None:
            engine = "wavefront" if backend == "bvh" else "batch"
        if backend == "bvh":
            from ..ops.bvh import attach_bvh

            arrays = attach_bvh(arrays, statics)
        self.arrays = jax.tree.map(jnp.asarray, arrays)
        self.statics = statics
        self.backend = backend
        self.engine = engine
        self.cam = camera_arrays(s.camera)
        self.cfg = TraceConfig(
            ray_depth=s.ray_depth, bg_color=tuple(s.bg_color),
            max_tries=max_tries, backend=backend,
        )

    def render_radiance(
        self, seed: int = 0, samples: int | None = None
    ) -> np.ndarray:
        """Full-frame mean radiance, (H, W, 3) f32 numpy, SPMD."""
        from ..parallel import render_frame_sharded

        s = self.settings
        samples = samples or s.samples
        rad = render_frame_sharded(
            jax.random.PRNGKey(seed), self.arrays, self.statics, self.cam,
            self.cfg, s.width, s.height, samples, self.mesh,
            engine=self.engine,
        )  # channel-major (3, H, W); transpose host-side after the fetch
        return np.ascontiguousarray(np.moveaxis(np.asarray(rad), 0, -1))

    def render_u8(self, seed: int = 0, samples: int | None = None) -> np.ndarray:
        from ..ops.tonemap import color_to_u8

        rad = self.render_radiance(seed, samples)
        return np.asarray(color_to_u8(jnp.asarray(rad)))


def _render_scene_sharded(
    desc: SceneDesc,
    seed: int = 0,
    batch_size: int | None = None,
    **kw,
) -> np.ndarray:
    """One-shot multi-chip frame render (see ShardedRenderer).

    ``batch_size`` does not apply (each device renders its whole tile in
    one program) and is rejected so a caller's intent is never dropped.
    """
    if batch_size is not None:
        raise ValueError(
            "batch_size is single-device-only; the sharded renderer runs one "
            "program per tile"
        )
    r = ShardedRenderer(desc, **kw)
    s = desc.settings
    t0 = time.perf_counter()
    img = r.render_u8(seed)
    log.info(
        "sharded render (%s): %dx%d @ %d spp in %.2fs",
        dict(r.mesh.shape), s.width, s.height, s.samples,
        time.perf_counter() - t0,
    )
    return img
