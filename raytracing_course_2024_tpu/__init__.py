"""Monte-Carlo path tracer in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
metametamoon/raytracing-course-2024 (a Rust CPU path tracer): text + glTF
scene ingestion, SAH BVH, one-sample-MIS path tracing with glTF
metallic-roughness BRDF and GGX-VNDF sampling, ACES output -- built for an
accelerator (SoA scenes, lane-major ray batches, lax.scan bounce loop,
shard_map multi-device tiling) rather than ported.
"""

__version__ = "0.1.0"

import os as _os

# fixed in-checkout location of the persistent compilation cache; the path
# is part of the cache key, so it must not move between runs
DEFAULT_COMPILE_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here. Otherwise the cache goes to
    ``DEFAULT_COMPILE_CACHE``. Entry points (the CLI, ``bench.py``,
    ``chip_smoke.py``) call this before their first compile."""
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    return DEFAULT_COMPILE_CACHE


from . import scene  # noqa: E402,F401
