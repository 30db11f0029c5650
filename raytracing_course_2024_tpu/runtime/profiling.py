"""Tracing / profiling helpers.

The reference's only perf tooling is a wall-clock print around render_scene
(src/main.rs:54-58) and an indicatif progress bar (src/rendering.rs:46).
Here (SURVEY.md section 5): a jax.profiler trace context for device timelines,
and a RenderStats record computed from the instrumented integrator (exact
path-vertex counts, the Mrays/s unit of the benchmark).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time


@dataclasses.dataclass
class RenderStats:
    width: int
    height: int
    samples: int
    ray_depth: int
    wall_seconds: float
    path_vertices: float  # exact count from the instrumented bounce loop
    primary_rays: int

    @property
    def mrays_per_sec(self) -> float:
        return self.path_vertices / self.wall_seconds / 1e6

    @property
    def avg_path_length(self) -> float:
        return self.path_vertices / max(self.primary_rays, 1)

    def __str__(self) -> str:
        return (
            f"{self.width}x{self.height} @ {self.samples} spp depth "
            f"{self.ray_depth}: {self.wall_seconds:.2f}s, "
            f"{self.path_vertices / 1e6:.1f}M path vertices "
            f"({self.mrays_per_sec:.1f} Mrays/s, avg depth "
            f"{self.avg_path_length:.2f})"
        )


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (TensorBoard/XProf format) around a
    render. Usage: ``with device_trace('/tmp/trace'): renderer.render_u8()``."""
    import jax

    with jax.profiler.trace(log_dir):
        yield


@contextlib.contextmanager
def wall_timer():
    """Yields a callable returning elapsed seconds."""
    t0 = time.perf_counter()
    yield lambda: time.perf_counter() - t0
