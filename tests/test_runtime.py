"""Runtime subsystems: checkpoint/resume, stats, image IO round trips."""

import numpy as np
import pytest

from raytracing_course_2024_tpu.runtime.checkpoint import render_with_checkpoints
from raytracing_course_2024_tpu.runtime.image_io import read_ppm, write_ppm
from raytracing_course_2024_tpu.runtime.render import Renderer
from raytracing_course_2024_tpu.scene import parse_text_scene

SCENE = """
DIMENSIONS 24 16
RAY_DEPTH 3
SAMPLES 16
BG_COLOR 0.1 0.2 0.3
CAMERA_POSITION 0 1 4
CAMERA_RIGHT 1 0 0
CAMERA_UP 0 1 0
CAMERA_FORWARD 0 0 -1
CAMERA_FOV_X 1.2

NEW_PRIMITIVE
PLANE 0 1 0
COLOR 0.7 0.6 0.5

NEW_PRIMITIVE
BOX 0.4 0.4 0.4
POSITION 0 0.4 0
EMISSION 3 3 3
"""


def test_checkpoint_resume_bitexact(tmp_path):
    desc = parse_text_scene(SCENE)
    r = Renderer(desc)
    ck = str(tmp_path / "state.npz")

    full = render_with_checkpoints(r, ck, total_spp=16, chunk_spp=4, seed=3)

    # simulate an interruption: rebuild the checkpoint halfway, then resume
    ck2 = str(tmp_path / "state2.npz")
    import raytracing_course_2024_tpu.runtime.checkpoint as C

    orig = C.Renderer.render_radiance
    calls = {"n": 0}

    class Boom(RuntimeError):
        pass

    def interrupting(self, *a, **k):
        if calls["n"] == 2:
            raise Boom()
        calls["n"] += 1
        return orig(self, *a, **k)

    C.Renderer.render_radiance = interrupting
    try:
        try:
            render_with_checkpoints(r, ck2, total_spp=16, chunk_spp=4, seed=3)
            raise AssertionError("expected interruption")
        except Boom:
            pass
    finally:
        C.Renderer.render_radiance = orig

    resumed = render_with_checkpoints(r, ck2, total_spp=16, chunk_spp=4, seed=3)
    assert np.allclose(resumed, full, atol=1e-6), np.abs(resumed - full).max()


def test_checkpoint_rejects_cross_scene_resume(tmp_path):
    """Resuming one scene's checkpoint against another scene of the same
    resolution/seed must fail loudly, not silently blend the two renders
    (VERDICT r4 weak #6)."""
    import pytest

    desc = parse_text_scene(SCENE)
    r = Renderer(desc)
    ck = str(tmp_path / "state.npz")
    render_with_checkpoints(r, ck, total_spp=8, chunk_spp=4, seed=3)

    other = parse_text_scene(SCENE.replace("COLOR 0.7 0.6 0.5", "COLOR 0.2 0.6 0.5"))
    r2 = Renderer(other)
    with pytest.raises(ValueError, match="different"):
        render_with_checkpoints(r2, ck, total_spp=8, chunk_spp=4, seed=3)

    # same scene, same config: resume remains valid (no-op completion)
    out = render_with_checkpoints(r, ck, total_spp=8, chunk_spp=4, seed=3)
    assert np.isfinite(out).all()


def test_stats(tmp_path):
    desc = parse_text_scene(SCENE)
    r = Renderer(desc)
    img, stats = r.render_radiance(seed=0, with_stats=True)
    assert img.shape == (16, 24, 3)
    assert stats.primary_rays == 24 * 16 * 16
    assert stats.path_vertices >= stats.primary_rays  # at least 1 vertex each
    assert stats.avg_path_length <= desc.settings.ray_depth
    assert stats.mrays_per_sec > 0
    assert "Mrays/s" in str(stats)


def test_chained_frames_match_dispatched():
    # bench.py's device-chained accounting (VERDICT r3 next #4): one
    # chained frame is the SAME program+stream as one dispatched batch
    # (the chain token is 0, fold_in index 0 == batch_i 0), so the vertex
    # counts must agree exactly; N frames accumulate ~N single-frame
    # counts (different fold_in streams, same scene -> within a few %).
    desc = parse_text_scene(SCENE)
    r = Renderer(desc)
    _, n1 = r.render_frame_device(seed=7, samples=16)
    v1 = r.render_frames_chained(1, seed=7, samples=16)
    assert v1 == n1, (v1, n1)
    v3 = r.render_frames_chained(3, seed=7, samples=16)
    assert 2.5 * v1 <= v3 <= 3.5 * v1, (v1, v3)


def test_ppm_roundtrip(tmp_path, rng):
    img = rng.integers(0, 255, (7, 9, 3), dtype=np.uint8)
    path = str(tmp_path / "x.ppm")
    write_ppm(path, img)
    back = read_ppm(path)
    assert np.array_equal(img, back)


def test_png_roundtrip_matches_ppm(tmp_path, rng):
    """The stdlib PNG writer's pixels read back equal to the PPM's."""
    from raytracing_course_2024_tpu.runtime.image_io import read_png, write_png

    img = rng.integers(0, 255, (7, 9, 3), dtype=np.uint8)
    write_ppm(str(tmp_path / "x.ppm"), img)
    write_png(str(tmp_path / "x.png"), img)
    assert np.array_equal(read_png(str(tmp_path / "x.png")),
                          read_ppm(str(tmp_path / "x.ppm")))


@pytest.mark.parametrize("env_dir", [True, False], ids=["env", "default"])
def test_compile_cache_placement(tmp_path, monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX; otherwise the
    cache goes to the fixed in-checkout directory."""
    import os

    import jax

    import raytracing_course_2024_tpu as rt

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert rt.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = rt.enable_compile_cache()
            repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert path == os.path.join(repo, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
