"""Golden regression renders -- per-pixel.

The Rust reference can't be executed in this environment (no cargo), so the
goldens are pinned PER-PIXEL radiance arrays of OUR renders at a fixed seed
on the CPU backend (tests/goldens.npz, written by tests/regen_goldens.py).
Any unintended change to parsing, sampling, shading, or traversal shifts
pixels far beyond the tolerance; spatial errors that preserve channel means
(flips, tile swaps, transposes -- the round-1 means-only blind spot) are
caught by the per-pixel and per-tile comparisons. Physical correctness is
covered separately (oracle pdf tests, closed-form integrator checks).

Regenerate (and commit in the same change) whenever the sample stream
changes: `python tests/regen_goldens.py`.
"""

import os

import numpy as np
import pytest

from conftest import scene_path
from raytracing_course_2024_tpu.runtime.render import Renderer
from raytracing_course_2024_tpu.scene import load_scene

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(HERE, "goldens.npz")

from regen_goldens import CONFIGS  # single source of truth for the set


def golden_compare(got: np.ndarray, want: np.ndarray):
    """Raise AssertionError unless ``got`` reproduces ``want``.

    Same platform + seed reproduces near-bitwise; the slack absorbs
    cross-jax-version numeric drift, including isolated pixels whose sample
    path flips at a float compare (those can differ by O(1), so a small
    outlier budget exists -- but only for scattered pixels, never structure).
    """
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    d = np.abs(got - want)
    assert d.mean() < 3e-3, f"mean|diff|={d.mean():.5f}"
    assert (d > 0.05).mean() < 0.01, f"outliers={(d > 0.05).mean():.4%}"
    # per-tile means: a flip/swap/transpose moves energy between tiles
    h, w, _ = want.shape
    th, tw = h // 4, w // 4
    for i in range(4):
        for j in range(4):
            sl = np.s_[i * th : (i + 1) * th, j * tw : (j + 1) * tw]
            gm, wm = got[sl].mean(), want[sl].mean()
            assert abs(gm - wm) < 0.01 + 0.02 * abs(wm), (i, j, gm, wm)


@pytest.fixture(scope="module")
def goldens():
    if not os.path.exists(GOLDENS):
        pytest.skip("tests/goldens.npz missing -- run tests/regen_goldens.py")
    return np.load(GOLDENS)


@pytest.mark.parametrize("cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_golden_pixels(scenes_dir, goldens, cfg):
    name, (w, h), spp = cfg
    key = f"{name}|{w}x{h}|{spp}"
    desc = load_scene(scene_path(name), w, h, spp)
    rad = np.asarray(Renderer(desc).render_radiance(seed=0))
    golden_compare(rad, goldens[key])


def test_golden_catches_spatial_errors(goldens):
    """The comparator must reject mean-preserving spatial corruption --
    the exact blind spot of the retired channel-means golden test."""
    img = goldens["practice7_1.gltf|64x36|8"]
    for corrupted in (img[::-1], img[:, ::-1], np.roll(img, 18, axis=0)):
        with pytest.raises(AssertionError):
            golden_compare(np.ascontiguousarray(corrupted), img)


@pytest.mark.slow
def test_backend_agreement(scenes_dir):
    """Dense and treelet backends must agree within MC noise on the same
    scene (different estimators would indicate a traversal bug)."""
    desc = load_scene(scene_path("cornell_box.gltf"), 48, 27, 32)
    # identical sampling order + identical hit results => identical images;
    # engine pinned to "batch" because the wavefront engine keys its RNG by
    # work item (a different stream); its own backend-agreement test lives
    # in test_wavefront.py
    dense = Renderer(desc, backend="dense").render_radiance(seed=0)
    bvh = Renderer(desc, backend="bvh", engine="batch").render_radiance(seed=0)
    assert np.allclose(dense, bvh, rtol=1e-3, atol=1e-3), (
        np.abs(dense - bvh).max()
    )
    # same pairing through the wavefront engine (shared stream there too)
    wf_dense = Renderer(desc, backend="dense", engine="wavefront").render_radiance(seed=0)
    wf_bvh = Renderer(desc, backend="bvh", engine="wavefront").render_radiance(seed=0)
    assert np.allclose(wf_dense, wf_bvh, rtol=1e-3, atol=1e-3), (
        np.abs(wf_dense - wf_bvh).max()
    )
