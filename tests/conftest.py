"""Test env: force CPU with an 8-device virtual mesh.

This is the standard way to exercise jax.sharding/shard_map code without
accelerator hardware (SURVEY.md section 4). ``jax.config.update`` after
import (before any backend use) is what forces the CPU; production runs use
the GPU, and tests marked ``gpu`` skip here (``chip_smoke.py`` runs those
checks on the card).
"""

import os

import jax

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from raytracing_course_2024_tpu.scene import SCENES_DIR as SCENES


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def scene_path(name: str) -> str:
    """Path of a scene file in SCENES_DIR; skips the calling test when the
    file is absent (the course's own scene files are not in the repo)."""
    path = os.path.join(SCENES, name)
    if not os.path.exists(path):
        pytest.skip(f"scene file {name} not available")
    return path


@pytest.fixture(scope="session")
def scenes_dir():
    if not os.path.isdir(SCENES):
        pytest.skip("scene directory not available")
    return SCENES


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (never true under this
    conftest, which forces the CPU; kept so the marked tests state what
    they need)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")
