"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Multi-device sharding is validated without GPUs via
--xla_force_host_platform_device_count (the standard JAX CI pattern,
SURVEY §4). This must run before the first `import jax` anywhere.

Tests marked `gpu` need a card. They run with MCPT_TEST_GPU=1, which keeps
JAX's default backend:

    MCPT_TEST_GPU=1 python -m pytest tests/ -m gpu -q

Everywhere else they skip (the `gpu_device` fixture decides, at run time).
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if os.environ.get("MCPT_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

from mcpt.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def cornell_scene():
    from mcpt.io.obj import load_scene

    return load_scene(
        os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell-box.obj"),
        with_bvh=False,
    )


@pytest.fixture(scope="session")
def cornell_scene_bvh():
    from mcpt.io.obj import load_scene

    return load_scene(
        os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell-box.obj"),
        with_bvh=True,
    )


@pytest.fixture(scope="session")
def veach_scene():
    from mcpt.io.obj import load_scene

    return load_scene(
        os.path.join(os.path.dirname(__file__), "..", "scenes", "veach-mis.obj"),
        with_bvh=True,
    )


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU, or a skip when this run has none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run with MCPT_TEST_GPU=1 on a card)")
    return devs[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
