"""Intersection dispatch and wavefront policy: no Pallas anywhere, the BVH
walk for large scenes, the fused loop unless the split loop is asked for."""
import glob
import os
import sys

import numpy as np

import jax.numpy as jnp

from mcpt.ops import intersect
from tests.test_walk import _rays, _soup_scene

PKG = os.path.join(os.path.dirname(__file__), "..", "mcpt")


def test_no_module_uses_pallas(cornell_scene):
    """No source file of the package names Pallas, and rendering imports
    none of it."""
    for path in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        with open(path) as f:
            assert "pallas" not in f.read().lower(), path
    from mcpt.render.renderer import RenderConfig, Renderer

    Renderer(cornell_scene, RenderConfig(max_bounces=2, width=8, height=8)).step()
    assert not [m for m in sys.modules if "pallas" in m]


def test_large_bvh_scene_dispatches_to_walk():
    """Past BRUTE_FORCE_MAX_TRIS with a BVH: closest_hit / any_hit are the
    walk; without a BVH the dense wave serves the same scene."""
    import dataclasses

    from mcpt.ops.traverse import any_hit_bvh, closest_hit_bvh

    rng = np.random.default_rng(5)
    scene = _soup_scene(rng, intersect.BRUTE_FORCE_MAX_TRIS + 904)
    assert intersect.uses_bvh_walk(scene)
    assert not intersect.uses_bvh_walk(dataclasses.replace(scene, bvh=None))
    o, d = _rays(rng, 64)
    got, ref = intersect.closest_hit(scene, o, d), closest_hit_bvh(scene, o, d)
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(ref.tri))
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))
    t_max = jnp.full((64,), 4.0)
    np.testing.assert_array_equal(
        np.asarray(intersect.any_hit(scene, o, d, t_max=t_max)),
        np.asarray(any_hit_bvh(scene, o, d, t_max=t_max)))


def test_large_scene_keeps_the_fused_loop(monkeypatch):
    """Scenes served by the walk run the one-program wavefront loop with
    the default chunk; the split loop is opt-in for every scene."""
    from mcpt.render.integrator import (
        DEFAULT_CHUNK_RAYS,
        chunk_rays_for,
        wavefront_mode,
    )

    monkeypatch.delenv("MCPT_WAVEFRONT", raising=False)
    monkeypatch.delenv("MCPT_CHUNK_LANES", raising=False)
    scene = _soup_scene(np.random.default_rng(6),
                        intersect.BRUTE_FORCE_MAX_TRIS + 1)
    assert intersect.uses_bvh_walk(scene)
    assert wavefront_mode(scene) == "loop"
    assert chunk_rays_for(scene) == DEFAULT_CHUNK_RAYS
