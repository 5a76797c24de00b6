"""The skip-link BVH walk (ops/traverse.py) vs brute force on random soups.

The walk serves every scene past ops/intersect.BRUTE_FORCE_MAX_TRIS. It
runs the same Moller-Trumbore algebra on the same triangles, and ties
resolve the same way (leaves are laid out in DFS order, so the walk meets
triangles in index order), so hits agree exactly apart from f32 rounding
differences between two compilations of the same expression.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from mcpt.ops.bvh import attach_bvh
from mcpt.ops.intersect import any_hit_bruteforce, closest_hit_bruteforce
from mcpt.ops.traverse import any_hit_bvh, closest_hit_bvh
from mcpt.scene import Camera, Geometry, Materials, Scene, TextureAtlas


def _soup_scene(rng, T, spread=5.0, tri_size=0.8):
    v0 = rng.uniform(-spread, spread, (T, 3))
    e1 = rng.normal(size=(T, 3)) * tri_size
    e2 = rng.normal(size=(T, 3)) * tri_size
    scene = Scene(
        geom=Geometry(
            v0=v0.astype(np.float32), e1=e1.astype(np.float32),
            e2=e2.astype(np.float32), vn=np.zeros((T, 3, 3), np.float32),
            uv=np.zeros((T, 3, 2), np.float32),
            mat_id=np.zeros((T,), np.int32), area=np.ones((T,), np.float32),
        ),
        mats=Materials(
            kd=np.ones((1, 3), np.float32), ks=np.zeros((1, 3), np.float32),
            ns=np.ones((1,), np.float32), radiance=np.zeros((1, 3), np.float32),
            tex_id=np.full((1,), -1, np.int32), tr=np.zeros((1, 3), np.float32),
            ni=np.ones((1,), np.float32),
        ),
        atlas=TextureAtlas(data=np.zeros((1, 1, 1, 3), np.float32),
                           size=np.ones((1, 2), np.int32)),
        light_tris=np.zeros((0,), np.int32),
        camera=Camera(eye=np.zeros(3, np.float32),
                      lookat=np.ones(3, np.float32),
                      up=np.array([0.0, 1.0, 0.0], np.float32),
                      fovy=np.asarray(40.0, np.float32)),
    )
    return attach_bvh(scene)


def _rays(rng, R, spread=6.0):
    o = rng.uniform(-spread, spread, (R, 3))
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


SOUPS = [120, 400, 5000]


@pytest.mark.parametrize("T", SOUPS)
def test_walk_closest_matches_bruteforce(T):
    rng = np.random.default_rng(T)
    scene = _soup_scene(rng, T)
    o, d = _rays(rng, 256)
    ref = closest_hit_bruteforce(scene, o, d)
    got = closest_hit_bvh(scene, o, d)
    ri, gi = np.asarray(ref.tri), np.asarray(got.tri)
    assert (ri >= 0).sum() > 20, "too few hits to mean anything"
    assert (ri == gi).mean() >= 0.995, (ri != gi).sum()
    both = (ri == gi) & (ri >= 0)
    np.testing.assert_allclose(np.asarray(got.t)[both],
                               np.asarray(ref.t)[both], rtol=1e-6)


@pytest.mark.parametrize("T", SOUPS)
def test_walk_any_matches_bruteforce(T):
    rng = np.random.default_rng(7 * T)
    scene = _soup_scene(rng, T)
    o, d = _rays(rng, 256)
    t_max = jnp.asarray(rng.uniform(0.5, 8.0, 256), jnp.float32)
    ref = np.asarray(any_hit_bruteforce(scene, o, d, t_max=t_max))
    got = np.asarray(any_hit_bvh(scene, o, d, t_max=t_max))
    assert 0 < ref.sum() < ref.size
    assert (ref == got).mean() >= 0.995, (ref != got).sum()


def test_walk_respects_t_bounds():
    """closest hit: [t_min, t_max) per ray; any hit: [t_min, t_max]."""
    rng = np.random.default_rng(9)
    scene = _soup_scene(rng, 400)
    o, d = _rays(rng, 128)
    full = closest_hit_bvh(scene, o, d)
    t = np.asarray(full.t)
    hit = np.asarray(full.tri) >= 0
    # cut every ray exactly at its hit: the open upper bound excludes it
    t_max = jnp.asarray(np.where(hit, t, 3.0), jnp.float32)
    cut = closest_hit_bvh(scene, o, d, t_max=t_max)
    assert not (np.asarray(cut.tri)[hit] == np.asarray(full.tri)[hit]).any()
    # per-ray bounds away from the hits: the walk and brute force agree
    t_rand = jnp.asarray(rng.uniform(0.5, 8.0, 128), jnp.float32)
    a = closest_hit_bvh(scene, o, d, t_max=t_rand)
    b = closest_hit_bruteforce(scene, o, d, t_max=t_rand)
    assert (np.asarray(a.tri) == np.asarray(b.tri)).mean() >= 0.99
    # start every ray past its hit: t_min excludes it as well
    t_min = jnp.asarray(np.where(hit, t * 1.0001, 1e-4), jnp.float32)
    late = closest_hit_bvh(scene, o, d, t_min=t_min)
    assert (np.asarray(late.t)[hit & (np.asarray(late.tri) >= 0)] > t[hit & (
        np.asarray(late.tri) >= 0)]).all()
    # any hit is closed at t_max: the closest hit itself still occludes
    occ = np.asarray(any_hit_bvh(scene, o, d, t_max=t_max))
    assert occ[hit].mean() >= 0.99


def test_walk_ragged_ray_count():
    """Ray counts that are not a power of two or a chunk multiple."""
    rng = np.random.default_rng(11)
    scene = _soup_scene(rng, 400)
    for R in (1, 45, 333):
        o, d = _rays(rng, R)
        ref = closest_hit_bruteforce(scene, o, d)
        got = closest_hit_bvh(scene, o, d)
        assert got.tri.shape == (R,) and got.t.shape == (R,)
        assert (np.asarray(ref.tri) == np.asarray(got.tri)).mean() >= 0.99
        assert any_hit_bvh(scene, o, d).shape == (R,)
