"""BVH build + traversal: structural checks and equivalence with brute force."""
import jax.numpy as jnp
import numpy as np
import pytest

from mcpt.ops.bvh import _build_bvh_numpy, validate_bvh
from mcpt.ops.intersect import any_hit_bruteforce, closest_hit_bruteforce
from mcpt.ops.traverse import any_hit_bvh, closest_hit_bvh


def _tri_bounds(v0, e1, e2):
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    return (
        np.minimum(np.minimum(p0, p1), p2),
        np.maximum(np.maximum(p0, p1), p2),
    )


def test_bvh_structure_random(rng):
    T = 300
    v = rng.uniform(-5, 5, (T, 3, 3))
    v0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    nodes, perm = _build_bvh_numpy(v0, e1, e2, leaf_size=4)
    lo, hi = _tri_bounds(v0, e1, e2)
    validate_bvh(nodes, perm, lo, hi)
    assert sorted(perm.tolist()) == list(range(T))


def test_bvh_structure_cornell(cornell_scene_bvh):
    bvh = cornell_scene_bvh.bvh
    assert bvh is not None
    count = np.asarray(bvh.count)
    assert (count <= 4).all()
    assert count.sum() == cornell_scene_bvh.num_tris


def _rand_rays(rng, n, center, spread):
    o = rng.uniform(-1, 1, (n, 3)) * spread + center
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


@pytest.mark.parametrize("scene_fix", ["cornell_scene_bvh", "veach_scene"])
def test_traversal_equals_bruteforce(request, rng, scene_fix):
    scene = request.getfixturevalue(scene_fix)
    center = np.asarray(scene.geom.v0).mean(axis=0)
    spread = scene.scale * 0.5
    o, d = _rand_rays(rng, 1500, center, spread)

    hb = closest_hit_bruteforce(scene, o, d)
    hv = closest_hit_bvh(scene, o, d)
    assert (np.asarray(hb.tri) == np.asarray(hv.tri)).mean() > 0.999
    same = np.asarray(hb.tri) == np.asarray(hv.tri)
    hit = np.asarray(hb.tri) >= 0
    np.testing.assert_allclose(
        np.asarray(hb.t)[same & hit], np.asarray(hv.t)[same & hit], rtol=1e-4
    )

    t_max = scene.scale * 0.3
    ab = any_hit_bruteforce(scene, o, d, t_max=t_max)
    av = any_hit_bvh(scene, o, d, t_max=t_max)
    assert (np.asarray(ab) == np.asarray(av)).mean() > 0.999


def test_bvh_single_triangle():
    v0 = np.array([[0.0, 0.0, 0.0]])
    e1 = np.array([[1.0, 0.0, 0.0]])
    e2 = np.array([[0.0, 1.0, 0.0]])
    nodes, perm = _build_bvh_numpy(v0, e1, e2, leaf_size=4)
    assert nodes["lo"].shape[0] == 1
    assert nodes["count"][0] == 1
    assert nodes["skip"][0] == -1


def test_bvh_identical_centroids():
    # 16 coincident triangles: midpoint split degenerates -> median fallback
    v0 = np.zeros((16, 3))
    e1 = np.tile(np.array([[1.0, 0, 0]]), (16, 1))
    e2 = np.tile(np.array([[0.0, 1, 0]]), (16, 1))
    nodes, perm = _build_bvh_numpy(v0, e1, e2, leaf_size=4)
    assert nodes["count"].sum() == 16
