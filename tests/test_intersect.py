"""Intersection kernels vs a numpy oracle (reference Triangle.cpp:48-106)."""
import jax.numpy as jnp
import numpy as np
import pytest

from mcpt.ops.intersect import (
    any_hit_bruteforce,
    closest_hit_bruteforce,
)


def _np_moller_trumbore(v0, e1, e2, o, d, det_eps, t_min, t_max, closed_max):
    """Oracle: per-(ray, tri) closest hit in float64."""
    R, T = o.shape[0], v0.shape[0]
    best_t = np.full(R, np.inf)
    best_tri = np.full(R, -1, np.int64)
    best_uv = np.zeros((R, 2))
    for r in range(R):
        for k in range(T):
            h = np.cross(d[r], e2[k])
            det = e1[k] @ h
            if abs(det) < det_eps:
                continue
            s = o[r] - v0[k]
            u = (s @ h) / det
            q = np.cross(s, e1[k])
            v = (d[r] @ q) / det
            t = (e2[k] @ q) / det
            ok_t = (t >= t_min) and (t <= t_max if closed_max else t < t_max)
            if ok_t and u >= 0 and v >= 0 and (1 - u - v) >= 0 and t < best_t[r]:
                best_t[r] = t
                best_tri[r] = k
                best_uv[r] = (u, v)
    return best_t, best_tri, best_uv


def _random_tri_scene(rng, T):
    from mcpt.scene import Geometry, Materials, Scene, TextureAtlas, Camera

    v = rng.uniform(-1, 1, (T, 3, 3))
    v0 = v[:, 0]
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    geom = Geometry(
        v0=jnp.asarray(v0, jnp.float32),
        e1=jnp.asarray(e1, jnp.float32),
        e2=jnp.asarray(e2, jnp.float32),
        vn=jnp.zeros((T, 3, 3)),
        uv=jnp.zeros((T, 3, 2)),
        mat_id=jnp.zeros((T,), jnp.int32),
        area=jnp.asarray(0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1), jnp.float32),
    )
    scene = Scene(
        geom=geom,
        mats=Materials(
            kd=jnp.ones((1, 3)) * 0.5,
            ks=jnp.zeros((1, 3)),
            ns=jnp.ones((1,)),
            radiance=jnp.zeros((1, 3)),
            tex_id=-jnp.ones((1,), jnp.int32),
            tr=jnp.zeros((1, 3)),
            ni=jnp.ones((1,)),
        ),
        atlas=TextureAtlas(data=jnp.zeros((1, 1, 1, 3)), size=jnp.ones((1, 2), jnp.int32)),
        light_tris=jnp.zeros((0,), jnp.int32),
        camera=Camera(
            eye=jnp.zeros(3), lookat=jnp.array([0.0, 0, 1]), up=jnp.array([0.0, 1, 0]),
            fovy=jnp.asarray(45.0),
        ),
        scale=2.0,
    )
    return scene, v0, e1, e2


@pytest.mark.parametrize("T", [7, 600])  # below and above the chunk size? use small chunk
def test_closest_hit_matches_oracle(rng, T):
    scene, v0, e1, e2 = _random_tri_scene(rng, T)
    R = 64
    o = rng.uniform(-2, 2, (R, 3))
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    hit = closest_hit_bruteforce(
        scene, jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
        t_min=1e-4, chunk=256,
    )
    ot, otri, ouv = _np_moller_trumbore(
        v0, e1, e2, o, d, det_eps=1e-5, t_min=1e-4, t_max=np.inf, closed_max=False
    )
    got_tri = np.asarray(hit.tri)
    # f32 vs f64 can flip ties / grazing hits; demand >95% exact agreement
    agree = got_tri == otri
    assert agree.mean() > 0.95
    np.testing.assert_allclose(
        np.asarray(hit.t)[agree & (otri >= 0)], ot[agree & (otri >= 0)], rtol=1e-3
    )


def test_any_hit_matches_oracle(rng):
    scene, v0, e1, e2 = _random_tri_scene(rng, 40)
    R = 128
    o = rng.uniform(-2, 2, (R, 3))
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = 1.5

    got = np.asarray(
        any_hit_bruteforce(
            scene, jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
            t_min=1e-4, t_max=t_max,
        )
    )
    ot, otri, _ = _np_moller_trumbore(
        v0, e1, e2, o, d, det_eps=1e-6, t_min=1e-4, t_max=t_max, closed_max=True
    )
    want = otri >= 0
    assert (got == want).mean() > 0.97  # grazing-ray f32 flips allowed


def test_t_interval_semantics(rng):
    """closest-hit uses [t_min, t_max) and any-hit [t_min, t_max]."""
    scene, *_ = _random_tri_scene(rng, 1)
    # single triangle at known location: z=0 plane triangle
    import jax.numpy as jnp
    from mcpt.scene import Geometry
    import dataclasses

    geom = Geometry(
        v0=jnp.asarray([[-1.0, -1.0, 0.0]]),
        e1=jnp.asarray([[2.0, 0.0, 0.0]]),
        e2=jnp.asarray([[0.0, 2.0, 0.0]]),
        vn=jnp.zeros((1, 3, 3)),
        uv=jnp.zeros((1, 3, 2)),
        mat_id=jnp.zeros((1,), jnp.int32),
        area=jnp.asarray([2.0]),
    )
    scene = dataclasses.replace(scene, geom=geom)
    o = jnp.asarray([[0.0, 0.0, -1.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    # hit at t=1 exactly
    assert closest_hit_bruteforce(scene, o, d, t_min=1e-4, t_max=2.0).tri[0] == 0
    assert closest_hit_bruteforce(scene, o, d, t_min=1e-4, t_max=1.0).tri[0] == -1  # open
    assert bool(any_hit_bruteforce(scene, o, d, t_min=1e-4, t_max=1.0)[0])  # closed
    assert not bool(any_hit_bruteforce(scene, o, d, t_min=1e-4, t_max=0.5)[0])
    assert closest_hit_bruteforce(scene, o, d, t_min=1.5, t_max=3.0).tri[0] == -1


def test_degenerate_triangle_rejected(rng):
    scene, *_ = _random_tri_scene(rng, 1)
    import dataclasses
    from mcpt.scene import Geometry

    geom = Geometry(  # zero-area triangle
        v0=jnp.asarray([[0.0, 0.0, 0.0]]),
        e1=jnp.asarray([[1.0, 0.0, 0.0]]),
        e2=jnp.asarray([[2.0, 0.0, 0.0]]),
        vn=jnp.zeros((1, 3, 3)),
        uv=jnp.zeros((1, 3, 2)),
        mat_id=jnp.zeros((1,), jnp.int32),
        area=jnp.asarray([0.0]),
    )
    scene = dataclasses.replace(scene, geom=geom)
    o = jnp.asarray([[0.0, 0.0, -1.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    assert closest_hit_bruteforce(scene, o, d).tri[0] == -1
    assert not bool(any_hit_bruteforce(scene, o, d)[0])


def _soup_scene(v0, e1, e2):
    """Scene from explicit triangle arrays (f32 storage — the f64 escape
    hatch promotes at trace time; these coords are exactly representable)."""
    import numpy as _np

    rng = _np.random.default_rng(0)
    scene, *_ = _random_tri_scene(rng, v0.shape[0])
    import dataclasses as dc

    geom = dc.replace(
        scene.geom,
        v0=jnp.asarray(v0, jnp.float32),
        e1=jnp.asarray(e1, jnp.float32),
        e2=jnp.asarray(e2, jnp.float32),
    )
    return dc.replace(scene, geom=geom)


def test_f64_geometry_escape_hatch():
    """MCPT_F64_GEOM parity item (reference traces geometry in double,
    src/utils.h:5-18): rays grazing a far-from-origin triangle edge by
    offsets below f32 resolution are classified correctly by the f64
    predicate (vs a numpy f64 oracle), while f32 provably cannot
    distinguish them."""
    import jax

    jax.config.update("jax_enable_x64", True)
    try:
        import dataclasses as dc

        import jax.numpy as jnp

        from mcpt.ops.intersect import closest_hit_bruteforce

        # triangle at large coordinates: f32 ulp there is ~1e-3
        base = 1.0e4
        v0 = np.array([[base, base, 0.0]])
        e1 = np.array([[1.0, 0.0, 0.0]])
        e2 = np.array([[0.0, 1.0, 0.0]])
        scene = _soup_scene(v0, e1, e2)

        # rays straight down onto points straddling the u=0 edge by +-1e-5
        eps = 1e-5
        xs = np.array([base + 0.5, base + 0.5])
        ys = np.array([base + eps, base - eps])  # inside, outside
        org = jnp.asarray(
            np.stack([xs, ys, np.ones(2)], axis=1), jnp.float64
        )
        d = jnp.asarray(np.tile([0.0, 0.0, -1.0], (2, 1)), jnp.float64)

        hit = closest_hit_bruteforce(scene, org, d, f64=True)
        tri = np.asarray(hit.tri)
        assert tri[0] == 0, "inside-edge ray must hit in f64"
        assert tri[1] == -1, "outside-edge ray must miss in f64"
        # f32 cannot represent the +-1e-5 offset at coordinate 1e4 at all:
        # both origins collapse to the same f32 value
        o32 = np.asarray(org, np.float32)
        assert o32[0, 1] == o32[1, 1], "offsets must be sub-f32-ulp"
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("case", ["ties", "all_miss", "random"])
def test_min_and_first_index_is_one_consistent_reduction(rng, case):
    """The returned index always names a candidate whose t is the returned
    minimum (the first such on ties), and a ray with no candidate gets
    F32_MAX and no in-range index."""
    from mcpt.ops.intersect import F32_MAX, _min_and_first_index

    R, C = 64, 37
    if case == "ties":
        t = rng.integers(0, 3, (R, C)).astype(np.float32)
    elif case == "all_miss":
        t = np.full((R, C), F32_MAX, np.float32)
    else:
        t = np.where(rng.uniform(size=(R, C)) < 0.7, F32_MAX,
                     rng.uniform(0, 10, (R, C))).astype(np.float32)
    base = 100 + np.arange(C, dtype=np.int32)[None, :]
    bt, idx = _min_and_first_index(jnp.asarray(t), jnp.asarray(base), axis=1)
    bt, idx = np.asarray(bt), np.asarray(idx)
    np.testing.assert_array_equal(bt, t.min(axis=1))
    np.testing.assert_array_equal(idx, 100 + t.argmin(axis=1))
