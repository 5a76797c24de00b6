"""Batched ray-triangle intersection (Moller-Trumbore).

The reference tests one ray against one triangle at a time behind virtual
calls (src/Triangle.cpp:48-106); here rays are a flat [R] batch and triangles
an SoA block, so each step is a [R, C] elementwise wave with a running-min
reduction — no recursion, no branches.

Epsilon parity with the reference:
  * closest-hit: |det| < 1e-5 rejects (Triangle.cpp:54), accept
    t in [t_min, t_max) with u>=0, v>=0, 1-u-v>=0 (Triangle.cpp:66)
  * any-hit: |det| < 1e-6 rejects (Triangle.cpp:85), accept t in
    [t_min, t_max] with u in [0,1], v>=0, u+v<=1 (Triangle.cpp:94-103)
  * default ray interval t1=1e-4, t2=inf (Render.h:30)
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from mcpt.scene import Geometry, Scene
from mcpt.utils.math import cross, dot

T_MIN = 1e-4  # reference Ray::t1 (src/Render.h:30)
F32_MAX = jnp.finfo(jnp.float32).max
DET_EPS_CLOSEST = 1e-5
DET_EPS_ANY = 1e-6

# Brute-force triangle chunk: one [R, CHUNK] wave per scan step.
DEFAULT_CHUNK = 512


@dataclass(frozen=True)
class Hit:
    """Closest-hit record for a ray batch. tri == -1 means miss.

    Only (t, tri) are carried: barycentrics are recomputed at shading time
    from the gathered triangle row (integrator.expand_hit), which keeps the
    [R, C] candidate wave a pure min-reduction with no per-ray selection.
    """

    t: jnp.ndarray  # f32[R]
    tri: jnp.ndarray  # i32[R]

    @property
    def valid(self) -> jnp.ndarray:
        return self.tri >= 0


jax.tree_util.register_dataclass(
    Hit, data_fields=["t", "tri"], meta_fields=[]
)

_IDX_BIG = jnp.int32(2**30)


def _pick_first_min(a, b):
    (ta, ia), (tb, ib) = a, b
    take_b = (tb < ta) | ((tb == ta) & (ib < ia))
    return jnp.where(take_b, tb, ta), jnp.where(take_b, ib, ia)


def _min_and_first_index(t_cand: jnp.ndarray, base_idx: jnp.ndarray, axis: int):
    """(min t, index of the first minimum) in ONE variadic reduction.

    `base_idx` broadcasts against t_cand and gives each candidate its
    global triangle id. The index always belongs to the returned t. Two
    separate reductions (min, then the first index whose t equals it) do
    not guarantee that: each may evaluate t_cand in its own fusion, rounded
    differently (FMA contraction), and on the GPU some rays then came back
    with a hit t and no index (2**30, out of range of every table).
    The returned t carries no gradient (the reduction has no JVP rule, and
    hit selection is discrete: integrator.expand_hit re-derives the hit
    geometry, attached, from the triangle row).
    """
    idx = jnp.broadcast_to(base_idx, t_cand.shape).astype(jnp.int32)
    return jax.lax.reduce(
        (jax.lax.stop_gradient(t_cand), idx), (jnp.asarray(F32_MAX, t_cand.dtype), _IDX_BIG),
        _pick_first_min, (axis,))


def _mt_candidates(v0, e1, e2, org, dirn, det_eps, f64: bool = False):
    """Moller-Trumbore for rays [R,3] x tris [C,3] -> t,u,v,det each [R,C].

    Broadcast layout: rays on axis 0, triangles on axis 1. `f64=True`
    evaluates the WHOLE predicate in double precision (the reference
    traces geometry in double, src/utils.h:5-18) — the escape hatch for
    scenes where f32 slab/MT rounding flips a grazing accept. Requires
    jax_enable_x64; only the dense `mt` dispatch offers it
    (MCPT_F64_GEOM=1), as a verification path, not a fast path.
    """
    if f64:
        import jax

        if not jax.config.jax_enable_x64:
            raise RuntimeError(
                "f64 geometry requested but jax_enable_x64 is off; set "
                "JAX_ENABLE_X64=1 (or jax.config.update) first"
            )
        v0, e1, e2 = (x.astype(jnp.float64) for x in (v0, e1, e2))
        org, dirn = org.astype(jnp.float64), dirn.astype(jnp.float64)
    o = org[:, None, :]  # [R,1,3]
    d = dirn[:, None, :]
    tv0 = v0[None, :, :]  # [1,C,3]
    te1 = e1[None, :, :]
    te2 = e2[None, :, :]

    h = cross(d, te2)  # [R,C,3]
    det = dot(te1, h)  # [R,C]
    s = o - tv0
    u = dot(s, h)
    q = cross(s, te1)
    v = dot(d, q)
    t = dot(te2, q)
    inv = jnp.where(jnp.abs(det) < det_eps, 0.0, 1.0 / det)
    return t * inv, u * inv, v * inv, jnp.abs(det) >= det_eps


def _closest_over_block(v0, e1, e2, tri_base, org, dirn, t_min, t_max,
                        tri_valid=None, f64: bool = False):
    """Closest hit of each ray against one triangle block.

    Returns per-ray (t, global_tri_index_or_-1); t = +inf on miss.
    `t_max` is the *exclusive* upper bound per ray ([R] or scalar).
    Fully fused: min-reductions only, no dynamic gathers (see Hit).
    """
    t, u, v, ok = _mt_candidates(v0, e1, e2, org, dirn, DET_EPS_CLOSEST,
                                 f64=f64)
    tm = jnp.asarray(t_min)
    tM = jnp.asarray(t_max)
    if tM.ndim == 1:
        tM = tM[:, None]
    if tm.ndim == 1:
        tm = tm[:, None]
    accept = ok & (t >= tm) & (t < tM) & (u >= 0) & (v >= 0) & (1.0 - u - v >= 0)
    if tri_valid is not None:
        accept = accept & tri_valid[None, :]
    t_cand = jnp.where(accept, t, F32_MAX)
    C = t_cand.shape[1]
    base = tri_base + jnp.arange(C, dtype=jnp.int32)[None, :]
    best_t, idx = _min_and_first_index(t_cand, base, axis=1)
    return (best_t.astype(jnp.float32),
            jnp.where(best_t < F32_MAX, idx, -1))


def _any_over_block(v0, e1, e2, org, dirn, t_min, t_max, tri_valid=None,
                    f64: bool = False):
    """Boolean any-hit of each ray against a block ([R] bool).

    Inclusive t interval, matching reference Triangle::isIntersect.
    """
    t, u, v, ok = _mt_candidates(v0, e1, e2, org, dirn, DET_EPS_ANY, f64=f64)
    tm = jnp.asarray(t_min)
    tM = jnp.asarray(t_max)
    if tM.ndim == 1:
        tM = tM[:, None]
    if tm.ndim == 1:
        tm = tm[:, None]
    accept = (
        ok
        & (u >= 0) & (u <= 1.0)
        & (v >= 0) & (u + v <= 1.0)
        & (t >= tm) & (t <= tM)
    )
    if tri_valid is not None:
        accept = accept & tri_valid[None, :]
    return jnp.any(accept, axis=1)


def _pad_tris(geom: Geometry, chunk: int):
    """Pad triangle arrays to a multiple of `chunk`; returns arrays + valid mask."""
    T = geom.v0.shape[0]
    Tp = max(chunk, ((T + chunk - 1) // chunk) * chunk)
    pad = Tp - T
    v0 = jnp.pad(geom.v0, ((0, pad), (0, 0)))
    e1 = jnp.pad(geom.e1, ((0, pad), (0, 0)))
    e2 = jnp.pad(geom.e2, ((0, pad), (0, 0)))
    valid = jnp.arange(Tp) < T
    return v0, e1, e2, valid, Tp


def closest_hit_bruteforce(
    scene: Scene, org, dirn, t_min=T_MIN, t_max=F32_MAX,
    chunk: int = DEFAULT_CHUNK, f64: bool = False,
) -> Hit:
    """Intersect-all closest hit, tiled over triangle chunks with lax.scan.

    Serves small scenes (cornell/veach class): no divergence, one fused
    elementwise wave per chunk. `f64=True` evaluates the accept predicate
    in double (see _mt_candidates).
    """
    geom = scene.geom
    T = geom.v0.shape[0]
    if T <= chunk:
        t, tri = _closest_over_block(
            geom.v0, geom.e1, geom.e2, 0, org, dirn, t_min, t_max, f64=f64
        )
        return Hit(t=t, tri=tri)

    v0, e1, e2, valid, Tp = _pad_tris(geom, chunk)
    n_chunks = Tp // chunk
    v0c = v0.reshape(n_chunks, chunk, 3)
    e1c = e1.reshape(n_chunks, chunk, 3)
    e2c = e2.reshape(n_chunks, chunk, 3)
    validc = valid.reshape(n_chunks, chunk)

    R = org.shape[0]
    init = (
        jnp.full((R,), F32_MAX),
        jnp.full((R,), -1, jnp.int32),
    )

    def body(carry, xs):
        bt, btri = carry
        cv0, ce1, ce2, cvalid, base = xs
        t, tri = _closest_over_block(
            cv0, ce1, ce2, base, org, dirn, t_min, t_max, tri_valid=cvalid,
            f64=f64,
        )
        better = t < bt
        return (
            jnp.where(better, t, bt),
            jnp.where(better, tri, btri),
        ), None

    bases = (jnp.arange(n_chunks) * chunk).astype(jnp.int32)
    (bt, btri), _ = jax.lax.scan(body, init, (v0c, e1c, e2c, validc, bases))
    return Hit(t=bt, tri=btri)


def any_hit_bruteforce(
    scene: Scene, org, dirn, t_min=T_MIN, t_max=F32_MAX,
    chunk: int = DEFAULT_CHUNK, f64: bool = False,
) -> jnp.ndarray:
    """Boolean occlusion test (shadow rays), tiled like closest_hit."""
    geom = scene.geom
    T = geom.v0.shape[0]
    if T <= chunk:
        return _any_over_block(geom.v0, geom.e1, geom.e2, org, dirn,
                               t_min, t_max, f64=f64)

    v0, e1, e2, valid, Tp = _pad_tris(geom, chunk)
    n_chunks = Tp // chunk
    v0c = v0.reshape(n_chunks, chunk, 3)
    e1c = e1.reshape(n_chunks, chunk, 3)
    e2c = e2.reshape(n_chunks, chunk, 3)
    validc = valid.reshape(n_chunks, chunk)

    def body(carry, xs):
        cv0, ce1, ce2, cvalid = xs
        hit = _any_over_block(cv0, ce1, ce2, org, dirn, t_min, t_max,
                              tri_valid=cvalid, f64=f64)
        return carry | hit, None

    init = jnp.zeros((org.shape[0],), bool)
    out, _ = jax.lax.scan(body, init, (v0c, e1c, e2c, validc))
    return out


# Above this triangle count a scene with a BVH attached is served by the
# skip-link walk (ops/traverse.py) instead of the dense intersect-all wave,
# whose cost is linear in T. Inherited from the first implementation; the
# crossover has not been measured on the GPU yet.
BRUTE_FORCE_MAX_TRIS = 4096


def uses_bvh_walk(scene) -> bool:
    """Static: does dispatch send this scene through the BVH walk?"""
    return scene.num_tris > BRUTE_FORCE_MAX_TRIS and scene.bvh is not None


def closest_hit(scene: Scene, org, dirn, t_min=T_MIN, t_max=F32_MAX) -> Hit:
    """Dispatch: the skip-link BVH walk for scenes past BRUTE_FORCE_MAX_TRIS
    (the reference builds a BVH for every scene, src/Render.cpp:9), the
    dense intersect-all wave below it."""
    sg = jax.lax.stop_gradient
    if uses_bvh_walk(scene):
        from mcpt.ops.traverse import closest_hit_bvh

        # hit SELECTION is discrete — detaching the ray loses no gradient
        # (the integrator re-derives t/u/v attached via expand_hit), and
        # lax.while_loop has no reverse-mode rule
        return closest_hit_bvh(scene, sg(org), sg(dirn), t_min, sg(t_max))
    # MCPT_F64_GEOM=1: reference-parity escape hatch, geometry in double
    # (src/utils.h:5-18). Dense scenes only; requires jax x64.
    f64 = os.environ.get("MCPT_F64_GEOM") == "1"
    return closest_hit_bruteforce(scene, org, dirn, t_min, t_max, f64=f64)


def any_hit(scene: Scene, org, dirn, t_min=T_MIN, t_max=F32_MAX) -> jnp.ndarray:
    sg = jax.lax.stop_gradient
    if uses_bvh_walk(scene):
        from mcpt.ops.traverse import any_hit_bvh

        # boolean output: detaching inputs builds no backward graph
        return any_hit_bvh(scene, sg(org), sg(dirn), t_min, sg(t_max))
    f64 = os.environ.get("MCPT_F64_GEOM") == "1"
    return any_hit_bruteforce(scene, org, dirn, t_min, t_max, f64=f64)
