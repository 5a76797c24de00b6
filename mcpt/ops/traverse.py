"""Stackless BVH traversal on device: vectorized skip-link walk.

The reference traverses its pointer BVH with recursion, visiting both children
unordered and shrinking ray.t2 after leaf hits so AABB tests prune
(src/BVH.cpp:90-136). Recursion does not exist under XLA; instead every ray in
the batch carries a node cursor into the flattened DFS array (ops/bvh.py) and
a single `lax.while_loop` advances all cursors together:

    hit  & inner -> cursor+1
    leaf         -> test <=LEAF_SIZE triangles (dense gather), cursor=skip
    miss         -> cursor=skip ; cursor==-1 retires the lane

The loop runs until every lane retires; divergence costs masked work, not
serialization. AABB slab test matches reference src/AABB.cpp:25-36 including
its 1.001 far-plane fudge and seeding from [t1, current-best-t).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from mcpt.ops.bvh import DEFAULT_LEAF_SIZE
from mcpt.ops.intersect import (
    DET_EPS_ANY,
    DET_EPS_CLOSEST,
    F32_MAX,
    Hit,
    T_MIN,
    _min_and_first_index,
)
from mcpt.scene import Scene
from mcpt.utils.math import cross, dot


def _slab_test(lo, hi, org, inv_d, t_lo, t_hi):
    """Reference AABB::Intersection: swap per axis, far *= 1.001, strict <."""
    ta = (lo - org) * inv_d  # [R,3]
    tb = (hi - org) * inv_d
    near = jnp.minimum(ta, tb)
    far = jnp.maximum(ta, tb) * 1.001
    tmin = jnp.maximum(t_lo, jnp.max(near, axis=-1))
    tmax = jnp.minimum(t_hi, jnp.min(far, axis=-1))
    return tmin < tmax


def _mt_leaf(v0, e1, e2, org, dirn, det_eps):
    """Moller-Trumbore with per-ray triangle sets: v0/e1/e2 [R,K,3]."""
    o = org[:, None, :]
    d = dirn[:, None, :]
    h = cross(d, e2)
    det = dot(e1, h)
    s = o - v0
    u = dot(s, h)
    q = cross(s, e1)
    v = dot(d, q)
    t = dot(e2, q)
    ok = jnp.abs(det) >= det_eps
    inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    return t * inv, u * inv, v * inv, ok


def closest_hit_bvh(scene: Scene, org, dirn, t_min=T_MIN, t_max=F32_MAX) -> Hit:
    bvh = scene.bvh
    geom = scene.geom
    R = org.shape[0]
    K = DEFAULT_LEAF_SIZE
    T = geom.v0.shape[0]

    inv_d = 1.0 / dirn
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (R,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))

    def cond(state):
        node, *_ = state
        return jnp.any(node >= 0)

    def body(state):
        node, bt, btri = state
        n = jnp.maximum(node, 0)
        lo = bvh.lo[n]  # [R,3]
        hi = bvh.hi[n]
        cnt = bvh.count[n]
        fst = bvh.first[n]
        skp = bvh.skip[n]

        live = node >= 0
        box_hit = _slab_test(lo, hi, org, inv_d, t_min, jnp.minimum(bt, t_max)) & live
        is_leaf = cnt > 0

        # --- leaf: test K triangles densely ---
        do_leaf = box_hit & is_leaf
        tri_idx = jnp.clip(
            fst[:, None] + jnp.arange(K, dtype=jnp.int32)[None, :], 0, T - 1
        )  # [R,K]
        lane_ok = (jnp.arange(K, dtype=jnp.int32)[None, :] < cnt[:, None]) & do_leaf[:, None]
        tv0 = geom.v0[tri_idx]
        te1 = geom.e1[tri_idx]
        te2 = geom.e2[tri_idx]
        t, u, v, ok = _mt_leaf(tv0, te1, te2, org, dirn, DET_EPS_CLOSEST)
        accept = (
            lane_ok
            & ok
            & (t >= t_min[:, None])
            & (t < jnp.minimum(bt, t_max)[:, None])
            & (u >= 0)
            & (v >= 0)
            & (1.0 - u - v >= 0)
        )
        t_cand = jnp.where(accept, t, F32_MAX)
        # fused min + first-min index (leaf tri ids ascend with k), no gathers
        leaf_t, leaf_tri = _min_and_first_index(t_cand, tri_idx, axis=1)
        better = leaf_t < bt
        bt = jnp.where(better, leaf_t, bt)
        btri = jnp.where(better, leaf_tri, btri)

        # --- advance cursor ---
        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, n + 1, skp)
        node = jnp.where(live, nxt, -1)
        return node, bt, btri

    init = (
        jnp.zeros((R,), jnp.int32),
        jnp.full((R,), F32_MAX),
        jnp.full((R,), -1, jnp.int32),
    )
    _, bt, btri = jax.lax.while_loop(cond, body, init)
    miss = btri < 0
    return Hit(t=jnp.where(miss, F32_MAX, bt), tri=btri)


def any_hit_bvh(scene: Scene, org, dirn, t_min=T_MIN, t_max=F32_MAX) -> jnp.ndarray:
    """Boolean occlusion walk with early lane retirement on first hit.

    Inclusive t interval and 1e-6 det epsilon, matching reference
    Triangle::isIntersect (src/Triangle.cpp:83-106) + BVH::has_hit.
    """
    bvh = scene.bvh
    geom = scene.geom
    R = org.shape[0]
    K = DEFAULT_LEAF_SIZE
    T = geom.v0.shape[0]

    inv_d = 1.0 / dirn
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (R,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))

    def cond(state):
        node, _ = state
        return jnp.any(node >= 0)

    def body(state):
        node, found = state
        n = jnp.maximum(node, 0)
        lo = bvh.lo[n]
        hi = bvh.hi[n]
        cnt = bvh.count[n]
        fst = bvh.first[n]
        skp = bvh.skip[n]

        live = node >= 0
        box_hit = _slab_test(lo, hi, org, inv_d, t_min, t_max) & live
        is_leaf = cnt > 0

        do_leaf = box_hit & is_leaf
        tri_idx = jnp.clip(
            fst[:, None] + jnp.arange(K, dtype=jnp.int32)[None, :], 0, T - 1
        )
        lane_ok = (jnp.arange(K, dtype=jnp.int32)[None, :] < cnt[:, None]) & do_leaf[:, None]
        tv0 = geom.v0[tri_idx]
        te1 = geom.e1[tri_idx]
        te2 = geom.e2[tri_idx]
        t, u, v, ok = _mt_leaf(tv0, te1, te2, org, dirn, DET_EPS_ANY)
        accept = (
            lane_ok
            & ok
            & (u >= 0)
            & (u <= 1.0)
            & (v >= 0)
            & (u + v <= 1.0)
            & (t >= t_min[:, None])
            & (t <= t_max[:, None])
        )
        found = found | jnp.any(accept, axis=1)

        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, n + 1, skp)
        node = jnp.where(live & ~found, nxt, -1)  # retire on first hit
        return node, found

    init = (jnp.zeros((R,), jnp.int32), jnp.zeros((R,), bool))
    _, found = jax.lax.while_loop(cond, body, init)
    return found
