"""Shading-local orthonormal basis, batched.

Matches reference `coordiantetransform` (src/BSDF.h:9-27): w = n,
a = (0,1,0) if |w.x| > 0.9 else (1,0,0), v = normalize(w x a), u = w x v.
Local z is the shading normal.
"""
from __future__ import annotations

import jax.numpy as jnp

from mcpt.utils.math import cross, normalize


def make_onb(n: jnp.ndarray):
    """n: f32[...,3] unit normals -> (u, v, w) each f32[...,3]."""
    w = n
    a = jnp.where(
        (jnp.abs(w[..., 0:1]) > 0.9),
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), w.shape),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), w.shape),
    )
    v = normalize(cross(w, a))
    u = cross(w, v)
    return u, v, w


def to_local(onb, t: jnp.ndarray) -> jnp.ndarray:
    u, v, w = onb
    return jnp.stack(
        [
            jnp.sum(t * u, axis=-1),
            jnp.sum(t * v, axis=-1),
            jnp.sum(t * w, axis=-1),
        ],
        axis=-1,
    )


def to_world(onb, a: jnp.ndarray) -> jnp.ndarray:
    u, v, w = onb
    return a[..., 0:1] * u + a[..., 1:2] * v + a[..., 2:3] * w
