"""Math utilities for the path tracer.

Batched replacements for the reference's glm-based helpers
(reference: src/utils.h). Everything is f32, batched, and branchless.
"""
from __future__ import annotations

import jax.numpy as jnp

# Matches the reference's float PI literal (src/utils.h:20).
PI = 3.14159265358979323846
INV_PI = 1.0 / PI


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis, keepdims=False."""
    return jnp.sum(a * b, axis=-1)


def dot3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over trailing axis, keepdims=True (for broadcasting)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 3D cross product over the trailing axis."""
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Normalize over the trailing axis. With eps=0 this matches glm::normalize
    (inf/nan on zero vectors); pass a small eps for guarded normalization."""
    n2 = jnp.sum(a * a, axis=-1, keepdims=True)
    return a / jnp.sqrt(n2 + eps)


def luminance(c: jnp.ndarray) -> jnp.ndarray:
    """Rec.709 luminance, matching reference BSDF.cpp:167-170."""
    return c[..., 0] * 0.212671 + c[..., 1] * 0.715160 + c[..., 2] * 0.072169


def power_heuristic(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """MIS power heuristic beta=2, matching reference src/utils.h:56-60.

    The reference computes p1^2/(p1^2+p2^2) with no guards; at f32 a
    degenerate pdf can reach inf (inf/inf = NaN) and NaNs poison gradients
    even on masked lanes (0-cotangent x inf-partial). Inputs are clipped to
    +-1e16 (squares stay < f32 max) and 0/0 maps to 0 — both only affect
    samples whose weighted contribution is already ~0 or ~1.
    """
    p1 = jnp.clip(p1, -1e16, 1e16)
    p2 = jnp.clip(p2, -1e16, 1e16)
    a = p1 * p1
    denom = a + p2 * p2
    return jnp.where(denom > 0, a / jnp.where(denom > 0, denom, 1.0), 0.0)


def max_component(c: jnp.ndarray) -> jnp.ndarray:
    return jnp.max(c, axis=-1)
