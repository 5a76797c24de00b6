"""Counter-based per-ray RNG on raw threefry2x32.

The reference uses one function-static mt19937 mutated concurrently by every
OpenMP thread — a real data race (src/utils.h:23-28 + src/Render.cpp:60,
SURVEY §5). Here every random number is a pure function of
(seed, sample_index, pixel_id, stream_tag, slot):

    word(r, tag, j) = threefry2x32(key, (r, tag*8 + j))

evaluated as ONE fused cipher call over the whole ray batch per stream —
no per-ray key objects, no vmap, no state. Consequences:

  * deterministic and reproducible for a fixed seed — images are
    bit-identical run to run;
  * batch-invariant: a pixel's samples do not depend on how the ray batch
    is chunked, tiled, or sharded, so multi-device renders equal
    single-device renders bitwise (tests/test_parallel.py).

Stream tags: 0 = camera jitter, b+1 = bounce b (up to 8 slots each).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.extend as jex
import jax.numpy as jnp

MAX_SLOTS = 8  # uniforms per (ray, tag) stream
MAX_TAGS = 64  # streams per (ray, sample): tag 0 = camera jitter, b+1 = bounce b


@dataclass(frozen=True)
class RayRng:
    """Per-batch RNG context: cipher key + global ray ids."""

    key_data: jnp.ndarray  # uint32[2]
    ray_id: jnp.ndarray  # uint32[R]


jax.tree_util.register_dataclass(RayRng, data_fields=["key_data", "ray_id"], meta_fields=[])


def _raw_key(key) -> jnp.ndarray:
    """Accept legacy uint32[2] keys and new-style typed keys."""
    if hasattr(key, "dtype") and jnp.issubdtype(key.dtype, jnp.integer):
        return key.astype(jnp.uint32)
    return jax.random.key_data(key).astype(jnp.uint32)


def per_ray_keys(key, ray_id: jnp.ndarray) -> RayRng:
    """Build the counter-based context for a ray batch (global pixel ids)."""
    return RayRng(key_data=_raw_key(key), ray_id=ray_id.astype(jnp.uint32))


def ray_uniforms(ctx: RayRng, tag, n: int) -> jnp.ndarray:
    """[R, n] uniforms in [0,1) for stream `tag` of each ray (n <= 8).

    One threefry2x32 call: counters are (ray_id, tag*8+slot) pairs, so every
    word is a pure function of the logical sample identity.
    """
    assert n <= MAX_SLOTS
    R = ctx.ray_id.shape[0]
    npairs = (n + 1) // 2
    lo = jnp.asarray(tag, jnp.uint32) * MAX_SLOTS + jnp.arange(npairs, dtype=jnp.uint32)
    hi = jnp.broadcast_to(ctx.ray_id[:, None], (R, npairs))
    lo = jnp.broadcast_to(lo[None, :], (R, npairs))
    counts = jnp.concatenate([hi.ravel(), lo.ravel()])
    out = jex.random.threefry_2x32(ctx.key_data, counts)
    w0 = out[: R * npairs].reshape(R, npairs)
    w1 = out[R * npairs :].reshape(R, npairs)
    words = jnp.concatenate([w0, w1], axis=1)[:, :n]
    # 24-bit mantissa -> [0, 1)
    return (words >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def sample_uniforms(key, pixel_id: jnp.ndarray, sid, tag, n: int) -> jnp.ndarray:
    """[R, n] uniforms keyed by (seed, pixel, GLOBAL sample id, tag).

    The wavefront-regeneration integrator's stream: unlike ray_uniforms
    (sample id folded into the cipher key on the host), the sample id lives
    in the counter, so every lane can sit at a different (sample, bounce)
    without leaving the jitted program:

        word = threefry2x32(key, (pixel, (sid*MAX_TAGS + tag)*MAX_SLOTS + slot))

    `sid` and `tag` may be scalars or [R] vectors. Streams are unique while
    sid*MAX_TAGS + tag < 2^29 (sid < ~8.4M samples at 64 tags) — far beyond
    any render. Same determinism/batch-invariance guarantees as ray_uniforms.
    """
    assert n <= MAX_SLOTS
    kd = _raw_key(key)
    pixel_id = pixel_id.astype(jnp.uint32)
    R = pixel_id.shape[0]
    base = (
        jnp.asarray(sid, jnp.uint32) * jnp.uint32(MAX_TAGS) + jnp.asarray(tag, jnp.uint32)
    ) * jnp.uint32(MAX_SLOTS)
    npairs = (n + 1) // 2
    slot = jnp.arange(npairs, dtype=jnp.uint32)
    lo = jnp.broadcast_to(base.reshape(-1, 1), (R, 1)) + slot[None, :]
    hi = jnp.broadcast_to(pixel_id[:, None], (R, npairs))
    counts = jnp.concatenate([hi.ravel(), lo.ravel()])
    out = jex.random.threefry_2x32(kd, counts)
    w0 = out[: R * npairs].reshape(R, npairs)
    w1 = out[R * npairs :].reshape(R, npairs)
    words = jnp.concatenate([w0, w1], axis=1)[:, :n]
    return (words >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))
