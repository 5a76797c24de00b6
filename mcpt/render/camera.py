"""Pinhole camera ray generation, batched over the full pixel grid.

Matches reference Render::cast_Ray (src/Render.cpp:71-80): vertical fov,
basis front = normalize(lookat-eye), right = normalize(front x up), raw
(non-orthogonalized) up, per-sample sub-pixel jitter, aspect on the u axis.
Pixel index i maps to (x, y) = (i % W, i // W) like the reference pixel loop
(src/Render.cpp:61-63); row y=0 is the bottom of the saved image (the
reference flips vertically at save, src/Scene.cpp:40-45).
"""
from __future__ import annotations

import jax.numpy as jnp

from mcpt.scene import Camera
from mcpt.utils.math import PI, cross, normalize


def generate_rays(camera: Camera, jitter: jnp.ndarray, pixel_idx=None):
    """jitter: f32[R,2] in [0,1); pixel_idx: optional i32[R] (default: all pixels).

    Returns (org [R,3], dir [R,3]).
    """
    W, H = camera.width, camera.height
    if pixel_idx is None:
        pixel_idx = jnp.arange(W * H, dtype=jnp.int32)
    x = (pixel_idx % W).astype(jnp.float32)
    y = (pixel_idx // W).astype(jnp.float32)

    hfac = jnp.tan(camera.fovy * (PI / 180.0) * 0.5) * 2.0
    front = normalize(camera.lookat - camera.eye)
    right = normalize(cross(front, camera.up))

    u = ((x + jitter[:, 0]) / W - 0.5) * hfac * (W / H)
    v = ((y + jitter[:, 1]) / H - 0.5) * hfac
    d = front[None, :] + u[:, None] * right[None, :] + v[:, None] * camera.up[None, :]
    d = normalize(d)
    org = jnp.broadcast_to(camera.eye, d.shape)
    return org, d
