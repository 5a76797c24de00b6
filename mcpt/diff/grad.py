"""Differentiable rendering: d(pixels)/d(materials, emission, vertices).

The estimator in render/integrator.py wraps every *sampling decision*
(uniform draws, lobe picks, sampled directions, RR outcomes) in
stop_gradient, so jax.grad of a render is the *detached-random* gradient:
the random numbers are frozen, every smooth quantity (hit points, normals,
geometric pdf factors, MIS weights) is differentiated, and discrete
decisions (which triangle a ray hits, visibility booleans, lobe choice)
are held fixed. This is unbiased for interior integrands and misses only
the visibility-edge terms (the reparameterized/edge-aware stage of the
BASELINE north star remains documented future work).

Differentiable parameters: per-material kd, ks, radiance, plus `dverts` —
a displacement field over the OBJ's SHARED vertex buffer [Nv,3]. Vertex
displacement moves every incident triangle coherently (geom.vert_idx maps
triangle corners to shared vertices), and flows into hit points, shading
normals' interpolation weights, light sample positions, areas, and the
d^2/cos NEE pdfs. Hit *selection* for scenes with prebuilt acceleration
structures (BVH) uses the base geometry — exact at the gradient
evaluation point dverts = 0; inverse-rendering steps that move vertices
re-bake the scene between steps. On BVH-walk scenes the integrator freezes
the walk's triangle selection (stop_gradient at the dispatch site) and
re-derives hit geometry attached from the displaced triangle row
(integrator.expand_hit), so dverts gradients flow on accelerated scenes
too.

The counter-based RNG makes the estimator a deterministic function of
(params, seed), so finite differences validate autodiff directly
(tests/test_grad.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from mcpt.render.integrator import trace_image
from mcpt.scene import Scene


@dataclass(frozen=True)
class SceneParams:
    """The differentiable subset of the scene: material table + vertex field."""

    kd: jnp.ndarray  # [M,3]
    ks: jnp.ndarray  # [M,3]
    radiance: jnp.ndarray  # [M,3]
    # Displacement over the shared OBJ vertex buffer [Nv,3]; None when the
    # scene has no vert_idx mapping (hand-built test soups). Gradients
    # w.r.t. dverts at 0 are d(pixel)/d(vertex position).
    dverts: Optional[jnp.ndarray] = None


jax.tree_util.register_dataclass(
    SceneParams, data_fields=["kd", "ks", "radiance", "dverts"], meta_fields=[]
)


def extract_params(scene: Scene) -> SceneParams:
    dverts = None
    if scene.geom.vert_idx is not None and scene.num_verts > 0:
        dverts = jnp.zeros((scene.num_verts, 3), jnp.float32)
    return SceneParams(
        kd=scene.mats.kd, ks=scene.mats.ks, radiance=scene.mats.radiance,
        dverts=dverts,
    )


def apply_params(scene: Scene, params: SceneParams) -> Scene:
    mats = dataclasses.replace(
        scene.mats, kd=params.kd, ks=params.ks, radiance=params.radiance
    )
    scene = dataclasses.replace(scene, mats=mats)
    if params.dverts is not None and scene.geom.vert_idx is not None:
        g = scene.geom
        d = params.dverts[g.vert_idx]  # [T,3,3] per-corner displacement
        e1 = g.e1 + d[:, 1] - d[:, 0]
        e2 = g.e2 + d[:, 2] - d[:, 0]
        n = jnp.cross(e1, e2)
        n2 = jnp.sum(n * n, axis=-1)
        # double-where: sqrt'(0)=inf on degenerate triangles would NaN the
        # whole dverts gradient; primal unchanged (sqrt(0) == 0)
        safe = n2 > 0
        area = jnp.where(safe, 0.5 * jnp.sqrt(jnp.where(safe, n2, 1.0)), 0.0)
        geom = dataclasses.replace(
            g,
            v0=g.v0 + d[:, 0],
            e1=e1,
            e2=e2,
            # area feeds the NEE light pdf (pack_light_table) — recompute
            # differentiably (reference Triangle::area, src/Triangle.cpp:24-28)
            area=area,
        )
        scene = dataclasses.replace(scene, geom=geom)
    return scene


def render_image(
    params: SceneParams,
    scene: Scene,
    key,
    spp: int,
    max_bounces: int,
) -> jnp.ndarray:
    """Differentiable render -> mean radiance [H,W,3] as a function of params."""
    sc = apply_params(scene, params)
    cam = sc.camera
    W, H = cam.width, cam.height
    pixel_idx = jnp.arange(W * H, dtype=jnp.int32)

    def one(acc, s):
        ks = jax.random.fold_in(key, s)
        rad = trace_image(sc, cam, ks, pixel_idx, max_bounces, differentiable=True)
        # scrub non-finite samples like the film does (reference
        # Scene.cpp:15-18); backward contribution of scrubbed lanes is 0
        rad = jnp.where(jnp.isfinite(rad), rad, 0.0)
        return acc + rad, None

    acc, _ = jax.lax.scan(one, jnp.zeros((W * H, 3)), jnp.arange(spp))
    return (acc / spp).reshape(H, W, 3)


def mse_loss(
    params: SceneParams, scene: Scene, target: jnp.ndarray, key, spp: int,
    max_bounces: int,
) -> jnp.ndarray:
    img = render_image(params, scene, key, spp, max_bounces)
    return jnp.mean((img - target) ** 2)


def mse_loss_dual(
    params: SceneParams, scene: Scene, target: jnp.ndarray, key, spp: int,
    max_bounces: int,
) -> jnp.ndarray:
    """Unbiased MSE surrogate from two independent renders.

    grad of mean((A-t)(B-t)) with A,B independent estimates of the true image
    is an unbiased estimate of grad of the TRUE squared error — plain MSE of
    a noisy render also differentiates the estimator's variance, which at low
    spp biases albedo downward (lower albedo = lower variance).
    """
    ka, kb = jax.random.split(key)
    a = render_image(params, scene, ka, spp, max_bounces)
    b = render_image(params, scene, kb, spp, max_bounces)
    return jnp.mean((a - target) * (b - target))


loss_and_grad = jax.value_and_grad(mse_loss)
