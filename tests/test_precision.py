"""Every matrix product on the render and gradient paths asks for HIGHEST.

An f32 product with no precision set may run in TF32 on the GPU, which
keeps ~10 mantissa bits: too coarse for the hard accept thresholds of the
intersection (t >= 1e-4, u, v >= 0). The guard lowers the jitted render
step and the inverse step and inspects every dot_general in the StableHLO.
"""
import dataclasses
import re

import jax
import pytest

DOT = re.compile(r"stablehlo\.dot_general[^\n]*")


def _check(text):
    bad = [d for d in DOT.findall(text)
           if "precision = [HIGHEST, HIGHEST]" not in d]
    assert not bad, bad[:3]


@pytest.fixture
def small_scene(cornell_scene):
    cam = dataclasses.replace(cornell_scene.camera, width=8, height=8)
    return dataclasses.replace(cornell_scene, camera=cam)


def test_guard_flags_default_precision():
    """The guard itself: a product without a precision is caught."""
    import jax.numpy as jnp

    x = jnp.ones((4, 4))
    _check(jax.jit(lambda a: jnp.dot(a, a, precision="highest")).lower(x).as_text())
    with pytest.raises(AssertionError):
        _check(jax.jit(lambda a: a @ a).lower(x).as_text())


def test_render_step_products_are_highest(small_scene):
    from mcpt.render.film import make_film
    from mcpt.render.renderer import render_pass_impl

    lowered = jax.jit(render_pass_impl, static_argnums=(4, 5)).lower(
        small_scene, make_film(8, 8), jax.random.PRNGKey(0), 0, 4, 1)
    _check(lowered.as_text())


def test_inverse_step_products_are_highest(small_scene):
    from mcpt.diff.grad import extract_params, render_image
    from mcpt.diff.inverse import make_inverse_step

    params = extract_params(small_scene)
    target = render_image(params, small_scene, jax.random.PRNGKey(1), 1, 2)
    init, step_fn = make_inverse_step(small_scene, target, spp=1,
                                      max_bounces=2)
    lowered = step_fn.lower(init(params), jax.random.PRNGKey(2))
    _check(lowered.as_text())
