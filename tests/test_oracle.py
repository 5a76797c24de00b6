"""JAX integrator vs the independent f64 numpy oracle (tests/oracle.py).

Different RNG streams -> images agree statistically, not pixelwise: channel
means must match within MC standard error, and per-pixel means at higher spp
must correlate strongly.
"""
import numpy as np
import pytest

from mcpt.render.renderer import Renderer, RenderConfig
from tests.oracle import render_oracle


def _jax_image(scene, w, h, spp, bounces, seed=0):
    r = Renderer(scene, RenderConfig(max_bounces=bounces, width=w, height=h, seed=seed))
    for _ in range(spp):
        r.step()
    return np.asarray(r.film.accum) / float(r.film.spp)


def test_cornell_mean_matches_oracle(cornell_scene):
    w = h = 32
    spp = 24
    img_t = _jax_image(cornell_scene, w, h, spp, bounces=12)
    img_o = render_oracle(cornell_scene, w, h, spp, max_bounces=12, seed=99)
    mt = img_t.mean(axis=(0, 1))
    mo = img_o.mean(axis=(0, 1))
    # MC standard error of the mean at this sample count is ~1%; allow 4%.
    np.testing.assert_allclose(mt, mo, rtol=0.04), (mt, mo)


def test_cornell_pixels_correlate_with_oracle(cornell_scene):
    w = h = 24
    spp = 32
    img_t = _jax_image(cornell_scene, w, h, spp, bounces=10)
    img_o = render_oracle(cornell_scene, w, h, spp, max_bounces=10, seed=7)
    # 4x4 block means average out per-pixel MC noise (effective spp x16)
    def blocks(im):
        return im.reshape(6, 4, 6, 4, 3).mean(axis=(1, 3)).reshape(-1)

    a = np.minimum(blocks(img_t), 2.0)
    b = np.minimum(blocks(img_o), 2.0)
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.99, corr


def test_veach_mean_matches_oracle(veach_scene):
    w, h = 32, 18
    spp = 32
    img_t = _jax_image(veach_scene, w, h, spp, bounces=6)
    img_o = render_oracle(veach_scene, w, h, spp, max_bounces=6, seed=3)
    # veach has high variance (tiny bright emitters); compare medians of the
    # tonemapped images plus means with loose tolerance
    mt = np.sqrt(np.clip(img_t, 0, 1)).mean()
    mo = np.sqrt(np.clip(img_o, 0, 1)).mean()
    assert abs(mt - mo) / mo < 0.05, (mt, mo)
