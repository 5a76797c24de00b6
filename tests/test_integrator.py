"""Integrator-level tests: determinism, BVH/bruteforce image equality,
statistical agreement with the reference goldens, film behavior."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcpt.render.film import accumulate, checkpoint_load, checkpoint_save, make_film
from mcpt.render.renderer import Renderer, RenderConfig


def _render(scene, spp=8, w=64, h=64, bounces=8, seed=0):
    r = Renderer(scene, RenderConfig(max_bounces=bounces, width=w, height=h, seed=seed))
    for _ in range(spp):
        r.step()
    return np.asarray(r.film.accum) / float(r.film.spp), r


def test_deterministic_same_seed(cornell_scene):
    img1, _ = _render(cornell_scene, spp=2, w=32, h=32, seed=7)
    img2, _ = _render(cornell_scene, spp=2, w=32, h=32, seed=7)
    np.testing.assert_array_equal(img1, img2)


def test_different_seed_differs(cornell_scene):
    img1, _ = _render(cornell_scene, spp=1, w=32, h=32, seed=0)
    img2, _ = _render(cornell_scene, spp=1, w=32, h=32, seed=1)
    assert not np.array_equal(img1, img2)


def test_bvh_equals_bruteforce_image(cornell_scene, cornell_scene_bvh):
    """Same estimator over both intersectors must produce the same image.

    The BVH permutes triangles, so light-triangle order can differ; the
    cornell light is a single quad (2 tris) sharing one material, and NEE
    samples lights uniformly — permutation within the light list changes
    which uniform maps to which triangle. So exact equality is not expected:
    the assertion is a tight statistical match (means within 5e-3) plus a
    pixelwise 95%-close check, which light-order permutation passes but a
    broken intersector does not.
    """
    img_b, rb = _render(cornell_scene, spp=4, w=48, h=48, seed=3)
    img_v, rv = _render(cornell_scene_bvh, spp=4, w=48, h=48, seed=3)
    # identical estimator + identical RNG; light order may differ -> compare
    # statistically tight + pixelwise loose
    assert abs(img_b.mean() - img_v.mean()) < 5e-3
    same = np.isclose(img_b, img_v, rtol=1e-3, atol=1e-3).mean()
    assert same > 0.95


def test_cornell_brightness_matches_reference_golden(cornell_scene):
    """Post-tonemap mean RGB should be in the ballpark of the reference
    golden render (results/cornell-box.obj119.png mean ~ (0.448,0.380,0.269),
    SURVEY §4). Scene geometry is re-authored, so tolerance is loose."""
    img, r = _render(cornell_scene, spp=12, w=64, h=64, bounces=12, seed=0)
    tone = np.sqrt(np.clip(img, 0, 1))
    mean = tone.mean(axis=(0, 1))
    golden = np.array([0.448, 0.380, 0.269])
    assert np.abs(mean - golden).max() < 0.03, mean


def test_no_nans_on_standard_scenes(cornell_scene, veach_scene):
    _, r1 = _render(cornell_scene, spp=2, w=32, h=32)
    assert int(r1.film.nan_count) == 0
    _, r2 = _render(veach_scene, spp=2, w=32, h=32, bounces=5)
    assert int(r2.film.nan_count) == 0


def test_emissive_seen_directly(cornell_scene):
    """Pixels looking at the light show raw radiance before tonemap."""
    img, _ = _render(cornell_scene, spp=2, w=64, h=64)
    # brightest pixel is the light itself: linear radiance >> 1, in the
    # upper image half (film row 0 = bottom; ceiling light = high rows)
    flat = img.mean(axis=-1)
    iy, ix = np.unravel_index(np.argmax(flat), flat.shape)
    assert img[iy, ix].max() > 5.0
    assert iy > flat.shape[0] // 2


def test_mirror_scene_renders(tmp_path):
    from mcpt.io.obj import load_scene

    scene = load_scene(
        os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell-box-mirror.obj"),
        with_bvh=True,
    )
    img, r = _render(scene, spp=4, w=48, h=48, bounces=10)
    assert int(r.film.nan_count) == 0
    assert img.mean() > 0.02


def test_film_nan_scrub():
    film = make_film(2, 2)
    bad = jnp.asarray(
        [[[np.nan, 1.0, 2.0], [0.0, np.nan, 0.0]], [[1.0, 1.0, 1.0], [0.0, 0.0, np.nan]]]
    )
    film = accumulate(film, bad)
    acc = np.asarray(film.accum)
    assert np.isfinite(acc).all()
    assert int(film.nan_count) == 3
    assert acc[0, 0, 1] == 1.0 and acc[0, 0, 0] == 0.0


def test_checkpoint_roundtrip(tmp_path, cornell_scene):
    img, r = _render(cornell_scene, spp=2, w=16, h=16, seed=5)
    p = str(tmp_path / "ckpt.npz")
    checkpoint_save(r.film, p, seed=5, sample_idx=r.sample_idx)
    film, seed, idx = checkpoint_load(p)
    assert seed == 5 and idx == 2
    np.testing.assert_array_equal(np.asarray(film.accum), np.asarray(r.film.accum))
    # resume: 2 + 2 more == 4 straight, same seed stream
    r2 = Renderer(
        dataclasses.replace(cornell_scene),
        RenderConfig(max_bounces=8, width=16, height=16, seed=5),
    )
    r2.film, r2.sample_idx = film, idx
    r2.step()
    r2.step()
    r_straight = Renderer(
        dataclasses.replace(cornell_scene),
        RenderConfig(max_bounces=8, width=16, height=16, seed=5),
    )
    for _ in range(4):
        r_straight.step()
    np.testing.assert_allclose(
        np.asarray(r2.film.accum), np.asarray(r_straight.film.accum), rtol=1e-6
    )


def test_spp_batched_pass_equals_single(cornell_scene):
    """spp_per_pass=2 must equal two spp_per_pass=1 steps (same seeds)."""
    r1 = Renderer(cornell_scene, RenderConfig(max_bounces=6, width=16, height=16, seed=9, spp_per_pass=1))
    r1.step()
    r1.step()
    r2 = Renderer(cornell_scene, RenderConfig(max_bounces=6, width=16, height=16, seed=9, spp_per_pass=2))
    r2.step()
    # sample identity is the global sample index -> bitwise equal
    np.testing.assert_allclose(
        np.asarray(r1.film.accum), np.asarray(r2.film.accum), rtol=1e-6
    )


def test_veach_brightness_regression(veach_scene):
    """Golden-statistic anchor for the MIS/glossy path.

    The reference's veach-mis golden has post-tonemap mean RGB ~
    (0.250, 0.178, 0.276) (BASELINE.md) but its scene pack is gitignored;
    ours is re-authored (round 5: color-matched slabs/emitters, pinned
    against the golden in test_golden_stats.py), so the anchor here is OUR
    recorded value at this exact config — a regression tripwire for the
    Blinn-Phong + MIS estimator, not a parity claim.
    """
    img, r = _render(veach_scene, spp=16, w=64, h=64, bounces=12, seed=0)
    tone = np.sqrt(np.clip(img, 0, 1))
    mean = float(tone.mean())
    # recorded 2026-08-21 on the CPU mesh (round-5 color re-authoring)
    assert abs(mean - 0.2782) < 0.02, mean


@pytest.mark.skipif(
    not os.environ.get("MCPT_SLOW_TESTS"),
    reason="1M-tri CPU render is minutes-slow; set MCPT_SLOW_TESTS=1",
)
def test_bathroom_brightness_regression():
    """Golden-statistic anchor for the 1M-triangle textured scene.

    Reference bathroom2 golden mean ~ (0.629, 0.517, 0.421) (BASELINE.md);
    ours is the re-authored bathroom-stress scene, anchored to our own
    recorded value.
    """
    scene = _load_bathroom()
    img, r = _render(scene, spp=2, w=32, h=32, bounces=6, seed=0)
    tone = np.sqrt(np.clip(img, 0, 1))
    assert np.isfinite(img).all()
    assert 0.05 < float(tone.mean()) < 0.95


def _load_bathroom():
    import os as _os

    from mcpt.io.obj import load_scene

    path = _os.path.join(
        _os.path.dirname(__file__), "..", "scenes", "bathroom-stress.obj"
    )
    return load_scene(path, with_bvh=True)


def test_host_chunked_pass_matches_single_program(cornell_scene):
    """render_pass_chunked (many bounded device executions) must be bitwise
    equal to the single-program pass: the counter-based per-(pixel, sample)
    RNG makes the result independent of the chunking."""
    import dataclasses as dc

    import jax.numpy as jnp

    from mcpt.render.film import make_film
    from mcpt.render.renderer import render_pass, render_pass_chunked

    cam = dc.replace(cornell_scene.camera, width=16, height=12)
    scene = dc.replace(cornell_scene, camera=cam)
    key = jax.random.PRNGKey(5)
    start = jnp.asarray(0, jnp.int32)
    a = render_pass(scene, make_film(12, 16), key, start, 4, 2)
    b = render_pass_chunked(scene, make_film(12, 16), key, start, 4, 2, chunk=64)
    np.testing.assert_array_equal(np.asarray(a.accum), np.asarray(b.accum))
    assert float(a.rays) == float(b.rays)
    assert int(a.nan_count) == int(b.nan_count)


def test_split_wavefront_bitwise_equals_fused_loop(cornell_scene):
    """The host-driven two-program wavefront (renderer.trace_chunk_split)
    must produce BITWISE-identical radiance to the fused lax.while_loop
    integrator: same RNG draws and the NEE-deferral preserves the add
    order exactly (see integrator's pipelined-wavefront section)."""
    import jax.numpy as jnp

    from mcpt.render.integrator import trace_wavefront
    from mcpt.render.renderer import trace_chunk_split

    scene = cornell_scene
    R = 384
    pidx = (jnp.arange(R, dtype=jnp.int32) * 97) % (
        scene.camera.width * scene.camera.height
    )
    lv = jnp.ones((R,), bool)
    key = jax.random.PRNGKey(11)
    start = jnp.asarray(7, jnp.int32)
    L0, nr0, nc0, _ = trace_wavefront(scene, scene.camera, key, pidx, start,
                                      spp=3, max_bounces=5)
    L1, nr1, nc1, _ = trace_chunk_split(scene, pidx, lv, key, start,
                                        max_bounces=5, spp_per_pass=3)
    np.testing.assert_array_equal(np.asarray(L0), np.asarray(L1))
    assert int(nr0) == int(nr1)
    assert int(nc0) == int(nc1)


def test_split_wavefront_renderer_pass(cornell_scene, monkeypatch):
    """MCPT_WAVEFRONT=split routes Renderer.step through the pipelined
    loop and matches the default pass bitwise."""
    import dataclasses as dc

    import jax.numpy as jnp

    from mcpt.render.film import make_film
    from mcpt.render.renderer import render_pass, render_pass_chunked

    cam = dc.replace(cornell_scene.camera, width=16, height=12)
    scene = dc.replace(cornell_scene, camera=cam)
    key = jax.random.PRNGKey(5)
    start = jnp.asarray(0, jnp.int32)
    a = render_pass(scene, make_film(12, 16), key, start, 4, 2)
    monkeypatch.setenv("MCPT_WAVEFRONT", "split")
    b = render_pass_chunked(scene, make_film(12, 16), key, start, 4, 2,
                            chunk=64)
    np.testing.assert_array_equal(np.asarray(a.accum), np.asarray(b.accum))
    assert float(a.rays) == float(b.rays)


def test_split_wavefront_compaction_bitwise(cornell_scene, monkeypatch):
    """Straggler compaction (re-packing live lanes into smaller programs)
    must not change a single bit: the counter-based RNG keys samples by
    (pixel, sample id), never by lane position."""
    import jax.numpy as jnp

    from mcpt.render.integrator import trace_wavefront
    from mcpt.render.renderer import trace_chunk_split

    monkeypatch.setenv("MCPT_COMPACT_MIN", "64")
    scene = cornell_scene
    R = 512
    pidx = (jnp.arange(R, dtype=jnp.int32) * 37) % (
        scene.camera.width * scene.camera.height
    )
    lv = jnp.ones((R,), bool)
    key = jax.random.PRNGKey(3)
    start = jnp.asarray(5, jnp.int32)
    L0, nr0, nc0, _ = trace_wavefront(scene, scene.camera, key, pidx, start,
                                      spp=4, max_bounces=8)
    L1, nr1, nc1, _ = trace_chunk_split(scene, pidx, lv, key, start,
                                        max_bounces=8, spp_per_pass=4)
    np.testing.assert_array_equal(np.asarray(L0), np.asarray(L1))
    assert int(nr0) == int(nr1)


def test_wavefront_mode_and_chunk_policy(cornell_scene, monkeypatch):
    """Dispatch policy unit checks: the fused loop is the default with
    DEFAULT_CHUNK_RAYS chunks; split mode gets whole-image chunks (loop
    chunks when asked for mode="loop", as the sharded pass does); env
    overrides are honored; unknown modes fail."""
    from mcpt.render.integrator import (
        DEFAULT_CHUNK_RAYS,
        chunk_rays_for,
        wavefront_mode,
    )

    monkeypatch.delenv("MCPT_WAVEFRONT", raising=False)
    monkeypatch.delenv("MCPT_CHUNK_LANES", raising=False)
    assert wavefront_mode(cornell_scene) == "loop"
    assert chunk_rays_for(cornell_scene) == DEFAULT_CHUNK_RAYS

    monkeypatch.setenv("MCPT_WAVEFRONT", "split")
    assert wavefront_mode(cornell_scene) == "split"
    r = cornell_scene.camera.width * cornell_scene.camera.height
    assert chunk_rays_for(cornell_scene) == max(r, DEFAULT_CHUNK_RAYS)
    assert chunk_rays_for(cornell_scene, mode="loop") == DEFAULT_CHUNK_RAYS

    monkeypatch.setenv("MCPT_CHUNK_LANES", "4096")
    assert chunk_rays_for(cornell_scene) == 4096

    for bogus in ("bogus", "auto"):
        monkeypatch.setenv("MCPT_WAVEFRONT", bogus)
        with pytest.raises(ValueError):
            wavefront_mode(cornell_scene)
