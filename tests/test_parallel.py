"""Sharded rendering on the virtual 8-device CPU mesh: bitwise equality with
single-device, both mesh axes, scaling bookkeeping."""
import jax
import numpy as np
import pytest

from mcpt.parallel.mesh import make_mesh
from mcpt.parallel.shard import ShardedRenderer
from mcpt.render.renderer import Renderer, RenderConfig


@pytest.fixture(scope="module")
def devices():
    d = jax.devices()
    assert len(d) == 8, "conftest must provide 8 virtual CPU devices"
    return d


def _single(scene, w, h, spp, seed=0, bounces=6):
    r = Renderer(scene, RenderConfig(max_bounces=bounces, width=w, height=h, seed=seed))
    for _ in range(spp):
        r.step()
    return np.asarray(r.film.accum)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_matches_single_device(cornell_scene, devices, shape):
    nt, ns = shape
    mesh = make_mesh(nt, ns)
    w = h = 32
    spp = 8
    single = _single(cornell_scene, w, h, spp, seed=0)
    sr = ShardedRenderer(
        cornell_scene, mesh=mesh, max_bounces=6, spp_per_pass=spp, seed=0,
        width=w, height=h,
    )
    sr.step()
    sharded = np.asarray(jax.device_get(sr.film.accum))
    np.testing.assert_allclose(sharded, single, rtol=2e-6, atol=2e-6)
    assert float(sr.film.spp) == spp


def test_sharded_film_is_row_sharded(cornell_scene, devices):
    mesh = make_mesh(8, 1)
    sr = ShardedRenderer(cornell_scene, mesh=mesh, width=32, height=32, max_bounces=4)
    # the STORAGE film is row-sharded over 'tiles' (the public .film view
    # is a de-interleaving reshape of it, so it may be resharded)
    shard_shapes = {s.data.shape for s in sr._film.accum.addressable_shards}
    assert shard_shapes == {(4, 32, 3)}  # 32 rows / 8 devices


def test_sharded_progressive_accumulation(cornell_scene, devices):
    mesh = make_mesh(4, 2)
    sr = ShardedRenderer(
        cornell_scene, mesh=mesh, width=32, height=32, max_bounces=6,
        spp_per_pass=2, seed=0,
    )
    sr.step()
    sr.step()
    single = _single(cornell_scene, 32, 32, 4, seed=0)
    np.testing.assert_allclose(
        np.asarray(jax.device_get(sr.film.accum)), single, rtol=2e-6, atol=2e-6
    )


def test_nan_count_reduced_over_mesh(cornell_scene, devices):
    mesh = make_mesh(2, 4)
    sr = ShardedRenderer(cornell_scene, mesh=mesh, width=16, height=16, max_bounces=4)
    sr.step()
    assert int(sr.film.nan_count) == 0


def test_sharded_checkpoint_portable_across_mesh_shapes(cornell_scene, devices):
    """A film checkpointed from a 4-tile renderer resumes on a 2-tile mesh
    (and single-device) bitwise: the public film API is image-order, so
    the interleaved storage layout never leaks into checkpoints."""
    spp = 4
    sr4 = ShardedRenderer(
        cornell_scene, mesh=make_mesh(4, 1, devices=devices[:4]), width=32,
        height=32, max_bounces=4, spp_per_pass=2, seed=0,
    )
    sr4.step()  # 2 spp
    saved = sr4.film  # image order (property)

    # resume the remaining 2 spp on a DIFFERENT mesh shape
    sr2 = ShardedRenderer(
        cornell_scene, mesh=make_mesh(2, 1, devices=devices[:2]), width=32,
        height=32, max_bounces=4, spp_per_pass=2, seed=0,
    )
    sr2.film = saved  # setter re-shards into 2-tile interleaved storage
    sr2.sample_idx = 2
    sr2.step()

    single = _single(cornell_scene, 32, 32, spp, seed=0, bounces=4)
    np.testing.assert_allclose(
        np.asarray(jax.device_get(sr2.film.accum)), single,
        rtol=2e-6, atol=2e-6,
    )


def test_sharded_steps_compile_once(cornell_scene, devices):
    """The empty film has the layout a pass returns, so later passes reuse
    the first pass's program (a second compile would land inside timed
    windows, e.g. measure_throughput_scaling's)."""
    from mcpt.parallel.shard import render_pass_sharded

    sr = ShardedRenderer(cornell_scene, mesh=make_mesh(2, 2, devices=devices[:4]),
                         width=16, height=16, max_bounces=2, spp_per_pass=2)
    before = render_pass_sharded._cache_size()
    for _ in range(3):
        sr.step()
    assert render_pass_sharded._cache_size() - before == 1
