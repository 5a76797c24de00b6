"""Sharded progressive rendering: shard_map over a ('tiles', 'spp') mesh.

Device-parallel replacement for the reference's OpenMP pixel loop
(src/Render.cpp:60-68, its only parallelism): image rows shard over the
'tiles' axis, sample indices shard over the 'spp' axis, the scene is
replicated, and the only collective is a psum of film accumulators over
'spp'. Because the RNG is counter-based per (pixel,
sample) (utils/rng.py), every sample is the one the single-device render
draws: sharding rows alone gives a bitwise-equal film; sharding samples
too reorders the f32 film sum in the psum (equal within rtol 2e-6).

Row assignment is INTERLEAVED, not contiguous blocks: tile t renders image
rows {t, t + nt, t + 2nt, ...}. Contiguous blocks are systematically
imbalanced — path length tracks image content (a cornell tile looking at
the light retires paths bounces earlier than one looking into the box;
measured 0.855 balance on contiguous quarters vs >=0.97 interleaved) —
while every interleaved tile samples the whole image's vertical structure.
Each device still stores its rows COMPACTLY (film storage row t*rows + k
holds image row k*nt + t), so no extra communication is introduced; reads
go through `film_to_image_order` (see ShardedRenderer.film).

Runs identically on several GPUs or on a virtual CPU mesh
(--xla_force_host_platform_device_count), which is how CI covers it.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mcpt.parallel.mesh import film_sharding, make_mesh
from mcpt.render.camera import generate_rays
from mcpt.render.film import Film, make_film
from mcpt.render.integrator import trace_paths
from mcpt.scene import Scene
from mcpt.utils.rng import per_ray_keys, ray_uniforms


def make_film_sharded(scene: Scene, mesh) -> Film:
    """Empty film laid out exactly as render_pass_sharded returns it (rows
    sharded, counters replicated), so the second pass reuses the first
    pass's compiled program instead of compiling for a new layout."""
    from jax.sharding import NamedSharding

    H, W = scene.camera.height, scene.camera.width
    film = make_film(H, W)
    rep = NamedSharding(mesh, P())
    return Film(
        accum=jax.device_put(film.accum, film_sharding(mesh)),
        spp=jax.device_put(film.spp, rep),
        nan_count=jax.device_put(film.nan_count, rep),
        rays=jax.device_put(film.rays, rep),
    )


def film_to_image_order(film: Film, n_tiles: int) -> Film:
    """Sharded-storage film -> image-row-order film.

    Storage row t*rows + k holds image row k*n_tiles + t (interleaved
    assignment, see module docstring); a zero-copy reshape/transpose
    restores scanline order.
    """
    H, W, _ = film.accum.shape
    rows = H // n_tiles
    acc = film.accum.reshape(n_tiles, rows, W, 3).transpose(1, 0, 2, 3)
    return Film(
        accum=acc.reshape(H, W, 3), spp=film.spp,
        nan_count=film.nan_count, rays=film.rays,
    )


def film_from_image_order(film: Film, mesh) -> Film:
    """Inverse of film_to_image_order + re-shard (checkpoint resume path).

    Every leaf moves onto THIS mesh's devices (the film may come from a
    renderer on a different mesh shape, or from a host checkpoint): the
    scalar counters replicate, the accumulator row-shards.
    """
    from jax.sharding import NamedSharding

    nt = mesh.shape["tiles"]
    H, W, _ = film.accum.shape
    rows = H // nt
    acc = jnp.asarray(film.accum).reshape(rows, nt, W, 3).transpose(1, 0, 2, 3)
    rep = NamedSharding(mesh, P())
    return Film(
        accum=jax.device_put(acc.reshape(H, W, 3), film_sharding(mesh)),
        spp=jax.device_put(jnp.asarray(film.spp, jnp.float32), rep),
        nan_count=jax.device_put(jnp.asarray(film.nan_count), rep),
        rays=jax.device_put(jnp.asarray(film.rays, jnp.float32), rep),
    )


@partial(
    jax.jit,
    static_argnames=("mesh", "max_bounces", "spp_per_pass"),
    donate_argnames=("film",),
)
def render_pass_sharded(
    scene: Scene,
    film: Film,
    key: jnp.ndarray,
    start_idx: jnp.ndarray,
    mesh,
    max_bounces: int,
    spp_per_pass: int,
) -> Film:
    """Add spp_per_pass samples/pixel, sharded over the mesh.

    Requires H % n_tiles == 0 and spp_per_pass % n_spp == 0.
    """
    cam = scene.camera
    W, H = cam.width, cam.height
    nt = mesh.shape["tiles"]
    ns = mesh.shape["spp"]
    assert H % nt == 0, f"image height {H} not divisible by tiles={nt}"
    assert spp_per_pass % ns == 0, f"spp_per_pass {spp_per_pass} % spp axis {ns}"
    rows = H // nt
    local_spp = spp_per_pass // ns

    def local_pass(accum, spp_ct, nan_ct, ray_ct):
        # accum: [rows, W, 3] this device's film rows (compact storage of
        # the INTERLEAVED image rows k*nt + ti, k = 0..rows-1 — see module
        # docstring: contiguous blocks are content-imbalanced)
        ti = jax.lax.axis_index("tiles")
        si = jax.lax.axis_index("spp")
        k = jnp.arange(rows, dtype=jnp.int32)
        img_rows = k * nt + ti.astype(jnp.int32)  # [rows]
        pixel_idx = (
            img_rows[:, None] * W + jnp.arange(W, dtype=jnp.int32)[None, :]
        ).reshape(-1)

        from mcpt.render.integrator import (
            chunk_rays_for,
            trace_image_wavefront,
        )

        # this device renders samples [start + si*local_spp, +local_spp) of
        # its pixel rows; the counter-based per-(pixel, sample) RNG makes the
        # result independent of this decomposition. The sharded pass is ONE
        # device program (shard_map), so it always runs the in-program
        # wavefront loop with loop-mode chunks.
        local_start = start_idx + si.astype(jnp.int32) * local_spp
        radiance, local_rays, local_nan = trace_image_wavefront(
            scene, cam, key, pixel_idx, local_start, local_spp, max_bounces,
            chunk_rays=chunk_rays_for(scene, mode="loop"),
        )
        local_acc = radiance.reshape(rows, W, 3)
        local_rays = local_rays.astype(jnp.float32)
        # sum sample shards; every 'spp' peer then holds the total
        local_acc = jax.lax.psum(local_acc, "spp")
        total_nan = jax.lax.psum(jax.lax.psum(local_nan, "spp"), "tiles")
        total_rays = jax.lax.psum(jax.lax.psum(local_rays, "spp"), "tiles")
        return (
            accum + local_acc,
            spp_ct + spp_per_pass,
            nan_ct + total_nan,
            ray_ct + total_rays,
        )

    accum, spp_ct, nan_ct, ray_ct = jax.shard_map(
        local_pass,
        mesh=mesh,
        in_specs=(P("tiles", None, None), P(), P(), P()),
        out_specs=(P("tiles", None, None), P(), P(), P()),
        # the per-device RNG stream (axis_index-derived) makes carries
        # "varying" over mesh axes; outputs are made consistent by the psums
        check_vma=False,
    )(film.accum, film.spp, film.nan_count, film.rays)
    return Film(accum=accum, spp=spp_ct, nan_count=nan_ct, rays=ray_ct)


def measure_scaling(
    scene: Scene, mesh, max_bounces: int = 4, spp_per_pass: Optional[int] = None,
    seed: int = 0,
) -> dict:
    """One sharded pass instrumented per device: traced-ray load balance.

    SPMD programs execute in lockstep, so per-pass wall time on uniform
    hardware = max over devices of per-device work; rays/s scaling
    efficiency ≈ load balance = mean(per-device rays) / max(per-device
    rays), degraded only by collective time (here: one film psum over
    'spp' + two scalar psums). On a virtual CPU mesh (CI, dryrun) wall
    time measures host-core oversubscription, not the program, so balance
    is the honest scaling proxy; multi-GPU wall time exercises the exact
    same compiled path.
    """
    cam = scene.camera
    W, H = cam.width, cam.height
    nt = mesh.shape["tiles"]
    ns = mesh.shape["spp"]
    n_dev = nt * ns
    spp_per_pass = spp_per_pass or ns
    assert H % nt == 0 and spp_per_pass % ns == 0
    rows = H // nt
    local_spp = spp_per_pass // ns
    key = jax.random.PRNGKey(seed)

    def local_rays(_):
        ti = jax.lax.axis_index("tiles")
        si = jax.lax.axis_index("spp")
        k = jnp.arange(rows, dtype=jnp.int32)
        img_rows = k * nt + ti.astype(jnp.int32)  # interleaved (see module doc)
        pixel_idx = (
            img_rows[:, None] * W + jnp.arange(W, dtype=jnp.int32)[None, :]
        ).reshape(-1)
        from mcpt.render.integrator import trace_image_wavefront

        _, nrays, _ = trace_image_wavefront(
            scene, cam, key, pixel_idx,
            si.astype(jnp.int32) * local_spp, local_spp, max_bounces,
        )
        return nrays.astype(jnp.float32).reshape(1)

    per_dev = jax.jit(
        jax.shard_map(
            local_rays,
            mesh=mesh,
            in_specs=(P(("tiles", "spp")),),
            out_specs=P(("tiles", "spp")),
            check_vma=False,
        )
    )(jnp.zeros((n_dev,), jnp.float32))
    import numpy as np

    counts = np.asarray(per_dev, np.float64)
    balance = float(counts.mean() / counts.max()) if counts.max() > 0 else 0.0
    return {
        "devices": n_dev,
        "rays_per_device": counts.tolist(),
        "total_rays": float(counts.sum()),
        "balance_efficiency": balance,
    }


def measure_throughput_scaling(
    scene: Scene, devices, counts=(1, 2, 4, 8), max_bounces: int = 4,
    seed: int = 0, warmup: int = 1, timed: int = 2,
) -> list:
    """Time one sharded pass at each device count; report rays/s ratios.

    The BASELINE scaling contract is rays/s vs device count, not load
    balance. Each row jits the identical render_pass_sharded program over a
    (n, 1) tiles-mesh built from a prefix of `devices`, times `timed`
    passes after `warmup`, and reports Mrays/s, speedup vs the 1-device
    row, and parallel efficiency. On a virtual CPU mesh absolute numbers
    reflect host-core oversubscription (all "devices" share the host), so
    treat efficiency as a smoke signal there; on several GPUs this is the
    scaling benchmark itself.
    """
    import numpy as np

    rows_out = []
    base = None
    for n in counts:
        if n > len(devices):
            break
        if scene.camera.height % n != 0:
            # a silent skip reads as measured coverage: say why
            print(
                f"[scaling] skipped {n} devices: image height "
                f"{scene.camera.height} % {n} != 0 (pad the height or pick "
                "a divisible tile count to measure this row)"
            )
            continue
        mesh = make_mesh(n, 1, devices=list(devices)[:n])
        sr = ShardedRenderer(
            scene, mesh=mesh, max_bounces=max_bounces, spp_per_pass=1,
            seed=seed,
        )
        for _ in range(warmup):
            sr.step()
        # read counters from the STORAGE film (the .film property builds a
        # de-interleaving reshape per access) and take rays0 BEFORE the
        # clock starts — neither belongs inside the timed window
        rays0 = float(sr._film.rays)
        t0 = time.perf_counter()
        for _ in range(timed):
            sr.step()
        dt = time.perf_counter() - t0
        rays = float(sr._film.rays) - rays0
        mrps = rays / dt / 1e6 if dt > 0 else 0.0
        if base is None:
            base = mrps
        speedup = mrps / base if base > 0 else 0.0
        rows_out.append({
            "devices": n,
            "mrays_per_s": mrps,
            "speedup": speedup,
            "efficiency": speedup / n if n else 0.0,
        })
    return rows_out


class ShardedRenderer:
    """Progressive renderer over a device mesh. API mirrors render.Renderer."""

    def __init__(self, scene: Scene, mesh=None, max_bounces: int = 24,
                 spp_per_pass: Optional[int] = None, seed: int = 0,
                 width: Optional[int] = None, height: Optional[int] = None):
        import dataclasses as dc

        if width or height:
            cam = dc.replace(
                scene.camera,
                width=width or scene.camera.width,
                height=height or scene.camera.height,
            )
            scene = dc.replace(scene, camera=cam)
        self.mesh = mesh if mesh is not None else make_mesh()
        # replicate the scene across the mesh once
        from mcpt.parallel.mesh import replicated

        self.scene = jax.device_put(scene, replicated(self.mesh))
        self.max_bounces = max_bounces
        self.spp_per_pass = spp_per_pass or self.mesh.shape["spp"]
        self.key = jax.random.PRNGKey(seed)
        self.sample_idx = 0
        # _film is in interleaved STORAGE order (see module docstring);
        # the `film` property presents/accepts image order
        self._film = make_film_sharded(self.scene, self.mesh)
        self.pass_times = []

    @property
    def film(self) -> Film:
        """The film in image (scanline) row order."""
        return film_to_image_order(self._film, self.mesh.shape["tiles"])

    @film.setter
    def film(self, value: Film) -> None:
        """Accepts an image-order film (e.g. a loaded checkpoint)."""
        self._film = film_from_image_order(value, self.mesh)

    def step(self) -> Film:
        t0 = time.perf_counter()
        self._film = render_pass_sharded(
            self.scene,
            self._film,
            self.key,
            jnp.asarray(self.sample_idx, jnp.int32),
            self.mesh,
            self.max_bounces,
            self.spp_per_pass,
        )
        jax.block_until_ready(self._film)
        self.pass_times.append(time.perf_counter() - t0)
        self.sample_idx += self.spp_per_pass
        # image order, like Renderer.step (the storage film is interleaved)
        return self.film

    def render(self, spp: int) -> Film:
        while self.sample_idx < spp:
            self.step()
        return self.film

    def save(self, path: str) -> str:
        from mcpt.render.film import save

        return save(self.film, path)
