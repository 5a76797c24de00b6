"""Framebuffer: progressive (sum, spp) accumulator, the checkpointable state.

Reference equivalent: the `Scene` class (src/Scene.h:7-27) — per-pixel
{color_sum, spp} with NaN scrubbing at accumulation (src/Scene.cpp:12-21).
Here the buffer is a pytree of device arrays, shardable over the mesh, and
NaN counts are surfaced as a metric instead of only silently zeroed
(SURVEY §5 observability note).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class Film:
    accum: jnp.ndarray  # f32[H,W,3] radiance sum
    spp: jnp.ndarray  # f32[] samples accumulated per pixel (uniform)
    nan_count: jnp.ndarray  # i32[] total NaN components scrubbed
    rays: jnp.ndarray  # f32[] traced rays accumulated (primary+path+shadow)


jax.tree_util.register_dataclass(
    Film, data_fields=["accum", "spp", "nan_count", "rays"], meta_fields=[]
)


def make_film(height: int, width: int) -> Film:
    return Film(
        accum=jnp.zeros((height, width, 3)),
        spp=jnp.zeros(()),
        nan_count=jnp.zeros((), jnp.int32),
        rays=jnp.zeros(()),
    )


def accumulate(
    film: Film, radiance: jnp.ndarray, spp_added: float = 1.0, rays_added=0.0
) -> Film:
    """radiance: f32[S, H, W, 3] (S sample layers) or [H, W, 3]."""
    if radiance.ndim == 3:
        radiance = radiance[None]
    nan_mask = jnp.isnan(radiance)
    scrubbed = jnp.where(nan_mask, 0.0, radiance)  # Scene.cpp:15-18
    return Film(
        accum=film.accum + jnp.sum(scrubbed, axis=0),
        spp=film.spp + spp_added,
        nan_count=film.nan_count + jnp.sum(nan_mask).astype(jnp.int32),
        rays=film.rays + rays_added,
    )


def to_display(film: Film) -> np.ndarray:
    """u8[H,W,3], reference tonemap (mean -> clamp -> gamma 1/2 -> x255.99)."""
    from mcpt.io.image import tonemap

    return tonemap(np.asarray(film.accum), float(film.spp))


def save(film: Film, path: str) -> str:
    from mcpt.io.image import save_png

    return save_png(path, np.asarray(film.accum), float(film.spp))


def checkpoint_save(film: Film, path: str, seed: int, sample_idx: int) -> None:
    """Persist the resumable render state (accum, spp, RNG position).

    The reference's progressive accumulator is implicitly checkpointable
    (SURVEY §5); here it is explicit: any sample boundary can resume.
    The write is ATOMIC (tmp file + os.replace): a process killed mid-write
    (the fault-injection contract, tests/test_cli.py) can corrupt at most
    the tmp file, never an existing checkpoint.
    """
    import os

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            accum=np.asarray(film.accum),
            spp=np.asarray(film.spp),
            nan_count=np.asarray(film.nan_count),
            rays=np.asarray(film.rays),
            seed=seed,
            sample_idx=sample_idx,
        )
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def checkpoint_load(path: str):
    z = np.load(path)
    film = Film(
        accum=jnp.asarray(z["accum"]),
        spp=jnp.asarray(z["spp"]),
        nan_count=jnp.asarray(z["nan_count"]),
        rays=jnp.asarray(z["rays"]) if "rays" in z else jnp.zeros(()),
    )
    return film, int(z["seed"]), int(z["sample_idx"])
