"""Top-level progressive renderer.

Reference equivalent: the main frame loop (src/main.cpp:21-37) +
Render::render (src/Render.cpp:56-69): each step adds one (or more) samples
per pixel to the film. The per-step work — ray gen, path trace, accumulate —
is a single jitted XLA program with donated film state, so progressive
rendering runs entirely on device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from mcpt.render.camera import generate_rays
from mcpt.render.film import Film, accumulate, make_film
from mcpt.render.integrator import trace_paths
from mcpt.scene import Scene


@dataclass
class RenderConfig:
    max_bounces: int = 24
    seed: int = 0
    spp_per_pass: int = 1  # samples per pixel per device step
    width: Optional[int] = None  # override camera WxH
    height: Optional[int] = None


def render_pass_impl(
    scene: Scene,
    film: Film,
    key: jnp.ndarray,
    start_idx: jnp.ndarray,
    max_bounces: int,
    spp_per_pass: int,
) -> Film:
    """Add `spp_per_pass` samples/pixel to the film. One XLA program.

    Sample s of the pass is globally identified as start_idx + s: the RNG
    stream of a (pixel, sample) pair is independent of pass batching. Uses
    the wavefront-regeneration integrator: each lane renders all
    spp_per_pass samples of its pixel back to back, so late-bounce lane
    occupancy stays high (integrator.trace_wavefront).
    """
    cam = scene.camera
    W, H = cam.width, cam.height
    R = W * H

    from mcpt.render.film import Film
    from mcpt.render.integrator import trace_image_wavefront

    from mcpt.render.integrator import chunk_rays_for

    pixel_idx = jnp.arange(R, dtype=jnp.int32)
    radiance, nrays, nan_ct = trace_image_wavefront(
        scene, cam, key, pixel_idx, start_idx, spp_per_pass, max_bounces,
        chunk_rays=chunk_rays_for(scene),
    )
    # pixel i = y*W + x (Render.cpp:63); film rows are y. NaNs were already
    # scrubbed per sample at path flush (counted in nan_ct).
    img = radiance.reshape(H, W, 3)
    return Film(
        accum=film.accum + img,
        spp=film.spp + spp_per_pass,
        nan_count=film.nan_count + nan_ct,
        rays=film.rays + nrays.astype(jnp.float32),
    )


render_pass = partial(jax.jit, static_argnames=("max_bounces", "spp_per_pass"),
                      donate_argnames=("film",))(render_pass_impl)


@partial(jax.jit, static_argnames=("max_bounces", "spp_per_pass"))
def _render_chunk(scene, pidx, lane_valid, key, start_idx, max_bounces,
                  spp_per_pass):
    from mcpt.render.integrator import trace_wavefront

    return trace_wavefront(
        scene, scene.camera, key, pidx, start_idx, spp_per_pass, max_bounces,
        lane_valid=lane_valid,
    )


# ---------------------------------------------------------------------------
# Host-driven pipelined wavefront (integrator.split_trace / split_shade),
# selected by MCPT_WAVEFRONT=split. Dispatches queue asynchronously; the
# lane count is polled LOOKAHEAD iterations behind, so the device does not
# wait on the host between iterations.
# ---------------------------------------------------------------------------

SPLIT_LOOKAHEAD = 4
SPLIT_POLL_EVERY = 4  # iterations per host readback of the lane count


@jax.jit
def _split_trace_jit(scene, o, d, so, sd, smax):
    from mcpt.render.integrator import split_trace

    return split_trace(scene, o, d, so, sd, smax)


@partial(jax.jit, donate_argnames=("st",),
         static_argnames=("spp", "max_bounces"))
def _split_shade_jit(scene, st, hit_t, hit_tri, occl, key, pidx, start_idx,
                     spp, max_bounces):
    from mcpt.render.integrator import split_shade

    return split_shade(scene, st, hit_t, hit_tri, occl, key, pidx, start_idx,
                       spp, max_bounces)


def wavefront_mode(scene) -> str:
    """Re-exported from integrator (chunk sizing depends on it there)."""
    from mcpt.render.integrator import wavefront_mode as _wm

    return _wm(scene)


@partial(jax.jit, donate_argnames=("result",),
         static_argnames=("size", "spp"))
def _split_compact_jit(st, result, pos, pidx, size, spp):
    """Re-pack pending lanes into the first `size` slots.

    A lane's samples depend only on (pixel, sample id) — the counter-based
    RNG makes the result invariant to lane placement — so live lanes can
    be moved freely. Retired lanes' L_sum is flushed into `result` at
    their `pos`; moved lanes keep accumulating and flush at the end.
    """
    pending = st["alive"] | (st["s"] < spp)
    result = result.at[pos].set(st["L_sum"])
    order = jnp.argsort(~pending, stable=True)
    idx = order[:size]
    small = {
        k: (v if v.ndim == 0 else v[idx]) for k, v in st.items()
    }
    return small, result, pos[idx], pidx[idx]


def trace_chunk_split(scene, pidx, lane_valid, key, start_idx, max_bounces,
                      spp_per_pass, lookahead=SPLIT_LOOKAHEAD):
    """One wavefront chunk via the pipelined host loop.

    Returns (L_sum [R,3], nrays, nan_ct, iters) — the trace_wavefront
    contract, with BITWISE-equal radiance (same RNG draws, same add
    order; tested). The loop hard-caps at spp*(max_bounces+3)+lookahead
    iterations (a lane advances s or b every iteration, +1 zombie step).

    STRAGGLER COMPACTION: the wavefront's tail — a handful of lanes still
    rendering deep samples — would otherwise run hundreds of full-width
    iterations, because the X program's cost is proportional to LANES,
    not live lanes. When the polled pending count fits a 4x /
    16x / 64x smaller program, live lanes are re-packed (exact: RNG is
    keyed by (pixel, sample), not lane) and the loop continues at that
    size. MCPT_COMPACT=0 disables.
    """
    import os

    import numpy as np

    from mcpt.render.integrator import split_state0

    R = int(pidx.shape[0])
    st = split_state0(R, spp_per_pass, lane_valid)
    start_idx = jnp.asarray(start_idx, jnp.int32)
    result = jnp.zeros((R, 3))
    pos = jnp.arange(R, dtype=jnp.int32)
    # size ladder: quarter at each step, multiples of 1024 (full tiles).
    # MCPT_COMPACT_MIN floors it (tests force it low to exercise the path)
    ladder = []
    if os.environ.get("MCPT_COMPACT", "1") != "0":
        floor_sz = int(os.environ.get("MCPT_COMPACT_MIN", "16384"))
        s = R
        while s > floor_sz:
            s = max(floor_sz, -(-(s // 4) // 1024) * 1024 if s // 4 >= 1024
                    else floor_sz)
            ladder.append(s)
    # X0: pure regen (all lanes dead, dummy miss hit)
    cur = R

    def x0(st, pidx_c, n):
        miss_t = jnp.full((n,), jnp.finfo(jnp.float32).max)
        miss_tri = jnp.full((n,), -1, jnp.int32)
        occ0 = jnp.zeros((n,), bool)
        return _split_shade_jit(
            scene, st, miss_t, miss_tri, occ0, key, pidx_c, start_idx,
            spp_per_pass, max_bounces,
        )

    st, n_pend = x0(st, pidx, R)
    pending = [n_pend]
    cap = spp_per_pass * (max_bounces + 3) + lookahead + 2
    it = 0
    while it < cap:
        # poll the lane count `lookahead` iterations behind, and only
        # every POLL_EVERY iterations: each poll is a host round trip,
        # which would dominate cheap-scene iterations if done every
        # iteration. Unpolled entries are dropped unseen.
        if len(pending) > lookahead:
            if it % SPLIT_POLL_EVERY == 0:
                n_live = int(np.asarray(pending.pop(0)))
                if n_live == 0:
                    break
                # compact into the smallest ladder size that fits (with
                # slack: the poll lags `lookahead` iterations, but lane
                # count only ever decreases, so n_live is an upper bound)
                tgt = None
                for s in ladder:
                    if s < cur and n_live <= s:
                        tgt = s
                if tgt is not None:
                    st, result, pos, pidx = _split_compact_jit(
                        st, result, pos, pidx, size=tgt, spp=spp_per_pass
                    )
                    cur = tgt
                    pending.clear()
            else:
                pending.pop(0)
        hit_t, hit_tri, occ = _split_trace_jit(
            scene, st["o"], st["d"], st["so"], st["sd"], st["smax"]
        )
        st, n_pend = _split_shade_jit(
            scene, st, hit_t, hit_tri, occ, key, pidx, start_idx,
            spp_per_pass, max_bounces,
        )
        pending.append(n_pend)
        it += 1
    else:
        # cap reached: drain remaining polls (each extra pair is a no-op
        # on an all-dead state, so the cap can never lose samples)
        for p in pending:
            if int(np.asarray(p)) != 0:
                raise RuntimeError(
                    "pipelined wavefront hit its iteration cap with lanes "
                    f"pending (cap {cap}) — max_bounces/spp accounting bug"
                )
    result = result.at[pos].set(st["L_sum"])
    return result, st["nrays"], st["nan_ct"], st["iters"]


@partial(jax.jit, donate_argnames=("film",), static_argnames=("spp_per_pass",))
def _film_update(film, radiance, nrays, nan_ct, spp_per_pass):
    H, W, _ = film.accum.shape
    img = radiance.reshape(H, W, 3)
    return Film(
        accum=film.accum + img,
        spp=film.spp + spp_per_pass,
        nan_count=film.nan_count + nan_ct,
        rays=film.rays + nrays.astype(jnp.float32),
    )


def render_pass_chunked(scene, film, key, start_idx, max_bounces,
                        spp_per_pass, chunk=None):
    """One pass as MANY device executions (one per pixel chunk).

    Bitwise-identical to render_pass (chunk-invariant RNG, tested in
    tests/test_integrator.py). Each execution stays short and small,
    whatever the image size, so a long pass never holds the device in one
    program; the chunk program compiles once and is re-executed. Whether
    this or the one-program pass is faster on the GPU is recorded in
    PERF.md.
    """
    from mcpt.render.integrator import chunk_rays_for

    cam = scene.camera
    R = cam.width * cam.height
    if chunk is None:
        chunk = chunk_rays_for(scene)
    n_chunks = -(-R // chunk)
    Rp = n_chunks * chunk
    pidx = jnp.concatenate(
        [jnp.arange(R, dtype=jnp.int32), jnp.zeros((Rp - R,), jnp.int32)]
    )
    lane_valid = jnp.arange(Rp) < R
    split = wavefront_mode(scene) == "split"
    parts, nrays, nan_ct = [], jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        if split:
            L, nr, nc, _ = trace_chunk_split(
                scene, pidx[sl], lane_valid[sl], key, start_idx,
                max_bounces, spp_per_pass,
            )
        else:
            L, nr, nc, _ = _render_chunk(
                scene, pidx[sl], lane_valid[sl], key, start_idx, max_bounces,
                spp_per_pass,
            )
        # NO per-chunk host sync: executions queue on the device (the
        # split loop's lagged polls are likewise overlapped), and a
        # readback here would serialize n_chunks host round trips
        nrays = nrays + nr
        nan_ct = nan_ct + nc
        parts.append(L)
    radiance = jnp.concatenate(parts, axis=0)[:R]
    return _film_update(film, radiance, nrays, nan_ct, spp_per_pass)


class Renderer:
    """Progressive renderer: build once, call `step()` repeatedly.

    Mirrors the reference structure Render(Model) + frame loop, minus the
    GLFW window: checkpoints/PNGs replace the live blit (SURVEY §2.2).
    """

    def __init__(self, scene: Scene, config: RenderConfig = None):
        self.config = config or RenderConfig()
        if self.config.width or self.config.height:
            import dataclasses as dc

            cam = dc.replace(
                scene.camera,
                width=self.config.width or scene.camera.width,
                height=self.config.height or scene.camera.height,
            )
            scene = dc.replace(scene, camera=cam)
        self.scene = scene
        self.key = jax.random.PRNGKey(self.config.seed)
        self.sample_idx = 0
        self.film = make_film(scene.camera.height, scene.camera.width)
        self.pass_times: list[float] = []

    def step(self) -> Film:
        """Render one pass (spp_per_pass samples/pixel). Returns the film."""
        t0 = time.perf_counter()
        from mcpt.render.integrator import chunk_rays_for

        R = self.scene.camera.width * self.scene.camera.height
        if R > chunk_rays_for(self.scene) or wavefront_mode(self.scene) == "split":
            # one device execution per chunk (see render_pass_chunked)
            self.film = render_pass_chunked(
                self.scene,
                self.film,
                self.key,
                jnp.asarray(self.sample_idx, jnp.int32),
                self.config.max_bounces,
                self.config.spp_per_pass,
            )
        else:
            self.film = render_pass(
                self.scene,
                self.film,
                self.key,
                jnp.asarray(self.sample_idx, jnp.int32),
                self.config.max_bounces,
                self.config.spp_per_pass,
            )
        jax.block_until_ready(self.film)
        self.pass_times.append(time.perf_counter() - t0)
        self.sample_idx += self.config.spp_per_pass
        return self.film

    def render(self, spp: int, progress: Callable = None) -> Film:
        """Render until `spp` total samples per pixel are accumulated."""
        while self.sample_idx < spp:
            self.step()
            if progress is not None:
                progress(self)
        return self.film

    def save(self, path: str) -> str:
        from mcpt.render.film import save

        return save(self.film, path)

    @property
    def stats(self) -> dict:
        """Per-pass metrics (traced rays measured on device, SURVEY §5)."""
        n = self.scene.camera.width * self.scene.camera.height
        t = self.pass_times[-1] if self.pass_times else float("nan")
        total_t = sum(self.pass_times)
        rays = float(self.film.rays)
        return {
            "passes": len(self.pass_times),
            "spp": self.sample_idx,
            "last_pass_s": t,
            "paths_per_s": n * self.config.spp_per_pass / t if t == t else float("nan"),
            "traced_rays": rays,
            "mrays_per_s": rays / total_t / 1e6 if total_t > 0 else float("nan"),
            "nan_scrubbed": int(self.film.nan_count),
        }
