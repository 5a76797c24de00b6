#!/usr/bin/env python
"""Smoke test of the path tracer on one NVIDIA GPU, at full size.

    python chip_smoke.py [--out-dir DIR]      # one card, every phase below
    python chip_smoke.py --chips 4            # four cards: the sharded phase

Phases, each compared with a plain reference (a failed comparison raises,
and the script exits non-zero):

  intersect-dense   veach-mis, 65,536 camera + cosine bounce rays (and as
                    many shadow rays) through the dense dispatch vs a plain
                    float64 numpy Moller-Trumbore on the host, and vs the
                    same dense wave compiled for the host CPU
  intersect-bvh     bathroom-stress (~1M tris), 8,192 such rays through the
                    BVH walk vs brute force over every triangle on the card
  render-cornell    `mcpt render` in-process, 1024^2 x 16 spp; tonemapped
                    mean vs the reference golden (+-0.02)
  render-veach      Renderer at the scene's 1280x720, 8 spp; golden (+-0.03)
  render-bathroom   Renderer at 1280x720, 1 spp, 24 bounces; no NaN,
                    non-degenerate image
  determinism       cornell 256^2 x 4 spp twice with one seed: bitwise equal
  inverse           cornell 256^2, 4 spp, 6 bounces, 20 Adam steps: the loss
                    falls, gradients are finite, one albedo gradient matches
                    a central finite difference; reports whether two gradient
                    evaluations are bitwise equal

With --chips 4 only the sharded phase runs: cornell 1024^2 x 16 spp on 4x1
and 2x2 meshes vs the one-card render, rays/s scaling from 1 to 4 cards,
and one sharded inverse gradient (128^2) vs the one-card gradient.

Earlier lines report the card (nvidia-smi name and power limit), the JAX
version, and per phase the compile and wall seconds and every comparison
with its tolerance. The last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU, or outside a checkout of the repo, it exits non-zero and
prints no result. Mrays/s figures are smoke readings, not a benchmark.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(ROOT, "scenes")

# tonemapped mean RGB of the reference's golden renders (BASELINE.md;
# the same pins as tests/test_golden_stats.py)
GOLDEN_CORNELL = (0.448, 0.380, 0.269)
GOLDEN_VEACH = (0.250, 0.178, 0.276)

# intersection agreement (see PERF.md): hit triangle ids, and t where the
# ids agree, relative to t
ID_AGREE_MIN = 0.9999
REL_DT_MAX = 1e-5


def report(phase: str, compile_s, wall_s, checks) -> None:
    c = "n/a" if compile_s is None else f"{compile_s:.2f}"
    print(f"[{phase}] compile_s={c} wall_s={wall_s:.2f}", flush=True)
    for line in checks:
        print(f"[{phase}]   {line}", flush=True)


def _timed(fn, *args):
    """(output, compile seconds, run seconds) of jit(fn)(*args)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    tc = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    return out, tc, time.perf_counter() - t0


def load(name: str, width=None, height=None):
    from mcpt.io.obj import load_scene

    scene = load_scene(os.path.join(SCENES, f"{name}.obj"))
    if width or height:
        cam = dataclasses.replace(scene.camera, width=width or scene.camera.width,
                                  height=height or scene.camera.height)
        scene = dataclasses.replace(scene, camera=cam)
    return scene


# ---------------------------------------------------------------------------
# intersection
# ---------------------------------------------------------------------------

def sample_rays(scene, n: int, seed: int = 0):
    """n rays like the integrator's: n/2 camera rays at random pixels and
    n/2 cosine-sampled bounce rays leaving their hits, plus one shadow ray
    per ray's hit toward a uniform light point. Hits come from the
    brute-force reference. Returns (org, dirn, shadow_org, shadow_dir,
    shadow_tmax, t_min)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcpt.ops.intersect import closest_hit_bruteforce
    from mcpt.render.camera import generate_rays
    from mcpt.render.integrator import (
        RAY_EPS_REL,
        expand_hit,
        pack_light_table,
        pack_tri_table,
        sample_light_point,
    )
    from mcpt.render.onb import make_onb, to_world

    rng = np.random.default_rng(seed)
    cam = scene.camera
    t_min = RAY_EPS_REL * scene.scale
    half = n // 2
    pidx = jnp.asarray(rng.integers(0, cam.width * cam.height, half), jnp.int32)
    jitter = jnp.asarray(rng.uniform(0, 1, (half, 2)), jnp.float32)
    o_cam, d_cam = generate_rays(cam, jitter, pidx)
    table = pack_tri_table(scene)

    def surface(o, d):
        hit = jax.jit(closest_hit_bruteforce)(scene, o, d, t_min)
        h = expand_hit(table, hit, o, d)
        n_f = jnp.where(h.front[:, None], h.normal, -h.normal)
        return np.asarray(h.valid), h.point, n_f

    valid, p_cam, n_cam = surface(o_cam, d_cam)
    if not valid.any():
        raise AssertionError("no camera ray hit the scene")
    src = jnp.asarray(np.nonzero(valid)[0][np.arange(n - half) % valid.sum()])
    u = jnp.asarray(rng.uniform(0, 1, (n - half, 2)), jnp.float32)
    r, phi = jnp.sqrt(u[:, 0]), 2.0 * jnp.pi * u[:, 1]
    local = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi),
                       jnp.sqrt(1.0 - u[:, 0])], axis=-1)
    o_b = p_cam[src]
    d_b = to_world(make_onb(n_cam[src]), local)
    org = jnp.concatenate([o_cam, o_b])
    dirn = jnp.concatenate([d_cam, d_b])

    valid_b, p_b, _ = surface(o_b, d_b)
    pts = jnp.concatenate([p_cam, p_b])
    ok = np.concatenate([valid, valid_b])
    pts = pts[jnp.asarray(np.nonzero(ok)[0][np.arange(n) % ok.sum()])]
    if scene.num_lights == 0:
        raise AssertionError("scene has no lights for shadow rays")
    ul = jnp.asarray(rng.uniform(0, 1, (n, 3)), jnp.float32)
    lp, _, _, _ = sample_light_point(pack_light_table(scene), scene.num_lights,
                                     ul[:, 0], ul[:, 1], ul[:, 2])
    to_l = lp - pts
    dist = jnp.linalg.norm(to_l, axis=-1)
    return (org, dirn, pts, to_l / dist[:, None], dist * (1.0 - 1e-3), t_min)


def compare_hits(name: str, got, ref, precision: str = "f32") -> str:
    """Assert hit agreement of `got` with `ref` (each with .t and .tri);
    returns the report line."""
    import numpy as np

    gt, gi = np.asarray(got.t), np.asarray(got.tri)
    rt, ri = np.asarray(ref.t), np.asarray(ref.tri)
    same = gi == ri
    both = same & (ri >= 0)
    rel = np.abs(gt[both] - rt[both]) / np.maximum(np.abs(rt[both]), 1e-30)
    max_rel = float(rel.max()) if rel.size else 0.0
    bitwise = float((same & (gt == rt)).mean())
    line = (f"{name}: tri ids agree {same.mean():.6f} (tol >= {ID_AGREE_MIN}), "
            f"max |dt|/t {max_rel:.3e} (tol <= {REL_DT_MAX:g}), "
            f"bitwise (id and t) {bitwise:.6f}; {int(ri.size)} rays, "
            f"{int((ri >= 0).sum())} hits, {precision}")
    if same.mean() < ID_AGREE_MIN or max_rel > REL_DT_MAX:
        raise AssertionError(line)
    return line


def compare_any(name: str, got, ref, precision: str = "f32") -> str:
    import numpy as np

    g, r = np.asarray(got), np.asarray(ref)
    agree = float((g == r).mean())
    line = (f"{name}: occlusion agrees {agree:.6f} (tol >= {ID_AGREE_MIN}); "
            f"{r.size} shadow rays, {int(r.sum())} occluded, {precision}")
    if agree < ID_AGREE_MIN:
        raise AssertionError(line)
    return line


def np_hits_f64(scene, org, dirn, t_min, t_max=None, block: int = 1024):
    """Plain Moller-Trumbore over every triangle in float64 numpy, with the
    reference's accept predicates (Triangle.cpp:48-106): closest hit when
    `t_max` is None (|det| >= 1e-5, t >= t_min), else any hit within
    [t_min, t_max] (|det| >= 1e-6). Independent of the package's
    intersection code. Returns (t, tri) or a bool array."""
    import numpy as np

    g = scene.geom
    v0, e1, e2 = (np.asarray(x, np.float64)[None] for x in (g.v0, g.e1, g.e2))
    org, dirn = np.asarray(org, np.float64), np.asarray(dirn, np.float64)
    closest = t_max is None
    R = org.shape[0]
    best_t, best_tri = np.full(R, np.inf), np.full(R, -1, np.int64)
    occluded = np.zeros(R, bool)
    for r0 in range(0, R, block):
        o, d = org[r0:r0 + block, None], dirn[r0:r0 + block, None]
        h = np.cross(d, e2)
        det = np.sum(e1 * h, -1)
        s = o - v0
        q = np.cross(s, e1)
        with np.errstate(divide="ignore", invalid="ignore"):
            u = np.sum(s * h, -1) / det
            v = np.sum(d * q, -1) / det
            t = np.sum(e2 * q, -1) / det
        if closest:
            ok = (np.abs(det) >= 1e-5) & (t >= t_min) & (u >= 0) & (v >= 0) \
                & (1.0 - u - v >= 0)
            tc = np.where(ok, t, np.inf)
            i = np.argmin(tc, axis=1)
            bt = tc[np.arange(tc.shape[0]), i]
            best_t[r0:r0 + block] = bt
            best_tri[r0:r0 + block] = np.where(np.isfinite(bt), i, -1)
        else:
            tm = np.asarray(t_max, np.float64)[r0:r0 + block, None]
            ok = (np.abs(det) >= 1e-6) & (u >= 0) & (u <= 1) & (v >= 0) \
                & (u + v <= 1) & (t >= t_min) & (t <= tm)
            occluded[r0:r0 + block] = ok.any(axis=1)
    if closest:
        return best_t, best_tri
    return occluded


def phase_intersect_dense(scene, n_rays: int, cpu_check: bool = True) -> dict:
    """Dense dispatch on the card vs the float64 numpy reference (closest
    and any hit), and the card's dense wave vs the same function compiled
    for the host CPU, which exposes compiler differences such as FMA
    contraction."""
    import jax

    from mcpt.ops import intersect as I

    if I.uses_bvh_walk(scene):
        raise AssertionError("scene dispatches to the BVH walk, not the dense wave")
    t0 = time.perf_counter()
    o, d, so, sd, smax, t_min = sample_rays(scene, n_rays)
    checks = [f"{scene.num_tris} tris"]
    got, tc, _ = _timed(I.closest_hit, scene, o, d, t_min)
    got_any, tc2, _ = _timed(I.any_hit, scene, so, sd, t_min, smax)
    ref_t, ref_tri = np_hits_f64(scene, o, d, t_min)
    checks.append(compare_hits(
        "closest_hit vs numpy f64 reference", got,
        types.SimpleNamespace(t=ref_t, tri=ref_tri), "card f32, reference f64"))
    checks.append(compare_any("any_hit vs numpy f64 reference", got_any,
                              np_hits_f64(scene, so, sd, t_min, smax),
                              "card f32, reference f64"))
    if cpu_check:
        cpu = jax.devices("cpu")[0]
        sc_c, args = jax.device_put((scene, (o, d, t_min)), cpu)
        ref_c = jax.jit(I.closest_hit)(sc_c, *args)
        checks.append(compare_hits("card dense wave vs host CPU dense wave",
                                   got, ref_c))
    report("intersect-dense", tc + tc2, time.perf_counter() - t0, checks)
    return {"checks": checks}


def phase_intersect_bvh(scene, n_rays: int) -> dict:
    """BVH walk (dispatch for scenes past BRUTE_FORCE_MAX_TRIS) vs brute
    force over every triangle."""
    import jax

    from mcpt.ops import intersect as I

    if not I.uses_bvh_walk(scene):
        raise AssertionError("scene does not dispatch to the BVH walk")
    t0 = time.perf_counter()
    o, d, so, sd, smax, t_min = sample_rays(scene, n_rays)
    with jax.default_matmul_precision("highest"):
        ref, tc_r, _ = _timed(I.closest_hit_bruteforce, scene, o, d, t_min)
        ref_any, _, _ = _timed(I.any_hit_bruteforce, scene, so, sd, t_min, smax)
    got, tc, run = _timed(I.closest_hit, scene, o, d, t_min)
    got_any, tc2, run2 = _timed(I.any_hit, scene, so, sd, t_min, smax)
    checks = [
        f"{scene.num_tris} tris, BVH walk closest {run * 1e3:.1f} ms, "
        f"any {run2 * 1e3:.1f} ms for {n_rays} rays",
        compare_hits("closest_hit_bvh vs brute force", got, ref),
        compare_any("any_hit_bvh vs brute force", got_any, ref_any),
    ]
    report("intersect-bvh", tc + tc2 + tc_r, time.perf_counter() - t0, checks)
    return {"checks": checks}


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

def _tonemap_mean(path: str):
    from mcpt.io.image import load_png

    return load_png(path).reshape(-1, 3).mean(axis=0)


def _check_mean(name, mean, golden, tol) -> str:
    dev = max(abs(float(m) - g) for m, g in zip(mean, golden))
    line = (f"{name}: tonemapped mean RGB ({mean[0]:.4f}, {mean[1]:.4f}, "
            f"{mean[2]:.4f}) vs golden {golden}: max deviation {dev:.4f} "
            f"(tol <= {tol})")
    if dev > tol:
        raise AssertionError(line)
    return line


def phase_render_cli(scene_path: str, width: int, height: int, spp: int,
                     out_dir: str, golden=GOLDEN_CORNELL, tol=0.02,
                     card: str = "") -> dict:
    """`mcpt render` in-process, two passes; compile = pass 1 - pass 2."""
    from mcpt.cli import main

    out = os.path.join(out_dir, "cornell.png")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(["render", scene_path, "--width", str(width),
                   "--height", str(height), "--spp", str(spp),
                   "--spp-per-pass", str(spp // 2), "--out", out])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"mcpt render exited {rc}")
    text = buf.getvalue()
    passes = [float(x) / 1e3 for x in re.findall(r"([0-9.]+) ms/pass", text)]
    stats = json.loads(text.strip().splitlines()[-1])
    if stats["nan_scrubbed"] != 0:
        raise AssertionError(f"render scrubbed {stats['nan_scrubbed']} NaNs")
    steady = passes[-1]
    checks = [
        _check_mean("PNG", _tonemap_mean(out), golden, tol),
        f"smoke reading {stats['traced_rays'] / len(passes) / steady / 1e6:.1f} "
        f"Mrays/s (second pass {steady:.3f} s) on {card}",
    ]
    report("render-cornell", max(passes[0] - steady, 0.0), wall, checks)
    return {"mean": _tonemap_mean(out)}


def phase_render(name: str, scene, spp: int, bounces: int, out_dir: str,
                 golden=None, tol=None, card: str = "") -> dict:
    """One Renderer pass of `spp` samples; the chunk program is compiled
    ahead (timed) so the pass times the render. Checks no NaN, a
    non-degenerate image, and the golden mean when given."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcpt.io.image import tonemap
    from mcpt.render.integrator import chunk_rays_for
    from mcpt.render.renderer import RenderConfig, Renderer, _render_chunk

    r = Renderer(scene, RenderConfig(max_bounces=bounces, spp_per_pass=spp,
                                     seed=0))
    cam = r.scene.camera
    tc = None
    if cam.width * cam.height > chunk_rays_for(r.scene):
        c = chunk_rays_for(r.scene)
        t0 = time.perf_counter()
        _render_chunk.lower(r.scene, jnp.zeros((c,), jnp.int32),
                            jnp.ones((c,), bool), r.key,
                            jnp.asarray(0, jnp.int32), max_bounces=bounces,
                            spp_per_pass=spp).compile()
        tc = time.perf_counter() - t0
    t0 = time.perf_counter()
    r.step()
    wall = time.perf_counter() - t0
    st = r.stats
    img = tonemap(np.asarray(r.film.accum), float(r.film.spp))
    mean = img.reshape(-1, 3).mean(axis=0) / 255.0
    from mcpt.io.image import write_png

    write_png(os.path.join(out_dir, f"{name}.png"), img[::-1])
    checks = [f"{scene.num_tris} tris, {cam.width}x{cam.height}, {spp} spp, "
              f"{bounces} bounces; nan_scrubbed {st['nan_scrubbed']} (tol 0)"]
    if st["nan_scrubbed"] != 0:
        raise AssertionError(checks[0])
    line = f"mean tonemapped value {mean.mean():.4f} (tol 0.05 < mean < 0.95)"
    if not 0.05 < mean.mean() < 0.95:
        raise AssertionError(line)
    checks.append(line)
    if golden is not None:
        checks.append(_check_mean("image", mean, golden, tol))
    checks.append(f"smoke reading {st['traced_rays'] / wall / 1e6:.2f} Mrays/s "
                  f"on {card}")
    report(f"render-{name}", tc, wall, checks)
    return {"mean": mean}


def phase_determinism(scene, size: int, spp: int) -> dict:
    import numpy as np

    from mcpt.render.renderer import RenderConfig, Renderer

    t0 = time.perf_counter()
    films = []
    for _ in range(2):
        r = Renderer(scene, RenderConfig(max_bounces=24, width=size,
                                         height=size, spp_per_pass=spp, seed=5))
        r.step()
        films.append(np.asarray(r.film.accum))
    same = np.array_equal(films[0], films[1])
    line = (f"cornell {size}^2 x {spp} spp rendered twice, seed 5: "
            f"films bitwise equal = {same} (tol: bitwise)")
    if not same:
        raise AssertionError(line)
    report("determinism", None, time.perf_counter() - t0, [line])
    return {"bitwise": same}


# ---------------------------------------------------------------------------
# inverse rendering
# ---------------------------------------------------------------------------

FD_EPS = 2e-3
FD_TOL = 0.05  # relative, as tests/test_grad.py
EVAL_KEYS = 4


def phase_inverse(scene, size: int, spp: int, bounces: int, steps: int,
                  fd_bounces: int = 4) -> dict:
    """Adam on cornell albedo + emission (the bench's inverse config).

    The raw gradient is checked finite at `bounces`. The finite difference
    runs at `fd_bounces` <= RR_START_BOUNCE + 1, where
    no Russian roulette decision exists: RR survival depends on the
    albedo, so across a flip the estimator jumps and a difference quotient
    measures the jump, not the gradient. Cornell's materials are all
    diffuse, so no lobe choice depends on the albedo either.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcpt.diff.grad import (
        SceneParams,
        extract_params,
        mse_loss,
        mse_loss_dual,
        render_image,
    )
    from mcpt.diff.inverse import make_inverse_step

    sc = dataclasses.replace(scene, camera=dataclasses.replace(
        scene.camera, width=size, height=size))
    t0 = time.perf_counter()
    true = dataclasses.replace(extract_params(sc), dverts=None)
    target = jax.block_until_ready(
        render_image(true, sc, jax.random.PRNGKey(7), spp, bounces))
    emissive = jnp.linalg.norm(true.radiance, axis=-1, keepdims=True) > 0.01
    mask = SceneParams(kd=jnp.ones_like(true.kd), ks=jnp.zeros_like(true.ks),
                       radiance=emissive * jnp.ones_like(true.radiance))
    rad0 = jnp.max(target.reshape(-1, 3), axis=0)
    guess = SceneParams(kd=jnp.full_like(true.kd, 0.5), ks=true.ks,
                        radiance=jnp.where(true.radiance > 0, rad0[None, :], 0.0),
                        dverts=None)
    init, step_fn = make_inverse_step(sc, target, spp=spp, max_bounces=bounces,
                                      param_mask=mask, radiance_lr=0.2)
    state = init(guess)
    key = jax.random.PRNGKey(1)
    tc0 = time.perf_counter()
    state, loss = step_fn(state, key)
    losses = [float(loss)]
    tc = time.perf_counter() - tc0
    for _ in range(steps - 1):
        state, loss = step_fn(state, key)
        losses.append(float(loss))
    # each step's loss is a fresh noisy estimate, so the fall is judged on
    # the optimized (two-render, unbiased) loss averaged over EVAL_KEYS
    # fixed keys, at the start and end parameters. Plain MSE would not do:
    # it also counts the render's variance, which grows with the albedo.
    dual_at = jax.jit(mse_loss_dual, static_argnums=(4, 5))

    def eval_loss(p):
        return float(np.mean([dual_at(p, sc, target, jax.random.PRNGKey(100 + i),
                                      spp, bounces) for i in range(EVAL_KEYS)]))

    l0, l1 = eval_loss(guess), eval_loss(state.params)
    gkey = jax.random.PRNGKey(3)
    kd_err = [float(jnp.max(jnp.abs(p.kd - true.kd))) for p in (guess, state.params)]
    checks = [f"{steps} Adam steps: per-step loss {losses[0]:.4e} -> "
              f"{losses[-1]:.4e}; loss over {EVAL_KEYS} fixed keys {l0:.6e} -> {l1:.6e} "
              f"(tol: falls); max |kd - kd*| {kd_err[0]:.3f} -> {kd_err[1]:.3f}"]
    if not l1 < l0:
        raise AssertionError(checks[0])

    # the raw gradient at the guess, at the phase's own bounce count and
    # before the step's isfinite guard: finite, and whether it repeats
    lg = jax.jit(jax.value_and_grad(mse_loss), static_argnums=(4, 5))
    loss_at = jax.jit(mse_loss, static_argnums=(4, 5))
    _, g1 = lg(guess, sc, target, gkey, spp, bounces)
    _, g2 = lg(guess, sc, target, gkey, spp, bounces)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(g1)]
    n_bad = sum(int((~np.isfinite(x)).sum()) for x in leaves)
    checks.append(f"gradient at {bounces} bounces: {n_bad} non-finite of "
                  f"{sum(x.size for x in leaves)} entries (tol 0)")
    if n_bad:
        raise AssertionError(checks[-1])
    bitwise = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
                  zip(jax.tree_util.tree_leaves(g1), jax.tree_util.tree_leaves(g2)))
    checks.append(f"two gradient evaluations bitwise equal = {bitwise} "
                  "(reported, not gated)")
    # one albedo entry vs a central finite difference, at fd_bounces
    _, g1 = lg(guess, sc, target, gkey, spp, fd_bounces)

    def at(delta):
        p = dataclasses.replace(guess, kd=guess.kd.at[0, 1].add(delta))
        return float(loss_at(p, sc, target, gkey, spp, fd_bounces))

    ad = float(g1.kd[0, 1])
    fd = (at(FD_EPS) - at(-FD_EPS)) / (2 * FD_EPS)
    rel = abs(ad - fd) / max(abs(ad), abs(fd), 1e-12)
    line = (f"d loss / d kd[white, green]: autodiff {ad:.6e}, central FD "
            f"{fd:.6e} (eps {FD_EPS}, {fd_bounces} bounces): rel diff "
            f"{rel:.4f} (tol <= {FD_TOL}), f32")
    checks.append(line)
    if rel > FD_TOL:
        raise AssertionError(line)
    report("inverse", tc, time.perf_counter() - t0, checks)
    return {"losses": losses, "grad_bitwise": bitwise}


# ---------------------------------------------------------------------------
# several cards
# ---------------------------------------------------------------------------

def phase_multichip(scene, devices, spp: int, grad_size: int,
                    scaling_counts=(1, 2, 4), card: str = "") -> dict:
    """ShardedRenderer on n x 1 and (n/2) x 2 meshes vs the one-device
    render; rays/s scaling; one sharded gradient vs the one-device one.

    Every comparison is reported before the phase fails on any of them.
    Films: at least 99.9 % of pixels within rtol 2e-6 of the one-device
    film and image means within 1e-5 relative. Sharding samples reorders
    the f32 sum (psum), and the sharded and one-device programs are
    separate compilations, whose rounding can send a rare path another
    way; both are reported (bitwise share, max difference).
    """
    import jax
    import numpy as np

    from mcpt.diff.grad import extract_params
    from mcpt.diff.inverse import sharded_loss_and_grad
    from mcpt.parallel.mesh import make_mesh
    from mcpt.parallel.shard import ShardedRenderer, measure_throughput_scaling
    from mcpt.render.renderer import RenderConfig, Renderer

    n = len(devices)
    t0 = time.perf_counter()
    cam = scene.camera
    checks = [f"{n} devices: {[str(d) for d in devices]}"]
    failed = []
    single = Renderer(scene, RenderConfig(max_bounces=24, spp_per_pass=spp,
                                          seed=0))
    single.step()
    ref = np.asarray(single.film.accum)
    for shape in ((n, 1), (n // 2, 2)):
        mesh = make_mesh(*shape, devices=devices)
        sr = ShardedRenderer(scene, mesh=mesh, max_bounces=24,
                             spp_per_pass=spp, seed=0)
        sr.step()
        used = {s.device for s in sr._film.accum.addressable_shards}
        if used != set(devices):
            raise AssertionError(f"film shards on {used}, not on all {n} devices")
        got = np.asarray(jax.device_get(sr.film.accum))
        diff = np.abs(got - ref)
        close = float(np.isclose(got, ref, rtol=2e-6, atol=2e-6)
                      .all(axis=-1).mean())
        mean_rel = float(abs(got.mean() - ref.mean()) / abs(ref.mean()))
        line = (f"{shape[0]}x{shape[1]} mesh vs one device, {cam.width}x"
                f"{cam.height} x {spp} spp: bitwise {np.array_equal(got, ref)}, "
                f"pixels bitwise {float((diff == 0).all(axis=-1).mean()):.6f}, "
                f"pixels within rtol 2e-6 {close:.6f} (tol >= 0.999), "
                f"image mean rel diff {mean_rel:.2e} (tol <= 1e-5), "
                f"max |diff| {float(diff.max()):.3e}; film shards on "
                f"{len(used)} devices, pass {sr.pass_times[-1]:.3f} s")
        checks.append(line)
        if close < 0.999 or mean_rel > 1e-5:
            failed.append(line)
    table = measure_throughput_scaling(scene, devices, counts=scaling_counts)
    for row in table:
        checks.append(f"scaling {row['devices']} devices: "
                      f"{row['mrays_per_s']:.2f} Mrays/s, x{row['speedup']:.3f}, "
                      f"efficiency {row['efficiency']:.3f} on {card}")
    sc = dataclasses.replace(scene, camera=dataclasses.replace(
        cam, width=grad_size, height=grad_size))
    params = dataclasses.replace(extract_params(sc), dverts=None)
    key = jax.random.PRNGKey(0)
    l1, g1 = sharded_loss_and_grad(sc, make_mesh(1, 1, devices=devices[:1]),
                                   params, key)
    ln, gn = sharded_loss_and_grad(sc, make_mesh(n, 1, devices=devices),
                                   params, key)
    # per leaf: max |diff| relative to the leaf's max |grad|, floored at
    # 1e-6 of the largest gradient so an all-zero leaf (ks: cornell has no
    # glossy lobe) is compared on the gradient's own scale
    leaves1 = [np.asarray(x) for x in jax.tree_util.tree_leaves(g1)]
    leavesn = [np.asarray(x) for x in jax.tree_util.tree_leaves(gn)]
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(g1)[0]]
    top = max(float(np.abs(a).max()) for a in leaves1)
    loss_rel = abs(float(ln) - float(l1)) / abs(float(l1))
    line = (f"sharded gradient ({n}x1) vs one device, {grad_size}^2: loss "
            f"{float(ln):.6e} vs {float(l1):.6e} (rel {loss_rel:.2e}, tol <= 1e-5)")
    bad = loss_rel > 1e-5
    for name, a, b in zip(names, leaves1, leavesn):
        scale = max(float(np.abs(a).max()), 1e-6 * top)
        rel = float(np.abs(a - b).max()) / scale
        bad |= not rel <= 1e-3
        line += (f"; {name}: max |g| {float(np.abs(a).max()):.3e}, max |diff| "
                 f"{float(np.abs(a - b).max()):.3e}, rel {rel:.2e} (tol <= 1e-3), "
                 f"bitwise {np.array_equal(a, b)}")
    checks.append(line + "; psum reorders the f32 sum")
    if bad:
        failed.append(line)
    report("multichip", None, time.perf_counter() - t0, checks)
    if failed:
        raise AssertionError("; ".join(failed))
    return {"scaling": table}


# ---------------------------------------------------------------------------

def card_name() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable: {e}"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded phase on four cards")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "smoke_out"),
                    help="where rendered PNGs go")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "mcpt")):
        sys.stderr.write("chip_smoke.py: run it from a checkout of the repo "
                         "(no mcpt/ package beside it)\n")
        return 2
    sys.path.insert(0, ROOT)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.stderr.write(f"chip_smoke.py: no GPU (JAX default platform is "
                         f"{dev.platform}); nothing run\n")
        return 2
    from mcpt.compile_cache import enable_compile_cache

    print(f"cache: {enable_compile_cache()}")
    card = card_name()
    for line in card.splitlines():
        print(f"nvidia-smi: {line}")
    card = card.splitlines()[0] if card else "unknown card"
    print(f"jax {jax.__version__}, device_kind {dev.device_kind}, "
          f"{len(jax.devices())} devices")
    os.makedirs(args.out_dir, exist_ok=True)
    t_all = time.perf_counter()

    if args.chips == 4:
        devs = jax.devices()
        if len(devs) < 4:
            raise AssertionError(f"--chips 4 needs four GPUs, found {len(devs)}")
        phase_multichip(load("cornell-box", 1024, 1024), devs[:4], spp=16,
                        grad_size=128, card=card)
    else:
        phase_intersect_dense(load("veach-mis"), 65536)
        bath = load("bathroom-stress")
        phase_intersect_bvh(bath, 8192)
        phase_render_cli(os.path.join(SCENES, "cornell-box.obj"), 1024, 1024,
                         16, args.out_dir, card=card)
        phase_render("veach", load("veach-mis"), spp=8, bounces=24,
                     out_dir=args.out_dir, golden=GOLDEN_VEACH, tol=0.03,
                     card=card)
        phase_render("bathroom", bath, spp=1, bounces=24,
                     out_dir=args.out_dir, card=card)
        del bath
        cornell = load("cornell-box")
        phase_determinism(cornell, 256, 4)
        phase_inverse(cornell, 256, spp=4, bounces=6, steps=20)
    print(f"total_s={time.perf_counter() - t_all:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
