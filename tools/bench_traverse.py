"""Traversal-only throughput + dense-vs-BVH threshold sweep.

Usage: python tools/bench_traverse.py [scene.obj] [--rays N] [--algo auto|bvh|dense]
       python tools/bench_traverse.py --sweep   # dense-vs-BVH crossover

Measures scene load time, then steady-state closest_hit and any_hit Mrays/s
on camera-like ray batches (primary rays + scrambled rays to mimic bounce
divergence). --sweep times the dense wave and the BVH walk on synthetic
soups of growing size, the measurement behind
ops/intersect.BRUTE_FORCE_MAX_TRIS.
"""
import argparse
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _time_fn(fn, o, d, n=5):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(o, d))
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn(o, d)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n, t_compile, out


def sweep():
    """Dense intersect-all vs the skip-link BVH walk on synthetic soups:
    the crossover triangle count behind BRUTE_FORCE_MAX_TRIS."""
    import dataclasses as dc

    import jax
    import jax.numpy as jnp

    from mcpt.ops.bvh import attach_bvh
    from mcpt.ops.intersect import closest_hit
    from mcpt.ops.traverse import closest_hit_bvh
    from mcpt.scene import Camera, Geometry, Materials, Scene, TextureAtlas

    rng = np.random.default_rng(7)
    R = 32768
    o = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)

    print(f"{'tris':>6} {'dense ms':>9} {'bvh ms':>9}  winner")
    for T in (128, 256, 512, 1024, 2048, 4096, 8192):
        base = rng.uniform(-5, 5, (T, 3))
        e1 = rng.normal(size=(T, 3)) * 0.5
        e2 = rng.normal(size=(T, 3)) * 0.5
        geom = Geometry(
            v0=np.asarray(base, np.float32), e1=np.asarray(e1, np.float32),
            e2=np.asarray(e2, np.float32),
            vn=np.zeros((T, 3, 3), np.float32),
            uv=np.zeros((T, 3, 2), np.float32),
            mat_id=np.zeros((T,), np.int32), area=np.ones((T,), np.float32),
        )
        sc = Scene(
            geom=geom,
            mats=Materials(
                kd=np.ones((1, 3)), ks=np.zeros((1, 3)), ns=np.ones((1,)),
                radiance=np.zeros((1, 3)),
                tex_id=np.full((1,), -1, np.int32), tr=np.zeros((1, 3)),
                ni=np.ones((1,)),
            ),
            atlas=TextureAtlas(data=np.zeros((1, 1, 1, 3)),
                               size=np.ones((1, 2), np.int32)),
            light_tris=np.zeros((0,), np.int32),
            camera=Camera(eye=np.zeros(3), lookat=np.ones(3),
                          up=np.array([0.0, 1.0, 0.0]),
                          fovy=np.asarray(40.0)),
        )
        sc = attach_bvh(sc)
        dense = dc.replace(sc, bvh=None)  # dispatch: dense below any size
        dt_d, _, _ = _time_fn(
            jax.jit(lambda oo, dd: closest_hit(dense, oo, dd)), o, d
        )
        dt_b, _, _ = _time_fn(
            jax.jit(lambda oo, dd: closest_hit_bvh(sc, oo, dd)), o, d
        )
        win = "bvh" if dt_b < dt_d else "dense"
        print(f"{T:>6} {dt_d*1e3:>9.2f} {dt_b*1e3:>9.2f}  {win}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default="scenes/bathroom-stress.obj")
    ap.add_argument("--rays", type=int, default=32768)
    ap.add_argument("--algo", default="auto", choices=["auto", "bvh", "dense"])
    ap.add_argument("--sweep", action="store_true",
                    help="dense-vs-BVH crossover on synthetic soups")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    print("device:", jax.devices()[0])
    if args.sweep:
        sweep()
        return

    t0 = time.perf_counter()
    from mcpt.io.obj import load_scene

    scene = load_scene(args.scene, with_bvh=True)
    jax.block_until_ready(scene.geom.v0)
    t_load = time.perf_counter() - t0
    print(f"load_scene: {t_load:.2f}s  tris={scene.num_tris}", flush=True)

    from mcpt.render.camera import generate_rays
    from mcpt.utils.rng import per_ray_keys, ray_uniforms

    cam = scene.camera
    R = args.rays
    key = jax.random.PRNGKey(0)
    pidx = jnp.arange(R, dtype=jnp.int32)  # first rows of the image
    keys = per_ray_keys(key, pidx)
    jitter = ray_uniforms(keys, 0, 2)
    org, dirn = generate_rays(cam, jitter, pidx)

    # scrambled = divergence stress (random pixels over the whole image)
    rng = np.random.default_rng(0)
    pidx2 = jnp.asarray(
        rng.integers(0, cam.width * cam.height, R), jnp.int32
    )
    keys2 = per_ray_keys(key, pidx2)
    org2, dirn2 = generate_rays(cam, ray_uniforms(keys2, 0, 2), pidx2)

    if args.algo == "bvh":
        from mcpt.ops.traverse import any_hit_bvh, closest_hit_bvh

        ch = lambda o, d, **k2: closest_hit_bvh(scene, o, d, **k2)
        ah = lambda o, d, **k2: any_hit_bvh(scene, o, d, **k2)
    elif args.algo == "dense":
        import dataclasses as dc

        from mcpt.ops.intersect import any_hit, closest_hit

        dense = dc.replace(scene, bvh=None)
        ch = lambda o, d, **k2: closest_hit(dense, o, d, **k2)
        ah = lambda o, d, **k2: any_hit(dense, o, d, **k2)
    else:
        from mcpt.ops.intersect import any_hit, closest_hit

        ch = lambda o, d, **k2: closest_hit(scene, o, d, **k2)
        ah = lambda o, d, **k2: any_hit(scene, o, d, **k2)

    # jit everything: unjitted calls dispatch op by op
    ch = jax.jit(ch)
    ah = jax.jit(ah)

    # realistic shadow rays: from primary hit points toward one light
    # triangle, t_max = distance (the integrator's NEE any-hit pattern)
    hit0 = ch(org, dirn)
    t0h = jnp.minimum(hit0.t, 1e3)
    p_hit = org + dirn * (t0h[:, None] * 0.999)
    if scene.num_lights > 0:
        lt = int(np.asarray(scene.light_tris)[0])
        target = np.asarray(scene.geom.v0)[lt]
    else:
        target = np.asarray(scene.camera.lookat)
    to_l = jnp.asarray(target)[None, :] - p_hit
    dist = jnp.linalg.norm(to_l, axis=1)
    d_sh = to_l / dist[:, None]

    for name, fn, (o, d), k2 in [
        ("closest/primary", ch, (org, dirn), {}),
        ("closest/scrambled", ch, (org2, dirn2), {}),
        ("anyhit/shadow", ah, (p_hit, d_sh), {"t_max": dist - 1e-3}),
        ("anyhit/primary", ah, (org, dirn), {}),
    ]:
        dt, t_compile, out = _time_fn(partial(fn, **k2), o, d)
        hits = None
        if hasattr(out, "tri"):
            hits = float((np.asarray(out.tri) >= 0).mean())
        print(
            f"{name}: {dt*1e3:8.2f} ms  {R/dt/1e6:8.2f} Mrays/s  "
            f"(first={t_compile:.1f}s"
            + (f", hit-rate={hits:.3f}" if hits is not None else "")
            + ")",
            flush=True,
        )


if __name__ == "__main__":
    main()
