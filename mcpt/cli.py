"""Command-line interface: the reference's hardcoded scene choice + compile
-time constants (src/main.cpp:7-12, SURVEY §5 "Config / flag system: none")
replaced by a real CLI.

Subcommands
-----------
  render   progressive path-traced render -> PNG (+ optional checkpoints)
  inverse  inverse rendering: recover kd/radiance from a target image (Adam)
  info     print scene statistics (the reference prints these at
           src/main.cpp:14)

Examples
--------
  python -m mcpt render scenes/cornell-box.obj --spp 64 --out out.png
  python -m mcpt render scenes/veach-mis.obj --spp 128 --mesh 4x2
  python -m mcpt render scenes/cornell-box.obj --resume ckpt.npz
  python -m mcpt inverse scenes/cornell-box.obj --target target.png
  python -m mcpt info scenes/bathroom-stress.obj
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("scene", help="path to .obj (with .mtl/.xml siblings)")
    p.add_argument("--width", type=int, default=None, help="override camera width")
    p.add_argument("--height", type=int, default=None, help="override camera height")
    p.add_argument("--spp", type=int, default=64, help="total samples per pixel")
    p.add_argument("--spp-per-pass", type=int, default=None,
                   help="samples per device step (default: min(spp, 16))")
    p.add_argument("--bounces", type=int, default=24,
                   help="max path length (RR starts at bounce 3, Render.cpp:164)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-bvh", action="store_true",
                   help="force brute-force intersection (small scenes)")


def _mesh_arg(spec: str):
    """'4x2' -> ('tiles', 'spp') mesh over the available devices."""
    import jax

    from mcpt.parallel.mesh import make_mesh

    nt, ns = (int(x) for x in spec.lower().split("x"))
    n = nt * ns
    devs = jax.devices()
    if len(devs) < n:
        raise SystemExit(
            f"--mesh {spec} needs {n} devices but only {len(devs)} "
            f"{devs[0].platform} devices are visible; for a virtual CPU mesh "
            f"set XLA_FLAGS=--xla_force_host_platform_device_count={n} and "
            "JAX_PLATFORMS=cpu in the environment BEFORE launching python"
        )
    return make_mesh(nt, ns, devices=devs[:n])


def cmd_render(args) -> int:
    import jax

    from mcpt.io.obj import load_scene
    from mcpt.render.film import checkpoint_load, checkpoint_save, save

    scene = load_scene(args.scene, with_bvh=not args.no_bvh)
    spp_per_pass = args.spp_per_pass or min(args.spp, 16)

    if args.mesh:
        from mcpt.parallel.shard import ShardedRenderer

        r = ShardedRenderer(
            scene, mesh=_mesh_arg(args.mesh), max_bounces=args.bounces,
            spp_per_pass=spp_per_pass, seed=args.seed,
            width=args.width, height=args.height,
        )
    else:
        from mcpt.render.renderer import RenderConfig, Renderer

        r = Renderer(scene, RenderConfig(
            max_bounces=args.bounces, seed=args.seed,
            spp_per_pass=spp_per_pass, width=args.width, height=args.height,
        ))

    if args.resume:
        film, seed, sample_idx = checkpoint_load(args.resume)
        if seed != args.seed:
            # real error, not assert: under `python -O` an assert is stripped
            # and a mismatched resume would silently mix two RNG streams
            raise SystemExit(
                f"checkpoint seed {seed} != --seed {args.seed}; the RNG stream "
                "is keyed on the seed, resuming would mix streams")
        r.film, r.sample_idx = film, sample_idx
        print(f"[render] resumed at {sample_idx} spp from {args.resume}")

    if args.profile:
        jax.profiler.start_trace(args.profile)

    name = os.path.splitext(os.path.basename(args.scene))[0]
    t0 = time.perf_counter()
    first_frame = True
    while r.sample_idx < args.spp:
        prev_spp = r.sample_idx
        r.step()
        spp = r.sample_idx
        dt = r.pass_times[-1]
        if args.live:
            # progressive display in the terminal (the reference's GLFW
            # frame loop, src/main.cpp:21-36; see io/term.py)
            from mcpt.io.term import live_draw

            live_draw(r.film, spp, args.spp, dt * 1e3, first=first_frame)
            first_frame = False
        else:
            print(f"[render] {spp}/{args.spp} spp  {dt * 1e3:.1f} ms/pass",
                  flush=True)
        # trigger on CROSSING a multiple of N: spp advances in
        # spp_per_pass strides, so `spp % N == 0` would silently never
        # fire when N is not a multiple of the stride
        crossed = (args.preview_every
                   and spp // args.preview_every > prev_spp // args.preview_every)
        if crossed and spp < args.spp:
            # progressive-display analog (reference blits the accumulating
            # film every frame, src/main.cpp:26-36): overwrite one preview
            # PNG through the same mean->clamp->gamma-1/2 tonemap as the
            # final save, so convergence can be watched from the filesystem
            pv = args.preview or f"{name}.preview.png"
            save(r.film, pv)
            print(f"[render] preview @ {spp} spp -> {pv}")
        # same crossing test as previews: `spp % N == 0` silently never
        # fires when N is not a multiple of the spp_per_pass stride
        if (args.checkpoint_every
                and spp // args.checkpoint_every
                > prev_spp // args.checkpoint_every):
            ck = args.checkpoint or f"{name}.ckpt.npz"
            checkpoint_save(r.film, ck, args.seed, spp)
            print(f"[render] checkpoint -> {ck}")
    wall = time.perf_counter() - t0

    if args.profile:
        jax.profiler.stop_trace()
        print(f"[render] profiler trace -> {args.profile}")

    out = args.out or f"{name}.obj{r.sample_idx}.png"  # reference naming (Scene.cpp:37)
    save(r.film, out)
    if args.save_radiance:
        import numpy as np

        spp_col = np.maximum(np.asarray(r.film.spp), 1.0)[..., None]
        np.savez(args.save_radiance,
                 radiance=np.asarray(r.film.accum) / spp_col)
        print(f"[render] radiance -> {args.save_radiance}")
    rays = float(r.film.rays)
    stats = {
        "scene": args.scene, "spp": r.sample_idx, "wall_s": round(wall, 3),
        "traced_rays": rays, "mrays_per_s": round(rays / wall / 1e6, 2),
        "nan_scrubbed": int(r.film.nan_count), "out": out,
    }
    print(json.dumps(stats))
    return 0


def cmd_inverse(args) -> int:
    import jax.numpy as jnp
    import numpy as np

    from mcpt.diff.grad import extract_params
    from mcpt.diff.inverse import run_inverse
    from mcpt.io.obj import load_scene

    scene = load_scene(args.scene, with_bvh=not args.no_bvh)
    if args.target.endswith(".npz"):
        target = jnp.asarray(np.load(args.target)["radiance"])
    else:
        from mcpt.io.image import load_png

        # invert the output tonemap (gamma 1/2, Scene.cpp:26-29); PNGs are
        # stored bottom-up (vertical flip at save) so flip back
        target = jnp.asarray(load_png(args.target)[::-1] ** 2.0)
        # A PNG target clamps radiance to [0,1] BEFORE the gamma curve
        # (Scene.cpp:27), so emission (radiance >> 1) is unrecoverable from
        # it; saturated pixels are the telltale. Use an .npz radiance target
        # for emission recovery.
        sat = float((target >= 0.98).mean())
        if sat > 0.001:
            print(
                f"[inverse] WARNING: {sat:.1%} of target pixels are "
                "saturated — the PNG tonemap clamps radiance to [0,1], so "
                "light emission cannot be recovered from this target. "
                "Render the target with --save-radiance (.npz) instead.",
                file=sys.stderr,
            )

    if args.width or args.height:
        import dataclasses as dc

        cam = dc.replace(scene.camera, width=args.width or scene.camera.width,
                         height=args.height or scene.camera.height)
        scene = dc.replace(scene, camera=cam)
    H, W = scene.camera.height, scene.camera.width
    assert target.shape == (H, W, 3), f"target {target.shape} != image {(H, W, 3)}"

    init = extract_params(scene)
    # start: mid-gray albedo; emission from the brightest target pixels —
    # emitters visible in the target carry ~their radiance directly (the
    # bounce-0 shortcut, src/Render.cpp:121-122), and Adam's normalized
    # step cannot cross a 1 -> ~40 scale gap in a 500-step budget
    rad0 = jnp.max(target.reshape(-1, 3), axis=0)
    guess = type(init)(
        kd=jnp.full_like(init.kd, 0.5),
        ks=init.ks,
        radiance=jnp.where(init.radiance > 0, rad0[None, :], 0.0),
    )

    # Identifiability: an emitter's own albedo is unconstrained by the
    # image — its pixels are dominated by emission (~40x reflectance
    # scale) and NEE never samples reflection off it with measurable
    # weight, so its kd gradient is pure noise. Default:
    # freeze emitter kd via param_mask and REPORT it as unconstrained
    # instead of silently emitting a garbage value.
    unconstrained_kd = []
    mask = None
    if not args.optimize_emitter_albedo:
        emissive = np.asarray(init.radiance).max(axis=1) > 0
        if emissive.any():
            unconstrained_kd = [int(i) for i in np.nonzero(emissive)[0]]
            mask = type(init)(
                kd=jnp.asarray(~emissive[:, None], jnp.float32)
                * jnp.ones_like(init.kd),
                ks=jnp.ones_like(init.ks),
                radiance=jnp.ones_like(init.radiance),
            )
            print(f"[inverse] freezing kd of emissive material(s) "
                  f"{unconstrained_kd}: unconstrained by the target "
                  "(pass --optimize-emitter-albedo to override)")

    def progress(i, loss, params):
        print(f"[inverse] step {i}  loss {loss:.3e}", flush=True)

    params, losses = run_inverse(
        scene, target, guess, steps=args.steps, spp=args.spp,
        max_bounces=args.bounces, learning_rate=args.lr, seed=args.seed,
        param_mask=mask,
        progress=progress,
        checkpoint_path=args.checkpoint or "inverse.ckpt.npz",
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        radiance_lr=args.radiance_lr or None,  # 0 -> share --lr
    )
    out = args.out or "inverse_params.npz"
    np.savez(out, kd=np.asarray(params.kd), ks=np.asarray(params.ks),
             radiance=np.asarray(params.radiance), losses=np.asarray(losses),
             unconstrained_kd=np.asarray(unconstrained_kd, np.int32))
    print(json.dumps({"final_loss": losses[-1], "steps": len(losses),
                      "unconstrained_kd_materials": unconstrained_kd,
                      "out": out}))
    return 0


def cmd_info(args) -> int:
    from mcpt.io.obj import load_scene

    scene = load_scene(args.scene, with_bvh=False)
    cam = scene.camera
    info = {
        "scene": args.scene,
        "triangles": scene.num_tris,
        "materials": int(scene.mats.kd.shape[0]),
        "lights": int(scene.light_tris.shape[0]),
        "textures": int(scene.atlas.data.shape[0]) if scene.atlas is not None else 0,
        "camera": {
            "width": cam.width, "height": cam.height, "fovy": float(cam.fovy),
            "eye": [float(x) for x in cam.eye],
            "lookat": [float(x) for x in cam.lookat],
        },
    }
    print(json.dumps(info, indent=2))
    return 0


def main(argv=None) -> int:
    from mcpt.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="mcpt", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="progressive render -> PNG")
    _add_render_args(pr)
    pr.add_argument("--out", default=None, help="output PNG path")
    pr.add_argument("--mesh", default=None,
                    help="TILESxSPP device mesh, e.g. 4x2 (default: single device)")
    pr.add_argument("--live", action="store_true",
                    help="progressive ANSI preview in the terminal after "
                         "every pass (the reference's GLFW display loop, "
                         "src/main.cpp:21-36, without a display server)")
    pr.add_argument("--preview-every", type=int, default=0,
                    help="write a tonemapped preview PNG every N spp (the "
                         "reference's progressive display, src/main.cpp:26-36)")
    pr.add_argument("--preview", default=None,
                    help="preview PNG path (default <scene>.preview.png)")
    pr.add_argument("--checkpoint", default=None, help="checkpoint path (.npz)")
    pr.add_argument("--checkpoint-every", type=int, default=0,
                    help="write a resumable checkpoint every N spp")
    pr.add_argument("--resume", default=None, help="resume from checkpoint (.npz)")
    pr.add_argument("--profile", default=None,
                    help="write a jax.profiler trace to this directory")
    pr.add_argument("--save-radiance", default=None, metavar="PATH",
                    help="also write the linear mean radiance as .npz "
                         "(unclamped; the sound target for `inverse`)")
    pr.set_defaults(fn=cmd_render)

    pi = sub.add_parser("inverse", help="inverse rendering (recover kd/emission)")
    _add_render_args(pi)
    pi.add_argument("--target", required=True, help="target image (.png or .npz)")
    pi.add_argument("--steps", type=int, default=500)
    pi.add_argument("--lr", type=float, default=2e-2)
    pi.add_argument("--radiance-lr", type=float, default=0.2,
                    help="separate Adam rate for emission (radiance lives "
                         "on a ~40x larger scale than reflectance; 0 = "
                         "share --lr)")
    pi.add_argument("--out", default=None, help="output params .npz")
    pi.add_argument("--checkpoint", default=None,
                    help="optimizer-state checkpoint path (.npz, default "
                         "inverse.ckpt.npz)")
    pi.add_argument("--checkpoint-every", type=int, default=0,
                    help="write the full Adam state every N steps")
    pi.add_argument("--resume", default=None,
                    help="resume from an optimizer-state checkpoint")
    pi.add_argument("--optimize-emitter-albedo", action="store_true",
                    help="also optimize the albedo of emissive materials "
                         "(default: frozen + reported as unconstrained — "
                         "an emitter's kd is unidentifiable from the image)")
    pi.set_defaults(fn=cmd_inverse, spp=4, bounces=6)

    pn = sub.add_parser("info", help="print scene statistics")
    pn.add_argument("scene")
    pn.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
