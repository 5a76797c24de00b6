#!/usr/bin/env python
"""Benchmarks on the attached GPU.

Default: cornell-box 1024x1024, 64 spp — prints ONE JSON line (this stays
the LAST stdout line in every mode):
  {"metric": "Mrays/s/chip", "value": N, "unit": "Mrays/s",
   "platform": "gpu", "device_kind": "...", "device_count": N, ...}

--suite: all five BASELINE.json configs — one JSON line per config (stdout),
headline cornell line last. --quick divides the measured spp by 8
(throughput is steady-state per-pass, so Mrays/s is unaffected;
time-to-image is extrapolated to the full spp).

Every line names the device it ran on. Off the GPU the script prints no
metric line and exits non-zero: a CPU number is never reported as a
device rate.

Ray accounting is honest traced work: 1 primary ray per sample plus
(1 path + 1 shadow) ray per active bounce, measured on-device by the
integrator's instrumented counters — not max_bounces * R.

Usage: python bench.py [--width 1024] [--height 1024] [--spp 64]
                       [--scene scenes/cornell-box.obj] [--bounces 24]
       python bench.py --suite [--quick]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def bench_render(scene_path, width, height, spp, bounces, spp_per_pass=None,
                 save=None, spp_measure=None):
    """Render benchmark for one config; returns a result dict.

    `spp_measure` (if set) is the spp actually rendered for timing;
    time_to_image_s is extrapolated linearly to the requested `spp`.
    """
    import jax

    from mcpt.io.obj import load_scene
    from mcpt.render.renderer import RenderConfig, Renderer

    t0 = time.perf_counter()
    scene = load_scene(scene_path, with_bvh=True)
    load_s = time.perf_counter() - t0
    dev = jax.devices()[0]
    measured = spp_measure or spp
    if spp_per_pass is None:
        spp_per_pass = min(64, measured)
    sys.stderr.write(
        f"[bench] device: {dev}, scene: {scene_path} tris: {scene.num_tris} "
        f"(load {load_s:.1f}s)\n"
    )

    r = Renderer(
        scene,
        RenderConfig(
            max_bounces=bounces,
            width=width,
            height=height,
            spp_per_pass=spp_per_pass,
            seed=0,
        ),
    )

    # warmup + compile (ray counts accumulate on-device in film.rays)
    t0 = time.perf_counter()
    r.step()
    compile_s = time.perf_counter() - t0

    # Measurement protocol: >= 3 timed repetitions (one pass each), report
    # the MEDIAN per-pass rate with min/max — a single timed rep is not
    # evidence. Renderer.step() already waits for the device per pass, so
    # per-pass timing adds no extra round trips.
    n_passes = max(3, measured // spp_per_pass - 1)
    rates, pass_times = [], []
    for _ in range(n_passes):
        rays0 = float(r.film.rays)
        t0 = time.perf_counter()
        r.step()
        dt_i = time.perf_counter() - t0
        pass_times.append(dt_i)
        rates.append((float(r.film.rays) - rays0) / dt_i / 1e6)

    def median(xs):
        s = sorted(xs)
        m = len(s) // 2
        return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])

    srt = sorted(rates)
    mrays = median(rates)
    dt = sum(pass_times)
    ms_pass = median(pass_times) * 1e3
    time_to_image = (spp / spp_per_pass) * ms_pass / 1e3
    sys.stderr.write(
        f"[bench] {n_passes} passes in {dt:.3f}s "
        f"(median {ms_pass:.1f} ms/pass, {mrays:.1f} Mrays/s "
        f"[min {srt[0]:.1f}, max {srt[-1]:.1f}], "
        f"time-to-image {time_to_image:.2f}s @ {spp}spp, "
        f"nan={int(r.film.nan_count)}, compile {compile_s:.1f}s)\n"
    )
    if save:
        r.save(save)

    return {
        "scene": os.path.basename(scene_path),
        "width": width,
        "height": height,
        "spp": spp,
        "spp_measured": measured,
        "bounces": bounces,
        "mrays_per_s": round(mrays, 2),
        "mrays_min": round(srt[0], 2),
        "mrays_max": round(srt[-1], 2),
        "reps": n_passes,
        "ms_per_pass": round(ms_pass, 1),
        "time_to_image_s": round(time_to_image, 2),
        "scene_load_s": round(load_s, 1),
        "compile_s": round(compile_s, 1),
        "nan_scrubbed": int(r.film.nan_count),
    }


def bench_inverse(steps_measure=25, steps_full=500, res=256, spp=4,
                  full: bool = False):
    """Inverse-rendering config (BASELINE #5): recover cornell-box albedo
    + light emission with Adam from an .npz-style radiance target.

    `full=True` runs ALL `steps_full` steps and reports per-parameter
    recovery error (max |kd - kd*|, max relative |radiance - radiance*|)
    plus a subsampled loss curve — the demonstrated convergence artifact,
    not an extrapolation. Quick mode times `steps_measure` steps and
    extrapolates wall time only.
    """
    import dataclasses as dc

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcpt.diff.grad import SceneParams, extract_params, render_image
    from mcpt.diff.inverse import make_inverse_step
    from mcpt.io.obj import load_scene

    scene = load_scene("scenes/cornell-box.obj", with_bvh=True)
    cam = dc.replace(scene.camera, width=res, height=res)
    scene = dc.replace(scene, camera=cam)
    # synthetic target: forward render at the true parameters (the
    # unclamped-radiance analog of `render --save-radiance`)
    key = jax.random.PRNGKey(7)
    params0 = extract_params(scene)
    target = render_image(params0, scene, key, spp, 6)
    target = jax.block_until_ready(target)

    # optimize kd (all materials) + radiance (emitters); ks/dverts frozen
    mask = SceneParams(
        kd=jnp.ones_like(params0.kd),
        ks=jnp.zeros_like(params0.ks),
        radiance=jnp.where(
            jnp.linalg.norm(params0.radiance, axis=-1, keepdims=True) > 0.01,
            1.0, 0.0,
        ) * jnp.ones_like(params0.radiance),
    )
    init, step_fn = make_inverse_step(
        scene, target, spp=spp, max_bounces=6, param_mask=mask,
        radiance_lr=0.2,
    )
    # start: mid-gray albedo; emission initialized from the brightest
    # target pixels — emitters visible in the target carry ~their radiance
    # directly (the bounce-0 shortcut, src/Render.cpp:121-122), so the
    # target max is a principled first estimate that Adam fine-tunes
    rad0 = jnp.max(target.reshape(-1, 3), axis=0)
    guess = SceneParams(
        kd=jnp.full_like(params0.kd, 0.5),
        ks=params0.ks,
        radiance=jnp.where(params0.radiance > 0, rad0[None, :], 0.0),
        # vertices are NOT optimized in this config: carrying dverts
        # would differentiate every pixel w.r.t. every vertex (the heavy
        # backward) only to mask the result to zero
        dverts=None,
    )
    state = init(guess)
    t0 = time.perf_counter()
    state, loss = step_fn(state, key)
    loss = float(loss)  # sync
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    losses = []
    n_steps = steps_full if full else steps_measure
    for i in range(n_steps - 1):
        state, loss = step_fn(state, key)
        if (i + 1) % 10 == 0:
            losses.append(float(loss))  # sync every 10 (bounds queue depth)
    loss = float(loss)
    dt = time.perf_counter() - t0
    steps_per_s = (n_steps - 1) / dt

    out = {
        "scene": "cornell-box.obj",
        "config": f"inverse {res}x{res} {spp}spp Adam",
        "steps_measured": n_steps,
        "steps_per_s": round(steps_per_s, 2),
        "wall_500_steps_s": round(steps_full / steps_per_s, 1),
        "final_loss": loss,
        "compile_s": round(compile_s, 1),
    }
    if full:
        emissive = np.linalg.norm(np.asarray(params0.radiance), axis=-1) > 0.01
        kd_err_all = np.abs(
            np.asarray(state.params.kd) - np.asarray(params0.kd)
        )
        # the emitter's own albedo is near-unidentifiable (its pixels are
        # dominated by emission ~40x any reflected term), so the recovery
        # criterion is the OBSERVABLE materials; the full number is
        # reported alongside
        kd_err = float(kd_err_all[~emissive].max())
        rad_true = np.asarray(params0.radiance)[emissive]
        rad_got = np.asarray(state.params.radiance)[emissive]
        # relative error over channels the emitter actually has (a colored
        # light's zero channel would divide by zero)
        lit = rad_true > 1e-6
        rad_rel = float(
            np.max(np.abs(rad_got[lit] - rad_true[lit]) / rad_true[lit])
        )
        out.update({
            "recovered": True,
            "kd_err_inf_nonemissive": round(kd_err, 4),
            "kd_err_inf_incl_emitter_albedo": round(float(kd_err_all.max()), 4),
            "kd_err_per_material": [round(float(x), 4) for x in kd_err_all.max(axis=1)],
            "radiance_rel_err_inf": round(rad_rel, 4),
            "loss_curve_every10": [round(x, 6) for x in losses],
        })
    return out


# The five BASELINE.json configs ("configs" list; see BASELINE.md).
# quick_spp: spp actually measured under --quick (throughput is
# steady-state per-pass, so Mrays/s is unaffected; time-to-image
# extrapolates linearly). Bathroom (1M tris through the BVH walk) gets the
# smallest sample and runs last, as the slowest config. The headline
# metric line is re-printed after the loop either way.
SUITE = [
    dict(name="cornell-512-16", scene="scenes/cornell-box.obj",
         width=512, height=512, spp=16, bounces=4, quick_spp=16),
    dict(name="veach-mis-1024-128", scene="scenes/veach-mis.obj",
         width=1024, height=1024, spp=128, bounces=24, quick_spp=16),
    dict(name="inverse-500", inverse=True),
    dict(name="cornell-1024-64", scene="scenes/cornell-box.obj",
         width=1024, height=1024, spp=64, bounces=24, quick_spp=8,
         headline=True),
    dict(name="bathroom-1280x720-256", scene="scenes/bathroom-stress.obj",
         width=1280, height=720, spp=256, bounces=24, quick_spp=8),
]


def device_fields() -> dict:
    """platform / device_kind / device_count of the default backend."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices())}


def metric_line(res: dict, dev: dict) -> str:
    return json.dumps({
        "metric": "Mrays/s/chip",
        "value": res["mrays_per_s"],
        "unit": "Mrays/s",
        "min": res.get("mrays_min"),
        "max": res.get("mrays_max"),
        "reps": res.get("reps"),
        **dev,
    })


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="scenes/cornell-box.obj")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--bounces", type=int, default=24)
    ap.add_argument("--spp-per-pass", type=int, default=None)
    ap.add_argument("--save", default=None, help="optionally save the PNG")
    ap.add_argument("--suite", action="store_true",
                    help="run all five BASELINE configs")
    ap.add_argument("--quick", action="store_true",
                    help="suite: measure spp/8, extrapolate time-to-image")
    ap.add_argument("--full-inverse", action="store_true",
                    help="suite: run ALL 500 inverse steps and report "
                         "per-parameter recovery error even under --quick")
    args = ap.parse_args()

    from mcpt.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = device_fields()
    if dev["platform"] != "gpu":
        sys.stderr.write(
            f"[bench] no GPU: the default JAX backend is {dev['platform']}; "
            "refusing to report a device rate\n"
        )
        sys.exit(2)

    if not args.suite:
        res = bench_render(
            args.scene, args.width, args.height, args.spp, args.bounces,
            spp_per_pass=args.spp_per_pass, save=args.save,
        )
        print(metric_line(res, dev))
        return

    headline = None
    for cfg in SUITE:
        try:
            if cfg.get("inverse"):
                # quick: timing extrapolation; full / --full-inverse: the
                # demonstrated 500-step recovery with per-parameter error
                res = bench_inverse(
                    steps_measure=5 if args.quick else 25,
                    full=(not args.quick) or args.full_inverse,
                )
            else:
                spp_measure = None
                if args.quick:
                    spp_measure = cfg.get("quick_spp", max(8, cfg["spp"] // 8))
                res = bench_render(
                    cfg["scene"], cfg["width"], cfg["height"], cfg["spp"],
                    cfg["bounces"], spp_measure=spp_measure,
                )
        except Exception as e:  # noqa: BLE001 — record, keep going
            res = {"error": f"{type(e).__name__}: {e}"}
        res["config"] = cfg["name"]
        res.update(dev)
        if cfg.get("headline"):
            headline = res
        print(json.dumps(res), flush=True)

    if headline and "mrays_per_s" in headline:
        print(metric_line(headline, dev))


if __name__ == "__main__":
    main()
