"""A/B timings of the pass and wavefront shapes inherited from the first
implementation.

Each pair runs in this one process, in turns (A, B, B, A), at real sizes:

  chunked     render_pass (one program) vs render_pass_chunked (one
              program per 32,768-lane chunk), cornell 1024^2 x 16 spp
  split       MCPT_WAVEFRONT loop vs split, bathroom 1280x720 x 1 spp

The dense-intersection (Woop matmul vs Moller-Trumbore) and gather
(one-hot product vs jnp.take) pairs were measured the same way before
the slower of each was removed; their numbers are in PERF.md.

Usage: python tools/ab_hotpath.py [--only chunked,split]
                                  [--out results.json]
Times are host wall clock around work that ends in block_until_ready;
every line carries the device. Report them with the card's name and power
limit (nvidia-smi).
"""
import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def _median_time(fn, reps):
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), min(ts), max(ts)


def abba(name, run_a, run_b, label_a, label_b, rows):
    """run_x() -> (median, min, max) seconds; order A, B, B, A."""
    res = {label_a: [], label_b: []}
    for lab, fn in ((label_a, run_a), (label_b, run_b), (label_b, run_b),
                    (label_a, run_a)):
        res[lab].append(fn())
    for lab in (label_a, label_b):
        meds = [r[0] for r in res[lab]]
        row = {"case": name, "variant": lab, "median_s": meds,
               "min_s": min(r[1] for r in res[lab]),
               "max_s": max(r[2] for r in res[lab])}
        rows.append(row)
        print(json.dumps(row), flush=True)


def case_chunked(rows, reps, size):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke as cs
    from mcpt.render.film import make_film
    from mcpt.render.renderer import render_pass, render_pass_chunked

    sc = cs.load("cornell-box", size, size)
    key = jax.random.PRNGKey(0)
    start = jnp.asarray(0, jnp.int32)

    def runner(fn):
        def run():
            jax.block_until_ready(fn(sc, make_film(size, size), key, start, 24, 16))
            return _median_time(
                lambda: fn(sc, make_film(size, size), key, start, 24, 16), reps)

        return run

    a = render_pass(sc, make_film(size, size), key, start, 24, 16)
    b = render_pass_chunked(sc, make_film(size, size), key, start, 24, 16)
    if not np.array_equal(np.asarray(a.accum), np.asarray(b.accum)):
        raise AssertionError("chunked pass differs from the one-program pass")
    abba(f"cornell {size}^2 x 16 spp pass", runner(render_pass),
         runner(render_pass_chunked), "one-program", "chunked", rows)


def case_split(rows, reps, scene_name):
    """Each mode's first pass includes its compile; later passes run only
    when the first is short."""
    import jax

    import chip_smoke as cs
    from mcpt.render.renderer import RenderConfig, Renderer

    sc = cs.load(scene_name)
    for mode in ("loop", "split"):
        os.environ["MCPT_WAVEFRONT"] = mode
        r = Renderer(sc, RenderConfig(max_bounces=24, spp_per_pass=1, seed=0))
        t0 = time.perf_counter()
        r.step()
        first = time.perf_counter() - t0
        ts = []
        if first < 60:
            for _ in range(reps):
                r.step()
                ts.append(r.pass_times[-1])
        cam = sc.camera
        row = {"case": f"{scene_name} {cam.width}x{cam.height} x 1 spp pass",
               "variant": mode,
               "first_pass_s_incl_compile": first, "passes_s": ts}
        rows.append(row)
        print(json.dumps(row), flush=True)
        jax.clear_caches()
    os.environ.pop("MCPT_WAVEFRONT")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="chunked,split")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--size", type=int, default=1024,
                    help="cornell image side for the render-pass cases")
    ap.add_argument("--split-scene", default="bathroom-stress")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    from mcpt.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    info = {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}
    print(json.dumps(info), flush=True)
    rows = []
    cases = {
        "chunked": lambda: case_chunked(rows, args.reps, args.size),
        "split": lambda: case_split(rows, 1, args.split_scene),
    }
    for name in args.only.split(","):
        t0 = time.perf_counter()
        cases[name]()
        print(f"[ab] {name} took {time.perf_counter() - t0:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": info, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
