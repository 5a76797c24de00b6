"""Apportion one wavefront-render chunk's device time by XLA op.

Captures a jax.profiler trace of ONE 32k-lane chunk execution (spp=1) and
aggregates the GPU device lanes' event durations by op name, printing the
cost breakdown (intersection / gathers / integrator shell), plus the
wavefront iteration count so costs normalize to per-iteration.

Usage: python tools/profile_pass.py [scene.obj] [--spp N] [--bounces N]
       [--chunk N] [--trace-dir DIR]
"""
import argparse
import collections
import glob
import gzip
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default="scenes/bathroom-stress.obj")
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--bounces", type=int, default=24)
    ap.add_argument("--chunk", type=int, default=32768)
    ap.add_argument("--trace-dir", default="mcpt_profile")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mcpt.compile_cache import enable_compile_cache

    enable_compile_cache()
    print("device:", jax.devices()[0])

    from mcpt.io.obj import load_scene
    from mcpt.render.renderer import _render_chunk

    t0 = time.perf_counter()
    scene = load_scene(args.scene, with_bvh=True)
    jax.block_until_ready(scene.geom.v0)
    print(f"load: {time.perf_counter() - t0:.1f}s tris={scene.num_tris}")

    R = args.chunk
    pidx = jnp.arange(R, dtype=jnp.int32)
    lane_valid = jnp.ones((R,), bool)
    key = jax.random.PRNGKey(0)
    start = jnp.asarray(0, jnp.int32)

    def run():
        out = _render_chunk(
            scene, pidx, lane_valid, key, start, args.bounces, args.spp
        )
        return jax.tree_util.tree_map(np.asarray, out)

    t0 = time.perf_counter()
    L, nrays, nan_ct, iters = run()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    L, nrays, nan_ct, iters = run()
    exec_s = time.perf_counter() - t0
    iters = int(iters)
    nrays = int(nrays)
    print(
        f"chunk: {exec_s * 1e3:.1f} ms (compile {compile_s:.1f}s), "
        f"{iters} wavefront iterations = {exec_s / max(iters, 1) * 1e3:.2f} "
        f"ms/iter, {nrays} rays -> {nrays / exec_s / 1e6:.2f} Mrays/s"
    )

    # ---- capture one traced execution ----
    os.makedirs(args.trace_dir, exist_ok=True)
    jax.profiler.start_trace(args.trace_dir, create_perfetto_trace=True)
    run()
    jax.profiler.stop_trace()

    traces = sorted(
        glob.glob(os.path.join(args.trace_dir, "**", "perfetto_trace.json.gz"),
                  recursive=True),
        key=os.path.getmtime,
    )
    if not traces:
        print("NO TRACE FILE FOUND — profiler unsupported on this backend?")
        return
    with gzip.open(traces[-1]) as f:
        d = json.load(f)
    ev = d["traceEvents"]
    pids = {}
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pids[e["pid"]] = e["args"].get("name", "")
    dev_pids = {p for p, n in pids.items() if "GPU" in (n or "")}
    tid_names = {}
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tid_names[(e["pid"], e.get("tid"))] = e["args"].get("name", "")
    # SELF time per event: XLA loop ops (while/scan) and jit wrappers
    # envelope their body ops on the same track, so raw durations double
    # count. Sort each track's events by (start, -dur) and subtract each
    # event's direct children with a nesting stack.
    tracks = collections.defaultdict(list)
    for e in ev:
        if e.get("ph") == "X" and e.get("pid") in dev_pids and "dur" in e:
            # the 'XLA Modules' track is a pure envelope of 'XLA Ops'
            # (counting both doubles every cost)
            if "Modules" in tid_names.get((e["pid"], e.get("tid")), ""):
                continue
            tracks[(e["pid"], e.get("tid"))].append(
                (e["ts"], -e["dur"], e["name"])
            )
    tot = collections.Counter()
    total = 0.0
    for track in tracks.values():
        track.sort()
        flat = []

        def flush(fr):
            _end, name, child, _ts, dur = fr
            flat.append((name, max(dur - child, 0.0)))

        stack = []  # [end_ts, name, child_dur_sum, start_ts, dur]
        for ts, ndur, name in track:
            dur = -ndur
            while stack and stack[-1][0] <= ts:
                flush(stack.pop())
            if stack:
                stack[-1][2] += dur  # direct child of the enclosing event
            stack.append([ts + dur, name, 0.0, ts, dur])
        while stack:
            flush(stack.pop())
        for name, s in flat:
            tot[name] += s
            total += s
    print(f"\ndevice SELF time by op ({total / 1e3:.1f} ms total on device):")
    for name, dur in tot.most_common(args.top):
        per_iter = dur / max(iters, 1)
        print(f"{dur / 1e3:9.2f} ms {dur / total * 100:5.1f}%  "
              f"{per_iter:8.1f} us/iter  {name[:90]}")


if __name__ == "__main__":
    main()
