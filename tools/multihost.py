"""Two-process jax.distributed rendering demo (DCN-shaped collectives).

The reference is single-process shared-memory OpenMP (src/Render.cpp:60-68);
the multi-HOST path is the same shard_map program compiled over a global
mesh whose devices live in different processes — collectives cross the
process boundary exactly like they cross the network between GPU hosts.

Run: python tools/multihost.py
Parent spawns 2 child processes (1 CPU device each -> 2 global devices).
Each child renders a sharded cornell frame over the global ('tiles', 'spp')
mesh, then process 0 re-renders its OWN film rows on a local single-device
mesh and checks bitwise equality (the counter-based RNG makes the sharded
result independent of the decomposition). Exit 0 + "MULTIHOST OK" = pass.
"""
from __future__ import annotations

import os
import subprocess
import sys

PORT = int(os.environ.get("MCPT_MULTIHOST_PORT", "39217"))
W, H, SPP, BOUNCES = 32, 16, 2, 3


def child(pid: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{PORT}", num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2, jax.process_count()
    n = len(jax.devices())
    assert n == 2, f"expected 2 global devices, got {n}"

    import dataclasses as dc

    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from mcpt.io.obj import load_scene
    from mcpt.parallel.mesh import make_mesh
    from mcpt.parallel.shard import ShardedRenderer

    scene = load_scene(
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scenes",
            "cornell-box.obj",
        ),
        with_bvh=False,
    )
    cam = dc.replace(scene.camera, width=W, height=H)
    scene = dc.replace(scene, camera=cam)

    # global mesh: 2 tiles x 1 spp, one device per process
    mesh = make_mesh(2, 1, devices=jax.devices())
    sr = ShardedRenderer(scene, mesh=mesh, max_bounces=BOUNCES, spp_per_pass=SPP, seed=0)
    sr.render(SPP)
    # each process holds its own film rows in STORAGE order (compact
    # interleaved assignment: tile pid renders image rows pid, pid+2, ...
    # — parallel/shard.py module docstring); pull the addressable shard
    local_rows = [s.data for s in sr._film.accum.addressable_shards]
    assert len(local_rows) == 1
    got = np.asarray(local_rows[0])

    # oracle: the same (interleaved) rows rendered on a LOCAL single-device
    # mesh — full frame in image order, strided slice for this tile
    local_mesh = make_mesh(1, 1, devices=jax.local_devices())
    sr1 = ShardedRenderer(scene, mesh=local_mesh, max_bounces=BOUNCES, spp_per_pass=SPP, seed=0)
    film1 = sr1.render(SPP)
    want = np.asarray(film1.accum)[pid::2]

    if not np.array_equal(got, want):
        print(f"[child {pid}] MISMATCH: max abs diff {np.abs(got - want).max()}")
        sys.exit(1)
    print(f"[child {pid}] rows {pid}::2 bitwise equal to local oracle")
    sys.exit(0)


def main() -> None:
    if "--child" in sys.argv:
        child(int(sys.argv[sys.argv.index("--child") + 1]))
        return
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # 1 CPU device per process
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", str(i)], env=env
        )
        for i in range(2)
    ]
    codes = [p.wait(timeout=600) for p in procs]
    if any(codes):
        print(f"MULTIHOST FAIL: exit codes {codes}")
        sys.exit(1)
    print("MULTIHOST OK: 2-process jax.distributed render bitwise-matches local oracle")


if __name__ == "__main__":
    main()
