"""Host-side BVH construction -> flattened skip-link arrays.

Replaces the reference's pointer-based recursive BVH (src/BVH.cpp:15-54):
same split policy (midpoint of the centroid bbox's longest axis, median-index
fallback on degenerate partitions, reference src/BVH.cpp:34-49) but emitted as
flat arrays in DFS (preorder) order for stackless device traversal:

  * AABB hit  -> next node is i+1 (left child directly follows its parent)
  * AABB miss -> next node is skip[i] (the preorder index just past node i's
    subtree, the classic "escape index"); skip == -1 terminates
  * leaf -> triangles [first[i], first[i]+count[i]) of the *reordered* buffer

Triangles are reordered so every leaf is a contiguous range, turning leaf
tests into dense vector loads instead of pointer chasing.

Build runs in numpy by default; the optional C++ builder (mcpt/native)
accelerates million-triangle scenes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from mcpt.scene import FlatBVH, Scene, permute_scene_tris

# Reference leaf threshold is 5 (src/BVH.h:32); we use 4 so the device-side
# leaf loop unrolls to a power-of-two lane count.
DEFAULT_LEAF_SIZE = 4


def build_bvh_arrays(
    v0: np.ndarray,
    e1: np.ndarray,
    e2: np.ndarray,
    leaf_size: int = DEFAULT_LEAF_SIZE,
    use_native: bool = True,
) -> Tuple[dict, np.ndarray]:
    """Build the flattened BVH.

    Returns (nodes, perm): `nodes` is a dict of arrays {lo, hi, first, count,
    skip}; `perm` is the triangle permutation such that leaf ranges index the
    reordered buffer tri_new[k] = tri_old[perm[k]].
    """
    if use_native:
        try:
            from mcpt.native.bvh_native import build_bvh_native

            return build_bvh_native(v0, e1, e2, leaf_size)
        except Exception as e:  # noqa: BLE001 — degrade, but loudly
            import warnings

            warnings.warn(
                "native BVH builder unavailable, falling back to the ~15x "
                f"slower numpy builder: {type(e).__name__}: {e}",
                RuntimeWarning,
                stacklevel=2,
            )
    return _build_bvh_numpy(v0, e1, e2, leaf_size)


def _build_bvh_numpy(v0, e1, e2, leaf_size):
    T = v0.shape[0]
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    tri_lo = np.minimum(np.minimum(p0, p1), p2)
    tri_hi = np.maximum(np.maximum(p0, p1), p2)
    centroid = (p0 + p1 + p2) / 3.0  # reference Triangle::center (Triangle.cpp:30-33)

    order = np.arange(T)
    lo, hi, first, count = [], [], [], []

    # Iterative preorder DFS (explicit frames, no Python recursion limit).
    # frame = [l, r, node_idx, phase, split]; phases: 0=enter, 1=left child
    # done, 2=right child done (record subtree extent).
    subtree_end = []  # preorder index just past node i's subtree
    frames = [[0, T, -1, 0, -1]]
    while frames:
        f = frames[-1]
        l, r, idx, phase, m = f
        if phase == 0:
            idx = len(lo)
            f[2] = idx
            seg = order[l:r]
            lo.append(tri_lo[seg].min(axis=0))
            hi.append(tri_hi[seg].max(axis=0))
            subtree_end.append(0)
            if r - l <= leaf_size:
                first.append(l)
                count.append(r - l)
                subtree_end[idx] = idx + 1
                frames.pop()
                continue
            first.append(0)
            count.append(0)
            # Midpoint split on the centroid bbox's longest axis
            # (reference src/BVH.cpp:34-44).
            c = centroid[seg]
            c_lo, c_hi = c.min(axis=0), c.max(axis=0)
            axis = int(np.argmax(c_hi - c_lo))
            mid_val = 0.5 * (c_lo[axis] + c_hi[axis])
            mask = c[:, axis] < mid_val
            m = l + int(mask.sum())
            if m == l or m == r:  # degenerate -> median split (BVH.cpp:47-49)
                key = np.argsort(c[:, axis], kind="stable")
                order[l:r] = seg[key]
                m = (l + r) // 2
            else:
                order[l:r] = np.concatenate([seg[mask], seg[~mask]])
            f[3], f[4] = 1, m
            frames.append([l, m, -1, 0, -1])
        elif phase == 1:
            f[3] = 2
            frames.append([m, r, -1, 0, -1])
        else:
            subtree_end[idx] = len(lo)
            frames.pop()

    n = len(lo)
    skip = np.asarray(subtree_end, np.int64)
    skip = np.where(skip >= n, -1, skip).astype(np.int32)
    nodes = {
        "lo": np.asarray(lo, np.float32),
        "hi": np.asarray(hi, np.float32),
        "first": np.asarray(first, np.int32),
        "count": np.asarray(count, np.int32),
        "skip": skip,
    }
    return nodes, order.astype(np.int64)


def attach_bvh(
    scene: Scene,
    leaf_size: int = DEFAULT_LEAF_SIZE,
    use_native: bool = True,
    to_device: bool = True,
) -> Scene:
    """Build a BVH for `scene`, reorder its triangles, attach flat arrays.

    Build and triangle permutation happen in numpy; with `to_device=True`
    the finished scene moves to the device in one batched transfer
    (scene.scene_to_device).
    """
    from mcpt.scene import scene_to_device

    v0 = np.asarray(scene.geom.v0, np.float64)
    e1 = np.asarray(scene.geom.e1, np.float64)
    e2 = np.asarray(scene.geom.e2, np.float64)
    nodes, perm = build_bvh_arrays(v0, e1, e2, leaf_size, use_native=use_native)
    scene = permute_scene_tris(scene, perm)
    bvh = FlatBVH(
        lo=np.asarray(nodes["lo"], np.float32),
        hi=np.asarray(nodes["hi"], np.float32),
        first=np.asarray(nodes["first"], np.int32),
        count=np.asarray(nodes["count"], np.int32),
        skip=np.asarray(nodes["skip"], np.int32),
    )
    scene = dataclasses.replace(scene, bvh=bvh)
    return scene_to_device(scene) if to_device else scene


def validate_bvh(nodes: dict, perm: np.ndarray, tri_lo, tri_hi) -> None:
    """Structural sanity checks (used by tests and the native-builder oracle)."""
    n = nodes["lo"].shape[0]
    count = nodes["count"]
    first = nodes["first"]
    skip = nodes["skip"]
    covered = np.zeros(perm.shape[0], bool)
    for i in range(n):
        if count[i] > 0:
            seg = slice(first[i], first[i] + count[i])
            assert not covered[seg].any(), "leaf ranges overlap"
            covered[seg] = True
            lo_t = tri_lo[perm[seg]]
            hi_t = tri_hi[perm[seg]]
            assert (nodes["lo"][i] <= lo_t.min(axis=0) + 1e-5).all()
            assert (nodes["hi"][i] >= hi_t.max(axis=0) - 1e-5).all()
        assert skip[i] == -1 or (skip[i] > i and skip[i] <= n)
    assert covered.all(), "not all triangles referenced by leaves"
