"""Edge-aware (visibility) vertex gradients: diff/edge.py validation.

The single-occluder scene where the detached estimator is provably wrong:
a quad occluder floats between an area light and a diffuse floor, OUTSIDE
the camera frustum. Moving the occluder sideways sweeps its penumbra
across the floor — the true expected-image derivative is large — but
every smooth factor the detached estimator differentiates (light sample
geometry, BRDFs, pdfs) is INDEPENDENT of the occluder position: the
whole derivative lives in the visibility discontinuity. So:

  * detached AD gradient  ~ 0                (the failing baseline)
  * detached AD + boundary-sampling edge term ~ finite-difference truth

FD here is the derivative of the EXPECTED image: at fixed seed, small
eps, and thousands of (pixel-jitter x light-sample) draws, the fraction
of samples whose shadow ray flips is proportional to eps and densely
sampled, so the central difference converges to the true derivative.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcpt.diff.grad import extract_params, render_image


def _write_occluder_scene(dirp):
    # floor y=0 (2 tris), occluder quad y=0.75 (2 tris), light y=1.5
    obj = ["mtllib occ.mtl"]
    verts = [
        # floor 0..3
        (0.0, 0.0, 0.0), (2.0, 0.0, 0.0), (2.0, 0.0, 2.0), (0.0, 0.0, 2.0),
        # occluder 4..7
        (0.85, 0.75, 0.85), (1.15, 0.75, 0.85),
        (1.15, 0.75, 1.15), (0.85, 0.75, 1.15),
        # light 8..11 (q0 + eu + ev corners)
        (0.9, 1.5, 0.9), (1.1, 1.5, 0.9), (1.1, 1.5, 1.1), (0.9, 1.5, 1.1),
    ]
    for v in verts:
        obj.append(f"v {v[0]} {v[1]} {v[2]}")
    obj.append("vn 0.0 1.0 0.0")
    obj.append("vn 0.0 -1.0 0.0")
    obj.append("usemtl white")
    obj += ["f 1//1 3//1 2//1", "f 1//1 4//1 3//1"]
    obj.append("usemtl occ")
    obj += ["f 5//2 7//2 6//2", "f 5//2 8//2 7//2"]
    obj.append("usemtl light")
    obj += ["f 9//2 11//2 10//2", "f 9//2 12//2 11//2"]
    with open(os.path.join(dirp, "occ.obj"), "w") as f:
        f.write("\n".join(obj) + "\n")
    with open(os.path.join(dirp, "occ.mtl"), "w") as f:
        f.write("newmtl white\nKd 0.75 0.75 0.75\n\n"
                "newmtl occ\nKd 0.6 0.6 0.6\n\n"
                "newmtl light\nKd 0.5 0.5 0.5\n")
    with open(os.path.join(dirp, "occ.xml"), "w") as f:
        f.write(
            '<camera type="perspective" width="16" height="16" fovy="40">\n'
            '  <eye x="1.0" y="0.45" z="-0.9"/>\n'
            '  <lookat x="1.0" y="0.0" z="0.9"/>\n'
            '  <up x="0.0" y="1.0" z="0.0"/>\n'
            "</camera>\n"
            '<light mtlname="light" radiance="30,30,30"/>\n'
        )
    return os.path.join(dirp, "occ.obj")


@pytest.mark.slow
def test_edge_term_recovers_occluder_gradient(tmp_path):
    from mcpt.diff.edge import nee_visibility_edge_grad
    from mcpt.io.obj import load_scene
    from mcpt.ops.intersect import closest_hit
    from mcpt.render.camera import generate_rays

    scene = load_scene(_write_occluder_scene(str(tmp_path)), with_bvh=True)
    H = W = 16
    spp, bounces = 256, 1  # direct lighting only
    key = jax.random.PRNGKey(3)
    params0 = extract_params(scene)
    assert params0.dverts is not None

    # occluder shared-vertex ids (material index 1 = "occ" by MTL order)
    occ_tris = np.nonzero(np.asarray(scene.geom.mat_id) == 1)[0]
    occ_ids = np.unique(np.asarray(scene.geom.vert_idx)[occ_tris])
    assert len(occ_ids) == 4

    # loss over the LEFT image half only: the scene is x-symmetric, so a
    # full-image mean's derivative cancels between the two penumbra sides
    # (both AD+edge and the truth would be ~0 — a vacuous test); masking
    # one side keeps a strong one-sided visibility derivative
    col = jnp.arange(H * W, dtype=jnp.int32) % W
    pix_mask = (col < W // 2).astype(jnp.float32)  # [H*W]
    img_mask = pix_mask.reshape(H, W)[..., None]
    n_weighted = float(pix_mask.sum()) * 3.0

    def loss(params):
        img = render_image(params, scene, key, spp, bounces)
        return jnp.sum(img * img_mask) / n_weighted

    # ---- detached AD gradient: near zero along the occluder sweep ----
    g = jax.grad(loss)(params0)
    ad_detached = float(np.asarray(g.dverts)[occ_ids, 0].sum())

    # ---- FD truth of the expected-image derivative ----
    def at(eps):
        dv = jnp.zeros_like(params0.dverts).at[occ_ids, 0].add(eps)
        return float(loss(dataclasses.replace(params0, dverts=dv)))

    eps = 0.02
    fd = (at(eps) - at(-eps)) / (2 * eps)
    assert abs(fd) > 1e-4, f"scene mis-authored: no penumbra signal, fd={fd}"

    # the detached estimator misses (essentially all of) the derivative
    assert abs(ad_detached) < 0.15 * abs(fd), (ad_detached, fd)

    # ---- boundary-sampling edge term ----
    # shading points: pixel-center primary hits on the floor
    pidx = jnp.arange(H * W, dtype=jnp.int32)
    org, dirn = generate_rays(
        scene.camera, jnp.full((H * W, 2), 0.5), pidx
    )
    hit = closest_hit(scene, org, dirn)
    t_safe = jnp.where(hit.valid, hit.t, 0.0)
    x = org + t_safe[:, None] * dirn
    on_floor = hit.valid & (scene.geom.mat_id[jnp.maximum(hit.tri, 0)] == 0)
    n_x = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), x.shape)
    kd = jnp.broadcast_to(jnp.array([0.75, 0.75, 0.75]), x.shape)
    # dLoss/dpixel for the masked-mean loss; zero off-floor / off-mask
    weight = jnp.where(
        (on_floor & (pix_mask > 0))[:, None], 1.0 / n_weighted, 0.0
    ) * jnp.ones((1, 3))

    occ_pos = {}
    g_ = scene.geom
    vi = np.asarray(g_.vert_idx)
    v0 = np.asarray(g_.v0); e1 = np.asarray(g_.e1); e2 = np.asarray(g_.e2)
    for t in occ_tris:
        for c, p in enumerate((v0[t], v0[t] + e1[t], v0[t] + e2[t])):
            occ_pos[int(vi[t, c])] = p
    occ_verts = jnp.asarray(np.stack([occ_pos[i] for i in occ_ids]))
    # boundary edges of the quad in occ_verts-local indices (0..3): the
    # quad was authored as corners in ring order 4,5,6,7
    ring = {int(i): k for k, i in enumerate(occ_ids)}
    corners = sorted(occ_pos.keys())
    e = [[ring[corners[0]], ring[corners[1]]],
         [ring[corners[1]], ring[corners[2]]],
         [ring[corners[2]], ring[corners[3]]],
         [ring[corners[3]], ring[corners[0]]]]
    occ_edges = jnp.asarray(np.array(e, np.int32))

    edge_grad = nee_visibility_edge_grad(
        x, n_x, kd, weight,
        occ_verts, occ_edges,
        light_q0=jnp.array([0.9, 1.5, 0.9]),
        light_eu=jnp.array([0.2, 0.0, 0.0]),
        light_ev=jnp.array([0.0, 0.0, 0.2]),
        light_le=jnp.array([30.0, 30.0, 30.0]),
        n_samples=256,
    )
    edge_x = float(np.asarray(edge_grad)[:, 0].sum())
    total = ad_detached + edge_x

    # edge-corrected gradient matches the FD truth
    assert abs(total - fd) <= 0.30 * abs(fd), (
        f"AD_detached={ad_detached:.5f} edge={edge_x:.5f} "
        f"total={total:.5f} fd={fd:.5f}"
    )


def _write_two_occluder_scene(dirp):
    """Floor + occluder A (the swept one) + occluder B ABOVE A, shadowing
    part of A's projected boundary: the scene class where the round-4
    prototype (all given edges contribute, centroid orientation, no
    mutual occlusion) is WRONG."""
    obj = ["mtllib occ2.mtl"]
    verts = [
        # floor 0..3
        (0.0, 0.0, 0.0), (2.0, 0.0, 0.0), (2.0, 0.0, 2.0), (0.0, 0.0, 2.0),
        # occluder A 4..7 (y=0.75)
        (0.85, 0.75, 0.85), (1.15, 0.75, 0.85),
        (1.15, 0.75, 1.15), (0.85, 0.75, 1.15),
        # occluder B 8..11 (y=1.2, covers the light's LEFT half)
        (0.60, 1.2, 0.60), (1.02, 1.2, 0.60),
        (1.02, 1.2, 1.40), (0.60, 1.2, 1.40),
        # light 12..15
        (0.9, 1.5, 0.9), (1.1, 1.5, 0.9), (1.1, 1.5, 1.1), (0.9, 1.5, 1.1),
    ]
    for v in verts:
        obj.append(f"v {v[0]} {v[1]} {v[2]}")
    obj.append("vn 0.0 1.0 0.0")
    obj.append("vn 0.0 -1.0 0.0")
    obj.append("usemtl white")
    obj += ["f 1//1 3//1 2//1", "f 1//1 4//1 3//1"]
    obj.append("usemtl occ")
    obj += ["f 5//2 7//2 6//2", "f 5//2 8//2 7//2"]
    obj.append("usemtl occB")
    obj += ["f 9//2 11//2 10//2", "f 9//2 12//2 11//2"]
    obj.append("usemtl light")
    obj += ["f 13//2 15//2 14//2", "f 13//2 16//2 15//2"]
    with open(os.path.join(dirp, "occ2.obj"), "w") as f:
        f.write("\n".join(obj) + "\n")
    with open(os.path.join(dirp, "occ2.mtl"), "w") as f:
        f.write("newmtl white\nKd 0.75 0.75 0.75\n\n"
                "newmtl occ\nKd 0.6 0.6 0.6\n\n"
                "newmtl occB\nKd 0.6 0.6 0.6\n\n"
                "newmtl light\nKd 0.5 0.5 0.5\n")
    with open(os.path.join(dirp, "occ2.xml"), "w") as f:
        f.write(
            '<camera type="perspective" width="16" height="16" fovy="40">\n'
            '  <eye x="1.0" y="0.45" z="-0.9"/>\n'
            '  <lookat x="1.0" y="0.0" z="0.9"/>\n'
            '  <up x="0.0" y="1.0" z="0.0"/>\n'
            "</camera>\n"
            '<light mtlname="light" radiance="30,30,30"/>\n'
        )
    return os.path.join(dirp, "occ2.obj")


@pytest.mark.slow
def test_general_silhouette_beats_convex_prototype(tmp_path):
    """With a second occluder shadowing part of occluder
    A's boundary, the round-4 prototype path (given edges, centroid
    orientation, no mutual occlusion) mis-estimates d(Loss)/d(A); the
    general path (build_silhouette_tables + per-(x, edge) silhouette +
    any_hit mutual occlusion) matches the finite-difference truth."""
    from mcpt.diff.edge import (
        build_silhouette_tables,
        nee_visibility_edge_grad,
    )
    from mcpt.io.obj import load_scene
    from mcpt.ops.intersect import closest_hit
    from mcpt.render.camera import generate_rays

    scene = load_scene(_write_two_occluder_scene(str(tmp_path)), with_bvh=True)
    H = W = 16
    spp, bounces = 256, 1
    key = jax.random.PRNGKey(3)
    params0 = extract_params(scene)

    occ_tris = np.nonzero(np.asarray(scene.geom.mat_id) == 1)[0]  # "occ" = A
    occ_ids = np.unique(np.asarray(scene.geom.vert_idx)[occ_tris])
    assert len(occ_ids) == 4

    col = jnp.arange(H * W, dtype=jnp.int32) % W
    pix_mask = (col < W // 2).astype(jnp.float32)
    img_mask = pix_mask.reshape(H, W)[..., None]
    n_weighted = float(pix_mask.sum()) * 3.0

    def loss(params):
        img = render_image(params, scene, key, spp, bounces)
        return jnp.sum(img * img_mask) / n_weighted

    def at(eps):
        dv = jnp.zeros_like(params0.dverts).at[occ_ids, 0].add(eps)
        return float(loss(dataclasses.replace(params0, dverts=dv)))

    eps = 0.02
    fd = (at(eps) - at(-eps)) / (2 * eps)
    assert abs(fd) > 1e-4, f"scene mis-authored: no penumbra signal, fd={fd}"
    g = jax.grad(loss)(params0)
    ad_detached = float(np.asarray(g.dverts)[occ_ids, 0].sum())

    # shading points (pixel-center primaries on the floor)
    pidx = jnp.arange(H * W, dtype=jnp.int32)
    org, dirn = generate_rays(scene.camera, jnp.full((H * W, 2), 0.5), pidx)
    hit = closest_hit(scene, org, dirn)
    t_safe = jnp.where(hit.valid, hit.t, 0.0)
    x = org + t_safe[:, None] * dirn
    on_floor = hit.valid & (scene.geom.mat_id[jnp.maximum(hit.tri, 0)] == 0)
    n_x = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), x.shape)
    kd = jnp.broadcast_to(jnp.array([0.75, 0.75, 0.75]), x.shape)
    weight = jnp.where(
        (on_floor & (pix_mask > 0))[:, None], 1.0 / n_weighted, 0.0
    ) * jnp.ones((1, 3))

    verts, edges, edge_nf, edge_opp_id = build_silhouette_tables(scene)
    opp_pos = verts[jnp.maximum(edge_opp_id, 0)]  # [E,2,3]
    light_kw = dict(
        light_q0=jnp.array([0.9, 1.5, 0.9]),
        light_eu=jnp.array([0.2, 0.0, 0.0]),
        light_ev=jnp.array([0.0, 0.0, 0.2]),
        light_le=jnp.array([30.0, 30.0, 30.0]),
        n_samples=128,
    )
    # prototype path: same edge set, centroid orientation, no occlusion
    g_naive = nee_visibility_edge_grad(
        x, n_x, kd, weight, verts, edges, **light_kw
    )
    naive_x = float(np.asarray(g_naive)[occ_ids, 0].sum())
    # general path
    g_gen = nee_visibility_edge_grad(
        x, n_x, kd, weight, verts, edges, **light_kw,
        edge_nf=edge_nf, edge_opp=opp_pos, scene=scene,
    )
    gen_x = float(np.asarray(g_gen)[occ_ids, 0].sum())

    total_naive = ad_detached + naive_x
    total_gen = ad_detached + gen_x
    err_naive = abs(total_naive - fd)
    err_gen = abs(total_gen - fd)
    # the general estimator matches FD; the prototype does not (and the
    # general one must beat it decisively, not within noise)
    assert err_gen <= 0.30 * abs(fd), (
        f"general: ad={ad_detached:.5f} edge={gen_x:.5f} fd={fd:.5f}")
    assert err_naive > 2.0 * err_gen, (
        f"naive unexpectedly fine: naive_err={err_naive:.5f} "
        f"gen_err={err_gen:.5f} fd={fd:.5f}")


def test_edge_term_wires_into_run_inverse(tmp_path):
    """The edge-aware visibility term plugs into run_inverse as an opt-in
    extra_grad_fn."""
    import jax.numpy as jnp

    from mcpt.diff.edge import make_nee_edge_term
    from mcpt.diff.grad import render_image
    from mcpt.diff.inverse import run_inverse
    from mcpt.io.obj import load_scene

    scene = load_scene(_write_occluder_scene(str(tmp_path)), with_bvh=True)
    key = jax.random.PRNGKey(0)
    params0 = extract_params(scene)
    target = render_image(params0, scene, key, 2, 2)
    term = make_nee_edge_term(
        scene, target,
        light_q0=jnp.array([0.9, 1.5, 0.9]),
        light_eu=jnp.array([0.2, 0.0, 0.0]),
        light_ev=jnp.array([0.0, 0.0, 0.2]),
        light_le=jnp.array([30.0, 30.0, 30.0]),
        n_samples=16, est_spp=1,
    )
    g = term(params0, key)
    assert g.dverts is not None and np.isfinite(np.asarray(g.dverts)).all()
    params, losses = run_inverse(
        scene, target, params0, steps=2, spp=1, max_bounces=2,
        extra_grad_fn=term,
    )
    assert np.isfinite(losses).all()
