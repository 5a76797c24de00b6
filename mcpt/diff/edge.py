"""Edge-aware (silhouette) gradients: boundary sampling for NEE visibility.

The production estimator (diff/grad.py) is detached-random: it freezes every
discrete decision, so d(pixel)/d(vertex) misses the VISIBILITY term — the
derivative contributed by a silhouette sweeping across the light as an
occluder moves. For an occluder the camera never sees directly, the detached
gradient is exactly zero while the true expected-image derivative is not
(the penumbra moves). The reference implements none of this (its hit and
shadow logic, src/BVH.cpp:90-136 + src/Triangle.cpp:48-106, is primal-only);
this is the BASELINE north star's "reparameterized/edge-aware gradients"
stage.

This module is the boundary-sampling estimator for the dominant such term:
direct lighting through NEE/BSDF at the FIRST path vertex (the classic
edge-sampling formulation of Li et al. 2018, "Differentiable Monte Carlo Ray
Tracing through Edge Sampling", specialized to a polygonal area light).

Derivation (Reynolds transport over the light surface): the direct
illumination at shading point x is

    I(x) = INT_L f(x, y) V(x, y) dA(y),
    f = brdf(x) * Le * cos_x * cos_y / d^2        (area-form integrand)

V's discontinuity boundary on the light plane is the projection of the
occluder's silhouette edges from x. For boundary curve y(s) moving with
parameter velocity dy/dtheta,

    dI/dtheta = INT_C f(x, y(s)) (dy/dtheta . n_occ(s)) |dy/ds| ds

with n_occ the in-plane curve normal pointing INTO the occluded region
(boundary moving toward the shadow shrinks it -> I grows). Note f carries
NO MIS weight: NEE and the BSDF-hit-light strategy split the same integrand,
so their edge terms sum back to the full-f boundary integral — one estimator
covers both.

The projection y(p) = x + c (p - x), c = <q0-x, n_l> / <p-x, n_l>, has the
closed-form Jacobian dy/dp = c (I - (p-x) n_l^T / <p-x, n_l>), so the whole
estimator is vectorized jnp with stratified edge samples — no per-sample
autodiff, no RNG.

SCOPE (round 5 generalization, tested in tests/test_edge.py):
  * first-vertex direct lighting, diffuse shading point (kd/pi);
  * one parallelogram light (v0, e_u, e_v), constant radiance;
  * GENERAL occluder sets: pass `edge_nf`/`edge_opp` (from
    build_silhouette_tables) for the per-(shading point, edge sample)
    silhouette test — an edge contributes only where its adjacent faces
    straddle the view direction (or it is a boundary edge) — with the
    occluded side oriented by the FRONT-facing face's projected interior
    (the round-4 prototype used the occluder centroid, valid only for a
    single convex occluder); and pass `scene` for the mutual-occlusion
    test — both sight segments x->p and p->y are verified with the real
    any_hit, so boundaries buried in another occluder's shadow (where V
    has no discontinuity) contribute nothing.
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from mcpt.utils.math import cross, dot, normalize


def build_silhouette_tables(scene, exclude_emissive: bool = True):
    """Edge tables over the scene's SHARED vertex buffer (numpy, build-time).

    Returns (verts [Nv,3], edges i32[E,2], edge_nf [E,2,3], edge_opp
    i32[E,2]): for each unique mesh edge, the shared-vertex ids of its
    endpoints, the geometric normals of its (up to two) adjacent faces
    (zero row = boundary edge), and the opposite-vertex id of each face
    (-1 when missing). Emissive faces are excluded by default (the light's
    own boundary is a different derivative term — the light-edge gradient —
    not occluder visibility).
    """
    g = scene.geom
    assert g.vert_idx is not None, "scene has no shared-vertex mapping"
    vi = np.asarray(g.vert_idx)
    v0 = np.asarray(g.v0)
    e1 = np.asarray(g.e1)
    e2 = np.asarray(g.e2)
    mat = np.asarray(g.mat_id)
    nv = int(vi.max()) + 1
    verts = np.zeros((nv, 3), np.float32)
    corners = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # [T,3,3]
    verts[vi.reshape(-1)] = corners.reshape(-1, 3)
    n_face = np.cross(e1, e2)
    nl = np.linalg.norm(n_face, axis=1, keepdims=True)
    n_face = n_face / np.maximum(nl, 1e-30)

    emissive = None
    if exclude_emissive:
        rad = np.asarray(scene.mats.radiance)
        emissive = rad.max(axis=1)[mat] > 0

    edge_map = {}
    for t in range(vi.shape[0]):
        if emissive is not None and emissive[t]:
            continue
        a, b, c = int(vi[t, 0]), int(vi[t, 1]), int(vi[t, 2])
        for (i, j, opp) in ((a, b, c), (b, c, a), (c, a, b)):
            key = (min(i, j), max(i, j))
            edge_map.setdefault(key, []).append((t, opp))
    E = len(edge_map)
    edges = np.zeros((E, 2), np.int32)
    edge_nf = np.zeros((E, 2, 3), np.float32)
    edge_opp = np.full((E, 2), -1, np.int32)
    for k, (key, faces) in enumerate(sorted(edge_map.items())):
        edges[k] = key
        for f, (t, opp) in enumerate(faces[:2]):
            edge_nf[k, f] = n_face[t]
            edge_opp[k, f] = opp
    return (jnp.asarray(verts), jnp.asarray(edges), jnp.asarray(edge_nf),
            jnp.asarray(edge_opp))


def nee_visibility_edge_grad(
    x: jnp.ndarray,  # [R,3] shading points (first path vertices)
    n_x: jnp.ndarray,  # [R,3] shading normals
    kd: jnp.ndarray,  # [R,3] diffuse albedo at x
    weight: jnp.ndarray,  # [R,3] adjoint dLoss/dpixel (e.g. 1/(N*3) for mean)
    occ_verts: jnp.ndarray,  # [V,3] occluder vertex positions
    occ_edges: jnp.ndarray,  # i32[E,2] boundary-edge vertex indices
    light_q0: jnp.ndarray,  # [3] light parallelogram corner
    light_eu: jnp.ndarray,  # [3] edge u (q0 -> q0+eu)
    light_ev: jnp.ndarray,  # [3] edge v
    light_le: jnp.ndarray,  # [3] constant emitted radiance
    n_samples: int = 128,
    edge_nf: Optional[jnp.ndarray] = None,  # [E,2,3] adjacent face normals
    edge_opp: Optional[jnp.ndarray] = None,  # [E,2,3] opposite-vertex POSITIONS
    scene=None,  # enable the mutual-occlusion any_hit tests
) -> jnp.ndarray:
    """d(Loss)/d(occ_verts) [V,3]: the visibility edge term of first-vertex
    direct lighting, for a loss with per-pixel adjoint `weight`.

    Stratified midpoint samples along each edge; contributions from samples
    whose projection lands outside the light are zero (the boundary only
    matters where it crosses the emitter).

    With `edge_nf`/`edge_opp` (build_silhouette_tables positions), each
    (shading point, edge sample) passes a SILHOUETTE test and orients the
    occluded side by the front-facing face's projected interior — exact
    for arbitrary meshes, not just one convex occluder. With `scene`, both
    sight segments (x -> edge point, edge point -> light) are checked with
    the production any_hit so mutually-occluded boundary stretches (where
    V is constant) contribute nothing.
    """
    R = x.shape[0]
    E = occ_edges.shape[0]
    S = n_samples

    n_l = normalize(cross(light_eu, light_ev))  # light plane normal
    # dual basis for the inside-parallelogram test
    eu, ev = light_eu, light_ev
    guu, guv, gvv = dot(eu, eu), dot(eu, ev), dot(ev, ev)
    det_g = guu * gvv - guv * guv
    # occluder centroid projected per shading point orients n_occ
    centroid = jnp.mean(occ_verts, axis=0)

    va = occ_verts[occ_edges[:, 0]]  # [E,3]
    vb = occ_verts[occ_edges[:, 1]]
    s = (jnp.arange(S) + 0.5) / S  # stratified midpoints

    # p[E,S,3] edge sample points
    p = va[:, None, :] + s[None, :, None] * (vb - va)[:, None, :]
    # broadcast layout: [R, E, S, 3]
    xb = x[:, None, None, :]
    pb = p[None, :, :, :]
    d_xp = pb - xb
    h = jnp.sum(d_xp * n_l, axis=-1)  # <p-x, n_l>  [R,E,S]
    A0 = jnp.sum((light_q0 - x) * n_l, axis=-1)  # [R]
    A = A0[:, None, None]  # <q0-x, n_l>
    # only edges strictly between x and the light plane cast this boundary
    valid_h = (jnp.abs(h) > 1e-12) & (A / jnp.where(h == 0, 1.0, h) > 1.0)
    c = jnp.where(valid_h, A / jnp.where(jnp.abs(h) > 1e-12, h, 1.0), 0.0)
    y = xb + c[..., None] * d_xp  # [R,E,S,3] projected boundary points

    # inside-parallelogram test in the light's (u, v) coordinates
    rel = y - light_q0
    bu = jnp.sum(rel * eu, axis=-1)
    bv = jnp.sum(rel * ev, axis=-1)
    au = (gvv * bu - guv * bv) / det_g
    av = (guu * bv - guv * bu) / det_g
    inside = (au >= 0) & (au <= 1) & (av >= 0) & (av <= 1) & valid_h

    if edge_nf is not None:
        # per-(x, edge sample) silhouette test: the adjacent faces must
        # straddle the view direction (boundary edges always qualify)
        nf1 = edge_nf[None, :, None, 0, :]
        nf2 = edge_nf[None, :, None, 1, :]
        s1 = jnp.sum(d_xp * nf1, axis=-1)
        s2 = jnp.sum(d_xp * nf2, axis=-1)
        has2 = (jnp.sum(edge_nf[:, 1] ** 2, axis=-1) > 0)[None, :, None]
        sil = jnp.where(has2, s1 * s2 < 0, True)
        inside = inside & sil

    if scene is not None:
        # mutual occlusion: the sight line x -> p -> y must be clear on
        # BOTH segments (a boundary buried in another occluder's shadow
        # has no visibility discontinuity). Margins mirror NEE's 1e-3
        # shadow-ray backoff so the edge's own faces never self-occlude
        # at the grazing point.
        from mcpt.ops.intersect import any_hit

        dist_xp = jnp.sqrt(jnp.maximum(jnp.sum(d_xp * d_xp, axis=-1), 1e-20))
        w_xp = d_xp / dist_xp[..., None]
        flat = lambda a: a.reshape(-1, a.shape[-1])
        xbb = jnp.broadcast_to(xb, d_xp.shape)
        t_lo = 1e-4 * scene.scale
        occ1 = any_hit(
            scene, flat(xbb), flat(w_xp), t_min=t_lo,
            t_max=(dist_xp * (1.0 - 1e-3)).reshape(-1),
        ).reshape(dist_xp.shape)
        # second segment starts just past p along the SAME direction
        # (x, p, y are collinear by construction)
        dist_xy_full = jnp.sqrt(
            jnp.maximum(jnp.sum((y - xb) ** 2, axis=-1), 1e-20)
        )
        o2 = xb + w_xp * (dist_xp * (1.0 + 1e-3))[..., None]
        t2 = dist_xy_full * (1.0 - 1e-3) - dist_xp * (1.0 + 1e-3)
        occ2 = any_hit(
            scene, flat(o2), flat(w_xp), t_min=t_lo,
            t_max=jnp.maximum(t2, 0.0).reshape(-1),
        ).reshape(dist_xp.shape)
        inside = inside & ~occ1 & ~occ2

    # integrand f(x, y) (area form, full — no MIS split; see module doc)
    d_xy = y - xb
    d2 = jnp.sum(d_xy * d_xy, axis=-1)
    dist = jnp.sqrt(jnp.maximum(d2, 1e-20))
    w_dir = d_xy / dist[..., None]
    cos_x = jnp.maximum(jnp.sum(n_x[:, None, None, :] * w_dir, axis=-1), 0.0)
    cos_y = jnp.maximum(jnp.sum(-w_dir * n_l, axis=-1), 0.0)
    geom = cos_x * cos_y / jnp.maximum(d2, 1e-20)  # [R,E,S]
    f_rgb = (kd[:, None, None, :] / jnp.pi) * light_le * geom[..., None]

    # curve tangent dy/ds and speed |dy/ds| via the closed-form Jacobian
    #   dy/dp = c (I - (p-x) n_l^T / h)
    e_dir = (vb - va)[None, :, None, :]  # dp/ds (unnormalized)

    def jac_apply(v):  # dy/dp @ v for v [.,3] broadcast over [R,E,S,3]
        return c[..., None] * (
            v - d_xp * (jnp.sum(v * n_l, axis=-1) / jnp.where(
                jnp.abs(h) > 1e-12, h, 1.0))[..., None]
        )

    dy_ds = jac_apply(e_dir)  # [R,E,S,3]
    speed = jnp.sqrt(jnp.maximum(jnp.sum(dy_ds * dy_ds, axis=-1), 1e-30))
    tau = dy_ds / speed[..., None]
    n_curve = cross(jnp.broadcast_to(n_l, tau.shape), tau)  # in light plane
    if edge_nf is not None and edge_opp is not None:
        # orient toward the occluded side: the FRONT-facing adjacent
        # face's interior projects into the shadow (the sight line past
        # the silhouette enters the surface there). Boundary edges use
        # their only face's interior regardless of facing (a thin sheet
        # occludes from both sides).
        nf1 = edge_nf[None, :, None, 0, :]
        s1 = jnp.sum(d_xp * nf1, axis=-1)
        has2 = (jnp.sum(edge_nf[:, 1] ** 2, axis=-1) > 0)[None, :, None]
        front1 = jnp.where(has2, s1 < 0, True)
        opp1 = jnp.broadcast_to(edge_opp[None, :, None, 0, :], d_xp.shape)
        opp2 = jnp.broadcast_to(edge_opp[None, :, None, 1, :], d_xp.shape)
        opp = jnp.where(front1[..., None], opp1, opp2)
        h_o = jnp.sum((opp - xb) * n_l, axis=-1)
        c_o = A / jnp.where(jnp.abs(h_o) > 1e-12, h_o, 1e-12)
        y_o = xb + c_o[..., None] * (opp - xb)  # projected interior point
        sign = jnp.sign(jnp.sum((y_o - y) * n_curve, axis=-1))
    else:
        # round-4 prototype: orient by the projected occluder centroid
        # (valid only for one convex occluder)
        h_c = jnp.sum((centroid - x) * n_l, axis=-1)  # [R]
        c_c = A0 / jnp.where(jnp.abs(h_c) > 1e-12, h_c, 1e-12)
        y_c = x + c_c[:, None] * (centroid - x)  # [R,3] on the light plane
        sign = jnp.sign(
            jnp.sum((y_c[:, None, None, :] - y) * n_curve, axis=-1)
        )
    n_occ = n_curve * jnp.where(sign == 0, 1.0, sign)[..., None]

    # adjoint weight: scalar per (pixel, edge, sample)
    w_pix = jnp.sum(weight[:, None, None, :] * f_rgb, axis=-1)  # [R,E,S]
    common = jnp.where(inside, w_pix * speed, 0.0) / S  # MC weight, ds = 1/S

    # dy/dtheta for vertex a: dy/dp @ (1-s) I -> (1-s) * (n_occ^T dy/dp);
    # the Jacobian is symmetric in structure, so apply it to n_occ as a
    # VJP: n_occ^T dy/dp = c (n_occ - <n_occ, d_xp> n_l / h)... careful:
    # (dy/dp)^T v = c (v - n_l <d_xp, v> / h). Note the TRANSPOSE swaps
    # which factor carries n_l.
    def jac_T_apply(v):  # (dy/dp)^T @ v
        return c[..., None] * (
            v - jnp.broadcast_to(n_l, v.shape) * (
                jnp.sum(d_xp * v, axis=-1) / jnp.where(
                    jnp.abs(h) > 1e-12, h, 1.0))[..., None]
        )

    vjp_n = jac_T_apply(n_occ)  # [R,E,S,3] = d<y, n_occ>/dp
    contrib = common[..., None] * vjp_n  # [R,E,S,3]

    ga = jnp.sum(contrib * (1.0 - s)[None, None, :, None], axis=(0, 2))  # [E,3]
    gb = jnp.sum(contrib * s[None, None, :, None], axis=(0, 2))

    grad = jnp.zeros_like(occ_verts)
    grad = grad.at[occ_edges[:, 0]].add(ga)
    grad = grad.at[occ_edges[:, 1]].add(gb)
    return grad


def make_nee_edge_term(
    scene,
    target: jnp.ndarray,
    light_q0,
    light_eu,
    light_ev,
    light_le,
    n_samples: int = 64,
    est_spp: int = 2,
    max_bounces: int = 2,
):
    """Build an `extra_grad_fn` for run_inverse: the NEE visibility
    (silhouette) term of d(MSE)/d(dverts).

    Scope matches nee_visibility_edge_grad (first-vertex direct lighting,
    diffuse shading points, one parallelogram light); silhouette tables
    come from the whole scene, so N occluders and non-convex shapes are
    handled, with mutual occlusion via the production any_hit. The MSE
    adjoint 2 (I - target) / N uses an `est_spp`-sample rendered estimate
    of I at the current params.

    Returns fn(params, key) -> SceneParams-shaped gradient pytree (zeros
    for kd/ks/radiance).
    """
    import jax

    from mcpt.diff.grad import SceneParams, render_image
    from mcpt.ops.intersect import closest_hit
    from mcpt.render.camera import generate_rays

    verts, edges, edge_nf, edge_opp_id = build_silhouette_tables(scene)
    opp_pos = verts[jnp.maximum(edge_opp_id, 0)]
    cam = scene.camera
    H, W = cam.height, cam.width
    n_pix = H * W
    pidx = jnp.arange(n_pix, dtype=jnp.int32)

    # pixel-center primary shading data (hit selection is frozen — the
    # boundary term is about the LIGHT's visibility, not the camera's)
    org, dirn = generate_rays(cam, jnp.full((n_pix, 2), 0.5), pidx)
    hit = closest_hit(scene, org, dirn)
    t_safe = jnp.where(hit.valid, hit.t, 0.0)
    x = org + t_safe[:, None] * dirn
    from mcpt.render.integrator import make_expander

    h = make_expander(scene)(hit, org, dirn)
    n_x = h.normal
    mat_of_pix = scene.geom.mat_id[jnp.maximum(hit.tri, 0)]
    valid = hit.valid

    def fn(params, key):
        img = render_image(params, scene, key, est_spp, max_bounces)
        adj = 2.0 * (img - target) / (n_pix * 3.0)
        weight = jnp.where(valid[:, None], adj.reshape(n_pix, 3), 0.0)
        kd_pix = params.kd[mat_of_pix]
        g = nee_visibility_edge_grad(
            x, n_x, kd_pix, weight, verts, edges,
            light_q0=light_q0, light_eu=light_eu, light_ev=light_ev,
            light_le=light_le, n_samples=n_samples,
            edge_nf=edge_nf, edge_opp=opp_pos, scene=scene,
        )
        return SceneParams(
            kd=jnp.zeros_like(params.kd),
            ks=jnp.zeros_like(params.ks),
            radiance=jnp.zeros_like(params.radiance),
            dverts=None if params.dverts is None else g,
        )

    return fn
