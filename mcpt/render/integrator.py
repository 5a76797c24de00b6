"""Wavefront path integrator: the reference's iterative estimator as a
fixed-shape `lax.scan` over bounces with masked lanes.

This is a faithful re-derivation of the ACTIVE integrator in the
reference (src/Render.cpp:111-175):

  * bounce-0 emitter hit adds radiance directly (Render.cpp:121-122,
    threshold |radiance| > 1e-4)
  * NEE: one uniform light point per bounce; pdf = d^2/(cos_l * area); MIS
    power heuristic vs the BSDF mixture pdf with the light pdf divided by
    n_lights inside the heuristic and the contribution multiplied by n_lights
    (Render.cpp:124-130, Render.cpp:202-223)
  * BSDF step: one-sample lobe mixture; terminate on pdf == 0; beta *=
    f * |cos| / pdf (Render.cpp:133-140)
  * look-ahead: trace the new ray; a front-facing emissive hit adds
    MIS-weighted emission — full weight after a mirror bounce, else
    power_heuristic(bsdf_pdf, light_pdf) with light_pdf =
    dist^2/cos/n_lights/area (Render.cpp:142-162; emissive test is
    |radiance| > 0, Render.cpp:146)
  * Russian roulette after bounce 3: q = min(max_comp(beta), 0.95)
    (Render.cpp:164-170)

Differences by design (not bugs):
  * the reference re-traces each path ray twice per bounce (loop head +
    look-ahead, Render.cpp:118+144, SURVEY §3.3) — here each ray is traced
    once and the hit record is carried;
  * recursion/unbounded loop -> fixed `max_bounces` scan (RR makes the tail
    contribution negligible) so the whole program is one XLA computation;
  * counter-based threefry RNG replaces the racy shared mt19937
    (src/utils.h:23-28, SURVEY §5);
  * secondary rays use a scene-relative t_min (f32 vs the reference's f64);
  * per-hit data (geometry + material) comes from ONE packed table row per
    triangle (one row gather instead of ~12 scalar gathers).

Sampling DECISIONS (uniform draws, sampled directions, lobe picks, RR
outcomes, visibility booleans) are wrapped in stop_gradient; smooth factors
(hit points/normals via expand_hit, NEE geometry pdfs, MIS weights) stay
attached. Under jax.grad the same code path yields detached-random
gradients for materials, emission, AND vertex positions
(d pixel / d {kd, ks, radiance, dverts}) — see diff/grad.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from mcpt.ops.intersect import F32_MAX, Hit, any_hit, closest_hit
from mcpt.render.bsdf import bsdf_fx, bsdf_pdf, bsdf_sample, build_lobes
from mcpt.render.onb import make_onb, to_local, to_world
from mcpt.scene import Scene
from mcpt.utils.math import cross, dot, normalize, power_heuristic

sg = jax.lax.stop_gradient

# Relative secondary-ray epsilon (the reference's absolute t1=1e-4 scaled by
# scene size; see Scene.scale).
RAY_EPS_REL = 1e-4
# Emitter thresholds, in reference order of appearance:
EMIT_DIRECT_THRESH = 1e-4  # bounce-0 direct add (Render.cpp:121)
RR_START_BOUNCE = 3  # RR applies when bounces > 3 (Render.cpp:164)
RR_CLAMP = 0.95


# ---------------------------------------------------------------------------
# Packed per-triangle table: geometry + per-face material in one row, so a
# hit expands through a single row gather.
# Columns: v0(0:3) e1(3:6) e2(6:9) vn(9:18) uv(18:24) area(24)
#          kd(25:28) ks(28:31) ns(31) radiance(32:35) tex_id(35)
# ---------------------------------------------------------------------------

TRI_TABLE_COLS = 36


def pack_tri_table(scene: Scene) -> jnp.ndarray:
    g, m = scene.geom, scene.mats
    T = g.v0.shape[0]
    mat = g.mat_id
    return jnp.concatenate(
        [
            g.v0,
            g.e1,
            g.e2,
            g.vn.reshape(T, 9),
            g.uv.reshape(T, 6),
            g.area[:, None],
            m.kd[mat],
            m.ks[mat],
            m.ns[mat][:, None],
            m.radiance[mat],
            m.tex_id[mat][:, None].astype(jnp.float32),
        ],
        axis=1,
    )


def pack_light_table(scene: Scene) -> jnp.ndarray:
    """Light rows: v0(0:3) e1(3:6) e2(6:9) vn(9:18) radiance(18:21) area(21)."""
    g, m = scene.geom, scene.mats
    lt = scene.light_tris
    L = lt.shape[0]
    return jnp.concatenate(
        [
            g.v0[lt],
            g.e1[lt],
            g.e2[lt],
            g.vn[lt].reshape(L, 9),
            m.radiance[g.mat_id[lt]],
            g.area[lt][:, None],
        ],
        axis=1,
    )


@dataclass(frozen=True)
class HitData:
    """Expanded shading data at a hit (reference hitInfo, Render.h:14-24,
    plus the per-face material the reference reaches via shared_ptr)."""

    point: jnp.ndarray  # [R,3]
    normal: jnp.ndarray  # [R,3]
    uv: jnp.ndarray  # [R,2]
    front: jnp.ndarray  # bool[R]
    area: jnp.ndarray  # [R] (lightarea when emissive)
    kd: jnp.ndarray  # [R,3] (texture NOT yet applied)
    ks: jnp.ndarray  # [R,3]
    ns: jnp.ndarray  # [R]
    radiance: jnp.ndarray  # [R,3]
    tex_id: jnp.ndarray  # i32[R]
    valid: jnp.ndarray  # bool[R]


jax.tree_util.register_dataclass(
    HitData,
    data_fields=[
        "point", "normal", "uv", "front", "area", "kd", "ks", "ns",
        "radiance", "tex_id", "valid",
    ],
    meta_fields=[],
)


def make_expander(scene: Scene):
    """Returns expand(hit, org, dirn) bound to this scene's packed table
    (built ONCE per trace, outside the bounce loop)."""
    tri_table = pack_tri_table(scene)
    return lambda hit, org, dirn: expand_hit(tri_table, hit, org, dirn)


def expand_hit(
    tri_table: jnp.ndarray, hit: Hit, org: jnp.ndarray, dirn: jnp.ndarray
) -> HitData:
    """Hit -> HitData via one packed-row gather (reference Triangle.cpp:66-78).

    Barycentrics are recomputed here from the gathered triangle row (same
    Moller-Trumbore algebra that accepted the hit, so bit-identical inputs;
    see ops/intersect.Hit). The recomputation is attached to the triangle
    row, so d(pixel)/d(vertex) flows even where hit SELECTION is frozen
    (stop_gradient at the dispatch site).
    """
    rows = jnp.take(tri_table, jnp.maximum(hit.tri, 0), axis=0)
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    hv = cross(dirn, e2)
    det = dot(e1, hv)
    # A missed ray expands triangle 0 and is masked out of every result,
    # but its values still meet a zero cotangent in the backward. Nearly
    # parallel to that triangle's plane (|det| ~ 0) it would give u, v past
    # 2^24, where w + u + v cancels to 0 and the normal is 0/0; 0 x NaN
    # then poisons the whole row's gradient. Missed lanes therefore take
    # det = 1 and u = v = 0 (the first vertex), in both passes; hit lanes
    # are unchanged (an accepted hit has |det| >= DET_EPS_CLOSEST).
    hit_ok = hit.valid
    inv = 1.0 / jnp.where(hit_ok, det, 1.0)
    s = org - v0
    q = cross(s, e1)
    u = jnp.where(hit_ok, dot(s, hv) * inv, 0.0)[:, None]
    v = jnp.where(hit_ok, dot(dirn, q) * inv, 0.0)[:, None]
    w = 1.0 - u - v
    vn = rows[:, 9:18].reshape(-1, 3, 3)
    uvs = rows[:, 18:24].reshape(-1, 3, 2)
    point = v0 + u * e1 + v * e2  # == interplote_Vertex (Triangle.cpp:68)
    n = normalize(w * vn[:, 0] + u * vn[:, 1] + v * vn[:, 2])
    uv = w * uvs[:, 0] + u * uvs[:, 1] + v * uvs[:, 2]
    return HitData(
        point=point,
        normal=n,
        uv=uv,
        front=dot(n, dirn) < 0,  # Triangle.cpp:71
        area=rows[:, 24],
        kd=rows[:, 25:28],
        ks=rows[:, 28:31],
        ns=rows[:, 31],
        radiance=rows[:, 32:35],
        tex_id=rows[:, 35].astype(jnp.int32),
        valid=hit.valid,
    )


def apply_texture(scene: Scene, h: HitData) -> jnp.ndarray:
    """Diffuse reflectance with nearest-neighbor texture lookup.

    Matches reference Texture::get_color (src/model.cpp:30-41): fract + clamp
    to [0, 0.999], x = int(u*w), row-major top-down, no filtering. Skipped
    entirely when the scene has no image textures.
    """
    if scene.atlas.data.shape[0] == 1 and scene.atlas.data.shape[1] == 1:
        return h.kd
    tid = jnp.maximum(h.tex_id, 0)
    wh = scene.atlas.size[tid]
    u = jnp.clip(h.uv[:, 0] - jnp.floor(h.uv[:, 0]), 0.0, 0.999)
    v = jnp.clip(h.uv[:, 1] - jnp.floor(h.uv[:, 1]), 0.0, 0.999)
    x = (u * wh[:, 0]).astype(jnp.int32)
    y = (v * wh[:, 1]).astype(jnp.int32)
    texel = scene.atlas.data[tid, y, x]
    return jnp.where((h.tex_id >= 0)[:, None], texel, h.kd)


def sample_light_point(light_table: jnp.ndarray, n_lights: int, u0, u1, u2):
    """Uniform light-triangle point (reference Render::sample + sample_Point2).

    Returns (point [R,3], normal [R,3], radiance [R,3], area [R]).
    """
    idx = jnp.minimum((u0 * n_lights).astype(jnp.int32), n_lights - 1)
    rows = jnp.take(light_table, idx, axis=0)
    # reflection trick for uniform barycentrics (Triangle.cpp:15-22)
    flip = u1 + u2 > 1.0
    bu = jnp.where(flip, 1.0 - u1, u1)[:, None]
    bv = jnp.where(flip, 1.0 - u2, u2)[:, None]
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    vn = rows[:, 9:18].reshape(-1, 3, 3)
    point = v0 + bu * e1 + bv * e2
    nrm = normalize((1.0 - bu - bv) * vn[:, 0] + bu * vn[:, 1] + bv * vn[:, 2])
    return point, nrm, rows[:, 18:21], rows[:, 21]


def trace_paths(
    scene: Scene,
    org: jnp.ndarray,
    dirn: jnp.ndarray,
    ray_keys,
    max_bounces: int = 24,
    with_stats: bool = False,
    differentiable: bool = False,
):
    """Trace a batch of camera rays to radiance [R,3].

    `ray_keys` is the counter-based RNG context (utils/rng.py), so the
    result for a pixel is independent of batching/sharding; uniforms are
    drawn as [R, 7] blocks per bounce.

    The bounce loop is a `lax.while_loop` that exits as soon as every lane
    has terminated (RR kills most paths well before max_bounces), except
    when `differentiable=True`, which uses a fixed `lax.scan` so reverse-mode
    AD works; both run the identical bounce body, so results are bitwise equal.
    """
    from mcpt.utils.rng import ray_uniforms

    R = org.shape[0]
    t_min = RAY_EPS_REL * scene.scale
    n_lights = scene.num_lights
    expand = make_expander(scene)
    light_table = pack_light_table(scene) if n_lights > 0 else None

    hit = closest_hit(scene, org, dirn, t_min=t_min)
    h = expand(hit, org, dirn)

    # bounce-0 direct emission (Render.cpp:121-122)
    emis0 = jnp.sqrt(jnp.sum(h.radiance * h.radiance, axis=-1)) > EMIT_DIRECT_THRESH
    L = jnp.where((h.valid & emis0)[:, None], h.radiance, 0.0)
    beta = jnp.ones((R, 3))
    active = h.valid

    def bounce_body(carry, b):
        dir_c, h, L, beta, active, nrays = carry
        entered = active  # lanes doing real work this bounce (NEE + path ray)
        u = ray_uniforms(ray_keys, b + 1, 7)

        kd_tex = apply_texture(scene, h)
        lobes = build_lobes(kd_tex, h.ks, h.ns)
        onb = make_onb(h.normal)
        wo_local = to_local(onb, -dir_c)

        # ---------------- NEE (Render.cpp:124-130) ----------------
        if n_lights > 0:
            lpoint, lnrm, lrad, larea = sample_light_point(
                light_table, n_lights, u[:, 0], u[:, 1], u[:, 2]
            )
            d = lpoint - h.point
            dist2 = jnp.sum(d * d, axis=-1)
            # double-where: sqrt'(0) = inf would turn dead lanes' zero
            # cotangents into NaN now that the geometric factors are
            # attached (primal is bitwise unchanged: sqrt(0) == 0)
            safe_d = dist2 > 0
            dist = jnp.where(safe_d, jnp.sqrt(jnp.where(safe_d, dist2, 1.0)), 0.0)
            # dead lanes have dist == 0 exactly; a 1e-30 floor makes the
            # division's transpose compute 1/(1e-30)^2 = inf (f32 underflow
            # of the square), and 0-cotangent x inf = NaN. The double-where
            # keeps the primal (0/1 = 0) and the partials finite.
            wl = d / jnp.maximum(jnp.where(safe_d, dist, 1.0), 1e-15)[:, None]
            cos_l = dot(-wl, lnrm)
            pdf_l = jnp.where(
                cos_l != 0.0,
                dist2 / jnp.where(cos_l != 0.0, cos_l, 1.0) / jnp.maximum(larea, 1e-30),
                0.0,
            )
            # sanitize: a denormal cos_l can push pdf_l to inf
            pdf_l = jnp.where(jnp.isfinite(pdf_l), pdf_l, 0.0)
            # pdf_l / wl / bp stay ATTACHED: they are smooth functions of the
            # scene (d^2, cos, area, lobe params) at frozen random numbers,
            # and the detached-random gradient (diff/grad.py) differentiates
            # every smooth factor — only discrete decisions are detached.
            # visibility: any-hit over (t_min, dist) — the reference's
            # inclusive t<=t2 bound would let the light occlude itself at
            # f32, so the upper bound backs off by a relative epsilon.
            # (boolean output; detach inputs so no backward graph builds)
            occluded = any_hit(
                scene, sg(h.point), sg(wl), t_min=t_min,
                t_max=sg(dist) * (1.0 - 1e-3),
            )
            wl_local = to_local(onb, wl)
            bp = bsdf_pdf(lobes, wo_local, wl_local)
            w_mis = power_heuristic(pdf_l / n_lights, bp)
            fx = bsdf_fx(lobes, wo_local, wl_local)
            cos_s = jnp.abs(dot(h.normal, wl))
            pdf_ok = jnp.abs(pdf_l) > 1e-20
            contrib = (
                w_mis[:, None]
                * beta
                * lrad
                * fx
                * (cos_s / jnp.where(pdf_ok, pdf_l, 1.0))[:, None]
                * n_lights
            )
            # |pdf_l| below ~1e-20 means the light point effectively
            # coincides with the shading point (denormal d^2): the weighted
            # contribution is analytically ~0 but evaluates as 0 * inf = NaN
            # at f32, so those samples are dropped outright.
            nee_ok = active & pdf_ok & ~occluded
            L = L + jnp.where(nee_ok[:, None], contrib, 0.0)

        # ---------------- BSDF sampling (Render.cpp:133-140) ----------------
        wi_local, f, pdf, is_mirror = bsdf_sample(
            lobes, wo_local, u[:, 3], u[:, 4], u[:, 5]
        )
        pdf = sg(pdf)
        wi_local = sg(wi_local)
        is_mirror = sg(is_mirror)
        # reference terminates on pdf == 0 (Render.cpp:135); the threshold is
        # raised to 1e-24 so denormal pdfs can't overflow beta to inf (such
        # samples are pure-firefly weight anyway)
        bsdf_ok = jnp.abs(pdf) > 1e-24
        active = active & bsdf_ok
        wi_world = to_world(onb, wi_local)
        cos_s = jnp.abs(dot(h.normal, wi_world))
        beta_new = beta * f * (cos_s / jnp.where(bsdf_ok, pdf, 1.0))[:, None]
        beta = jnp.where(active[:, None], beta_new, beta)

        # ---------------- look-ahead trace (Render.cpp:142-162) -------------
        nxt = closest_hit(scene, sg(h.point), wi_world, t_min=t_min)
        hn = expand(nxt, sg(h.point), wi_world)
        emis_n = jnp.sqrt(jnp.sum(hn.radiance**2, axis=-1)) > 0.0  # truthiness
        hit_light = active & hn.valid & emis_n & hn.front

        dl = h.point - hn.point
        dist2l = jnp.sum(dl * dl, axis=-1)
        # dead lanes (current miss + look-ahead miss both expand tri row 0)
        # have dl == 0 exactly; normalize's backward is 0/0 there. Swap in a
        # unit vector on those lanes — primal is unchanged because
        # light_pdf's numerator dist2l is 0 either way.
        safe_l = (dist2l > 0)[:, None]
        dl_safe = jnp.where(safe_l, dl, jnp.ones_like(dl))
        cos_nl = dot(normalize(dl_safe, eps=1e-30), hn.normal)
        light_pdf = jnp.where(
            cos_nl != 0.0,
            dist2l
            / jnp.where(cos_nl != 0.0, cos_nl, 1.0)
            / jnp.maximum(float(max(n_lights, 1)), 1.0)
            / jnp.maximum(hn.area, 1e-30),
            0.0,
        )
        # light_pdf attached (smooth in d^2/cos/area); the sampled-direction
        # pdf stays detached with the draw it belongs to
        w_hit = power_heuristic(pdf, sg(light_pdf))
        emit_contrib = jnp.where(
            is_mirror[:, None], beta * hn.radiance, beta * hn.radiance * w_hit[:, None]
        )
        L = L + jnp.where(hit_light[:, None], emit_contrib, 0.0)

        active = active & hn.valid

        # ---------------- Russian roulette (Render.cpp:164-170) -------------
        q = sg(jnp.minimum(jnp.max(beta, axis=-1), RR_CLAMP))
        do_rr = (b > RR_START_BOUNCE) & active
        killed = do_rr & (u[:, 6] > q)
        survived = do_rr & ~killed
        beta = jnp.where(survived[:, None], beta / jnp.maximum(q, 1e-30)[:, None], beta)
        active = active & ~killed

        # traced-ray accounting: one path ray + one shadow ray per lane that
        # entered this bounce (the reference additionally re-traces the path
        # ray at the loop head, which we don't replicate)
        nrays = nrays + jnp.sum(entered.astype(jnp.int32)) * 2

        return (wi_world, hn, L, beta, active, nrays), None

    nrays0 = jnp.asarray(R, jnp.int32)  # primary rays
    carry = (dirn, h, L, beta, active, nrays0)
    if differentiable:
        # reverse-mode needs a fixed trip count; jax.checkpoint drops the
        # per-bounce activations (the [R,C] intersection waves dominate)
        # and recomputes them in the backward sweep — memory goes from
        # O(bounces * wave) to O(wave), which is what lets 512^2 inverse
        # steps fit on one device. prevent_cse=False: scan already keeps
        # the recomputation apart, and the extra optimization barriers
        # gave non-finite kd gradients on the GPU (PERF.md, PR 1).
        carry, _ = jax.lax.scan(
            jax.checkpoint(bounce_body, prevent_cse=False), carry,
            jnp.arange(max_bounces),
        )
    else:
        # early-exit bounce loop: stop when every lane is retired
        def w_cond(state):
            b, c = state
            return (b < max_bounces) & jnp.any(c[4])

        def w_body(state):
            b, c = state
            c, _ = bounce_body(c, b)
            return b + 1, c

        _, carry = jax.lax.while_loop(w_cond, w_body, (jnp.asarray(0, jnp.int32), carry))
    L = carry[2]
    if with_stats:
        return L, carry[5]
    return L


# Rays (lanes) per wavefront chunk. Bounds the [chunk, T] intersection
# working set: a 1024^2 pass streams chunks through the same program
# instead of materializing huge [R, T] waves. Inherited from the first
# implementation; not yet swept on the GPU (ROADMAP 1d).
DEFAULT_CHUNK_RAYS = 32768
SPLIT_CHUNK_RAYS_MAX = 1 << 21  # 2M lanes ~ 250 MB of wavefront state


def wavefront_mode(scene) -> str:
    """'loop' (one lax.while_loop program, the default) or 'split' (the
    host-driven two-program loop, renderer.trace_chunk_split).

    MCPT_WAVEFRONT=split selects the split loop; both give bitwise-equal
    radiance (tested).
    """
    import os

    mode = os.environ.get("MCPT_WAVEFRONT", "loop")
    if mode not in ("loop", "split"):
        raise ValueError(f"MCPT_WAVEFRONT={mode!r} not in loop|split")
    return mode


def chunk_rays_for(scene, mode: str = None) -> int:
    """Wavefront chunk size for `scene` under `mode` (default: the
    configured wavefront_mode).

    MCPT_CHUNK_LANES overrides. Split mode takes the whole image in one
    chunk (capped): each of its device programs is one wavefront
    iteration, so wider chunks amortize the per-iteration host dispatches
    over more lanes. Loop mode keeps DEFAULT_CHUNK_RAYS.
    """
    import os

    env = os.environ.get("MCPT_CHUNK_LANES")
    if env:
        return int(env)
    if (mode or wavefront_mode(scene)) == "split":
        cam = scene.camera
        r = cam.width * cam.height
        return min(max(r, DEFAULT_CHUNK_RAYS), SPLIT_CHUNK_RAYS_MAX)
    return DEFAULT_CHUNK_RAYS


# ---------------------------------------------------------------------------
# Wavefront-regeneration integrator (the fast primal path).
#
# trace_paths keeps every lane bound to one SAMPLE: once a path dies the lane
# idles until the whole chunk finishes, and cornell-class scenes average only
# ~1.6 live bounces per 12+ executed (per-bounce occupancy collapses to <1%
# after bounce 6). Here a lane is bound to one PIXEL and renders all `spp`
# samples of that pixel back to back: when its path dies it immediately
# starts the pixel's next sample in place (classic persistent-threads
# wavefront, re-derived for XLA: one closest_hit + one any_hit per loop
# iteration over a full-width lane pool). Radiance accumulates into a
# per-lane sum, so no scatter is ever needed — lane i IS pixel i's
# accumulator. Estimator semantics are identical to trace_paths /
# the reference's iterative integrator (src/Render.cpp:111-175), including
# the ordering quirks:
#   * a ray sampled at vertex b gets its MIS emission added even if RR then
#     kills the path (reference adds look-ahead emission BEFORE the RR test,
#     Render.cpp:146-170) -> lanes carry a `last_leg` flag and die only
#     after the final trace's emission is added;
#   * the RR survival boost 1/q applies from the NEXT vertex on, not to the
#     already-sampled ray's emission (Render.cpp:168) -> the boost is
#     carried in `rr_boost` and folded into beta after the emission add.
# RNG comes from utils.rng.sample_uniforms: each uniform is a pure function
# of (seed, pixel, global sample id, bounce, slot), so results are
# deterministic and invariant to chunking/sharding, like trace_paths.
# ---------------------------------------------------------------------------


def trace_wavefront(
    scene: Scene,
    cam,
    key,
    pixel_idx: jnp.ndarray,
    start_idx,
    spp: int,
    max_bounces: int,
    lane_valid: jnp.ndarray = None,
):
    """Sum of `spp` samples' radiance for each pixel in `pixel_idx`.

    Returns (L_sum [R,3], traced_rays i32[], nan_scrubbed i32[],
    iters i32[] — wavefront loop iterations executed, the per-pass cost
    denominator for profiling). Sample s of lane i is globally identified
    as (pixel_idx[i], start_idx + s); NaNs are scrubbed per sample at
    flush, matching the reference's per-sample set_Pixel scrub
    (src/Scene.cpp:15-18). `lane_valid` masks off padding lanes entirely
    (they render nothing and count nothing).
    """
    from mcpt.render.camera import generate_rays
    from mcpt.utils.rng import MAX_TAGS, sample_uniforms

    assert max_bounces + 1 < MAX_TAGS, f"max_bounces {max_bounces} >= {MAX_TAGS - 1}"
    R = pixel_idx.shape[0]
    t_min = RAY_EPS_REL * scene.scale
    n_lights = scene.num_lights
    expand = make_expander(scene)
    light_table = pack_light_table(scene) if n_lights > 0 else None
    pix_u32 = pixel_idx.astype(jnp.uint32)
    start_u32 = jnp.asarray(start_idx, jnp.uint32)

    zero3 = jnp.zeros((R, 3))
    s_init = (
        jnp.zeros((R,), jnp.int32)
        if lane_valid is None
        else jnp.where(lane_valid, 0, spp)
    )
    st0 = {
        "s": s_init,  # next local sample to start
        "sid": jnp.zeros((R,), jnp.uint32),  # current path's global sample id
        "b": jnp.zeros((R,), jnp.int32),  # current vertex index
        "o": zero3,
        "d": jnp.ones((R, 3)),
        "prev_pdf": jnp.zeros((R,)),
        "prev_mirror": jnp.zeros((R,), bool),
        "rr_boost": jnp.ones((R,)),
        "last_leg": jnp.zeros((R,), bool),
        "L_path": zero3,
        "L_sum": zero3,
        "beta": jnp.ones((R, 3)),
        "alive": jnp.zeros((R,), bool),
        "nrays": jnp.zeros((), jnp.int32),
        "nan_ct": jnp.zeros((), jnp.int32),
        "iters": jnp.zeros((), jnp.int32),
    }

    def cond(st):
        return jnp.any(st["alive"] | (st["s"] < spp))

    def body(st):
        s, sid, b = st["s"], st["sid"], st["b"]
        o, d = st["o"], st["d"]
        prev_pdf, prev_mirror = st["prev_pdf"], st["prev_mirror"]
        rr_boost, last_leg = st["rr_boost"], st["last_leg"]
        L_path, L_sum, beta = st["L_path"], st["L_sum"], st["beta"]
        alive = st["alive"]
        nrays, nan_ct = st["nrays"], st["nan_ct"]

        # ---- regenerate: dead lanes start their pixel's next sample
        start_new = (~alive) & (s < spp)
        sid_new = start_u32 + s.astype(jnp.uint32)
        jit2 = sample_uniforms(key, pix_u32, sid_new, 0, 2)
        o_new, d_new = generate_rays(cam, jit2, pixel_idx)
        sn = start_new[:, None]
        o = jnp.where(sn, o_new, o)
        d = jnp.where(sn, d_new, d)
        sid = jnp.where(start_new, sid_new, sid)
        b = jnp.where(start_new, 0, b)
        beta = jnp.where(sn, 1.0, beta)
        L_path = jnp.where(sn, 0.0, L_path)
        prev_pdf = jnp.where(start_new, 0.0, prev_pdf)
        prev_mirror = jnp.where(start_new, False, prev_mirror)
        rr_boost = jnp.where(start_new, 1.0, rr_boost)
        last_leg = jnp.where(start_new, False, last_leg)
        s = jnp.where(start_new, s + 1, s)
        alive = alive | start_new

        # ---- trace every live lane's pending ray (camera or bounce).
        # Dead lanes (their pixel's samples are exhausted) trace a
        # guaranteed-miss ray far outside every AABB, so the BVH walk
        # retires them at the root instead of walking stale directions.
        o_eff = jnp.where(alive[:, None], o, 1e30)
        d_eff = jnp.where(alive[:, None], d, 1.0)
        hit = closest_hit(scene, o_eff, d_eff, t_min=t_min)
        h = expand(hit, o, d)
        valid = alive & h.valid
        nrays = nrays + jnp.sum(alive.astype(jnp.int32))

        # ---- emission at the reached vertex
        emis_norm = jnp.sqrt(jnp.sum(h.radiance * h.radiance, axis=-1))
        b0 = b == 0
        # bounce-0 direct add (Render.cpp:121-122)
        L_path = L_path + jnp.where(
            (valid & b0 & (emis_norm > EMIT_DIRECT_THRESH))[:, None], h.radiance, 0.0
        )
        # look-ahead MIS emission (Render.cpp:146-162): prev vertex is o
        dl = o - h.point
        dist2l = jnp.sum(dl * dl, axis=-1)
        cos_nl = dot(normalize(dl, eps=1e-30), h.normal)
        light_pdf = jnp.where(
            cos_nl != 0.0,
            dist2l
            / jnp.where(cos_nl != 0.0, cos_nl, 1.0)
            / jnp.maximum(float(max(n_lights, 1)), 1.0)
            / jnp.maximum(h.area, 1e-30),
            0.0,
        )
        w_hit = power_heuristic(prev_pdf, light_pdf)
        hit_light = valid & ~b0 & (emis_norm > 0.0) & h.front
        emit_contrib = jnp.where(
            prev_mirror[:, None], beta * h.radiance, beta * h.radiance * w_hit[:, None]
        )
        L_path = L_path + jnp.where(hit_light[:, None], emit_contrib, 0.0)

        # RR survival boost applies from THIS vertex on (Render.cpp:168)
        beta = beta * rr_boost[:, None]
        rr_boost = jnp.ones((R,))

        # ---- vertex shading: lanes continuing past this vertex
        at_vertex = valid & ~last_leg
        u = sample_uniforms(key, pix_u32, sid, (b + 1).astype(jnp.uint32), 7)
        kd_tex = apply_texture(scene, h)
        lobes = build_lobes(kd_tex, h.ks, h.ns)
        onb = make_onb(h.normal)
        wo_local = to_local(onb, -d)

        # NEE (Render.cpp:124-130)
        if n_lights > 0:
            lpoint, lnrm, lrad, larea = sample_light_point(
                light_table, n_lights, u[:, 0], u[:, 1], u[:, 2]
            )
            dnee = lpoint - h.point
            dist2 = jnp.sum(dnee * dnee, axis=-1)
            dist = jnp.sqrt(dist2)
            wl = dnee / jnp.maximum(dist, 1e-30)[:, None]
            cos_l = dot(-wl, lnrm)
            pdf_l = jnp.where(
                cos_l != 0.0,
                dist2 / jnp.where(cos_l != 0.0, cos_l, 1.0) / jnp.maximum(larea, 1e-30),
                0.0,
            )
            pdf_l = jnp.where(jnp.isfinite(pdf_l), pdf_l, 0.0)
            # lanes not shading this bounce get t_max = 0 (< t_min): the
            # traversal prunes them to zero visits instead of tracing a
            # stale shadow ray
            dist_eff = jnp.where(at_vertex, dist, 0.0)
            occluded = any_hit(
                scene, h.point, wl, t_min=t_min, t_max=dist_eff * (1.0 - 1e-3)
            )
            wl_local = to_local(onb, wl)
            bp = bsdf_pdf(lobes, wo_local, wl_local)
            w_mis = power_heuristic(pdf_l / n_lights, bp)
            fx = bsdf_fx(lobes, wo_local, wl_local)
            cos_s = jnp.abs(dot(h.normal, wl))
            pdf_ok = jnp.abs(pdf_l) > 1e-20
            contrib = (
                w_mis[:, None]
                * beta
                * lrad
                * fx
                * (cos_s / jnp.where(pdf_ok, pdf_l, 1.0))[:, None]
                * n_lights
            )
            nee_ok = at_vertex & pdf_ok & ~occluded
            L_path = L_path + jnp.where(nee_ok[:, None], contrib, 0.0)
            nrays = nrays + jnp.sum(at_vertex.astype(jnp.int32))

        # BSDF sampling (Render.cpp:133-140)
        wi_local, f, pdf, is_mirror = bsdf_sample(
            lobes, wo_local, u[:, 3], u[:, 4], u[:, 5]
        )
        bsdf_ok = jnp.abs(pdf) > 1e-24
        wi_world = to_world(onb, wi_local)
        cos_s = jnp.abs(dot(h.normal, wi_world))
        beta_new = beta * f * (cos_s / jnp.where(bsdf_ok, pdf, 1.0))[:, None]
        cont = at_vertex & bsdf_ok
        beta = jnp.where(cont[:, None], beta_new, beta)

        # RR (Render.cpp:164-170): the sampled ray still traces + adds its
        # emission next iteration; a kill only makes that leg the last one
        q = jnp.minimum(jnp.max(beta, axis=-1), RR_CLAMP)
        do_rr = (b > RR_START_BOUNCE) & cont
        killed = do_rr & (u[:, 6] > q)
        survived = do_rr & ~killed
        rr_boost = jnp.where(survived, 1.0 / jnp.maximum(q, 1e-30), 1.0)
        last_leg = killed | (b >= max_bounces - 1)

        # advance path state
        o = jnp.where(cont[:, None], h.point, o)
        d = jnp.where(cont[:, None], wi_world, d)
        prev_pdf = jnp.where(cont, pdf, prev_pdf)
        prev_mirror = jnp.where(cont, is_mirror, prev_mirror)
        b = jnp.where(cont, b + 1, b)

        # lanes that missed, ran out of pdf, or just traced their last leg die
        alive_next = cont
        flushed = alive & ~alive_next
        nan_mask = jnp.isnan(L_path) & flushed[:, None]
        nan_ct = nan_ct + jnp.sum(nan_mask).astype(jnp.int32)
        L_clean = jnp.where(nan_mask, 0.0, L_path)
        L_sum = L_sum + jnp.where(flushed[:, None], L_clean, 0.0)
        alive = alive_next

        return {
            "s": s,
            "sid": sid,
            "b": b,
            "o": o,
            "d": d,
            "prev_pdf": prev_pdf,
            "prev_mirror": prev_mirror,
            "rr_boost": rr_boost,
            "last_leg": last_leg,
            "L_path": L_path,
            "L_sum": L_sum,
            "beta": beta,
            "alive": alive,
            "nrays": nrays,
            "nan_ct": nan_ct,
            "iters": st["iters"] + 1,
        }

    st = jax.lax.while_loop(cond, body, st0)
    return st["L_sum"], st["nrays"], st["nan_ct"], st["iters"]


def trace_image_wavefront(
    scene: Scene,
    cam,
    key,
    pixel_idx: jnp.ndarray,
    start_idx,
    spp: int,
    max_bounces: int,
    chunk_rays: int = DEFAULT_CHUNK_RAYS,
):
    """trace_wavefront chunked over the pixel batch (static shapes).

    Returns (L_sum [R,3], traced_rays, nan_scrubbed). Chunking cannot change
    any sample: the RNG is keyed by (pixel, global sample id).
    """
    R = pixel_idx.shape[0]
    chunk = min(chunk_rays, R)
    n_chunks = -(-R // chunk)
    Rp = n_chunks * chunk
    pidx = jnp.concatenate([pixel_idx, jnp.zeros((Rp - R,), jnp.int32)])
    lane_valid = jnp.arange(Rp) < R

    def one_chunk(carry, xs):
        pidx_chunk, valid_chunk = xs
        nrays, nan_ct = carry
        L, nr, nc, _ = trace_wavefront(
            scene, cam, key, pidx_chunk, start_idx, spp, max_bounces,
            lane_valid=None if Rp == R else valid_chunk,
        )
        return (nrays + nr, nan_ct + nc), L

    if n_chunks == 1:
        (nrays, nan_ct), L = one_chunk(
            (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32)),
            (pidx, lane_valid),
        )
        L = L[:R]
    else:
        (nrays, nan_ct), Ls = jax.lax.scan(
            one_chunk,
            (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32)),
            (pidx.reshape(n_chunks, chunk), lane_valid.reshape(n_chunks, chunk)),
        )
        L = Ls.reshape(Rp, 3)[:R]
    return L, nrays, nan_ct


# ---------------------------------------------------------------------------
# Two-program pipelined wavefront (host-driven).
#
# The while-loop wavefront above runs a whole chunk as ONE device program.
# This variant splits each wavefront iteration into TWO device programs
# dispatched from the host —
#
#   P (trace):  closest_hit(ray batch) + any_hit(shadow batch)
#   X (shade):  the ENTIRE integrator shell, with no intersection inside
#
# so an intersection kernel that does not combine well with the rest of
# the loop body can run in a program of its own, and the host can compact
# straggler lanes into smaller programs between iterations. The NEE
# occlusion is pipelined one iteration: the shadow ray built at vertex k is
# tested by P(k+1) and its contribution lands at X(k+1) BEFORE
# emission(k+1) — the exact add order of the fused loop, so L_sum is
# BITWISE-equal to trace_wavefront (tested). Lanes dying at a vertex
# already survive one iteration for the reference's look-ahead emission
# (Render.cpp:146-170); the deferred shadow test rides that same
# iteration, so occupancy is unchanged. The host queues P/X pairs
# asynchronously (no readbacks between dispatches) and polls the lane
# count with a LOOKAHEAD lag, so the device does not wait on the host.
# Selected by MCPT_WAVEFRONT=split; which of the two is faster on the GPU
# is recorded in PERF.md.
# ---------------------------------------------------------------------------


def split_state0(R: int, spp: int, lane_valid=None):
    """Initial pipelined-wavefront state (all lanes dead, nothing pending).

    Every field is a DISTINCT buffer (no shared zeros): the state dict is
    donated whole to the shade program, and donating one buffer twice is a
    runtime error.
    """
    def zero3():
        return jnp.zeros((R, 3))

    s_init = (
        jnp.zeros((R,), jnp.int32)
        if lane_valid is None
        else jnp.where(lane_valid, 0, spp)
    )
    return {
        "s": s_init,
        "sid": jnp.zeros((R,), jnp.uint32),
        "b": jnp.zeros((R,), jnp.int32),
        "o": jnp.full((R, 3), 1e30),
        "d": jnp.ones((R, 3)),
        "so": jnp.full((R, 3), 1e30),  # pending shadow ray
        "sd": jnp.ones((R, 3)),
        "smax": jnp.zeros((R,)),
        "prev_pdf": jnp.zeros((R,)),
        "prev_mirror": jnp.zeros((R,), bool),
        "rr_boost": jnp.ones((R,)),
        "last_leg": jnp.zeros((R,), bool),
        "pend_ok": jnp.zeros((R,), bool),
        "pend_contrib": zero3(),
        "L_path": zero3(),
        "L_sum": zero3(),
        "beta": jnp.ones((R, 3)),
        "alive": jnp.zeros((R,), bool),  # not yet flushed
        "tracing": jnp.zeros((R,), bool),  # current ray is real
        "nrays": jnp.zeros((), jnp.int32),
        "nan_ct": jnp.zeros((), jnp.int32),
        "iters": jnp.zeros((), jnp.int32),
    }


def split_trace(scene: Scene, o, d, so, sd, smax):
    """Program P: one closest + one shadow any-hit, nothing else.

    Returns (hit_t, hit_tri, occl).
    """
    t_min = RAY_EPS_REL * scene.scale
    hit = closest_hit(scene, o, d, t_min=t_min)
    occ = any_hit(scene, so, sd, t_min=t_min, t_max=smax)
    return hit.t, hit.tri, occ


def split_shade(
    scene: Scene,
    st: dict,
    hit_t,
    hit_tri,
    occl,
    key,
    pixel_idx,
    start_idx,
    spp: int,
    max_bounces: int,
):
    """Program X: the full integrator shell for one wavefront iteration.

    Same math, same RNG draws, same ADD ORDER as trace_wavefront's body
    (bitwise-equal L_sum, tested in tests/test_integrator.py); see the
    section comment for the NEE pipelining argument. Returns
    (st', n_pending) where n_pending == 0 means the chunk is finished.
    """
    from mcpt.ops.intersect import Hit
    from mcpt.render.camera import generate_rays
    from mcpt.utils.rng import MAX_TAGS, sample_uniforms

    assert max_bounces + 1 < MAX_TAGS
    R = pixel_idx.shape[0]
    n_lights = scene.num_lights
    expand = make_expander(scene)
    light_table = pack_light_table(scene) if n_lights > 0 else None
    pix_u32 = pixel_idx.astype(jnp.uint32)
    start_u32 = jnp.asarray(start_idx, jnp.uint32)

    s, sid, b = st["s"], st["sid"], st["b"]
    o, d = st["o"], st["d"]
    prev_pdf, prev_mirror = st["prev_pdf"], st["prev_mirror"]
    rr_boost, last_leg = st["rr_boost"], st["last_leg"]
    L_path, L_sum, beta = st["L_path"], st["L_sum"], st["beta"]
    alive, tracing = st["alive"], st["tracing"]
    nrays, nan_ct = st["nrays"], st["nan_ct"]

    # ---- resolve the PREVIOUS vertex's NEE with its occlusion result
    # (lands before this vertex's emission -> the fused loop's add order)
    L_path = L_path + jnp.where(
        (st["pend_ok"] & ~occl)[:, None], st["pend_contrib"], 0.0
    )

    # ---- expand the hit P just returned
    h = expand(Hit(t=hit_t, tri=hit_tri), o, d)
    valid = tracing & h.valid

    # ---- emission at the reached vertex (identical to trace_wavefront)
    emis_norm = jnp.sqrt(jnp.sum(h.radiance * h.radiance, axis=-1))
    b0 = b == 0
    L_path = L_path + jnp.where(
        (valid & b0 & (emis_norm > EMIT_DIRECT_THRESH))[:, None], h.radiance, 0.0
    )
    dl = o - h.point
    dist2l = jnp.sum(dl * dl, axis=-1)
    cos_nl = dot(normalize(dl, eps=1e-30), h.normal)
    light_pdf = jnp.where(
        cos_nl != 0.0,
        dist2l
        / jnp.where(cos_nl != 0.0, cos_nl, 1.0)
        / jnp.maximum(float(max(n_lights, 1)), 1.0)
        / jnp.maximum(h.area, 1e-30),
        0.0,
    )
    w_hit = power_heuristic(prev_pdf, light_pdf)
    hit_light = valid & ~b0 & (emis_norm > 0.0) & h.front
    emit_contrib = jnp.where(
        prev_mirror[:, None], beta * h.radiance, beta * h.radiance * w_hit[:, None]
    )
    L_path = L_path + jnp.where(hit_light[:, None], emit_contrib, 0.0)

    beta = beta * rr_boost[:, None]
    rr_boost = jnp.ones((R,))

    # ---- vertex shading
    at_vertex = valid & ~last_leg
    u = sample_uniforms(key, pix_u32, sid, (b + 1).astype(jnp.uint32), 7)
    kd_tex = apply_texture(scene, h)
    lobes = build_lobes(kd_tex, h.ks, h.ns)
    onb = make_onb(h.normal)
    wo_local = to_local(onb, -d)

    # NEE: build this vertex's shadow ray + contribution, resolved at the
    # NEXT shade step with P's occlusion answer
    if n_lights > 0:
        lpoint, lnrm, lrad, larea = sample_light_point(
            light_table, n_lights, u[:, 0], u[:, 1], u[:, 2]
        )
        dnee = lpoint - h.point
        dist2 = jnp.sum(dnee * dnee, axis=-1)
        dist = jnp.sqrt(dist2)
        wl = dnee / jnp.maximum(dist, 1e-30)[:, None]
        cos_l = dot(-wl, lnrm)
        pdf_l = jnp.where(
            cos_l != 0.0,
            dist2 / jnp.where(cos_l != 0.0, cos_l, 1.0) / jnp.maximum(larea, 1e-30),
            0.0,
        )
        pdf_l = jnp.where(jnp.isfinite(pdf_l), pdf_l, 0.0)
        wl_local = to_local(onb, wl)
        bp = bsdf_pdf(lobes, wo_local, wl_local)
        w_mis = power_heuristic(pdf_l / n_lights, bp)
        fx = bsdf_fx(lobes, wo_local, wl_local)
        cos_s = jnp.abs(dot(h.normal, wl))
        pdf_ok = jnp.abs(pdf_l) > 1e-20
        contrib = (
            w_mis[:, None]
            * beta
            * lrad
            * fx
            * (cos_s / jnp.where(pdf_ok, pdf_l, 1.0))[:, None]
            * n_lights
        )
        pend_ok = at_vertex & pdf_ok
        pend_contrib = jnp.where(pend_ok[:, None], contrib, 0.0)
        so = h.point
        sd = wl
        smax = jnp.where(at_vertex, dist * (1.0 - 1e-3), 0.0)
        nrays = nrays + jnp.sum(at_vertex.astype(jnp.int32))
    else:
        pend_ok = jnp.zeros((R,), bool)
        pend_contrib = jnp.zeros((R, 3))
        so = jnp.full((R, 3), 1e30)
        sd = jnp.ones((R, 3))
        smax = jnp.zeros((R,))

    # BSDF sampling + RR (identical to trace_wavefront)
    wi_local, f, pdf, is_mirror = bsdf_sample(
        lobes, wo_local, u[:, 3], u[:, 4], u[:, 5]
    )
    bsdf_ok = jnp.abs(pdf) > 1e-24
    wi_world = to_world(onb, wi_local)
    cos_s2 = jnp.abs(dot(h.normal, wi_world))
    beta_new = beta * f * (cos_s2 / jnp.where(bsdf_ok, pdf, 1.0))[:, None]
    cont = at_vertex & bsdf_ok
    beta = jnp.where(cont[:, None], beta_new, beta)

    q = jnp.minimum(jnp.max(beta, axis=-1), RR_CLAMP)
    do_rr = (b > RR_START_BOUNCE) & cont
    killed = do_rr & (u[:, 6] > q)
    survived = do_rr & ~killed
    rr_boost = jnp.where(survived, 1.0 / jnp.maximum(q, 1e-30), 1.0)
    last_leg = killed | (b >= max_bounces - 1)

    o = jnp.where(cont[:, None], h.point, o)
    d = jnp.where(cont[:, None], wi_world, d)
    prev_pdf = jnp.where(cont, pdf, prev_pdf)
    prev_mirror = jnp.where(cont, is_mirror, prev_mirror)
    b = jnp.where(cont, b + 1, b)

    # ---- flush. A lane with an unresolved NEE but no continuation (pdf
    # underflow at the sampled lobe) becomes a ZOMBIE: alive (unflushed)
    # but not tracing; its pending contribution lands next shade step,
    # then it flushes. Lanes that died tracing their look-ahead leg have
    # already resolved everything.
    alive_next = cont | pend_ok
    flushed = alive & ~alive_next
    nan_mask = jnp.isnan(L_path) & flushed[:, None]
    nan_ct = nan_ct + jnp.sum(nan_mask).astype(jnp.int32)
    L_clean = jnp.where(nan_mask, 0.0, L_path)
    L_sum = L_sum + jnp.where(flushed[:, None], L_clean, 0.0)
    alive = alive_next
    tracing = cont

    # ---- regenerate dead lanes for the NEXT trace
    start_new = (~alive) & (s < spp)
    sid_new = start_u32 + s.astype(jnp.uint32)
    jit2 = sample_uniforms(key, pix_u32, sid_new, 0, 2)
    cam = scene.camera
    o_new, d_new = generate_rays(cam, jit2, pixel_idx)
    sn = start_new[:, None]
    o = jnp.where(sn, o_new, o)
    d = jnp.where(sn, d_new, d)
    sid = jnp.where(start_new, sid_new, sid)
    b = jnp.where(start_new, 0, b)
    beta = jnp.where(sn, 1.0, beta)
    L_path = jnp.where(sn, 0.0, L_path)
    prev_pdf = jnp.where(start_new, 0.0, prev_pdf)
    prev_mirror = jnp.where(start_new, False, prev_mirror)
    rr_boost = jnp.where(start_new, 1.0, rr_boost)
    last_leg = jnp.where(start_new, False, last_leg)
    s = jnp.where(start_new, s + 1, s)
    alive = alive | start_new
    tracing = tracing | start_new

    # park non-tracing lanes far outside every AABB (the BVH walk retires
    # them at the root — same trick as trace_wavefront)
    o = jnp.where(tracing[:, None], o, 1e30)
    d = jnp.where(tracing[:, None], d, 1.0)
    nrays = nrays + jnp.sum(tracing.astype(jnp.int32))

    st2 = {
        "s": s, "sid": sid, "b": b, "o": o, "d": d,
        "so": so, "sd": sd, "smax": smax,
        "prev_pdf": prev_pdf, "prev_mirror": prev_mirror,
        "rr_boost": rr_boost, "last_leg": last_leg,
        "pend_ok": pend_ok, "pend_contrib": pend_contrib,
        "L_path": L_path, "L_sum": L_sum, "beta": beta,
        "alive": alive, "tracing": tracing,
        "nrays": nrays, "nan_ct": nan_ct, "iters": st["iters"] + 1,
    }
    n_pending = jnp.sum((alive | (s < spp)).astype(jnp.int32))
    return st2, n_pending


def trace_image(
    scene: Scene,
    cam,
    sample_key: jnp.ndarray,
    pixel_idx: jnp.ndarray,
    max_bounces: int,
    chunk_rays: int = DEFAULT_CHUNK_RAYS,
    with_stats: bool = False,
    differentiable: bool = False,
):
    """Trace one sample for `pixel_idx` pixels, chunked over the ray batch.

    Returns radiance [R,3] (and traced-ray count if with_stats). The RNG is
    keyed by global pixel id, so chunking does not change any sample.
    `differentiable=True` selects the fixed-trip-count bounce loop that
    reverse-mode AD requires (see trace_paths).
    """
    from mcpt.render.camera import generate_rays
    from mcpt.utils.rng import per_ray_keys, ray_uniforms

    R = pixel_idx.shape[0]
    chunk = min(chunk_rays, R)
    n_chunks = -(-R // chunk)
    Rp = n_chunks * chunk
    # padded lanes re-trace pixel 0; their output is discarded
    pidx = jnp.concatenate([pixel_idx, jnp.zeros((Rp - R,), jnp.int32)])

    def body(nrays, pidx_chunk):
        ray_keys = per_ray_keys(sample_key, pidx_chunk)
        jitter = ray_uniforms(ray_keys, 0, 2)
        org, dirn = generate_rays(cam, jitter, pidx_chunk)
        out = trace_paths(
            scene,
            org,
            dirn,
            ray_keys,
            max_bounces=max_bounces,
            with_stats=with_stats,
            differentiable=differentiable,
        )
        if with_stats:
            rad, nr = out
            return nrays + nr, rad
        return nrays, out

    if n_chunks == 1:
        nrays, rad = body(jnp.zeros((), jnp.int32), pidx)
        rad = rad[:R]
    else:
        nrays, rads = jax.lax.scan(
            body, jnp.zeros((), jnp.int32), pidx.reshape(n_chunks, chunk)
        )
        rad = rads.reshape(Rp, 3)[:R]
    if with_stats:
        return rad, nrays
    return rad
