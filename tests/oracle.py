"""Independent CPU oracle: the reference's iterative estimator in numpy f64.

This is a from-the-spec reimplementation of /root/reference/src/Render.cpp's
ACTIVE integrator (ray_tracing(Ray&), Render.cpp:111-175) used as a
correctness anchor for the JAX integrator (SURVEY §7 step 2): float64, its
own RNG, no JAX. Images from the two implementations must agree statistically
at equal spp (different RNG streams -> compare means/variances, not pixels).
"""
from __future__ import annotations

import numpy as np

PI = np.pi


def _luminance(c):
    return c[..., 0] * 0.212671 + c[..., 1] * 0.715160 + c[..., 2] * 0.072169


def _normalize(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-300)


def _dot(a, b):
    return np.sum(a * b, axis=-1)


class OracleScene:
    def __init__(self, scene):
        """Build from a device Scene pytree (f64 copies)."""
        g = scene.geom
        self.v0 = np.asarray(g.v0, np.float64)
        self.e1 = np.asarray(g.e1, np.float64)
        self.e2 = np.asarray(g.e2, np.float64)
        self.vn = np.asarray(g.vn, np.float64)
        self.mat_id = np.asarray(g.mat_id)
        self.area = np.asarray(g.area, np.float64)
        self.kd = np.asarray(scene.mats.kd, np.float64)
        self.ks = np.asarray(scene.mats.ks, np.float64)
        self.ns = np.asarray(scene.mats.ns, np.float64)
        self.radiance = np.asarray(scene.mats.radiance, np.float64)
        self.lights = np.asarray(scene.light_tris)
        self.cam = scene.camera

    # ---- intersection (brute force, f64) ----
    def closest(self, o, d, t_min, t_max=np.inf):
        R = o.shape[0]
        h = np.cross(d[:, None, :], self.e2[None])
        det = _dot(self.e1[None], h)
        ok = np.abs(det) >= 1e-5
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        s = o[:, None, :] - self.v0[None]
        u = _dot(s, h) * inv
        q = np.cross(s, self.e1[None])
        v = _dot(d[:, None, :], q) * inv
        t = _dot(self.e2[None], q) * inv
        tm = t_min if np.ndim(t_min) == 0 else t_min[:, None]
        acc = ok & (t >= tm) & (t < t_max) & (u >= 0) & (v >= 0) & (1 - u - v >= 0)
        t = np.where(acc, t, np.inf)
        k = np.argmin(t, axis=1)
        r = np.arange(R)
        tri = np.where(np.isfinite(t[r, k]), k, -1)
        return t[r, k], tri, u[r, k], v[r, k]

    def any(self, o, d, t_min, t_max):
        h = np.cross(d[:, None, :], self.e2[None])
        det = _dot(self.e1[None], h)
        ok = np.abs(det) >= 1e-6
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        s = o[:, None, :] - self.v0[None]
        u = _dot(s, h) * inv
        q = np.cross(s, self.e1[None])
        v = _dot(d[:, None, :], q) * inv
        t = _dot(self.e2[None], q) * inv
        tm = t_min if np.ndim(t_min) == 0 else t_min[:, None]
        tM = t_max if np.ndim(t_max) == 0 else t_max[:, None]
        acc = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= tm) & (t <= tM)
        return acc.any(axis=1)


def _onb(n):
    w = n
    a = np.where(
        np.abs(w[:, 0:1]) > 0.9, np.array([[0.0, 1, 0]]), np.array([[1.0, 0, 0]])
    )
    v = _normalize(np.cross(w, a))
    u = np.cross(w, v)
    return u, v, w


def _to_local(onb, t):
    u, v, w = onb
    return np.stack([_dot(t, u), _dot(t, v), _dot(t, w)], axis=-1)


def _to_world(onb, a):
    u, v, w = onb
    return a[:, 0:1] * u + a[:, 1:2] * v + a[:, 2:3] * w


def render_oracle(scene, width, height, spp, max_bounces=24, seed=0, t_min_rel=1e-4):
    """Render [H,W,3] mean radiance with the oracle estimator."""
    osc = OracleScene(scene)
    cam = osc.cam
    rng = np.random.default_rng(seed)
    R = width * height
    eye = np.asarray(cam.eye, np.float64)
    lookat = np.asarray(cam.lookat, np.float64)
    up = np.asarray(cam.up, np.float64)
    fov = float(cam.fovy)
    scale = float(np.linalg.norm(
        (osc.v0 + np.maximum.reduce([np.zeros(3), osc.e1.max(0), osc.e2.max(0)])).max(0)
        - osc.v0.min(0)
    ))
    t_min = t_min_rel * max(scale, 1e-6)

    acc = np.zeros((R, 3))
    for s in range(spp):
        idx = np.arange(R)
        x = (idx % width).astype(np.float64)
        y = (idx // width).astype(np.float64)
        hfac = np.tan(fov * PI / 180.0 * 0.5) * 2.0
        front = _normalize((lookat - eye)[None])[0]
        right = _normalize(np.cross(front, up)[None])[0]
        ju = rng.random(R)
        jv = rng.random(R)
        uu = ((x + ju) / width - 0.5) * hfac * (width / height)
        vv = ((y + jv) / height - 0.5) * hfac
        d = _normalize(front[None] + uu[:, None] * right[None] + vv[:, None] * up[None])
        o = np.broadcast_to(eye, d.shape).copy()
        acc += _trace(osc, o, d, rng, max_bounces, t_min)
    return (acc / spp).reshape(height, width, 3)


def _trace(osc, o, d, rng, max_bounces, t_min):
    R = o.shape[0]
    L = np.zeros((R, 3))
    beta = np.ones((R, 3))
    n_lights = len(osc.lights)

    t, tri, u, v = osc.closest(o, d, t_min)
    active = tri >= 0

    def hit_info(tri, u, v, d):
        trix = np.maximum(tri, 0)
        p = osc.v0[trix] + u[:, None] * osc.e1[trix] + v[:, None] * osc.e2[trix]
        vn = osc.vn[trix]
        n = _normalize((1 - u - v)[:, None] * vn[:, 0] + u[:, None] * vn[:, 1] + v[:, None] * vn[:, 2])
        front = _dot(n, d) < 0
        mat = osc.mat_id[trix]
        return p, n, front, mat, osc.area[trix]

    p, n, front, mat, area = hit_info(tri, u, v, d)
    rad = osc.radiance[mat]
    L += np.where(
        (active & (np.linalg.norm(rad, axis=-1) > 1e-4))[:, None], rad, 0.0
    )

    for b in range(max_bounces):
        if not active.any():
            break
        kd = osc.kd[mat]
        ks = osc.ks[mat]
        ns = osc.ns[mat]
        has_spec = np.linalg.norm(ks, axis=-1) > 0
        is_mirror = has_spec & (ns >= 10000)
        spec_ref = np.where(is_mirror[:, None], 1.0, ks)
        lum_d = _luminance(kd)
        lum_s = np.where(has_spec, _luminance(spec_ref), 0.0)
        lsum = lum_d + lum_s
        w_d = np.where(lsum > 0, lum_d / np.where(lsum > 0, lsum, 1), 1.0)
        w_s = np.where(lsum > 0, lum_s / np.where(lsum > 0, lsum, 1), 0.0)
        total = kd + np.where(has_spec[:, None], spec_ref, 0.0)
        mx = total.max(axis=-1)
        sc = np.where(mx >= 1, 1.0 / np.maximum(mx, 1e-30), 1.0)[:, None]
        kd = kd * sc
        spec_ref = spec_ref * sc

        onb = _onb(n)
        wo = _to_local(onb, -d)
        woz = wo[:, 2]

        def fx(wi):
            f = kd / PI
            ok = has_spec & ~is_mirror & ~((wi[:, 2] < 0) | (woz < 0))
            h = _normalize(wi + wo)
            f = f + np.where(
                ok[:, None],
                spec_ref * ((ns + 2) / (2 * PI) * np.maximum(h[:, 2], 0) ** ns)[:, None],
                0.0,
            )
            return f

        def pdf_mix(wi):
            pd = np.where((wi[:, 2] < 0) | (woz < 0), 0.0, wi[:, 2] / PI)
            ok = has_spec & ~is_mirror & ~((wi[:, 2] < 0) | (woz < 0))
            h = _normalize(wi + wo)
            pg = np.where(ok, (ns + 1) / (2 * PI) * np.maximum(h[:, 2], 0) ** ns, 0.0)
            return pd * w_d + pg * w_s

        # NEE
        if n_lights > 0:
            u0, u1, u2 = rng.random(R), rng.random(R), rng.random(R)
            li = np.minimum((u0 * n_lights).astype(int), n_lights - 1)
            lt = osc.lights[li]
            fl = u1 + u2 > 1
            bu = np.where(fl, 1 - u1, u1)[:, None]
            bv = np.where(fl, 1 - u2, u2)[:, None]
            lp = osc.v0[lt] + bu * osc.e1[lt] + bv * osc.e2[lt]
            lvn = osc.vn[lt]
            ln = _normalize((1 - bu - bv) * lvn[:, 0] + bu * lvn[:, 1] + bv * lvn[:, 2])
            lrad = osc.radiance[osc.mat_id[lt]]
            dl = lp - p
            dist2 = _dot(dl, dl)
            dist = np.sqrt(dist2)
            wl = dl / np.maximum(dist, 1e-300)[:, None]
            cosl = _dot(-wl, ln)
            pdf_l = np.where(cosl != 0, dist2 / np.where(cosl != 0, cosl, 1) / osc.area[lt], 0.0)
            occ = osc.any(p, wl, t_min, dist * (1 - 1e-3))
            wll = _to_local(onb, wl)
            w_mis = _ph(pdf_l / n_lights, pdf_mix(wll))
            coss = np.abs(_dot(n, wl))
            contrib = (
                w_mis[:, None] * beta * lrad * fx(wll)
                * (coss / np.where(pdf_l != 0, pdf_l, 1))[:, None] * n_lights
            )
            ok = active & (pdf_l != 0) & ~occ
            L += np.where(ok[:, None], contrib, 0.0)

        # BSDF sample
        ul, ua, ub = rng.random(R), rng.random(R), rng.random(R)
        tw = np.where(has_spec, w_s + w_d, w_d)
        choose_spec = has_spec & (ul * tw <= w_s)
        # diffuse
        phi = ua * 2 * PI
        th = 0.5 * np.arccos(np.clip(1 - 2 * ub, -1, 1))
        wd = np.stack([np.sin(th) * np.cos(phi), np.sin(th) * np.sin(phi), np.cos(th)], -1)
        pdf_d = np.abs(np.cos(th)) / PI
        # glossy
        cth = ub ** (1.0 / (ns + 1))
        sth = np.sqrt(np.maximum(1 - cth**2, 0))
        h = np.stack([sth * np.cos(phi), sth * np.sin(phi), cth], -1)
        wg = -wo + h * (2 * _dot(h, wo))[:, None]
        gok = wg[:, 2] >= 0
        pdf_g = np.where(gok, (ns + 1) / (2 * PI) * cth**ns, 0.0)
        # mirror
        wm = np.stack([-wo[:, 0], -wo[:, 1], woz], -1)

        pick_m = choose_spec & is_mirror
        pick_g = choose_spec & ~is_mirror
        wi = np.where(pick_m[:, None], wm, np.where(pick_g[:, None], wg, wd))
        ch_valid = (woz >= 0) & np.where(pick_g, gok, True)
        wi = np.where(ch_valid[:, None], wi, 0.0)
        f_ch = np.where(
            pick_m[:, None],
            np.where(ch_valid[:, None], 1.0 / np.maximum(woz, 1e-30)[:, None], 0.0) * np.ones(3),
            np.where(pick_g[:, None], fx(wi) - kd / PI, kd / PI),
        )
        pdf_ch = np.where(pick_m, 1.0, np.where(pick_g, pdf_g, pdf_d))
        pdf_ch = np.where(ch_valid, pdf_ch, 0.0)
        f_ch = np.where(ch_valid[:, None], f_ch, 0.0)
        chw = np.where(choose_spec, w_s, w_d)
        # add other lobes
        pd_at = np.where((wi[:, 2] < 0) | (woz < 0), 0.0, wi[:, 2] / PI)
        okg = has_spec & ~is_mirror & ~((wi[:, 2] < 0) | (woz < 0))
        hh = _normalize(wi + wo)
        pg_at = np.where(okg, (ns + 1) / (2 * PI) * np.maximum(hh[:, 2], 0) ** ns, 0.0)
        f = np.where(
            choose_spec[:, None], f_ch + kd / PI, f_ch + (fx(wi) - kd / PI)
        )
        pdf = np.where(
            choose_spec, pdf_ch * chw + pd_at * w_d, pdf_ch * chw + pg_at * w_s
        )
        active = active & (pdf != 0)
        wiw = _to_world(onb, wi)
        coss = np.abs(_dot(n, wiw))
        beta = np.where(
            active[:, None], beta * f * (coss / np.where(pdf != 0, pdf, 1))[:, None], beta
        )

        # look-ahead
        t2, tri2, u2b, v2b = osc.closest(p, wiw, t_min)
        p2, n2, front2, mat2, area2 = hit_info(tri2, u2b, v2b, wiw)
        rad2 = osc.radiance[mat2]
        emis = np.linalg.norm(rad2, axis=-1) > 0
        hitl = active & (tri2 >= 0) & emis & front2
        dl2 = p - p2
        dist2b = _dot(dl2, dl2)
        cos2 = _dot(_normalize(dl2), n2)
        lpdf = np.where(
            cos2 != 0,
            dist2b / np.where(cos2 != 0, cos2, 1) / max(n_lights, 1) / np.maximum(area2, 1e-30),
            0.0,
        )
        wh = _ph(pdf, lpdf)
        add = np.where(pick_m[:, None] & ch_valid[:, None], beta * rad2, beta * rad2 * wh[:, None])
        L += np.where(hitl[:, None], add, 0.0)

        active = active & (tri2 >= 0)

        # RR
        if b > 3:
            q = np.minimum(beta.max(axis=-1), 0.95)
            urr = rng.random(R)
            kill = active & (urr > q)
            surv = active & ~kill
            beta = np.where(surv[:, None], beta / np.maximum(q, 1e-30)[:, None], beta)
            active = active & ~kill
        else:
            rng.random(R)  # keep stream aligned across bounces

        p, n, front, mat, area = p2, n2, front2, mat2, area2
        d = wiw

    return np.where(np.isnan(L), 0.0, L)


def _ph(p1, p2):
    a = p1 * p1
    den = a + p2 * p2
    return np.where(den > 0, a / np.where(den > 0, den, 1), 0.0)
