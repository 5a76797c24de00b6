"""Branchless batched BSDF: Lambert + Blinn-Phong + perfect mirror.

The reference builds a heap-allocated lobe list per hit and dispatches through
virtual Fx/Sample/Pdf (src/BSDF.cpp:87-151). Here every ray lane evaluates all
lobes with masks — the batched form of "MoE-like" lobe dispatch (SURVEY
§2.3): no allocation, no branches, pure elementwise math over [R] batches.

Estimator parity notes (all against /root/reference/src/BSDF.cpp):
  * lobe construction: |Ks|>0 adds mirror when Ns>=10000 else Blinn-Phong;
    Diffuse always added (BSDF.cpp:96-107)
  * selection weights = Rec.709 luminance fractions of lobe reflectance,
    computed BEFORE energy-conservation rescaling (BSDF.cpp:108-109,165-186)
  * energy conservation: if max component of sum(reflect) >= 1, divide every
    lobe's reflectance by it (BSDF.cpp:188-202)
  * Diffuse.Fx has NO backface check (deliberately removed; BSDF.cpp:6-8 and
    reference README.md:24) — kd/pi unconditionally
  * Diffuse sampling: theta = 0.5*acos(1-2u) (cosine-weighted), pdf=cos/pi,
    returns f=kd/pi constant (BSDF.cpp:11-26)
  * Blinn-Phong: Fx = Ks*(n+2)/(2pi)*cos^n(theta_H); half-vector sampling
    cos(theta_H)=v^{1/(n+1)}, pdf=(n+1)/(2pi)*cos^n(theta_H) (BSDF.cpp:33-76)
  * mirror: delta lobe, f=1/cos, pdf=1, Fx=Pdf=0 for MIS (BSDF.cpp:78-85,
    BSDF.h:80-82)
  * one-sample mixture: pick lobe by weight prefix sum, then add the other
    lobes' Fx and weighted Pdf (BSDF.cpp:123-151)
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from mcpt.utils.math import PI, dot, luminance, normalize

MIRROR_NS_THRESHOLD = 10000.0  # reference BSDF.cpp:98


@dataclass(frozen=True)
class Lobes:
    """Per-lane lobe parameters after weighting + energy conservation."""

    kd: jnp.ndarray  # f32[R,3] diffuse reflectance (post-EC)
    ks: jnp.ndarray  # f32[R,3] specular reflectance (post-EC; (1,1,1) for mirror pre-EC)
    ns: jnp.ndarray  # f32[R]
    has_spec: jnp.ndarray  # bool[R]
    is_mirror: jnp.ndarray  # bool[R]
    w_d: jnp.ndarray  # f32[R] diffuse selection weight
    w_s: jnp.ndarray  # f32[R] specular selection weight


jax.tree_util.register_dataclass(
    Lobes,
    data_fields=["kd", "ks", "ns", "has_spec", "is_mirror", "w_d", "w_s"],
    meta_fields=[],
)


def build_lobes(kd_tex: jnp.ndarray, ks: jnp.ndarray, ns: jnp.ndarray) -> Lobes:
    """Construct the per-lane lobe set (reference BSDF::BSDF, BSDF.cpp:87-110)."""
    has_spec = jnp.sqrt(jnp.sum(ks * ks, axis=-1)) > 0.0  # glm::length(Ks) truthiness
    is_mirror = has_spec & (ns >= MIRROR_NS_THRESHOLD)
    spec_reflect = jnp.where(is_mirror[:, None], jnp.ones_like(ks), ks)

    # Selection weights from pre-EC luminance (BSDF.cpp:165-186).
    lum_d = luminance(kd_tex)
    lum_s = jnp.where(has_spec, luminance(spec_reflect), 0.0)
    lsum = lum_d + lum_s
    safe = lsum > 0
    # If all luminance is zero the reference leaves `weight` uninitialized
    # (UB); we define it as diffuse-only.
    w_d = jnp.where(safe, lum_d / jnp.where(safe, lsum, 1.0), 1.0)
    w_s = jnp.where(safe, lum_s / jnp.where(safe, lsum, 1.0), 0.0)

    # Energy conservation rescale (BSDF.cpp:188-202).
    total = kd_tex + jnp.where(has_spec[:, None], spec_reflect, 0.0)
    maxc = jnp.max(total, axis=-1)
    scale = jnp.where(maxc >= 1.0, 1.0 / jnp.maximum(maxc, 1e-30), 1.0)[:, None]
    return Lobes(
        kd=kd_tex * scale,
        ks=spec_reflect * scale,
        ns=ns,
        has_spec=has_spec,
        is_mirror=is_mirror,
        w_d=w_d,
        w_s=w_s,
    )


def _half_vec(wi, wo):
    return normalize(wi + wo, eps=1e-30)


def glossy_fx(lobes: Lobes, wo, wi):
    """[R,3] Blinn-Phong lobe Fx (BSDF.cpp:33-40); zero where lobe absent."""
    active = lobes.has_spec & ~lobes.is_mirror & ~((wi[..., 2] < 0) | (wo[..., 2] < 0))
    h = _half_vec(wi, wo)
    hz = jnp.maximum(h[..., 2], 0.0)
    factor = (lobes.ns + 2.0) / (2.0 * PI)
    val = lobes.ks * (factor * _safe_pow(hz, lobes.ns))[:, None]
    return jnp.where(active[:, None], val, 0.0)


def glossy_pdf(lobes: Lobes, wo, wi):
    """[R] Blinn-Phong half-vector pdf x nothing (lobe pdf only, BSDF.cpp:67-76)."""
    active = lobes.has_spec & ~lobes.is_mirror & ~((wi[..., 2] < 0) | (wo[..., 2] < 0))
    h = _half_vec(wi, wo)
    hz = jnp.maximum(h[..., 2], 0.0)
    val = (lobes.ns + 1.0) / (2.0 * PI) * _safe_pow(hz, lobes.ns)
    return jnp.where(active, val, 0.0)


def diffuse_fx(lobes: Lobes):
    """[R,3] Lambert Fx = kd/pi, NO backface check (BSDF.cpp:4-9)."""
    return lobes.kd / PI


def diffuse_pdf(wo, wi):
    """[R] cosine pdf with the reference's sign cutoffs (BSDF.cpp:28-31)."""
    bad = (wi[..., 2] < 0) | (wo[..., 2] < 0)
    return jnp.where(bad, 0.0, wi[..., 2] / PI)


def _safe_pow(base, exp):
    """pow with base>=0; 0^0 := 1 like std::pow.

    Backward-safe at base == 0 via the double-where pattern. The floor must
    be a NORMAL f32: a denormal guard (the old 1e-38 < min-normal
    1.1754944e-38) is flushed to zero by the backend's FTZ mode, so
    log(max(0, 1e-38)) evaluated log(0) = -inf and its transpose emitted
    NaN even at zero cotangent — which poisoned the entire dverts gradient
    through the packed tri-table matmul (tests/test_grad.py vertex FD).
    """
    safe = base > 0
    b = jnp.maximum(jnp.where(safe, base, 1.0), 1.2e-38)
    return jnp.where(
        safe, jnp.exp(exp * jnp.log(b)), jnp.where(exp == 0, 1.0, 0.0)
    )


def bsdf_fx(lobes: Lobes, wo, wi):
    """Sum of lobe Fx, world-free (local frame inputs). Reference BSDF::Fx."""
    return diffuse_fx(lobes) + glossy_fx(lobes, wo, wi)


def bsdf_pdf(lobes: Lobes, wo, wi):
    """Weighted sum of lobe pdfs (reference BSDF::Pdf, BSDF.cpp:153-163)."""
    return diffuse_pdf(wo, wi) * lobes.w_d + glossy_pdf(lobes, wo, wi) * lobes.w_s


def bsdf_sample(lobes: Lobes, wo, u_lobe, u1, u2):
    """One-sample-MIS lobe mixture sampling (reference BSDF::Sample).

    Args: wo local view dir [R,3]; u_lobe/u1/u2 uniforms [R].
    Returns (wi [R,3], f [R,3], pdf [R], is_mirror_sample bool[R]).
    All quantities are zero/invalid where pdf == 0 (caller masks).
    """
    R = wo.shape[0]
    wo_z = wo[..., 2]
    valid_view = wo_z >= 0  # every lobe zero-samples when wo.z < 0

    # --- lobe choice by prefix-sum of weights, spec lobe first when present
    # (bxdfs order: [spec?, diffuse], BSDF.cpp:96-107,125-133).
    total_w = jnp.where(lobes.has_spec, lobes.w_s + lobes.w_d, lobes.w_d)
    choose_spec = lobes.has_spec & (u_lobe * total_w <= lobes.w_s)

    # --- diffuse candidate: theta = 0.5*acos(1-2u) (BSDF.cpp:16-23)
    phi_d = u1 * (2.0 * PI)
    theta = 0.5 * jnp.arccos(jnp.clip(1.0 - 2.0 * u2, -1.0, 1.0))
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    wi_d = jnp.stack([sin_t * jnp.cos(phi_d), sin_t * jnp.sin(phi_d), cos_t], axis=-1)
    pdf_d = jnp.abs(cos_t) / PI
    f_d = diffuse_fx(lobes)

    # --- glossy candidate: half-vector sampling (BSDF.cpp:42-65)
    phi_s = u1 * (2.0 * PI)
    cos_th = _safe_pow(u2, 1.0 / (lobes.ns + 1.0))
    sin_th = jnp.sqrt(jnp.maximum(1.0 - cos_th * cos_th, 0.0))
    h = jnp.stack([sin_th * jnp.cos(phi_s), sin_th * jnp.sin(phi_s), cos_th], axis=-1)
    wi_g = -wo + h * (2.0 * dot(h, wo))[:, None]
    glossy_ok = wi_g[..., 2] >= 0
    pdf_g = jnp.where(
        glossy_ok, (lobes.ns + 1.0) / (2.0 * PI) * _safe_pow(cos_th, lobes.ns), 0.0
    )
    f_g = glossy_fx(lobes, wo, wi_g)

    # --- mirror candidate (BSDF.cpp:78-85)
    wi_m = jnp.stack([-wo[..., 0], -wo[..., 1], wo_z], axis=-1)
    # Backward-safe denominator: masked (wo_z <= 0) lanes still evaluate
    # d(1/x) = -1/x^2 in the transpose; with the old 1e-30 floor x^2
    # underflowed f32 to 0, so the partial was -inf and 0-cotangent x inf
    # = NaN poisoned every upstream parameter. 1e-15 keeps x^2 normal.
    f_m = jnp.where(
        valid_view[:, None],
        1.0 / jnp.maximum(wo_z, 1e-15)[:, None] * jnp.ones_like(wo),
        0.0,
    )
    pdf_m = jnp.where(valid_view, 1.0, 0.0)

    # --- select the chosen lobe's candidate
    pick_mirror = choose_spec & lobes.is_mirror
    pick_glossy = choose_spec & ~lobes.is_mirror
    wi = jnp.where(
        pick_mirror[:, None], wi_m, jnp.where(pick_glossy[:, None], wi_g, wi_d)
    )
    chosen_f = jnp.where(
        pick_mirror[:, None], f_m, jnp.where(pick_glossy[:, None], f_g, f_d)
    )
    chosen_pdf = jnp.where(pick_mirror, pdf_m, jnp.where(pick_glossy, pdf_g, pdf_d))
    chosen_w = jnp.where(choose_spec, lobes.w_s, lobes.w_d)

    # Chosen-lobe zero-sample conditions (each lobe's early returns).
    chosen_valid = valid_view & jnp.where(pick_glossy, glossy_ok, True)
    chosen_pdf = jnp.where(chosen_valid, chosen_pdf, 0.0)
    chosen_f = jnp.where(chosen_valid[:, None], chosen_f, 0.0)
    wi = jnp.where(chosen_valid[:, None], wi, 0.0)

    # --- one-sample MIS mixture: add other lobes' Fx / weighted Pdf
    # (BSDF.cpp:138-148). Mirror's Fx/Pdf are 0 so only two cross terms exist.
    other_f_for_spec = diffuse_fx(lobes)  # diffuse Fx has no cutoffs
    other_pdf_for_spec = diffuse_pdf(wo, wi) * lobes.w_d
    other_f_for_diff = glossy_fx(lobes, wo, wi)  # zero when no glossy lobe
    other_pdf_for_diff = glossy_pdf(lobes, wo, wi) * lobes.w_s

    f = jnp.where(
        choose_spec[:, None],
        chosen_f + other_f_for_spec,
        chosen_f + other_f_for_diff,
    )
    pdf = jnp.where(
        choose_spec,
        chosen_pdf * chosen_w + other_pdf_for_spec,
        chosen_pdf * chosen_w + other_pdf_for_diff,
    )
    return wi, f, pdf, pick_mirror & chosen_valid
