"""Generate the benchmark scenes in the reference's scene format (OBJ+MTL+XML).

The reference renders cornell-box / veach-mis / bathroom2 from a course scene
pack (`example-scenes-cg24/`) that is gitignored in its repo
(reference .gitignore:3, src/main.cpp:7-12), so the geometry is re-authored
here from the classic published scene definitions:

  * cornell-box  — the original Cornell box dimensions (cornell.graphics.cornell.edu)
  * cornell-box-mirror — same, tall block turned into a perfect mirror
  * veach-mis    — Veach's MIS test: 4 glossy plates with varying exponents,
                   3 spherical emitters of equal power but different areas
  * bathroom-stress — procedural ~1M-triangle divergence stress scene with an
                   image texture and mirror, standing in for bathroom2

XML format matches reference src/model.cpp:211-281 (camera + top-level
<light> elements); MTL matches src/model.cpp:158-209.

Usage: python scenes/generate.py [--out scenes] [--stress-tris 1000000]

bathroom-stress.obj (~300 MB) is not committed: `mcpt.io.obj.load_obj`
calls `ensure_scene()` here, which makes it on first use (the same file as
`--stress-tris 1000000`) and checks its SHA-256.
"""
from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np


class MeshWriter:
    def __init__(self):
        self.v, self.vn, self.vt, self.faces = [], [], [], []
        self.mtl_of_face = []
        self.cur = None

    def usemtl(self, name):
        self.cur = name

    def add_tri(self, p0, p1, p2, n=None, uv=None):
        if n is None:
            e1, e2 = np.subtract(p1, p0), np.subtract(p2, p0)
            nrm = np.cross(e1, e2)
            ln = np.linalg.norm(nrm)
            nrm = nrm / ln if ln > 0 else np.array([0.0, 0.0, 1.0])
            n = [nrm, nrm, nrm]
        if uv is None:
            uv = [(0, 0), (1, 0), (1, 1)]
        base_v = len(self.v)
        base_n = len(self.vn)
        base_t = len(self.vt)
        self.v += [tuple(p0), tuple(p1), tuple(p2)]
        self.vn += [tuple(x) for x in n]
        self.vt += [tuple(x) for x in uv]
        self.faces.append(
            tuple((base_v + i + 1, base_t + i + 1, base_n + i + 1) for i in range(3))
        )
        self.mtl_of_face.append(self.cur)

    def add_quad(self, p0, p1, p2, p3, n=None, uv=None):
        """Quad split into 2 triangles; winding p0->p1->p2->p3."""
        if uv is None:
            uv = [(0, 0), (1, 0), (1, 1), (0, 1)]
        nn = None if n is None else [n, n, n]
        self.add_tri(p0, p1, p2, n=nn, uv=[uv[0], uv[1], uv[2]])
        self.add_tri(p0, p2, p3, n=nn, uv=[uv[0], uv[2], uv[3]])

    def write_obj(self, path, mtlname):
        with open(path, "w") as f:
            f.write(f"mtllib {mtlname}\n")
            for p in self.v:
                f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
            for t in self.vt:
                f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
            for n in self.vn:
                f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
            last = None
            for face, m in zip(self.faces, self.mtl_of_face):
                if m != last:
                    f.write(f"usemtl {m}\n")
                    last = m
                f.write(
                    "f "
                    + " ".join(f"{a}/{b}/{c}" for (a, b, c) in face)
                    + "\n"
                )


def write_mtl(path, mats):
    """mats: list of dicts with name, Kd, optional Ks/Ns/map_Kd."""
    with open(path, "w") as f:
        for m in mats:
            f.write(f"newmtl {m['name']}\n")
            kd = m.get("Kd", (0, 0, 0))
            f.write(f"Kd {kd[0]} {kd[1]} {kd[2]}\n")
            if "Ks" in m:
                ks = m["Ks"]
                f.write(f"Ks {ks[0]} {ks[1]} {ks[2]}\n")
            if "Ns" in m:
                f.write(f"Ns {m['Ns']}\n")
            if "map_Kd" in m:
                f.write(f"map_Kd {m['map_Kd']}\n")
            f.write("\n")


def write_xml(path, cam, lights):
    with open(path, "w") as f:
        f.write(
            f'<camera type="perspective" width="{cam["width"]}" '
            f'height="{cam["height"]}" fovy="{cam["fovy"]}">\n'
        )
        for tag in ("eye", "lookat", "up"):
            x, y, z = cam[tag]
            f.write(f'  <{tag} x="{x}" y="{y}" z="{z}"/>\n')
        f.write("</camera>\n")
        for name, rad in lights:
            f.write(
                f'<light mtlname="{name}" radiance="{rad[0]},{rad[1]},{rad[2]}"/>\n'
            )


def icosphere(center, radius, subdiv=1):
    """Return list of triangles (p0,p1,p2) of a subdivided icosahedron."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    ]
    verts = [np.array(v) / np.linalg.norm(v) for v in verts]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    for _ in range(subdiv):
        new_faces = []
        cache = {}

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = verts[i] + verts[j]
                verts.append(m / np.linalg.norm(m))
                cache[key] = len(verts) - 1
            return cache[key]

        for (a, b, c) in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
    c = np.asarray(center, np.float64)
    tris = []
    for (a, b, cc) in faces:
        tris.append(
            (
                c + radius * verts[a],
                c + radius * verts[b],
                c + radius * verts[cc],
                (verts[a], verts[b], verts[cc]),  # smooth normals
            )
        )
    return tris


# ---------------------------------------------------------------------------
# Cornell box (original Cornell measurements, cm)
# ---------------------------------------------------------------------------

def gen_cornell(out_dir, name="cornell-box", mirror_tall_block=False):
    m = MeshWriter()

    m.usemtl("white")
    # floor
    m.add_quad((552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2))
    # ceiling
    m.add_quad((556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2), (0, 548.8, 0))
    # back wall
    m.add_quad((549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2), (556, 548.8, 559.2))
    m.usemtl("green")  # right wall (x=0 side is LEFT from camera at -z... classic: x=0 green)
    m.add_quad((0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2))
    m.usemtl("red")  # left wall
    m.add_quad((552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2), (556, 548.8, 0))

    # short block
    m.usemtl("white")
    sb = [
        (130.0, 165.0, 65.0), (82.0, 165.0, 225.0),
        (240.0, 165.0, 272.0), (290.0, 165.0, 114.0),
    ]
    sbf = [(130.0, 0.0, 65.0), (82.0, 0.0, 225.0), (240.0, 0.0, 272.0), (290.0, 0.0, 114.0)]
    m.add_quad(*sb)  # top
    for i in range(4):
        j = (i + 1) % 4
        m.add_quad(sbf[i], sbf[j], sb[j], sb[i])

    # tall block
    m.usemtl("mirror" if mirror_tall_block else "white")
    tb = [
        (423.0, 330.0, 247.0), (265.0, 330.0, 296.0),
        (314.0, 330.0, 456.0), (472.0, 330.0, 406.0),
    ]
    tbf = [(423.0, 0.0, 247.0), (265.0, 0.0, 296.0), (314.0, 0.0, 456.0), (472.0, 0.0, 406.0)]
    m.add_quad(*tb)
    for i in range(4):
        j = (i + 1) % 4
        m.add_quad(tbf[i], tbf[j], tb[j], tb[i])

    # light, slightly below ceiling, facing down
    m.usemtl("light")
    y = 548.0
    m.add_quad(
        (343.0, y, 227.0), (213.0, y, 227.0), (213.0, y, 332.0), (343.0, y, 332.0),
        n=(0.0, -1.0, 0.0),
    )

    mats = [
        {"name": "white", "Kd": (0.725, 0.71, 0.68)},
        {"name": "green", "Kd": (0.14, 0.45, 0.091)},
        {"name": "red", "Kd": (0.63, 0.065, 0.05)},
        {"name": "light", "Kd": (0.65, 0.65, 0.65)},
    ]
    if mirror_tall_block:
        mats.append({"name": "mirror", "Kd": (0.0, 0.0, 0.0), "Ks": (0.95, 0.95, 0.95), "Ns": 10000})
    cam = {
        "width": 1024, "height": 1024, "fovy": 39.3077,
        "eye": (278.0, 273.0, -800.0),
        "lookat": (278.0, 273.0, -799.0),
        "up": (0.0, 1.0, 0.0),
    }
    # Radiance calibrated so the 64x64 converged render's post-tonemap mean
    # matches the reference golden results/cornell-box.obj119.png statistics
    # (0.448, 0.380, 0.269) — the original cg24 scene files are not
    # distributed, so the emission is fit to the published image.
    lights = [("light", (42.985, 38.772, 30.874))]

    m.write_obj(os.path.join(out_dir, f"{name}.obj"), f"{name}.mtl")
    write_mtl(os.path.join(out_dir, f"{name}.mtl"), mats)
    write_xml(os.path.join(out_dir, f"{name}.xml"), cam, lights)


# ---------------------------------------------------------------------------
# Veach MIS test
# ---------------------------------------------------------------------------

def gen_veach(out_dir, name="veach-mis"):
    """Veach MIS test, color-matched to the reference golden
    (/root/reference/results/veach-mis.obj313.png, post-tonemap mean RGB
    (0.250, 0.178, 0.276)): a navy-blue backdrop/floor, four PINK glossy
    slab plates (thickness visible, highlights salmon), and FOUR white
    spherical emitters of equal power whose radius grows left to right
    (0.033 / 0.1 / 0.3 / 0.9 — the classic construction: equal power makes
    the small sphere the brightest surface)."""
    m = MeshWriter()
    # Backdrop + floor (diffuse navy blue, as in the golden)
    m.usemtl("floor")
    m.add_quad((-10, -4.14615, -10), (10, -4.14615, -10), (10, -4.14615, 10), (-10, -4.14615, 10),
               n=(0, 1, 0))
    m.add_quad((-10, -10, -2), (10, -10, -2), (10, 10, -2), (-10, 10, -2), n=(0, 0, 1))

    # Four long glossy plates, tilted so each reflects the emitter row into
    # the camera (normal = bisector of to-light and to-camera directions,
    # the Veach MIS construction). Rendered as thin SLABS (the golden shows
    # their front edges).
    cam_pos = np.array([0.0, 2.0, 15.0])
    light_center = np.array([0.0, 0.0, 0.0])
    plate_centers = [
        (0.0, -1.2, 3.8),  # top (most polished)
        (0.0, -1.7, 2.9),
        (0.0, -2.2, 2.0),
        (0.0, -2.7, 1.1),  # bottom (roughest)
    ]
    half_w, half_d, th = 4.0, 0.45, 0.16
    for i, pc in enumerate(plate_centers):
        p = np.array(pc)
        to_l = light_center - p
        to_c = cam_pos - p
        n = to_l / np.linalg.norm(to_l) + to_c / np.linalg.norm(to_c)
        n /= np.linalg.norm(n)
        t = np.array([0.0, -n[2], n[1]])  # in-plane depth axis (y-z plane)
        t /= np.linalg.norm(t)
        xa = np.array([1.0, 0.0, 0.0])
        c0 = p - xa * half_w - t * half_d
        c1 = p + xa * half_w - t * half_d
        c2 = p + xa * half_w + t * half_d
        c3 = p - xa * half_w + t * half_d
        # winding chosen so the geometric normal equals n (points at camera)
        e1, e2 = c1 - c0, c2 - c0
        if np.dot(np.cross(e1, e2), n) < 0:
            c0, c1, c2, c3 = c3, c2, c1, c0
        m.usemtl(f"plate{i}")
        m.add_quad(c0, c1, c2, c3, n=tuple(n))
        # slab: bottom face + four diffuse side skirts (the visible dark
        # edges in the golden)
        b0, b1, b2, b3 = (c - n * th for c in (c0, c1, c2, c3))
        m.usemtl(f"plateside{i}")
        m.add_quad(b3, b2, b1, b0, n=tuple(-n))
        for (qa, qb, qc, qd) in ((c0, c1, b1, b0), (c1, c2, b2, b1),
                                 (c2, c3, b3, b2), (c3, c0, b0, b3)):
            side_n = np.cross(qb - qa, qc - qa)
            nl = np.linalg.norm(side_n)
            if nl > 0:
                m.add_quad(qa, qb, qc, qd, n=tuple(side_n / nl))

    # Four spherical emitters of equal power, radius growing left -> right
    radii = [0.0333, 0.1, 0.3, 0.9]
    xpos = [-3.75, -1.25, 1.25, 3.75]
    total_power = 24.0
    for i, (r, x) in enumerate(zip(radii, xpos)):
        m.usemtl(f"emit{i}")
        for (p0, p1, p2, ns) in icosphere((x, 0.0, 0.0), r, subdiv=2):
            m.add_tri(p0, p1, p2, n=ns)

    mats = [
        {"name": "floor", "Kd": (0.275, 0.15, 0.405)},
    ]
    for i, ns in enumerate((5000, 1000, 200, 50)):
        mats.append(
            {"name": f"plate{i}", "Kd": (0.38, 0.05, 0.075),
             "Ks": (0.80, 0.40, 0.44), "Ns": ns}
        )
        mats.append({"name": f"plateside{i}", "Kd": (0.22, 0.045, 0.065)})
    lights = []
    for i, r in enumerate(radii):
        area = 4 * math.pi * r * r
        rad = total_power / area
        mats.append({"name": f"emit{i}", "Kd": (0, 0, 0)})
        lights.append((f"emit{i}", (rad, rad, rad)))

    cam = {
        "width": 1280, "height": 720, "fovy": 28.0,
        "eye": (0.0, 2.0, 15.0),
        "lookat": (0.0, -2.0, 2.5),
        "up": (0.0, 1.0, 0.0),
    }
    m.write_obj(os.path.join(out_dir, f"{name}.obj"), f"{name}.mtl")
    write_mtl(os.path.join(out_dir, f"{name}.mtl"), mats)
    write_xml(os.path.join(out_dir, f"{name}.xml"), cam, lights)


# ---------------------------------------------------------------------------
# Bathroom-class stress scene: ~1M triangles, texture + mirror
# ---------------------------------------------------------------------------

def gen_stress(out_dir, name="bathroom-stress", target_tris=1_000_000, seed=0):
    rng = np.random.default_rng(seed)
    m = MeshWriter()

    # Room: 10x6x10 box, inward normals
    m.usemtl("wall")
    m.add_quad((10, 0, 0), (0, 0, 0), (0, 0, 10), (10, 0, 10), n=(0, 1, 0))      # floor
    m.add_quad((10, 6, 0), (10, 6, 10), (0, 6, 10), (0, 6, 0), n=(0, -1, 0))    # ceiling
    m.add_quad((10, 0, 10), (0, 0, 10), (0, 6, 10), (10, 6, 10), n=(0, 0, -1))  # back
    m.add_quad((0, 0, 10), (0, 0, 0), (0, 6, 0), (0, 6, 10), n=(1, 0, 0))       # left
    m.add_quad((10, 0, 0), (10, 0, 10), (10, 6, 10), (10, 6, 0), n=(-1, 0, 0))  # right

    # Textured floor panel
    m.usemtl("tiled")
    m.add_quad((9.5, 0.01, 0.5), (0.5, 0.01, 0.5), (0.5, 0.01, 9.5), (9.5, 0.01, 9.5),
               n=(0, 1, 0), uv=[(0, 0), (8, 0), (8, 8), (0, 8)])

    # Mirror panel on the back wall
    m.usemtl("mirror")
    m.add_quad((8, 1, 9.99), (2, 1, 9.99), (2, 5, 9.99), (8, 5, 9.99), n=(0, 0, -1))

    # Dense displaced height-field grid: most of the triangle budget.
    grid_budget = int(target_tris * 0.7)
    n = max(8, int(math.sqrt(grid_budget / 2)))
    m.usemtl("relief")
    xs = np.linspace(1.0, 9.0, n + 1)
    zs = np.linspace(1.0, 9.0, n + 1)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = 0.4 + 0.25 * np.sin(X * 3.1) * np.cos(Z * 2.7) + 0.1 * np.sin(X * 11 + Z * 7)
    # vertex normals of the heightfield
    dYdx = np.gradient(Y, xs, axis=0)
    dYdz = np.gradient(Y, zs, axis=1)
    for i in range(n):
        for j in range(n):
            p = lambda a, b: (X[a, b], Y[a, b], Z[a, b])
            nv = lambda a, b: _hf_normal(dYdx[a, b], dYdz[a, b])
            uvc = lambda a, b: (xs[a] / 10.0, zs[b] / 10.0)
            m.add_tri(p(i, j), p(i + 1, j), p(i + 1, j + 1),
                      n=[nv(i, j), nv(i + 1, j), nv(i + 1, j + 1)],
                      uv=[uvc(i, j), uvc(i + 1, j), uvc(i + 1, j + 1)])
            m.add_tri(p(i, j), p(i + 1, j + 1), p(i, j + 1),
                      n=[nv(i, j), nv(i + 1, j + 1), nv(i, j + 1)],
                      uv=[uvc(i, j), uvc(i + 1, j + 1), uvc(i, j + 1)])

    # Scattered icospheres for BVH irregularity
    sphere_budget = target_tris - 2 * n * n - 16
    n_spheres = max(1, sphere_budget // 320)  # subdiv=2 => 320 tris each
    m.usemtl("props")
    for _ in range(n_spheres):
        c = rng.uniform([1.5, 1.2, 1.5], [8.5, 4.5, 8.5])
        r = rng.uniform(0.05, 0.25)
        for (p0, p1, p2, ns) in icosphere(c, r, subdiv=2):
            m.add_tri(p0, p1, p2, n=ns)

    # Ceiling light
    m.usemtl("light")
    m.add_quad((6.5, 5.98, 3.5), (3.5, 5.98, 3.5), (3.5, 5.98, 6.5), (6.5, 5.98, 6.5),
               n=(0, -1, 0))

    # checker texture
    tex = _checker_png(os.path.join(out_dir, f"{name}-tiles.png"))

    mats = [
        {"name": "wall", "Kd": (0.7, 0.68, 0.65)},
        {"name": "tiled", "Kd": (0.8, 0.8, 0.8), "map_Kd": os.path.basename(tex)},
        {"name": "mirror", "Kd": (0.0, 0.0, 0.0), "Ks": (0.92, 0.94, 0.96), "Ns": 10000},
        {"name": "relief", "Kd": (0.55, 0.5, 0.45), "Ks": (0.2, 0.2, 0.2), "Ns": 80},
        {"name": "props", "Kd": (0.3, 0.45, 0.6)},
        {"name": "light", "Kd": (0.8, 0.8, 0.8)},
    ]
    cam = {
        "width": 1280, "height": 720, "fovy": 55.0,
        "eye": (5.0, 3.0, 0.3),
        "lookat": (5.0, 2.2, 5.0),
        "up": (0.0, 1.0, 0.0),
    }
    lights = [("light", (22.0, 20.0, 17.0))]
    m.write_obj(os.path.join(out_dir, f"{name}.obj"), f"{name}.mtl")
    write_mtl(os.path.join(out_dir, f"{name}.mtl"), mats)
    write_xml(os.path.join(out_dir, f"{name}.xml"), cam, lights)
    return len(m.faces)


def _hf_normal(dydx, dydz):
    n = np.array([-dydx, 1.0, -dydz])
    return n / np.linalg.norm(n)


def _checker_png(path, n=256, tiles=8):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from mcpt.io.image import write_png

    ij = np.arange(n)
    cx = (ij[:, None] * tiles // n + ij[None, :] * tiles // n) % 2
    img = np.where(cx[..., None] == 0, np.array([235, 235, 230]), np.array([40, 60, 90]))
    return write_png(path, img.astype(np.uint8))


BATHROOM_TRIS = 1_000_000
# SHA-256 of bathroom-stress.obj at BATHROOM_TRIS, as committed before the
# file was made generated: the goldens and results/ were rendered from it
BATHROOM_SHA256 = "16aa801cfb89fe8745f0ee5820e319f87aa59c9ce72527a435cc83e77986dba6"


def file_sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


def ensure_scene(path: str) -> str:
    """Return `path`, first generating it if it is the bathroom-stress OBJ
    and absent.

    The ~1M-triangle OBJ (~300 MB) is not committed: it is made from its
    seed (~40 s of host time) and must hash to BATHROOM_SHA256; a mismatch
    (numpy's RNG or float formatting drifting) removes the file and raises.
    """
    if os.path.basename(path) == "bathroom-stress.obj" and not os.path.exists(path):
        gen_stress(os.path.dirname(os.path.abspath(path)),
                   target_tris=BATHROOM_TRIS)
        got = file_sha256(path)
        if got != BATHROOM_SHA256:
            os.remove(path)
            raise RuntimeError(
                f"generated {path} has SHA-256 {got}, expected "
                f"{BATHROOM_SHA256}: the scene is not the one the goldens "
                "were rendered from")
    return path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--stress-tris", type=int, default=0,
                    help="generate bathroom-stress with ~N triangles (0 = skip)")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    gen_cornell(args.out)
    gen_cornell(args.out, name="cornell-box-mirror", mirror_tall_block=True)
    gen_veach(args.out)
    print("wrote cornell-box, cornell-box-mirror, veach-mis to", args.out)
    if args.stress_tris:
        n = gen_stress(args.out, target_tris=args.stress_tris)
        print(f"wrote bathroom-stress with {n} triangles")


if __name__ == "__main__":
    main()
