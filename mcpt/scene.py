"""Scene representation: structure-of-arrays pytrees for device rendering.

The reference keeps the scene as a pointer soup: per-triangle objects holding
shared_ptr<Material> (reference: src/Triangle.h:11-14, src/Render.cpp:12-44).
Here everything becomes flat, static-shaped arrays so the whole scene lives
in device memory, gathers are vectorized, and the arrays are replicated per
device.

Host-side loading produces numpy arrays (`SceneData.from_host`), converted to
device arrays once; all render code consumes this pytree.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls, data_fields, meta_fields=()):
    jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )
    return cls


@dataclass(frozen=True)
class Camera:
    """Pinhole camera, parsed from the scene XML (reference: src/model.cpp:211-262).

    `fovy` is the vertical field of view in degrees; ray generation matches
    reference src/Render.cpp:71-80.
    """

    eye: jnp.ndarray  # f32[3]
    lookat: jnp.ndarray  # f32[3]
    up: jnp.ndarray  # f32[3]
    fovy: jnp.ndarray  # f32[] scalar, degrees
    width: int = 512  # static
    height: int = 512  # static


_register(Camera, ["eye", "lookat", "up", "fovy"], ["width", "height"])


@dataclass(frozen=True)
class Materials:
    """Flat material table (reference: src/model.h:32-40 Material struct).

    `tr`/`ni` are parsed-but-unused in the reference (src/model.cpp:195-200,
    SURVEY §2.1#3); we keep them in the table for scene round-tripping but no
    shading code reads them.
    """

    kd: jnp.ndarray  # f32[M,3] diffuse albedo (constant-color fallback)
    ks: jnp.ndarray  # f32[M,3] specular reflectance
    ns: jnp.ndarray  # f32[M]   Blinn-Phong exponent (>=10000 => mirror)
    radiance: jnp.ndarray  # f32[M,3] emitted radiance (from XML light map)
    tex_id: jnp.ndarray  # i32[M]  index into TextureAtlas, -1 = use kd
    tr: jnp.ndarray  # f32[M,3] (unused by shading; parity only)
    ni: jnp.ndarray  # f32[M]   (unused by shading; parity only)


_register(Materials, ["kd", "ks", "ns", "radiance", "tex_id", "tr", "ni"])


@dataclass(frozen=True)
class Geometry:
    """Triangle soup in SoA layout with precomputed Moller-Trumbore edges.

    The reference stores 3 vertices per triangle and recomputes edges every
    intersection test (src/Triangle.cpp:48-64); we precompute v0/e1/e2 once.
    """

    v0: jnp.ndarray  # f32[T,3]
    e1: jnp.ndarray  # f32[T,3]  v1-v0
    e2: jnp.ndarray  # f32[T,3]  v2-v0
    vn: jnp.ndarray  # f32[T,3,3] per-vertex shading normals
    uv: jnp.ndarray  # f32[T,3,2] per-vertex texture coords
    mat_id: jnp.ndarray  # i32[T]
    area: jnp.ndarray  # f32[T] precomputed triangle area (light pdf)
    # Shared-vertex indices of the 3 corners into the ORIGINAL OBJ vertex
    # buffer (i32[T,3]); lets a displacement field over shared vertices
    # (diff/grad.SceneParams.dverts) move every incident triangle coherently,
    # so d(pixel)/d(vertex) accumulates over the full one-ring. Optional:
    # hand-built test geometries without an indexed mesh leave it None.
    vert_idx: Optional[jnp.ndarray] = None


_register(Geometry, ["v0", "e1", "e2", "vn", "uv", "mat_id", "area", "vert_idx"])


@dataclass(frozen=True)
class TextureAtlas:
    """Padded texture array: all image textures resized into one [N,H,W,3] block.

    The reference stores per-texture vectors with nearest-neighbor lookup
    (src/model.cpp:30-41); here a single padded gatherable array replaces the
    pointer indirection. `size[i] = (w, h)` is each texture's true resolution.
    """

    data: jnp.ndarray  # f32[N,H,W,3]
    size: jnp.ndarray  # i32[N,2] (w,h)


_register(TextureAtlas, ["data", "size"])


@dataclass(frozen=True)
class FlatBVH:
    """Linearized BVH with skip links for stackless traversal.

    Replaces the reference's pointer-based recursive BVH (src/BVH.{h,cpp}).
    Nodes are in DFS order: on AABB hit the next node is `i+1`, on miss it is
    `skip[i]`; `skip[i] == -1` terminates. Leaves reference a contiguous range
    of the (reordered) triangle buffer: `first[i] .. first[i]+count[i]`.
    """

    lo: jnp.ndarray  # f32[N,3]
    hi: jnp.ndarray  # f32[N,3]
    first: jnp.ndarray  # i32[N] leaf: first tri; inner: 0
    count: jnp.ndarray  # i32[N] leaf: #tris; inner: 0
    skip: jnp.ndarray  # i32[N] miss link, -1 = done


_register(FlatBVH, ["lo", "hi", "first", "count", "skip"])


@dataclass(frozen=True)
class Scene:
    """Full device scene. Replicated across the mesh; only rays are sharded."""

    geom: Geometry
    mats: Materials
    atlas: TextureAtlas
    light_tris: jnp.ndarray  # i32[L] triangle indices of emitters
    camera: Camera
    bvh: Optional[FlatBVH] = None
    # Scene bbox diagonal (static). The reference traces in f64 with absolute
    # epsilons (Ray::t1 = 1e-4, src/Render.h:30); at f32 the self-intersection
    # noise floor scales with scene size, so secondary-ray t_min is
    # `RAY_EPS_REL * scale` (see render/integrator.py).
    scale: float = 1.0
    # Number of shared vertices in the original OBJ buffer (static; sizes
    # the diff/grad displacement field when geom.vert_idx is present).
    num_verts: int = 0

    @property
    def num_tris(self) -> int:
        return self.geom.v0.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_tris.shape[0]


_register(
    Scene,
    ["geom", "mats", "atlas", "light_tris", "camera", "bvh"],
    ["scale", "num_verts"],
)


# ---------------------------------------------------------------------------
# Host-side construction
# ---------------------------------------------------------------------------

# Emitter threshold: |radiance| > 0.01 puts a triangle in the light list
# (reference: src/Render.cpp:41-42).
LIGHT_RADIANCE_THRESHOLD = 0.01


def scene_to_device(scene: Scene) -> Scene:
    """One batched transfer of the whole scene pytree to the default device.

    Host-side construction keeps every leaf as numpy; converting the full
    pytree in a single device_put replaces the per-array transfers and the
    on-device 1M-row permutation gather that made a 1M-triangle scene take
    minutes to load (each leaf moves once, already in its final order/dtype).
    """
    return jax.device_put(scene)


def build_scene_host(
    vertices: np.ndarray,  # f64[Nv,3]
    normals: np.ndarray,  # f64[Nn,3]
    uvs: np.ndarray,  # f64[Nt,2]
    faces: np.ndarray,  # i32[T,3,4]  (v_idx, vn_idx, vt_idx, mat_idx) per corner
    mats: dict,  # dict of numpy material arrays (see io/obj.py)
    atlas: "tuple[np.ndarray, np.ndarray] | None",
    camera: dict,
    to_device: bool = True,
) -> Scene:
    """Flatten indexed faces into the SoA triangle soup.

    Mirrors reference src/Render.cpp:12-44 (tranform_triangle): the material
    index is taken from face corner 0, AABB corners (here: areas) are
    precomputed, and emitters with |radiance| > 0.01 build the light list.

    With `to_device=False` every leaf stays a numpy array (the load pipeline
    permutes triangles into BVH order on host first, then converts once via
    `scene_to_device`).
    """
    f = np.asarray(faces)
    T = f.shape[0]
    v = vertices[f[:, :, 0]].astype(np.float64)  # [T,3,3]
    vn = normals[f[:, :, 1]].astype(np.float32)
    if uvs.shape[0] == 0:
        uvs = np.zeros((1, 2), np.float64)
        uv = np.zeros((T, 3, 2), np.float32)
    else:
        uv = uvs[np.clip(f[:, :, 2], 0, uvs.shape[0] - 1)].astype(np.float32)
    mat_id = f[:, 0, 3].astype(np.int32)  # corner-0 material (Render.cpp:33)

    v0 = v[:, 0]
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    radiance = mats["radiance"]
    light_mask = np.linalg.norm(radiance[mat_id], axis=-1) > LIGHT_RADIANCE_THRESHOLD
    light_tris = np.nonzero(light_mask)[0].astype(np.int32)

    if atlas is None:
        atlas_data = np.zeros((1, 1, 1, 3), np.float32)
        atlas_size = np.ones((1, 2), np.int32)
    else:
        atlas_data, atlas_size = atlas

    geom = Geometry(
        v0=np.asarray(v0, np.float32),
        e1=np.asarray(e1, np.float32),
        e2=np.asarray(e2, np.float32),
        vn=np.asarray(vn, np.float32),
        uv=np.asarray(uv, np.float32),
        mat_id=np.asarray(mat_id, np.int32),
        area=np.asarray(area, np.float32),
        vert_idx=np.asarray(f[:, :, 0], np.int32),
    )
    materials = Materials(
        kd=np.asarray(mats["kd"], np.float32),
        ks=np.asarray(mats["ks"], np.float32),
        ns=np.asarray(mats["ns"], np.float32),
        radiance=np.asarray(mats["radiance"], np.float32),
        tex_id=np.asarray(mats["tex_id"], np.int32),
        tr=np.asarray(mats.get("tr", np.zeros_like(mats["kd"])), np.float32),
        ni=np.asarray(mats.get("ni", np.ones_like(mats["ns"])), np.float32),
    )
    cam = Camera(
        eye=np.asarray(camera["eye"], np.float32),
        lookat=np.asarray(camera["lookat"], np.float32),
        up=np.asarray(camera["up"], np.float32),
        fovy=np.asarray(camera["fovy"], np.float32),
        width=int(camera["width"]),
        height=int(camera["height"]),
    )
    if vertices.shape[0] > 0:
        diag = float(np.linalg.norm(vertices.max(axis=0) - vertices.min(axis=0)))
    else:
        diag = 1.0
    scene = Scene(
        geom=geom,
        mats=materials,
        atlas=TextureAtlas(
            data=np.asarray(atlas_data, np.float32),
            size=np.asarray(atlas_size, np.int32),
        ),
        light_tris=np.asarray(light_tris, np.int32),
        camera=cam,
        bvh=None,
        scale=diag if diag > 0 else 1.0,
        num_verts=int(vertices.shape[0]),
    )
    return scene_to_device(scene) if to_device else scene


def permute_scene_tris(scene: Scene, perm: np.ndarray) -> Scene:
    """Reorder the triangle buffer (BVH leaf order) and remap light indices.

    Runs entirely in numpy: permuting 1M-triangle arrays on host is
    milliseconds, while the equivalent on-device gather (plus pulling device
    arrays back) dominated scene load time.
    """
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    g = scene.geom
    geom = Geometry(
        v0=np.asarray(g.v0)[perm],
        e1=np.asarray(g.e1)[perm],
        e2=np.asarray(g.e2)[perm],
        vn=np.asarray(g.vn)[perm],
        uv=np.asarray(g.uv)[perm],
        mat_id=np.asarray(g.mat_id)[perm],
        area=np.asarray(g.area)[perm],
        vert_idx=None if g.vert_idx is None else np.asarray(g.vert_idx)[perm],
    )
    light_tris = inv[np.asarray(scene.light_tris)].astype(np.int32)
    return dataclasses.replace(scene, geom=geom, light_tris=light_tris)
