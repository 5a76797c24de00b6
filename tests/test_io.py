"""Scene loading tests: OBJ/MTL/XML parity with the reference loader
(reference src/model.cpp:44-281)."""
import os

import numpy as np
import pytest

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def test_cornell_counts(cornell_scene):
    # 5 walls*2 + 2 boxes*5 quads*2 + light*2 = 10 + 20 + 2 = 32
    assert cornell_scene.num_tris == 32
    assert cornell_scene.num_lights == 2  # one emissive quad = 2 tris
    assert cornell_scene.camera.width == 1024
    assert cornell_scene.camera.height == 1024


def test_cornell_camera(cornell_scene):
    cam = cornell_scene.camera
    np.testing.assert_allclose(np.asarray(cam.eye), [278, 273, -800])
    np.testing.assert_allclose(np.asarray(cam.lookat), [278, 273, -799])
    np.testing.assert_allclose(float(cam.fovy), 39.3077, rtol=1e-5)


def test_radiance_wired_from_xml(cornell_scene):
    # XML <light mtlname="light" radiance="18.4,15.6,8.0"/> must land on the
    # material named "light" (reference src/model.cpp:177-184).
    rad = np.asarray(cornell_scene.mats.radiance)
    emissive = np.linalg.norm(rad, axis=-1) > 0.01
    assert emissive.sum() == 1
    np.testing.assert_allclose(rad[emissive][0], [42.985, 38.772, 30.874])


def test_light_list_threshold(cornell_scene):
    # light triangles have |radiance| > 0.01 (reference Render.cpp:41-42)
    g = cornell_scene.geom
    rad = np.asarray(cornell_scene.mats.radiance)
    lt = np.asarray(cornell_scene.light_tris)
    mat = np.asarray(g.mat_id)
    assert (np.linalg.norm(rad[mat[lt]], axis=-1) > 0.01).all()


def test_mtl_ks_ns(veach_scene):
    ks = np.asarray(veach_scene.mats.ks)
    ns = np.asarray(veach_scene.mats.ns)
    # 4 glossy plates with Ns 5000/1000/200/50
    glossy = np.linalg.norm(ks, axis=-1) > 0
    assert glossy.sum() == 4
    assert sorted(ns[glossy].tolist()) == [50, 200, 1000, 5000]


def test_geometry_areas(cornell_scene):
    g = cornell_scene.geom
    area = np.asarray(g.area)
    e1 = np.asarray(g.e1)
    e2 = np.asarray(g.e2)
    ref = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    np.testing.assert_allclose(area, ref, rtol=1e-5)


def test_obj_quad_fan(tmp_path):
    # polygons beyond triangles are fan-triangulated
    p = tmp_path / "quad.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 1\nvt 0 0\n"
        "f 1/1/1 2/1/1 3/1/1 4/1/1\n"
    )
    from mcpt.io.obj import load_obj

    host = load_obj(str(p))
    assert host.faces.shape[0] == 2


def test_missing_xml_defaults(tmp_path):
    from mcpt.io.obj import load_obj

    p = tmp_path / "bare.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nvt 0 0\nf 1/1/1 2/1/1 3/1/1\n")
    host = load_obj(str(p))
    assert host.camera["width"] == 512
    assert host.faces.shape == (1, 3, 4)


def test_xml_multiroot_fragment(tmp_path):
    # reference XML files are multi-root fragments (camera + lights siblings)
    from mcpt.io.obj import load_xml_camera

    p = tmp_path / "s.xml"
    p.write_text(
        '<camera type="perspective" width="100" height="50" fovy="45">\n'
        '<eye x="1" y="2" z="3"/><lookat x="0" y="0" z="0"/><up x="0" y="1" z="0"/>\n'
        "</camera>\n"
        '<light mtlname="a" radiance="1,2,3"/>\n'
        '<light mtlname="b" radiance="4,5,6"/>\n'
    )
    cam, lights = load_xml_camera(str(p))
    assert cam["width"] == 100 and cam["height"] == 50
    np.testing.assert_allclose(lights["a"], [1, 2, 3])
    np.testing.assert_allclose(lights["b"], [4, 5, 6])


def test_tonemap_roundtrip():
    from mcpt.io.image import tonemap

    acc = np.array([[[0.25, 1.0, 4.0]]], np.float32) * 2.0
    out = tonemap(acc, 2.0)  # mean = (0.25, 1, 4) -> clamp -> sqrt
    np.testing.assert_array_equal(out[0, 0], [127, 255, 255])


def test_load_hdr_flat_and_rle(tmp_path):
    """Radiance RGBE decode parity with stbi_loadf: c * 2^(e-136)."""
    import numpy as np

    from mcpt.io.image import load_hdr

    H, W = 4, 16
    rng = np.random.default_rng(0)
    rgbe = rng.integers(1, 255, (H, W, 4), dtype=np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (H, W))
    want = rgbe[..., :3].astype(np.float32) * np.ldexp(
        np.float32(1.0), rgbe[..., 3].astype(np.int32) - 136
    )[..., None]

    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {H} +X {W}\n".encode()

    flat = tmp_path / "flat.hdr"
    flat.write_bytes(header + rgbe.tobytes())
    np.testing.assert_allclose(load_hdr(str(flat)), want, rtol=1e-6)

    # new-style RLE: per scanline, marker 2 2 hi lo then 4 component streams
    out = bytearray(header)
    for y in range(H):
        out += bytes([2, 2, W >> 8, W & 0xFF])
        for ch in range(4):
            row = rgbe[y, :, ch]
            # encode as one literal run + one repeated run for coverage
            half = W // 2
            out += bytes([half]) + row[:half].tobytes()
            out += bytes([128 + half, int(row[half])])
            # make the repeated-run data consistent with `want`
            rgbe[y, half:, ch] = row[half]
    want = rgbe[..., :3].astype(np.float32) * np.ldexp(
        np.float32(1.0), rgbe[..., 3].astype(np.int32) - 136
    )[..., None]
    rle = tmp_path / "rle.hdr"
    rle.write_bytes(bytes(out))
    np.testing.assert_allclose(load_hdr(str(rle)), want, rtol=1e-6)


def test_missing_obj_made_by_generator_beside_it(tmp_path):
    """load_obj asks a generate.py in the scene's directory to make a
    missing OBJ, so every entry point loads generated scenes the same way."""
    from mcpt.io.obj import load_obj

    (tmp_path / "generate.py").write_text(
        "def ensure_scene(path):\n"
        "    with open(path, 'w') as f:\n"
        "        f.write('v 0 0 0\\nv 1 0 0\\nv 0 1 0\\nf 1 2 3\\n')\n"
        "    return path\n")
    host = load_obj(str(tmp_path / "made.obj"), use_native=False)
    assert (tmp_path / "made.obj").exists()
    assert len(host.faces) == 1


def test_missing_obj_without_generator_fails(tmp_path):
    from mcpt.io.obj import load_obj

    with pytest.raises(FileNotFoundError):
        load_obj(str(tmp_path / "absent.obj"), use_native=False)


def test_generated_scene_hash_mismatch_raises(tmp_path, monkeypatch):
    """A bathroom-stress OBJ whose bytes drift from the committed hash is
    removed and refused."""
    import sys

    sys.path.insert(0, os.path.dirname(SCENES))
    from scenes import generate

    def fake_gen(out_dir, target_tris):
        (tmp_path / "bathroom-stress.obj").write_text("v 0 0 0\n")

    monkeypatch.setattr(generate, "gen_stress", fake_gen)
    with pytest.raises(RuntimeError, match="SHA-256"):
        generate.ensure_scene(str(tmp_path / "bathroom-stress.obj"))
    assert not (tmp_path / "bathroom-stress.obj").exists()
