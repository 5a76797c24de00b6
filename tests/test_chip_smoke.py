"""chip_smoke.py on the CPU: it refuses to report without a GPU, and each
of its phases runs at a tiny size (the chip runs them at full size)."""
import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORNELL = os.path.join(ROOT, "scenes", "cornell-box.obj")


def _small(scene, w, h):
    return dataclasses.replace(
        scene, camera=dataclasses.replace(scene.camera, width=w, height=h))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_gpu():
    r = _run(ROOT, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_refuses_outside_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_intersect_dense_tiny(veach_scene, capsys):
    cs.phase_intersect_dense(veach_scene, 256, cpu_check=True)
    out = capsys.readouterr().out
    assert "closest_hit vs numpy f64 reference" in out
    assert "any_hit vs numpy f64 reference" in out
    assert "card dense wave vs host CPU dense wave" in out


def test_numpy_f64_reference_matches_oracle(veach_scene):
    """The smoke's float64 reference agrees with the per-ray oracle the
    intersection tests use."""
    import numpy as np

    from tests.test_intersect import _np_moller_trumbore

    o, d, so, sd, smax, t_min = cs.sample_rays(veach_scene, 32)
    g = veach_scene.geom
    args = [np.asarray(x, np.float64) for x in (g.v0, g.e1, g.e2)]
    t, tri = cs.np_hits_f64(veach_scene, o, d, t_min, block=7)
    ot, otri, _ = _np_moller_trumbore(*args, np.asarray(o, np.float64),
                                      np.asarray(d, np.float64), 1e-5, t_min,
                                      np.inf, False)
    np.testing.assert_array_equal(tri, otri)
    np.testing.assert_allclose(t[tri >= 0], ot[otri >= 0], rtol=1e-12)


def test_phase_intersect_bvh_tiny(cornell_scene_bvh, monkeypatch, capsys):
    from mcpt.ops import intersect

    # cornell's 32 tris take the walk once the threshold is below them
    monkeypatch.setattr(intersect, "BRUTE_FORCE_MAX_TRIS", 16)
    cs.phase_intersect_bvh(cornell_scene_bvh, 128)
    assert "closest_hit_bvh vs brute force" in capsys.readouterr().out


def test_phase_render_cli_tiny(tmp_path, capsys):
    res = cs.phase_render_cli(CORNELL, 32, 32, 4, str(tmp_path), tol=1.0)
    assert res["mean"].shape == (3,)
    assert os.path.exists(tmp_path / "cornell.png")
    assert "Mrays/s" in capsys.readouterr().out


def test_phase_render_chunked_tiny(cornell_scene, tmp_path, monkeypatch, capsys):
    # 32x32 > 512 lanes: the pass runs chunked, so the chunk program is
    # compiled ahead as on the chip
    monkeypatch.setenv("MCPT_CHUNK_LANES", "512")
    cs.phase_render("tiny", _small(cornell_scene, 32, 32), spp=2, bounces=4,
                    out_dir=str(tmp_path), golden=cs.GOLDEN_CORNELL, tol=1.0)
    out = capsys.readouterr().out
    assert "[render-tiny] compile_s=" in out and "compile_s=n/a" not in out


def test_phase_determinism_tiny(cornell_scene):
    assert cs.phase_determinism(cornell_scene, 16, 2)["bitwise"]


def test_phase_inverse_tiny(cornell_scene):
    res = cs.phase_inverse(cornell_scene, 32, spp=2, bounces=4, steps=10)
    assert len(res["losses"]) == 10


def test_phase_inverse_fails_on_nonfinite_gradient(cornell_scene, monkeypatch):
    import jax.numpy as jnp

    from mcpt.diff import grad

    plain = grad.mse_loss
    monkeypatch.setattr(grad, "mse_loss", lambda p, *a: plain(p, *a)
                        + 0.0 * jnp.sum(jnp.sqrt(p.kd - 2.0)))
    with pytest.raises(AssertionError, match="non-finite"):
        cs.phase_inverse(cornell_scene, 16, spp=1, bounces=2, steps=2)


def test_phase_multichip_on_virtual_devices(cornell_scene, capsys):
    devs = jax.devices()[:4]
    assert len(devs) == 4
    res = cs.phase_multichip(_small(cornell_scene, 16, 16), devs, spp=4,
                             grad_size=8)
    assert [row["devices"] for row in res["scaling"]] == [1, 2, 4]
    out = capsys.readouterr().out
    assert "4x1 mesh" in out and "2x2 mesh" in out and "sharded gradient" in out
