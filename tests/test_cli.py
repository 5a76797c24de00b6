"""CLI smoke tests: info + a tiny render with checkpoint/resume round trip.

The reference has no CLI (scene choice is hardcoded, src/main.cpp:7-12);
these cover the config surface SURVEY §5 requires this build to add.
"""
import json
import os

import numpy as np
import pytest

from mcpt.cli import main
from mcpt.io.image import read_png

SCENE = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell-box.obj")


def test_info(capsys):
    assert main(["info", SCENE]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["triangles"] == 32
    assert out["lights"] >= 1
    assert out["camera"]["width"] == 1024


def test_render_checkpoint_resume(tmp_path, capsys):
    png = str(tmp_path / "out.png")
    ck = str(tmp_path / "ck.npz")
    # 2 passes of 1 spp with a checkpoint after the first
    args = ["render", SCENE, "--width", "32", "--height", "32", "--spp", "2",
            "--spp-per-pass", "1", "--bounces", "2", "--no-bvh",
            "--checkpoint", ck, "--checkpoint-every", "1", "--out", png]
    assert main(args) == 0
    full = read_png(png)
    capsys.readouterr()

    # resume from the 1-spp checkpoint and render the second sample
    png2 = str(tmp_path / "out2.png")
    assert main(["render", SCENE, "--width", "32", "--height", "32",
                 "--spp", "2", "--spp-per-pass", "1", "--bounces", "2",
                 "--no-bvh", "--resume", ck, "--out", png2]) == 0
    resumed = read_png(png2)
    # counter-based RNG: resumed render is bitwise identical
    np.testing.assert_array_equal(full, resumed)


def test_fault_injection_kill_resume_bitwise(tmp_path):
    """Kill a render mid-run (SIGKILL, no cleanup), resume from its last
    checkpoint, and require the final film BITWISE equal to an
    uninterrupted run (SURVEY §5 checkpoint/resume contract; the
    counter-based RNG makes the recovered samples identical, and the
    atomic checkpoint write guarantees the file we resume from is whole).
    """
    import signal
    import subprocess
    import sys
    import time

    ck = str(tmp_path / "ck.npz")
    png_resumed = str(tmp_path / "resumed.png")
    png_full = str(tmp_path / "full.png")
    base = [sys.executable, "-m", "mcpt.cli", "render", SCENE,
            "--width", "32", "--height", "32", "--spp-per-pass", "1",
            "--bounces", "2", "--no-bvh"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    # victim: 64 spp (far more than it will live to finish), checkpoint
    # every sample
    proc = subprocess.Popen(
        base + ["--spp", "64", "--checkpoint", ck, "--checkpoint-every", "1",
                "--out", str(tmp_path / "never.png")],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if os.path.exists(ck):
                break
            if proc.poll() is not None:
                raise AssertionError("render exited before first checkpoint")
            time.sleep(0.05)
        else:
            raise AssertionError("no checkpoint appeared within 120 s")
        # let it run a little past the checkpoint so the kill lands
        # mid-pass, not at a tidy boundary
        time.sleep(0.5)
    finally:
        proc.send_signal(signal.SIGKILL)  # exact PID, no cleanup handlers
        proc.wait()

    with np.load(ck) as z:
        resumed_at = int(z["sample_idx"])
    assert resumed_at >= 1

    target_spp = resumed_at + 2  # a few more samples past the kill point
    r = subprocess.run(
        base + ["--spp", str(target_spp), "--resume", ck,
                "--out", png_resumed],
        env=env, capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr

    r = subprocess.run(
        base + ["--spp", str(target_spp), "--out", png_full],
        env=env, capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr

    a = read_png(png_resumed)
    b = read_png(png_full)
    np.testing.assert_array_equal(a, b)


def test_render_seed_mismatch_rejected(tmp_path):
    ck = str(tmp_path / "ck.npz")
    main(["render", SCENE, "--width", "16", "--height", "16", "--spp", "1",
          "--spp-per-pass", "1", "--bounces", "1", "--no-bvh",
          "--checkpoint", ck, "--checkpoint-every", "1",
          "--out", str(tmp_path / "a.png")])
    with pytest.raises(SystemExit):
        main(["render", SCENE, "--width", "16", "--height", "16", "--spp", "2",
              "--seed", "7", "--no-bvh", "--resume", ck,
              "--out", str(tmp_path / "b.png")])


def test_inverse_reports_unconstrained_emitter_kd(tmp_path, capsys):
    """The CLI inverse freezes emitter albedo by default and REPORTS it as
    unconstrained (an emitter's kd is unidentifiable from the image: its
    pixels are dominated by emission)."""
    rad = str(tmp_path / "target.npz")
    assert main(["render", SCENE, "--width", "16", "--height", "16",
                 "--spp", "1", "--bounces", "2", "--no-bvh",
                 "--save-radiance", rad,
                 "--out", str(tmp_path / "t.png")]) == 0
    capsys.readouterr()
    out = str(tmp_path / "params.npz")
    assert main(["inverse", SCENE, "--width", "16", "--height", "16",
                 "--target", rad, "--steps", "2", "--spp", "1",
                 "--bounces", "2", "--no-bvh", "--out", out]) == 0
    text = capsys.readouterr().out
    stats = json.loads(text.strip().splitlines()[-1])
    assert stats["unconstrained_kd_materials"], "emitter not reported"
    z = np.load(out)
    frozen = z["unconstrained_kd"]
    assert len(frozen) >= 1
    # frozen kd stayed at the 0.5 init (mask really froze it)
    np.testing.assert_allclose(z["kd"][frozen], 0.5, atol=1e-6)


def test_render_preview_every(tmp_path):
    """--preview-every writes intermediate tonemapped PNGs (the reference's
    progressive-display analog, src/main.cpp:26-36)."""
    png = str(tmp_path / "out.png")
    pv = str(tmp_path / "preview.png")
    args = ["render", SCENE, "--width", "32", "--height", "32", "--spp", "3",
            "--spp-per-pass", "1", "--bounces", "2", "--no-bvh",
            "--preview-every", "1", "--preview", pv, "--out", png]
    assert main(args) == 0
    assert os.path.exists(pv), "preview PNG not written"
    prev = read_png(pv)
    assert prev.shape == (32, 32, 3)
    # the last preview (2 spp) is a valid image but not the 3-spp final
    final = read_png(png)
    assert prev.shape == final.shape
    assert (prev != final).any()  # written mid-render, fewer samples


def test_render_live_terminal_preview(tmp_path, capsys):
    """--live redraws an ANSI half-block frame per pass (the reference's
    progressive display loop, src/main.cpp:21-36, terminal edition)."""
    png = str(tmp_path / "out.png")
    args = ["render", SCENE, "--width", "32", "--height", "32", "--spp", "2",
            "--spp-per-pass", "1", "--bounces", "2", "--no-bvh",
            "--live", "--out", png]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "\x1b[38;2;" in out and "▀" in out, "no ANSI half-block frame"
    assert "2/2 spp" in out
    assert os.path.exists(png)


def test_ansi_frame_tonemap_matches_png_curve():
    """io/term.tonemap_u8 must be the PNG writer's curve exactly."""
    import numpy as np

    from mcpt.io.term import ansi_frame, tonemap_u8
    from mcpt.render.film import Film

    H = W = 8
    accum = np.random.default_rng(0).uniform(0, 2, (H, W, 3)).astype(np.float32)
    spp = np.full((H, W), 4.0, np.float32)
    film = Film(accum=accum, spp=spp, nan_count=np.zeros(()), rays=np.zeros(()))
    u8 = tonemap_u8(accum, spp)
    expect = (np.sqrt(np.clip(accum / 4.0, 0, 1)) * 255.99).astype(np.uint8)[::-1]
    np.testing.assert_array_equal(u8, expect)
    s = ansi_frame(film, max_cols=8, max_rows=4)
    assert s.count("\n") == 3  # 8 pixel rows -> 4 half-block lines
