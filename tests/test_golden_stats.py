"""Statistical comparison against the reference's golden renders.

The reference's only ground truth is its converged result PNGs
(/root/reference/results/, SURVEY §4); BASELINE.md records their
post-tonemap mean RGB. Our scenes are re-authored (the reference's scene
files are gitignored upstream, SURVEY §4), so pixelwise comparison is
impossible — but cornell-box is the classic fixed-specification scene, and
our re-authoring matches the reference's closely enough that the tonemapped
image MEAN should land within a few percent of the golden's. veach-mis and
bathroom differ by construction (own emitter powers / geometry), so only
cornell is pinned; the committed render is the artifact under test.
"""
import os

import numpy as np
import pytest

RESULTS = os.path.join(os.path.dirname(__file__), "..", "results")

# BASELINE.md "Golden image statistics": post-tonemap mean RGB of
# /root/reference/results/cornell-box.obj119.png
GOLDEN_CORNELL_MEAN = (0.448, 0.380, 0.269)
# /root/reference/results/veach-mis.obj313.png — the round-5 re-authoring
# matches its palette (navy backdrop, pink slab plates, four white
# emitters growing left->right); committed render mean lands within 0.006
GOLDEN_VEACH_MEAN = (0.250, 0.178, 0.276)


def _mean_rgb(path):
    from mcpt.io.image import load_png

    return load_png(path).astype(np.float64).reshape(-1, 3).mean(axis=0)


def test_cornell_render_matches_reference_golden_stats():
    path = os.path.join(RESULTS, "cornell-box.obj64.png")
    if not os.path.exists(path):
        pytest.skip("committed cornell render not present")
    mean = _mean_rgb(path)
    # loose bound: MC noise at 64 vs 119 spp is well under 1%; the scenes
    # are independently authored, so allow a few percent absolute
    for got, want in zip(mean, GOLDEN_CORNELL_MEAN):
        assert abs(got - want) < 0.02, (
            f"cornell mean RGB {tuple(round(m, 3) for m in mean)} deviates "
            f"from reference golden {GOLDEN_CORNELL_MEAN} by > 0.02"
        )


def test_veach_render_matches_reference_golden_stats():
    """The veach re-authoring is color-faithful enough that
    its tonemapped mean pins against the reference golden (the geometry is
    independently authored — composition differs — so the tolerance is
    wider than cornell's)."""
    import glob

    paths = glob.glob(os.path.join(RESULTS, "veach-mis.obj*.png"))
    if not paths:
        pytest.skip("committed veach render not present")
    mean = _mean_rgb(sorted(paths)[-1])
    for got, want in zip(mean, GOLDEN_VEACH_MEAN):
        assert abs(got - want) < 0.03, (
            f"veach mean RGB {tuple(round(m, 3) for m in mean)} deviates "
            f"from reference golden {GOLDEN_VEACH_MEAN} by > 0.03"
        )


def test_committed_renders_are_not_degenerate():
    """The other committed renders exist and are neither black nor blown
    out (a cheap pin against a silently-broken integrator)."""
    import glob

    found = []
    for pat in ("veach-mis.obj*.png", "bathroom-stress.obj*.png"):
        found += glob.glob(os.path.join(RESULTS, pat))
    if not found:
        pytest.skip("no committed veach/bathroom renders present")
    for path in found:
        mean = _mean_rgb(path)
        assert 0.05 < mean.mean() < 0.95, (path, mean)
