"""The native library is built from source, keyed by a hash of the source
and flags, for the generic target of the machine (no -march=native)."""
import ctypes
import os

from mcpt.native import build


def test_library_name_keys_on_source_and_flags(monkeypatch):
    path = build.library_path()
    assert os.path.dirname(path) == build.OUT_DIR
    assert "-march=native" not in build.FLAGS
    assert "-ffp-contract=off" in build.FLAGS
    monkeypatch.setattr(build, "FLAGS", build.FLAGS + ["-DMCPT_TEST"])
    assert build.library_path() != path


def test_fresh_build_from_source(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "OUT_DIR", str(tmp_path))
    out = build.ensure_built()
    assert out.startswith(str(tmp_path)) and os.path.exists(out)
    lib = ctypes.CDLL(out)
    assert hasattr(lib, "mcpt_build_bvh") and hasattr(lib, "mcpt_parse_obj")
    assert build.ensure_built() == out  # second call reuses it
