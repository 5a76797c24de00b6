"""Build the native library (g++ -O3 -shared) from source, keyed by hash.

The shared object's file name carries a hash of the source and the compile
flags, so a library built from other source is never loaded, and a rebuilt
source never reuses a stale binary. It is compiled for the generic target
of the machine's architecture (no -march=native) with floating-point
contraction off: a binary copied from another host still runs, and the BVH
comes out the same on every host. The build directory is not committed; a
fresh checkout builds on first use. `python -m mcpt.native.build` forces a
rebuild.
"""
from __future__ import annotations

import hashlib
import os
import platform
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "mcpt_native.cpp")
OUT_DIR = os.path.join(_DIR, "_build")
FLAGS = ["-O3", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC"]


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS + [platform.machine()]).encode())
    return os.path.join(OUT_DIR, f"libmcpt_native-{h.hexdigest()[:16]}.so")


def ensure_built(force: bool = False) -> str:
    """Return the .so path, building it if absent. Raises on compile failure."""
    out = library_path()
    if not force and os.path.exists(out):
        return out
    os.makedirs(OUT_DIR, exist_ok=True)
    tmp = out + f".tmp.{os.getpid()}"
    cmd = ["g++", *FLAGS, SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, out)  # atomic under concurrent builders
    return out


if __name__ == "__main__":
    print(ensure_built(force=True))
