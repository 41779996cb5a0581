"""Build the native host runtime (_tpjnative.so) with g++.

No pybind11 in this image, so the native layer is a plain C ABI shared
library loaded via ctypes.  Built on first use and cached next to the
sources; rebuilt automatically when any source file is newer than the
library.  Thread-safe via an exclusive lock file (batch drivers may race
to import from many worker threads/processes).
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sysconfig
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "src"
LIB_PATH = _HERE / "_tpjnative.so"

CXX = os.environ.get("CXX", "g++")
CXXFLAGS = [
    "-O3",
    "-std=c++17",
    "-fPIC",
    "-shared",
    "-fno-exceptions",
    "-fno-rtti",
    "-fopenmp",
    "-Wall",
    "-Werror",
]


def _needs_build() -> bool:
    if not LIB_PATH.exists():
        return True
    lib_mtime = LIB_PATH.stat().st_mtime
    return any(
        src.stat().st_mtime > lib_mtime for src in SRC_DIR.glob("*.cpp")
    )


def _compile(flags: list[str], out: Path, sources: list[str]) -> None:
    cmd = [CXX, *flags, "-o", str(out), *sources]
    march = os.environ.get("TPJ_NATIVE_MARCH", "native")
    if march:
        cmd.insert(1, f"-march={march}")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(
            f"native build failed ({' '.join(cmd)}):\n{res.stderr[-2000:]}"
        )


def build(force: bool = False) -> Path:
    """Compile the shared library if stale. Returns its path.

    Builds with OpenMP; a toolchain without an OpenMP runtime gets a
    serial build instead (the pragmas compile away, src/omp_compat.h),
    which is bit-identical and only slower."""
    if not force and not _needs_build():
        return LIB_PATH
    lock_path = _HERE / ".build.lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if force or _needs_build():
                sources = sorted(str(p) for p in SRC_DIR.glob("*.cpp"))
                if not sources:
                    raise FileNotFoundError(f"no C++ sources in {SRC_DIR}")
                tmp = LIB_PATH.with_suffix(".so.tmp")
                try:
                    _compile(CXXFLAGS, tmp, sources)
                except RuntimeError:
                    serial = [f for f in CXXFLAGS if f != "-fopenmp"]
                    _compile(serial + ["-Wno-unknown-pragmas"], tmp, sources)
                os.replace(tmp, LIB_PATH)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return LIB_PATH


if __name__ == "__main__":
    print(build(force=True))
