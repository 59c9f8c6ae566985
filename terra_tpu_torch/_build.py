"""Compile native sources into the package's own ``_build`` directory.

Every shared library the port loads (the g++ SAH builder, the nvcc
traversal kernel) is built from sources in the repository at first use.
The output name carries a hash of the command and the sources, so an edit
rebuilds and an unchanged tree reuses the earlier build. The compiler
writes to a temporary file that is renamed into place, so processes that
build at once never load a half-written library. A failed build raises:
there is no fallback.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

from .profile import profiler

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def build_shared(cmd: list[str], sources: list[str], stem: str,
                 timeout: float = 900.0, deps: list[str] = ()) -> str:
    """Run ``cmd + ["-o", out] + sources`` unless ``out`` already exists.

    ``deps`` (headers the sources include) enter the hash but not the
    command. Returns the library path. The compiler's messages (for nvcc
    with ``-Xptxas -v``: registers, spills) are kept beside it as
    ``<out>.log``. A compiler run is the span ``terra.kernel.build``
    (``profile``); a library already built is none.
    """
    h = hashlib.sha256("\0".join(cmd).encode())
    for src in [*sources, *deps]:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        with profiler.span("terra.kernel.build"):
            proc = subprocess.run([*cmd, "-o", tmp, *sources], capture_output=True,
                                  text=True, timeout=timeout)
        with open(out + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"build of {stem} failed ({cmd[0]} exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def nvcc() -> str:
    """Path of the CUDA compiler (on PATH, else /usr/local/cuda/bin)."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return path


def build_log(path: str) -> str:
    """The compiler's messages from the build of ``path``."""
    with open(path + ".log") as f:
        return f.read()
