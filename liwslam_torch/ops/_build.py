"""Build and load the port's CUDA kernels (``liwslam_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

The libraries go to ``liwslam_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source, of every ``csrc/`` header it includes
(directly or through another header) and of the flags, so an edited source
or header is rebuilt at its next use and an unchanged one is loaded as it
is.  All
sources that need a build are compiled at once, one ``nvcc`` process each.
There is no fallback: a missing ``nvcc`` or a failed build raises, with the
compiler's output in the message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("extract_lines", "track_solve", "lk_track", "cam_solve")
# where nvcc is looked for after PATH and $CUDA_HOME
CUDA_ROOTS = ("/usr/local/cuda",)
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}
# per source: seconds spent compiling in this process (0.0 when loaded from
# an earlier build) and the compiler's output (ptxas register/spill report)
build_info: dict = {}


def find_nvcc() -> str:
    """Path of ``nvcc``; raises when the CUDA compiler is not installed."""
    cands = [shutil.which("nvcc")]
    roots = (os.environ.get("CUDA_HOME"),) + CUDA_ROOTS
    cands += [os.path.join(r, "bin", "nvcc") for r in roots if r]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "liwslam_torch: nvcc (the CUDA compiler) was not found on PATH, "
        f"$CUDA_HOME or {', '.join(CUDA_ROOTS)}; the CUDA kernels cannot be built"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources_of(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes, transitively."""
    todo, seen = [name + ".cu"], []
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        with open(os.path.join(CSRC, f), "rb") as fh:
            todo += [
                inc.decode() for inc in _INCLUDE.findall(fh.read())
                if os.path.isfile(os.path.join(CSRC, inc.decode()))
            ]
    return seen


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in _sources_of(name):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}.{h.hexdigest()[:16]}.so")


def load() -> dict:
    """{source name: ctypes.CDLL}, building what is missing or stale."""
    todo = [n for n in SOURCES if n not in _loaded]
    if not todo:
        return _loaded
    paths = {n: _lib_path(n) for n in todo}
    need = [n for n in todo if not os.path.isfile(paths[n])]
    if need:
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.time()
        procs = {}
        for n in need:
            tmp = f"{paths[n]}.{os.getpid()}.tmp"
            cmd = [nvcc, *FLAGS, "-o", tmp, os.path.join(CSRC, n + ".cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for n, (tmp, p) in procs.items():
            out, _ = p.communicate()
            build_info[n] = {"seconds": time.time() - t0, "log": out}
            if p.returncode != 0:
                failed.append(f"--- nvcc {n}.cu (exit {p.returncode}) ---\n{out}")
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("liwslam_torch: kernel build failed\n" + "\n".join(failed))
    for n in todo:
        build_info.setdefault(n, {"seconds": 0.0, "log": ""})
        _loaded[n] = ctypes.CDLL(paths[n])
    return _loaded
