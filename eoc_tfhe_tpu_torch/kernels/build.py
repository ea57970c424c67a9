"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launch function; it is compiled for
``sm_90a`` into ``_build/lib<name>-<hash>.so`` (the hash is of the source and
of every ``csrc/`` header it includes, so an edited source or header is
rebuilt) at first use and loaded once per process.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P, _I = ctypes.c_void_p, ctypes.c_int

#: C entry point and ctypes argument types of each kernel source.
SIGNATURES = {
    # acc0, bara, key, W, Winv, out; B, n, U, N, R, l, Bgbit, L, kbits, p0, p1,
    # crt_inv; stream
    "blind_rotate_ntt": ("blind_rotate_ntt_launch", [_P] * 6 + [_I] * 12 + [_P]),
    # the same arguments; key (n, 2, F, K, 2M) int8
    "blind_rotate_ntt_v1": ("blind_rotate_ntt_v1_launch", [_P] * 6 + [_I] * 12 + [_P]),
    # acc0, bara, key, out; B, n, U, N, l, Bgbit; stream
    "blind_rotate_compact": ("blind_rotate_compact_launch", [_P] * 4 + [_I] * 6 + [_P]),
}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, or PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found; set CUDA_HOME")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list[Path]:
    """``<name>.cu`` and every ``csrc/`` header it includes, transitively."""
    todo, seen = [SRC_DIR / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [SRC_DIR / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())]
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list[str]:
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(SRC_DIR / f"{name}.cu")]


def build_all() -> dict[str, tuple[float, str]]:
    """Compile every kernel source that is not built yet, one nvcc each, all
    started together.  Returns {name: (seconds, compiler log)}; raises if any
    build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    for name in SIGNATURES:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    logs, failed = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    out = _target(name)
    if not out.exists():
        build_all()
    lib = ctypes.CDLL(str(out))
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib
