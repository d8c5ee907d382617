"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each ``kernels/<name>/csrc/<file>.cu`` has a plain C interface and is
compiled on first use into ``build/kernels/<file>-<hash>.so`` at the root
of the checkout (``.gitignore`` lists ``build/``); the hash covers every
file of the source's ``csrc/`` directory (so an edited header rebuilds the
sources beside it) and the flags.  Nothing is compiled when a module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[Path, ctypes.CDLL] = {}


def sources() -> List[Path]:
    """Every CUDA source of the port, sorted."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def target(src: Path, defines: Sequence[str] = ()) -> Path:
    """The library ``src`` builds into: named by a hash of the flags (with
    any extra ``-D`` defines) and of every file under the source's
    directory, names included."""
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for path in sorted(p for p in src.parent.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(src.parent)).encode() + b"\0")
        h.update(path.read_bytes())
    h.update(src.name.encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def _start(src: Path, defines: Sequence[str] = ()):
    """Starts nvcc on ``src`` unless its library exists; returns
    ``(target, tmp, process)`` or ``(target, None, None)``."""
    out = target(src, defines)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(src: Path, out: Path, tmp, proc) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(srcs: Iterable[Path] = ()) -> Dict[str, dict]:
    """Compiles the given sources (default: all) with one nvcc each, all
    started together.  Returns ``{stem: {"seconds", "log", "path"}}``."""
    srcs = list(srcs) or sources()
    with _LOCK:
        t0 = time.perf_counter()
        started = [(src, *_start(src)) for src in srcs]
        report = {}
        for src, out, tmp, proc in started:
            log = _finish(src, out, tmp, proc)
            report[src.stem] = dict(seconds=time.perf_counter() - t0, log=log,
                                    path=out)
    return report


def build_variants(src: Path, variants: Dict[str, Sequence[str]]
                   ) -> Dict[str, Path]:
    """Compiles ``src`` once for each set of extra defines (a kernel's
    compile-time experiment switches), all nvcc processes started together.
    Returns ``{name: library path}``."""
    with _LOCK:
        started = {name: _start(src, tuple(defs))
                   for name, defs in variants.items()}
        for out, tmp, proc in started.values():
            _finish(src, out, tmp, proc)
    return {name: out for name, (out, _, _) in started.items()}


def load(src: Path) -> ctypes.CDLL:
    """The loaded library of ``src``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(src)
        if lib is None:
            out, tmp, proc = _start(src)
            _finish(src, out, tmp, proc)
            lib = _LIBS[src] = ctypes.CDLL(str(out))
    return lib
