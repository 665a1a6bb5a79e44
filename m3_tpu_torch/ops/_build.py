"""Build and load the CUDA kernels of ``m3_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``, at first
use.  Libraries land in ``build/m3_tpu_torch/`` at the root of the
checkout, named by a hash of the source and the flags, so an edit to a
source rebuilds it.  A failed build raises with the compiler's output;
nothing falls back.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on a non-zero code.  ``LAUNCHES``
counts launches per kernel: each wrapper bumps its count where it launches
and nowhere else, so a run can show which kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "m3_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))

LAUNCHES: dict[str, int] = {}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_bound: dict[tuple[str, int], tuple[ctypes.CDLL, dict]] = {}
BUILD_LOGS: dict[str, str] = {}


def count_launch(kernel: str) -> None:
    with _lock:
        LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


def reset_launches() -> None:
    with _lock:
        LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(home):
        return home
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels "
                       "cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: tuple[str, ...] = SOURCES) -> dict[str, Path]:
    """Compile every source not yet built, one ``nvcc`` per source, all
    started together.  Returns the library path of each name."""
    targets = {name: _target(name) for name in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[name])  # atomic: a concurrent build is harmless
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    return targets


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed, with
    the ``argtypes`` of the entries in ``signatures`` set and an ``int``
    return type (an entry given as ``(argtypes, restype)`` returns
    ``restype``).  Each signatures table is bound once, on its first
    request; later calls with the same table only look it up."""
    hit = _bound.get((name, id(signatures)))
    if hit is not None:
        return hit[0]
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all((name,))[name]))
            lib.m3_error_string.argtypes = [ctypes.c_int]
            lib.m3_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        # several modules may bind entries of one source, never differently
        for fn, sig in signatures.items():
            argtypes, restype = sig if isinstance(sig, tuple) else (sig, ctypes.c_int)
            entry = getattr(lib, fn)
            if entry.argtypes is not None and list(entry.argtypes) != list(argtypes):
                raise ValueError(f"{name}.{fn} bound with two signatures")
            entry.argtypes = argtypes
            entry.restype = restype
        # the table is kept, so its id names it for as long as the entry lives
        _bound[(name, id(signatures))] = (lib, signatures)
        return lib


def check(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    if code != 0:
        msg = lib.m3_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({msg})")


P = ctypes.c_void_p  # device pointers, the stream, host pointers
I = ctypes.c_int
LL = ctypes.c_longlong
D = ctypes.c_double
