"""ctypes loader for the shared native (C++) host sources in ``native/``.

Port of the two pieces of ``m3_tpu/utils/native.py`` the write path needs:
``load`` and ``prepare_value_fields_native``.  Unlike the reference, which
writes ``lib<name>.so`` next to its source, each library is built with
g++ into ``build/m3_tpu_torch/native/`` at the root of the checkout,
named by a hash of the source and the flags, so an edited source rebuilds
and ``native/`` is never written.  A failed build raises with the
compiler's output; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "m3_tpu_torch" / "native"
# the reference's flags, plus -ffp-contract=off: g++ contracts a*b+c into
# an FMA by default where the target has one, and the value grammar must
# round each operation as numpy does
GXX_FLAGS = ("-O2", "-march=native", "-ffp-contract=off", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _target(name: str) -> Path:
    src = (NATIVE_DIR / f"{name}.cc").read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """``native/<name>.cc`` as a loaded shared library, compiled at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        so = _target(name)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run(
                ["g++", *GXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / f"{name}.cc")],
                capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed on native/{name}.cc (exit "
                                   f"{res.returncode}):\n{res.stdout}{res.stderr}")
            os.replace(tmp, so)  # atomic: a concurrent build is harmless
        lib = _libs[name] = ctypes.CDLL(str(so))
        return lib


def prepare_value_fields_native(values: np.ndarray, n_valid: np.ndarray, n_threads: int = 0):
    """Threaded C++ value-grammar pass (``native/m3tsz_prepare.cc``), the
    production host half of the batched encoder.  Returns (ctl_bits u64,
    ctl_n i32, pay_bits u64, pay_n i32), each [L, T], identical to
    ``m3_tpu_torch.ops.m3tsz_encode.prepare_value_fields``."""
    lib = load("m3tsz_prepare")
    fn = lib.m3tsz_prepare_value_fields
    fn.restype = None
    fn.argtypes = [
        np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.int32),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        np.ctypeslib.ndpointer(np.uint64), np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.uint64), np.ctypeslib.ndpointer(np.int32),
    ]
    vs = np.ascontiguousarray(values, dtype=np.float64)
    nv = np.ascontiguousarray(n_valid, dtype=np.int32)
    L, T = vs.shape
    ctl_bits = np.zeros((L, T), dtype=np.uint64)
    ctl_n = np.zeros((L, T), dtype=np.int32)
    pay_bits = np.zeros((L, T), dtype=np.uint64)
    pay_n = np.zeros((L, T), dtype=np.int32)
    fn(vs, nv, L, T, n_threads, ctl_bits, ctl_n, pay_bits, pay_n)
    return ctl_bits, ctl_n, pay_bits, pay_n
