"""ctypes loader for the shared native (C++) host sources in ``native/``.

Port of the pieces of ``m3_tpu/utils/native.py`` the port needs: ``load``,
``prepare_value_fields_native`` (the encoder's value grammar), and the
decode readers' host passes over ``native/m3tsz_ref.cc``: ``blob_offsets``,
``count_batch_native``, ``decode_merged_native`` and
``pad_lane_tails_native``.  Unlike the reference, which
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


def blob_offsets(streams: list[bytes]) -> tuple[bytes, np.ndarray]:
    """Concatenate streams + int64 offset table (the marshalling shape
    every native batch entry point takes).  Callers running a count pass
    and a decode pass back to back compute this once and pass it to both
    via ``packed=``."""
    blob = b"".join(streams)
    offsets = np.zeros(len(streams) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in streams], out=offsets[1:])
    return blob, offsets


_I64P = np.ctypeslib.ndpointer(np.int64)


def _typed(fn, argtypes):
    """Set a ctypes entry's signature once (void return)."""
    if not getattr(fn, "_typed", False):
        fn.restype = None
        fn.argtypes = argtypes
        fn._typed = True
    return fn


def count_batch_native(
    streams: list[bytes], unit_nanos: int = 1_000_000_000,
    n_threads: int = 0, packed: tuple[bytes, np.ndarray] | None = None,
) -> np.ndarray:
    """Threaded count-only decode pass: datapoints per stream, -1 for
    streams with constructs the C++ decoder cannot handle.  Lets batch
    readers size the decode grid exactly (a stream's datapoint count is
    not recoverable from its byte length)."""
    fn = _typed(load("m3tsz_ref").m3tsz_count_batch, [
        ctypes.c_char_p, _I64P, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, _I64P])
    L = len(streams)
    blob, offsets = packed if packed is not None else blob_offsets(streams)
    counts = np.zeros(L, dtype=np.int64)
    fn(blob, offsets, L, unit_nanos, n_threads, counts)
    return counts


def decode_merged_native(
    streams: list[bytes], row_dst: np.ndarray, row_cap: np.ndarray,
    out_t: np.ndarray, out_v: np.ndarray,
    unit_nanos: int = 1_000_000_000, n_threads: int = 0,
    packed: tuple[bytes, np.ndarray] | None = None,
):
    """Fused decode + merge (``m3tsz_decode_merged``): decode stream m
    directly at flat offset ``row_dst[m]`` of ``out_t``/``out_v``.
    Returns (row_n, row_first, row_last, row_sorted)."""
    fn = _typed(load("m3tsz_ref").m3tsz_decode_merged, [
        ctypes.c_char_p, _I64P, ctypes.c_int64, ctypes.c_int64,
        _I64P, _I64P, ctypes.c_int,
        _I64P, np.ctypeslib.ndpointer(np.float64),
        _I64P, _I64P, _I64P, np.ctypeslib.ndpointer(np.uint8)])
    M = len(streams)
    blob, offsets = packed if packed is not None else blob_offsets(streams)
    row_n = np.zeros(M, dtype=np.int64)
    row_first = np.zeros(M, dtype=np.int64)
    row_last = np.zeros(M, dtype=np.int64)
    row_sorted = np.zeros(M, dtype=np.uint8)
    fn(blob, offsets, M, unit_nanos,
       np.ascontiguousarray(row_dst, dtype=np.int64),
       np.ascontiguousarray(row_cap, dtype=np.int64),
       n_threads, out_t, out_v, row_n, row_first, row_last, row_sorted)
    return row_n, row_first, row_last, row_sorted


def pad_lane_tails_native(out_t: np.ndarray, out_v: np.ndarray,
                          lane_counts: np.ndarray) -> None:
    """Fill each lane's slots past ``lane_counts`` with the +inf-time /
    NaN-value padding (``pad_lane_tails``), in place."""
    fn = _typed(load("m3tsz_ref").pad_lane_tails, [
        _I64P, np.ctypeslib.ndpointer(np.float64), _I64P,
        ctypes.c_int64, ctypes.c_int64])
    n_lanes, n_cap = out_t.shape
    fn(out_t, out_v, np.ascontiguousarray(lane_counts, dtype=np.int64),
       n_lanes, n_cap)
