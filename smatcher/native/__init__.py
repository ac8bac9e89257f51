"""ctypes bindings for the native table builders (builders.cpp).

The shared library is built lazily with `make` on first use and cached next
to this file.  Every entry point has a pure-python fallback in
smatcher/automata/, selected automatically when the toolchain or library
is unavailable — `load()` returns None in that case.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libsmatcher.so")
_lock = threading.Lock()
_lib = None
_tried = False

_i8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _configure(lib):
    lib.sm_build_ac.restype = ctypes.c_int64
    lib.sm_build_ac.argtypes = [_i8p] + [ctypes.c_int64] * 3 + [_i32p, _i32p, _i8p, _i32p, _i32p]
    lib.sm_build_sh.restype = ctypes.c_int64
    lib.sm_build_sh.argtypes = [_i8p] + [ctypes.c_int64] * 3 + [_i32p, _i8p, _i32p]
    lib.sm_build_sbom.restype = ctypes.c_int64
    lib.sm_build_sbom.argtypes = [_i8p] + [ctypes.c_int64] * 3 + [_i32p, _i32p, _i32p, _i32p]
    lib.sm_encode_fasta.restype = ctypes.c_int64
    lib.sm_encode_fasta.argtypes = [_i8p, ctypes.c_int64, _i8p, _i8p]
    lib.sm_count_cpu.restype = ctypes.c_int64
    lib.sm_count_cpu.argtypes = [_i8p, ctypes.c_int64, _i8p,
                                  ctypes.c_int64, ctypes.c_int64]
    lib.sm_build_wm_shift.restype = ctypes.c_int64
    lib.sm_build_wm_shift.argtypes = ([_i8p] + [ctypes.c_int64] * 4
                                       + [_i32p, _i32p, _i32p])
    lib.sm_fill_wm_prefix.restype = ctypes.c_int64
    lib.sm_fill_wm_prefix.argtypes = ([_i8p] + [ctypes.c_int64] * 2
                                       + [_i32p] + [ctypes.c_int64] * 2
                                       + [_i32p, _i32p])
    lib.sm_build_sog.restype = ctypes.c_int64
    lib.sm_build_sog.argtypes = ([_i8p] + [ctypes.c_int64] * 4 + [_u32p])
    lib.sm_match_enum.restype = ctypes.c_int64
    lib.sm_match_enum.argtypes = [_i8p, ctypes.c_int64, _i8p,
                                   ctypes.c_int64, ctypes.c_int64,
                                   _i64p, _i32p, ctypes.c_int64]
    return lib


def load():
    """Returns the configured ctypes library, building it if needed; None if
    unavailable (no compiler, build failure, or SMATCHER_NO_NATIVE=1)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("SMATCHER_NO_NATIVE"):
            return None
        src_path = os.path.join(_DIR, "builders.cpp")

        def _build():
            subprocess.run(["make", "-s", "-C", _DIR], check=True,
                           capture_output=True, timeout=120)

        try:
            stale = (not os.path.exists(_LIB_PATH)
                     or (os.path.exists(src_path)
                         and os.path.getmtime(_LIB_PATH) < os.path.getmtime(src_path)))
            if stale:
                _build()
            try:
                _lib = _configure(ctypes.CDLL(_LIB_PATH))
            except OSError:
                # a stale/foreign-architecture binary: rebuild once and retry
                _build()
                _lib = _configure(ctypes.CDLL(_LIB_PATH))
        except Exception:
            _lib = None
        return _lib


def build_ac_native(patterns: np.ndarray, sigma: int):
    """Returns (transition, supply, final, delta, depth, n_states) trimmed to
    the used state count, or None if the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    s_max = m * p + 1
    transition = np.empty((s_max, sigma), np.int32)
    supply = np.empty(s_max, np.int32)
    final = np.empty(s_max, np.uint8)
    delta = np.empty((s_max, sigma + 1), np.int32)
    depth = np.empty(s_max, np.int32)
    n = lib.sm_build_ac(patterns, p, m, sigma, transition, supply, final,
                         delta, depth)
    if n < 0:
        raise ValueError("pattern byte out of range for alphabet")
    n = int(n)
    return (transition[:n].copy(), supply[:n].copy(), final[:n].copy(),
            delta[:n].copy(), depth[:n].copy(), n)


def build_sh_native(patterns: np.ndarray, sigma: int):
    lib = load()
    if lib is None:
        return None
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    s_max = m * p + 1
    transition = np.empty((s_max, sigma), np.int32)
    final = np.empty(s_max, np.uint8)
    bmBc = np.empty(sigma, np.int32)
    n = lib.sm_build_sh(patterns, p, m, sigma, transition, final, bmBc)
    if n < 0:
        raise ValueError("pattern byte out of range for alphabet")
    n = int(n)
    return transition[:n].copy(), final[:n].copy(), bmBc, n


def encode_fasta_native(raw: np.ndarray, lut: np.ndarray):
    """Encode a FASTA byte stream ('>' lines skipped, lut[b]==255 = skip).

    raw: (n,) uint8; lut: (256,) uint8.  Returns (n_out,) uint8, or None if
    the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    lut = np.ascontiguousarray(lut, dtype=np.uint8)
    out = np.empty(max(raw.size, 1), np.uint8)
    n = lib.sm_encode_fasta(raw, raw.size, lut, out)
    return out[:int(n)].copy()


def count_cpu_native(text: np.ndarray, patterns: np.ndarray):
    """Native CPU ground-truth count (builders.cpp:sm_count_cpu — the
    reference's multiwm2 CPU path analogue), or None if unavailable."""
    lib = load()
    if lib is None:
        return None
    text = np.ascontiguousarray(text, dtype=np.uint8)
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    return int(lib.sm_count_cpu(text, text.size, patterns, p, m))


def build_wm_native(patterns: np.ndarray, sigma: int, H: int):
    """Wu-Manber tables: (shift, prefix_value, prefix_index, prefix_size,
    lmax) in the reference's exact semantics, or None if unavailable.
    H = wu_determine_shiftsize(sigma) (the python-side size table)."""
    lib = load()
    if lib is None:
        return None
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    shift = np.empty(H, np.int32)
    h_last = np.empty(max(p, 1), np.int32)
    prefix_size = np.empty(H, np.int32)
    if lib.sm_build_wm_shift(patterns, p, m, sigma, H, shift, h_last,
                              prefix_size) < 0:
        raise ValueError("pattern byte out of range (or m < 3)")
    lmax = max(1, int(prefix_size.max(initial=0)))
    prefix_value = np.empty((H, lmax), np.int32)
    prefix_index = np.empty((H, lmax), np.int32)
    if lib.sm_fill_wm_prefix(patterns, p, m, h_last, H, lmax,
                              prefix_value, prefix_index) < 0:
        raise RuntimeError("WM prefix fill overflow (inconsistent sizes)")
    return shift, prefix_value, prefix_index, prefix_size, lmax


def build_sog_native(patterns: np.ndarray, sigma: int, width: int):
    """SOG T table ((sigma^3,) uint32) or None if unavailable."""
    lib = load()
    if lib is None:
        return None
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    T = np.empty(sigma ** 3, np.uint32)
    if lib.sm_build_sog(patterns, p, m, sigma, width, T) < 0:
        raise ValueError("SOG requires m == width in {8,16,32} and in-range "
                         "pattern bytes")
    return T


def build_sbom_native(patterns: np.ndarray, sigma: int):
    """Returns (transition, F lists per state, n_states) or None."""
    lib = load()
    if lib is None:
        return None
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    s_max = m * p + 1
    transition = np.empty((s_max, sigma), np.int32)
    f_head = np.empty(s_max, np.int32)
    f_pid = np.empty(max(p, 1), np.int32)
    f_next = np.empty(max(p, 1), np.int32)
    n = lib.sm_build_sbom(patterns, p, m, sigma, transition, f_head, f_pid, f_next)
    if n < 0:
        raise ValueError("pattern byte out of range for alphabet")
    n = int(n)
    # rebuild per-state id lists (stored as prepend-linked entries)
    F = {}
    heads = f_head[:n]
    for s in np.nonzero(heads >= 0)[0]:
        ids = []
        e = int(heads[s])
        while e >= 0:
            ids.append(int(f_pid[e]))
            e = int(f_next[e])
        F[int(s)] = ids[::-1]           # restore insertion order
    return transition[:n].copy(), F, n


def match_enum_native(text: np.ndarray, patterns: np.ndarray):
    """(positions int64 sorted, pattern_ids int64) for every window of
    `text` equal to >= 1 pattern — smallest original id on ties/duplicates
    (the attribution contract of scanner.matches()); None if the native
    library is unavailable.  A host-side attribution path (the
    ground truth of the device matches): a threaded bucket+memcmp scan (builders.cpp:sm_match_enum) instead of
    the O(matches x m) numpy fallback datagen.match_ids."""
    lib = load()
    if lib is None:
        return None
    text = np.ascontiguousarray(text, dtype=np.uint8)
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    total = int(lib.sm_count_cpu(text, text.size, patterns, p, m))
    pos = np.empty(total, np.int64)
    ids = np.empty(total, np.int32)
    got = int(lib.sm_match_enum(text, text.size, patterns, p, m,
                                 pos, ids, total))
    if got != total:            # cannot happen: same match predicate
        raise AssertionError(f"native enum {got} != count {total}")
    return pos, ids.astype(np.int64)
