"""Build and load the native compat engine.

The C sources are compiled on first use into a shared library cached in
the checkout's ``.tsta_cache/native/`` (keyed by a content hash), then
loaded with ctypes.  No pybind11 dependency; the ABI is plain C.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from tsta_tpu.utils import cache

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIB = None

CFLAGS = ["-O3", "-march=native", "-g", "-fPIC", "-shared", "-Wall"]


def _all_cflags(openmp: bool = False):
    """CFLAGS (+ -fopenmp for the one source that uses OpenMP) + optional
    extras from TSTA_NATIVE_CFLAGS (space-separated); extras participate
    in the cache key so variant builds don't collide."""
    extra = os.environ.get("TSTA_NATIVE_CFLAGS", "").split()
    return CFLAGS + (["-fopenmp"] if openmp else []) + extra


class MsaResultStruct(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.c_int),
        ("cols", ctypes.c_int),
        ("msa", ctypes.POINTER(ctypes.c_char_p)),
        ("consensus", ctypes.c_char_p),
        ("rounds", ctypes.c_int),
        ("last_scores", ctypes.POINTER(ctypes.c_int)),
        ("graph_len", ctypes.POINTER(ctypes.c_int)),
        ("add_len", ctypes.POINTER(ctypes.c_int)),
    ]


def _compile(src: str, out: str, openmp: bool) -> None:
    cc = os.environ.get("CC", "gcc")
    cmd = [cc] + _all_cflags(openmp) + ["-o", out, src]  # as in the key
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("native build failed:\n%s" % proc.stderr)


def _cached_path(src: str, stem: str, openmp: bool) -> str:
    cc = os.environ.get("CC", "gcc")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join([cc] + _all_cflags(openmp)).encode())  # flags in key
    cache_dir = os.environ.get("TSTA_NATIVE_CACHE") or cache.cache_dir(
        "native")
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, "lib%s_%s.so" % (stem, h.hexdigest()[:16]))


def _load_cached(srcname: str, stem: str, openmp: bool = False
                 ) -> ctypes.CDLL:
    """Compile ``srcname`` (if needed) into the content-hash-keyed cache
    and load it.  Callers set restype/argtypes on the returned lib.

    ``openmp`` sources build with -fopenmp where the toolchain has
    OpenMP and single-threaded where it does not (a gcc without
    libgomp): the compat engine guards every OpenMP use with _OPENMP and
    computes identical values in sequential tile order."""
    src = os.path.join(_DIR, srcname)
    variants = [True, False] if openmp else [False]
    paths = [_cached_path(src, stem, v) for v in variants]
    for path in paths:
        if os.path.exists(path):
            return ctypes.CDLL(path)
    errors = []
    for v, path in zip(variants, paths):
        try:
            _compile(src, path, v)
        except RuntimeError as e:
            errors.append(e)
            continue
        return ctypes.CDLL(path)
    raise errors[-1]


def load() -> ctypes.CDLL:
    """Compile (if needed) and load the compat engine library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = _load_cached("compat_msa.c", "tsta_compat", openmp=True)
        lib.tsta_msa_run.restype = ctypes.c_int
        lib.tsta_msa_run.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(MsaResultStruct),
        ]
        lib.tsta_msa_free.argtypes = [ctypes.POINTER(MsaResultStruct)]
        _LIB = lib
        return lib


class SeqIndexStruct(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_long),
        ("cap", ctypes.c_long),
        ("name_off", ctypes.POINTER(ctypes.c_long)),
        ("name_len", ctypes.POINTER(ctypes.c_long)),
        ("com_off", ctypes.POINTER(ctypes.c_long)),
        ("com_len", ctypes.POINTER(ctypes.c_long)),
        ("seq_off", ctypes.POINTER(ctypes.c_long)),
        ("seq_len", ctypes.POINTER(ctypes.c_long)),
        ("qual_off", ctypes.POINTER(ctypes.c_long)),
        ("qual_len", ctypes.POINTER(ctypes.c_long)),
        ("text", ctypes.POINTER(ctypes.c_ubyte)),
        ("text_len", ctypes.c_long),
        ("is_fastq", ctypes.c_int),
        ("err", ctypes.c_char * 256),
    ]


_SEQIO_LIB = None


def load_seqio() -> ctypes.CDLL:
    """Compile (if needed) and load the native seqio parser library."""
    global _SEQIO_LIB
    with _LOCK:
        if _SEQIO_LIB is not None:
            return _SEQIO_LIB
        lib = _load_cached("seqio_fast.c", "tsta_seqio")
        lib.tsta_seqio_parse.restype = ctypes.c_int
        lib.tsta_seqio_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(SeqIndexStruct),
        ]
        lib.tsta_seqio_free.argtypes = [ctypes.POINTER(SeqIndexStruct)]
        _SEQIO_LIB = lib
        return lib


_POA_LIB = None


def load_poa() -> ctypes.CDLL:
    """Compile (if needed) and load the native POA graph helpers."""
    global _POA_LIB
    with _LOCK:
        if _POA_LIB is not None:
            return _POA_LIB
        lib = _load_cached("poa_fast.c", "tsta_poa")
        lp = ctypes.POINTER(ctypes.c_long)
        lib.tsta_poa_toposort.restype = ctypes.c_long
        lib.tsta_poa_toposort.argtypes = [ctypes.c_long, lp, lp, lp, lp,
                                          lp, lp]
        setup_poa_symbols(lib)
        _POA_LIB = lib
        return lib


def setup_poa_symbols(lib):
    """argtypes for poa_fast.c beyond toposort (idempotent)."""
    lp = ctypes.POINTER(ctypes.c_long)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.tsta_poa_rank_kahn.restype = ctypes.c_long
    lib.tsta_poa_rank_kahn.argtypes = [ctypes.c_long, lp, lp, lp, lp,
                                       lp]
    lib.tsta_poa_consensus.restype = ctypes.c_long
    lib.tsta_poa_consensus.argtypes = [ctypes.c_long] + [lp] * 8
    ub = ctypes.POINTER(ctypes.c_ubyte)
    lib.tsta_poa_merge.restype = ctypes.c_long
    lib.tsta_poa_merge.argtypes = [
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ub, ip, ip, ip, ub, ctypes.c_long, ctypes.c_long, ip, ip,
        ub, ctypes.c_long, lp]
    return lib
