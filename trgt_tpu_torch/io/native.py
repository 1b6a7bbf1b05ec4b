"""ctypes loader for the native BGZF/BAM codec (csrc/bamcodec.cpp).

Builds the shared library on first use (g++ -O3 -lz) into
`build/trgt_tpu_torch/` at the repository root, under a name keyed by a
hash of the source, so an edited source is rebuilt; all callers fall
back to the pure-Python implementations when the toolchain or build is
unavailable."""

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading

log = logging.getLogger("trgt")

_lock = threading.Lock()
_lib = None
_tried = False

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "bamcodec.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                          "trgt_tpu_torch")
_GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def _library_path() -> str:
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(_BUILD_DIR, f"libbamcodec-{h.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
    except OSError as e:
        log.debug("native codec build failed: %s", e)
        return False
    try:
        subprocess.run(["g++", *_GXX_FLAGS, _SRC, "-o", tmp, "-lz"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        log.debug("native codec build failed: %s", e)
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def get_lib():
    """Returns the loaded library or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        so = _library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            log.debug("native codec load failed: %s", e)
            return None
        lib.trgt_bgzf_read_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.trgt_bgzf_read_file.restype = ctypes.c_int
        lib.trgt_bgzf_decompress.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.trgt_bgzf_decompress.restype = ctypes.c_int
        lib.trgt_bgzf_compress.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.trgt_bgzf_compress.restype = ctypes.c_int
        lib.trgt_buf_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.trgt_decode_seq.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_char_p]
        lib.trgt_rans_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.trgt_rans_decode.restype = ctypes.c_int
        lib.trgt_banded_align.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.trgt_banded_align.restype = ctypes.c_int
        lib.trgt_endsfree_align.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        lib.trgt_endsfree_align.restype = ctypes.c_int
        lib.trgt_endsfree_banded.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.trgt_endsfree_banded.restype = ctypes.c_int
        lib.trgt_hmm_label.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.trgt_hmm_label.restype = ctypes.c_int
        lib.trgt_bamlet_record.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,     # cigar as raw bytes
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_double,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,     # mo as raw bytes
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.trgt_bamlet_record.restype = ctypes.c_int64
        _lib = lib
        return _lib


def bgzf_read_file(path: str):
    """Decompress a whole BGZF file natively; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_size = ctypes.c_size_t()
    rc = lib.trgt_bgzf_read_file(path.encode(), ctypes.byref(out),
                                 ctypes.byref(out_size))
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out, out_size.value)
    finally:
        lib.trgt_buf_free(out)


def bgzf_compress(data: bytes, level: int = 6, add_eof: bool = True):
    """BGZF-compress a buffer natively; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    src = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_size = ctypes.c_size_t()
    rc = lib.trgt_bgzf_compress(src, len(data), level,
                                1 if add_eof else 0, ctypes.byref(out),
                                ctypes.byref(out_size))
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out, out_size.value)
    finally:
        lib.trgt_buf_free(out)


def rans_decode(data: bytes):
    """Native rANS4x8 decode (CRAM spec §13); None if unavailable or on
    malformed input (callers fall back to the Python twin)."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_size = ctypes.c_size_t()
    rc = lib.trgt_rans_decode(data, len(data), ctypes.byref(out),
                              ctypes.byref(out_size))
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out, out_size.value)
    finally:
        lib.trgt_buf_free(out)


def decode_seq(packed: bytes, l_seq: int):
    lib = get_lib()
    if lib is None:
        return None
    src = (ctypes.c_uint8 * len(packed)).from_buffer_copy(packed)
    out = ctypes.create_string_buffer(l_seq)
    lib.trgt_decode_seq(src, l_seq, out)
    return out.raw.decode("ascii")


def banded_align(pattern: bytes, text: bytes, mism: int, gapo: int,
                 gape: int, tb: int, te: int, W: int):
    """One native banded-alignment pass (native twin of
    kernels/align_banded._banded_pass + traceback). Returns
    (rc, score, ops_bytes): rc 0 = certified (ops valid), 1 =
    certificate failed (score is the banded upper bound), None if the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    score = ctypes.c_int64()
    ops_cap = len(pattern) + len(text)
    ops = ctypes.create_string_buffer(ops_cap)
    ops_len = ctypes.c_int64()
    rc = lib.trgt_banded_align(
        pattern, len(pattern), text, len(text), mism, gapo, gape,
        tb, te, W, ctypes.byref(score), ops, ops_cap,
        ctypes.byref(ops_len))
    if rc == -1:
        return None
    return rc, score.value, ops.raw[:ops_len.value]


def endsfree_align(pattern: bytes, text: bytes, mism: int, gapo: int,
                   gape: int):
    """Native ends-free alignment (twin of
    kernels/align_host.align_ends_free_text). Returns
    (score, n_matches, (p_start, p_end), (t_start, t_end)) or None."""
    lib = get_lib()
    if lib is None:
        return None
    out = (ctypes.c_int64 * 6)()
    rc = lib.trgt_endsfree_align(pattern, len(pattern), text, len(text),
                                 mism, gapo, gape, out)
    if rc != 0:
        return None
    return (int(out[0]), int(out[1]), (int(out[2]), int(out[3])),
            (int(out[4]), int(out[5])))


def endsfree_banded(pattern: bytes, text: bytes, mism: int, gapo: int,
                    gape: int, dlo: int, dhi: int):
    """Native diagonal-banded ends-free alignment (band j - i in
    [dlo, dhi]); bit-identical to endsfree_align when the caller's
    certificate holds (kernels/span_window.py). Returns
    (score, n_matches, (p_start, p_end), (t_start, t_end)), or None if
    the library is unavailable or the banded traceback was invalid
    (callers recompute on the full DP)."""
    lib = get_lib()
    if lib is None:
        return None
    out = (ctypes.c_int64 * 6)()
    rc = lib.trgt_endsfree_banded(pattern, len(pattern), text, len(text),
                                  mism, gapo, gape, dlo, dhi, out)
    if rc != 0:
        return None
    return (int(out[0]), int(out[1]), (int(out[2]), int(out[3])),
            (int(out[4]), int(out[5])))


def hmm_label(tables: dict, sym, out_cap: int):
    """Native HMM Viterbi labeling (twin of hmm/model.Hmm.label).
    `tables` is the flat-array dict prepared by Hmm._native_tables();
    sym is the encoded '#'+query+'#' int32 array. Returns the state
    path list, raises ValueError on traceback failure, or returns None
    if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np
    L = len(sym)
    out = np.empty(out_cap, dtype=np.int32)
    out_len = ctypes.c_int64()
    i32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    rc = lib.trgt_hmm_label(
        tables["S"], tables["E"], L,
        i32p(tables["in_idx"]),
        tables["in_lp"].ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        tables["em"].ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        tables["silent"].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        tables["has_edges"].ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)),
        tables["n_levels"], i32p(tables["level_off"]),
        i32p(tables["level_states"]), i32p(sym), i32p(out), out_cap,
        ctypes.byref(out_len))
    if rc == -1:
        return None
    if rc == 1:
        raise ValueError("HMM traceback failed (no valid path)")
    return out[:out_len.value].tolist()
