"""Build the port's CUDA kernels and load them with ctypes.

Every `trgt_tpu_torch/csrc/*.cu` file is compiled by nvcc, at first use,
into ONE shared library with a plain C interface (no PyTorch headers, so
a build takes seconds, not minutes). The library lands in
`build/trgt_tpu_torch/` at the repository root (listed in .gitignore),
under a name keyed by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused.

A failed build raises; nothing here falls back to the plain PyTorch
versions of the kernels. Each C entry point returns the launch's
`cudaGetLastError()`, which `check` turns into an exception.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "trgt_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# filled by the build that loaded the library: path, seconds, nvcc log
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "trgt_flank_align": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    "trgt_viterbi": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                     _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                     _P, _P],
    "trgt_viterbi_slice_bytes": [_I, _I, _I, _I],
    "trgt_edit_distances": [_P, _I, _P, _I, _P, _P, _P, _I, _P],
    "trgt_e2e_scan": [_P, _I, _P, _I, _P, _P, _P, ctypes.c_size_t, _P, _P,
                      _P, _I, _I, _I, _I, _P],
    "trgt_e2e_strip": [_I],
    "trgt_e2e_band_half": [_I],
    "trgt_e2e_band": [_P, _I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                      _I, _I, _I, _I, _P],
}


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = []
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "cannot be built")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libtrgt_torch_kernels-"
                                   f"{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu unless a library for these exact sources exists;
    returns its path. Raises RuntimeError with nvcc's output on failure."""
    path = library_path()
    if os.path.exists(path):
        build_info.update(path=path, seconds=0.0, log="(cached)")
        return path
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed (rc={proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    build_info.update(path=path, seconds=seconds,
                      log=(proc.stdout + proc.stderr).strip())
    return path


def get_lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.trgt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.trgt_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = get_lib().trgt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
