"""Build and load the port's CUDA kernels (csrc/*.cu).

The sources are compiled at first use, one nvcc process per source,
all started together, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c

and linked (`nvcc -shared`) into one shared library under
build/kmer_tpu_torch/ at the repository root, named by a hash of the
sources and flags (a changed source builds anew; an unchanged one loads
the library already built).  Whole-program objects are enough for the
grid barrier of csrc/table.cu's cooperative kernel
(cooperative_groups::this_grid().sync() needs no -rdc since CUDA 11).
The library
has a plain C interface and is bound with ctypes: every pointer and the
CUDA stream pass as c_void_p.  Each entry point returns
cudaGetLastError() after its launches; `check` raises when that is not
0, since a refused launch never runs and a later synchronize does not
report it.

LAUNCHES holds one plain-int launch count per kernel.  Each wrapper adds
one to its count where it launches its kernel and nowhere else, so a run
can show that the main path went through the kernels.  A kernel with two
entry points counts both: `myers` is csrc/myers.cu's one-word kernel,
launched by ktt_myers (the (R, P) counts) and ktt_myers_sums (their sum
a pattern), `myers_multiword` its W-word kernel; `bloom` counts calls of
ktt_bloom_insert, which launches csrc/bloom.cu's two kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kmer_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

LAUNCHES = {"extract": 0, "seghist": 0, "merge_partition": 0,
            "merge_path": 0, "merge_partition1": 0, "merge_path1": 0,
            "merge_partition3": 0, "merge_path3": 0, "resolve": 0, "myers": 0,
            "myers_multiword": 0, "bloom": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# entry point -> argtypes (all return int: a cudaError_t)
_SIGNATURES = {
    "ktt_extract": [_P, _I64, _I32, _P, _P, _P],
    "ktt_extract_rows": [_P, _I64, _I32, _I32, _P, _P, _P],
    "ktt_extract_per_thread": [],
    "ktt_seghist": [_P, _P, _I64, _I32, _I32, _I32, _P, _P, _P],
    "ktt_seghist_tile_lanes": [],
    "ktt_merge_tile_lanes": [],
    "ktt_merge_partition": [_P, _I64, _P, _I64, _P, _P],
    "ktt_merge_path": [_P, _I64, _P, _I64, _P, _P, _P],
    "ktt_merge_tile_lanes1": [],
    "ktt_merge_partition1": [_P, _I64, _P, _I64, _P, _P],
    "ktt_merge_path1": [_P, _I64, _P, _I64, _P, _P, _P],
    "ktt_merge_tile_lanes3": [],
    "ktt_merge_partition3": [_P, _P, _I64, _P, _P, _I64, _P, _P],
    "ktt_merge_path3": [_P, _P, _I64, _P, _P, _I64, _P, _P, _P, _P],
    "ktt_resolve": [_P, _P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _P,
                    _P, _P, _I32, _P],
    "ktt_resolve_info": [_P],
    "ktt_myers": [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32, _P, _P],
    "ktt_myers_multiword": [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32,
                            _I32, _P, _P, _P],
    "ktt_myers_sums": [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32, _P, _P],
    "ktt_myers_multiword_sums": [_P, _P, _P, _P, _I64, _I64, _I64, _I32,
                                 _I32, _I32, _P, _P, _P],
    "ktt_myers_shape": [_I64, _I64, _I32, _I32, _I32, _P],
    "ktt_bloom_insert": [_P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _P, _P,
                         _P, _I64, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's build, None if loaded


def sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("kmer_tpu_torch: nvcc not found (set CUDA_HOME)")


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libkmer_tpu_torch_{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> None:
    """Run the nvcc commands concurrently; raise on the first failure
    after every one has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = []
    for p in procs:
        _out, err = p.communicate()
        if p.returncode != 0:
            errs.append(f"nvcc failed ({p.returncode}):\n{err}")
    if errs:
        raise RuntimeError("kmer_tpu_torch: " + "\n".join(errs))


def _build(so: str) -> None:
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"tmp.{os.getpid()}"
    nvcc = _nvcc()
    cus = [s for s in sources() if s.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(c)}.{tag}.o")
            for c in cus]
    t0 = time.perf_counter()
    try:
        _run_all([nvcc, *NVCC_FLAGS, "-c", "-o", o, c]
                 for c, o in zip(cus, objs))
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", f"{so}.{tag}",
                   *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(f"{so}.{tag}", so)  # atomic publish for concurrent builds
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The kernels' library, built from csrc/ at first use.

    A failure to build or load it raises RuntimeError, never OSError:
    the tools treat OSError as an unreadable input, and a kernel that
    cannot load must not pass for one."""
    global _lib
    with _lock:
        if _lib is None:
            so = _library_path()
            try:
                if not os.path.exists(so):
                    _build(so)
                lib = ctypes.CDLL(so)
            except OSError as e:
                raise RuntimeError(f"kmer_tpu_torch: cannot build or load "
                                   f"the kernel library {so}: {e}") from e
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ktt_error_string.argtypes = [ctypes.c_int]
            lib.ktt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().ktt_error_string(rc).decode()
        raise RuntimeError(f"kmer_tpu_torch: {name} launch failed: "
                           f"CUDA error {rc} ({msg})")


def launch(entry: str, count: str, t, *args) -> None:
    """Call the library's `entry` with `args` and the raw cudaStream_t of
    PyTorch's current stream on t's device, with t's device made the
    current one for the call: CUDA refuses a launch into a stream of
    another device, and the entry points' cudaFuncSetAttribute and
    cudaGetDevice act on the current device.  Adds one to
    LAUNCHES[count]; raises when the launch failed."""
    import torch

    with torch.cuda.device(t.device):
        rc = getattr(library(), entry)(
            *args, torch.cuda.current_stream(t.device).cuda_stream)
    LAUNCHES[count] += 1
    check(rc, count)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
