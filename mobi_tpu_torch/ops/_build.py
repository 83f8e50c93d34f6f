"""Builds the port's CUDA kernels, loads them with ctypes and counts their
launches.

Every `csrc/*.cu` is compiled for Hopper (`sm_90a`) by its own `nvcc`
process, all started together, and the objects are linked into one shared
library with a plain C interface. The library lands in `build/kernels/` at the
repository root, named by a hash of the sources (`*.cu` and the `*.cuh` they
include) and flags, so an edited source rebuilds and an unchanged one loads
the library already there. The build runs
at the first CUDA call of a kernel wrapper, never at import. A failed build or
load raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
         "-Xptxas=-v", ARCH]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
compile_seconds: dict = {}  # source -> seconds its nvcc took, in the build of this process

# Launches of each kernel since the counts were last set to 0: a wrapper
# counts one through `launched` where it launches its kernel, and nowhere else.
launches = dict.fromkeys(("flash_fwd", "flash_fwd_tav", "flash_fwd_lse", "flash_bwd_dq",
                          "flash_bwd_dkv", "gn_silu"), 0)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # fp32 K1 and K3: q, k, v, o, lse (null for K1), batch, heads, nq, nk,
    # d, 12 strides, scale_log2, stream
    "mobi_flash_fwd": [_P] * 5 + [_I] * 5 + [_L] * 12 + [_F, _P],
    # bf16 K1, K2 and K3: q, k, v, o, lse (null for K1 and K2), batch,
    # heads, nq, nk, d, tav, 12 strides, scale_log2, stream
    "mobi_flash_fwd_sm90": [_P] * 5 + [_I] * 6 + [_L] * 12 + [_F, _P],
    # fp32 K2: q, k, v, o, batch, heads, nq, nk, d, 12 strides, scale_log2,
    # stream
    "mobi_flash_fwd_tav": [_P] * 4 + [_I] * 5 + [_L] * 12 + [_F, _P],
    # fp32 K4 (mma.sync) and bf16 K4 (wgmma): q, k, v, dout, lse, delta, dq,
    # batch, heads, nq, nk, d, strides (15), scale, stream
    "mobi_flash_bwd_dq": [_P] * 7 + [_I] * 5 + [_P, _F, _P],
    "mobi_flash_bwd_dq_sm90": [_P] * 7 + [_I] * 5 + [_P, _F, _P],
    # fp32 and bf16 K5: q, k, v, dout, lse, delta, dk, dv, batch, heads, nq,
    # nk, d, strides (18), scale, stream
    "mobi_flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_P, _F, _P],
    "mobi_flash_bwd_dkv_sm90": [_P] * 8 + [_I] * 5 + [_P, _F, _P],
    # x, gamma, beta, y, batch, channels, groups, hw, fp32, eps, variant,
    # cluster, chunk, threads, stream
    "mobi_gn_silu": [_P] * 4 + [_I] * 5 + [_F] + [_I] * 4 + [_P],
}


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of mobi_tpu_torch cannot be built"
        )
    return found


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmobi_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is already built.
    The compiler's register and shared-memory report (ptxas -v) is kept
    beside the library as `<name>.log`, and each source's compile seconds
    in `compile_seconds`."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs, t0 = [], time.perf_counter()
        for src in sorted(CSRC.glob("*.cu")):
            obj, report = Path(tmp) / f"{src.stem}.o", Path(tmp) / f"{src.stem}.txt"
            cmd = [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)]
            with open(report, "w") as f:  # a file, not a pipe: a long report cannot block nvcc
                jobs.append((src, obj, report, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
        pending = list(jobs)
        while pending:  # every compile, failed or not
            time.sleep(0.05)
            for job in [j for j in pending if j[-1].poll() is not None]:
                compile_seconds[job[0].name] = time.perf_counter() - t0
                pending.remove(job)
        texts = {src.name: report.read_text() for src, _, report, _ in jobs}
        log = [f"== {src.name}\n{texts[src.name]}" for src, *_ in jobs]
        failed = [f"nvcc failed on {src.name}:\n{texts[src.name]}" for src, *_, proc in jobs if proc.returncode]
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", ARCH, "-o", str(tmp_so),
             *[str(obj) for _, obj, *_ in jobs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"linking {out.name} failed:\n{link.stdout}")
        out.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp_so, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launched(err: int, kernel: str) -> None:
    """Raise on the error a launch function returned (a cudaError_t, or 10000
    + the CUresult of a TMA tensor map that could not be encoded); else
    count the launch."""
    if err > 10000:
        raise RuntimeError(f"{kernel}: encoding a TMA tensor map failed with CUresult {err - 10000}")
    if err:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {err}")
    launches[kernel] += 1


def reset_launches() -> None:
    launches.update(dict.fromkeys(launches, 0))
