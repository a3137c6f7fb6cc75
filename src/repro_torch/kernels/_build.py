"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Every source is compiled by its own ``nvcc`` process (all started at
once) for ``sm_90a``, then linked into one shared library with a plain
C interface, loaded with ``ctypes``.  Nothing includes PyTorch's
headers, so a cold build takes seconds.  The library lands in
``build/repro_torch_kernels/`` at the repository root, named by a hash
of the sources so an edited source is never served from a stale build.
A failed build raises; there is no fallback.  The TMA tensor maps of
the flash kernels need the driver API's ``cuTensorMapEncodeTiled``; the
sources fetch it at run time through the runtime's
``cudaGetDriverEntryPoint*``, so the library links against nothing but
the CUDA runtime.

Each C entry returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

# C signatures: every pointer and the stream are c_void_p so ctypes never
# truncates them to 32 bits.
SIGNATURES = {
    "fedavg_agg_f32": [_P, _P, _P, _I, _I, _L, _I, _P],
    "fedavg_agg_masked_f32": [_P, _P, _P, _P, _I, _I, _L, _I, _P],
    "fedavg_agg_stale_f32": [_P, _P, _P, _P, _P, _I, _I, _L, _I, _P],
    "stream_update_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                          _F, _P],
    "stream_update_route": [_I],
    "compress_update_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I,
                            _I, _I, _I, _I, _P],
    "compress_update_smem": [_L, _I, _I],
    "diversity_stats": [_P, _P, _P, _I, _I, _I, _P],
    "diversity_route": [_P, _P, _I],
    "sub2_pgd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                 _F, _F, _F, _F, _I, _F, _F, _I, _I, _I, _P],
    "flash_attention_fwd_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _F, _P],
    "flash_attention_fwd_f32_smem": [_I],
    "flash_attention_fwd_tc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _F, _P],
    "flash_attention_bwd": [_P] * 10 + [_I] * 9 + [_F, _P],
    "flash_attention_bwd_smem": [_I],
    "flash_attention_bwd_tc": [_P] * 10 + [_I] * 9 + [_F, _P],
    "flash_attention_bwd_tc_smem": [_I],
    "flash_attention_tc_smem": [_I],
    "flash_attention_decode_smem": [_I, _I, _I],
    "flash_attention_decode_clusters": [_I, _I, _I, _I],
    "flash_attention_decode_blocks": [_I, _I, _I],
    "flash_attention_decode": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _F, _I, _I, _P],
    "shared_fill": [_I, _I, _P],
    "launch_floor": [_P],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(DEFAULT_NVCC):
        return DEFAULT_NVCC
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for path in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> pathlib.Path:
    """Compile every source in parallel and link the shared library.

    Returns the library's path; reuses a finished build of the same
    sources.  ``verbose`` prints ptxas's register and shared-memory use
    of every kernel.  Raises ``RuntimeError`` with the compiler's output
    when a step fails.
    """
    target = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in _sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                   str(src), "-o", str(obj)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(str(obj))
        failures = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if verbose and out:
                print(out)
            if proc.returncode != 0:
                failures.append(f"{src.name}:\n{out}")
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        staged = pathlib.Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(staged, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch (a
    negative code: a driver ``CUresult`` while encoding a TMA map)."""
    if code > 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")
    if code < 0:
        raise RuntimeError(f"CUDA kernel {name}: cuTensorMapEncodeTiled "
                           f"failed with CUresult {-code}")
