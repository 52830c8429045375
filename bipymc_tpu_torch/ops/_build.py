"""Build and load the port's CUDA kernels.

Each source in ``bipymc_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C
interface, and loaded with ``ctypes``. The sources include no PyTorch
header, so a build takes seconds instead of the minutes a
``torch.utils.cpp_extension`` build of a file including
``torch/extension.h`` takes. All sources are compiled at once, one
``nvcc`` process each, at the first launch of any kernel; the libraries
go to ``build/torch_kernels/`` at the root of the checkout, named by a
hash of their source and of the shared headers (``csrc/*.cuh``), so an
edited source is rebuilt and an unchanged one is reused.

Pointers and the current CUDA stream pass as Python ints; each C entry
point returns the launch's ``cudaError_t``, or :data:`ERR_SHARED_MEMORY`
or :data:`ERR_NO_CLUSTER` where it refuses the launch before making it,
which :func:`check` turns into an exception.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_U64 = ctypes.c_uint64
# an entry point's refusal, before any launch: the operands' shapes need
# more shared memory than a block may take (csrc/*.cu return it as -1)
ERR_SHARED_MEMORY = -1
# a cluster launch's refusal, before the launch: the occupancy query
# (cudaOccupancyMaxActiveClusters) finds no room on the card for one
# cluster of the planned size (csrc/chol.cu and csrc/bchol.cu return it
# as -2)
ERR_NO_CLUSTER = -2
# C signatures of the entry points, by source name
SIGNATURES = {
    "distinct_idx": ("distinct_idx_launch",
                     [_P, _L, _I, _I, _I, _P, _P, _P]),
    "dream_proposal": ("dream_propose_launch",
                       [_P, _L, _P, _I, _P, _L, _P, _L, _P, _L, _P, _I, _I,
                        _I, _F, _F, _F, _P, _P, _P]),
    "fused_rw_chunk": ("fused_rw_chunk_launch",
                       [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I,
                        _F, _F, _I, _P, _P, _P, _P, _P, _P]),
    "fused_chunk": ("fused_chunk_launch",
                    [_P, _P, _P, _I, _P, _L, _P, _L, _P, _L, _I, _U64, _L,
                     _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _P, _P,
                     _I, _F, _F, _I, _P, _P, _P, _P, _P]),
    "fused_stretch": ("fused_stretch_launch",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _F, _F,
                       _P, _P, _P, _I, _I, _P, _P]),
    "sqdist": ("sqdist_launch", [_P, _P, _P, _I, _I, _I, _I, _P]),
    "bchol": ("bchol_launch", [_P, _P, _P, _P, _I, _I, _P, _P]),
    "chol": ("chol_launch", [_P, _P, _I, _I, _P]),
    "chol_coop": ("chol_coop_launch", [_P, _P, _P, _P, _I, _I, _P]),
    "trisolve": ("trisolve_launch",
                 [_P, _P, _P, _I, _I, _I, _L, _I, _P]),
    "gather_rows": ("gather_rows_launch",
                    [_P, _L, _L, _I, _I, _P, _I, _L, _P, _P]),
    "accept_select": ("accept_select_launch",
                      [_P, _L, _P, _L, _I, _I, _P, _P, _P, _P, _P, _L, _P, _P,
                       _P, _P, _P]),
}
# further entry points of a source: name -> (source, C symbol, argtypes)
ENTRY_POINTS = {
    "fused_rw_chunk_plan": ("fused_rw_chunk", "fused_rw_chunk_plan",
                            [_I, _I, _I, _I, _I, _I, _P]),
    "fused_chunk_plan": ("fused_chunk", "fused_chunk_plan",
                         [_I, _I, _I, _I, _I, _I, _I, _P]),
    "bchol_plan": ("bchol", "bchol_plan", [_I, _I, _P]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the port's CUDA kernels are built from source at first use")
    return str(path)


def _lib_path(name: str) -> Path:
    # the shared headers (*.cuh) are part of every source's identity
    src = b"".join(p.read_bytes() for p in [SRC_DIR / f"{name}.cu"]
                   + sorted(SRC_DIR.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:16]}.so"


@functools.cache
def build_all() -> dict:
    """Compile every missing kernel library, all ``nvcc`` runs at once.

    Returns ``{name: (seconds, compiler log)}`` for the sources compiled
    by this call (an empty dict when every library was already built).
    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    start = time.perf_counter()
    for name in SIGNATURES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = (time.perf_counter() - start, log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)          # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


@functools.cache
def _cdll(name: str) -> ctypes.CDLL:
    build_all()
    return ctypes.CDLL(str(_lib_path(name)))


@functools.cache
def library(name: str):
    """The entry point of kernel source ``name``, or the entry point
    ``name`` of :data:`ENTRY_POINTS`, built and loaded on first use."""
    if name in ENTRY_POINTS:
        source, fn_name, argtypes = ENTRY_POINTS[name]
    else:
        source, (fn_name, argtypes) = name, SIGNATURES[name]
    fn = getattr(_cdll(source), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error or the card had no room for
    a cluster (``RuntimeError``), or the entry point refused the shapes
    (``ValueError``)."""
    if err == ERR_SHARED_MEMORY:
        raise ValueError(f"kernel {name}: the operands' shapes do not fit "
                         "the shared memory a block may take")
    if err == ERR_NO_CLUSTER:
        raise RuntimeError(f"kernel {name}: the card has no room for one "
                           "cluster of the planned size")
    if err != 0:
        raise RuntimeError(f"CUDA launch of kernel {name} failed: "
                           f"cudaError_t {err}")
