"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``. The
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and an unchanged one is reused. Builds happen at first
use (never at import) into ``fourierflow_tpu_torch/_build/``, which git
ignores; :func:`build` starts one ``nvcc`` per source, all at once.

:func:`register_op` makes a kernel a PyTorch operator with a plain (CPU),
a kernel (CUDA) and a shape-only (Meta) implementation, so that
``torch.export`` records each call as one node that launches the kernel
when the exported program runs on the card.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["KERNEL_SOURCES", "MAX_SMEM", "build", "load", "check", "stream_ptr", "build_logs",
           "check_device", "register_op"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

KERNEL_SOURCES = ("fused_ff", "fused_spectral", "segment_sum")

MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# ptxas register/shared-memory report of each build made in this process.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"{name}-{digest}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, in parallel.
    Returns the seconds each build took (0.0 where the library existed)."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    seconds = {n: 0.0 for n in names}
    if not todo:
        return seconds
    nvcc = _nvcc()
    procs = {}
    start = time.perf_counter()
    for name, path in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        build_logs[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it. Every source exports
    ``cuda_error_string`` for :func:`check`."""
    path = _lib_path(name)
    if not path.exists():
        build([name])
    lib = ctypes.CDLL(str(path))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.cuda_error_string(err).decode()})")


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, as a pointer for ctypes."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_device(x, what: str) -> None:
    """Raise unless ``x`` lies on the CPU or a CUDA device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")


def register_op(library, name: str, schema: str, plain, kernel, meta):
    """Define ``library``'s operator ``name`` with ``schema`` (its
    arguments and results, as ``"(Tensor x) -> Tensor"``): ``plain`` runs
    on CPU tensors, ``kernel`` on CUDA tensors, ``meta`` gives the results'
    shapes and types only (fake tensors while ``torch.export`` traces).
    Tensors of any other device find no implementation and raise. Returns
    the operator (its default overload), callable like a function."""
    import torch

    library.define(name + schema)
    for fn, key in ((plain, "CPU"), (kernel, "CUDA"), (meta, "Meta")):
        library.impl(name, fn, key)
    return getattr(getattr(torch.ops, library.ns), name).default
