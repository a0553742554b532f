"""Build the hand-written CUDA kernels at first use and bind them.

Every ``csrc/*.cu`` source becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` (Hopper) and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds. The libraries go
to ``build/repro_torch_kernels/<hash of the sources>/`` under the repository
root, so an edited source is rebuilt and an unchanged one is reused. The
sources are compiled in parallel, one ``nvcc`` per file. No
``--use_fast_math``: the kernels' score bits rely on IEEE adds and compares.

Nothing here runs at import time: the CPU tests import the kernel modules
without a CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.abspath(os.path.join(CSRC, "..", "..", "..", ".."))
BUILD_ROOT = os.path.join(_REPO, "build", "repro_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/*.cu``), sorted."""
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use and need the CUDA toolkit")


def _build_dir() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every source that has no library yet, all at once (one
    ``nvcc`` process per source). Returns {source name: library path};
    raises with the compiler's output when a build fails."""
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    paths, procs = {}, {}
    for name in sources():
        lib = os.path.join(out_dir, name[:-3] + ".so")
        paths[name] = lib
        if os.path.exists(lib):
            continue
        tmp = f"{lib[:-3]}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               os.path.join(CSRC, name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name} failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        if verbose:
            print(f"[build] {name}:\n{log}", flush=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building on first use."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            _libs[name] = ctypes.CDLL(paths[name + ".cu"])
        return _libs[name]


def function(lib: str, name: str, restype, argtypes: list):
    """The C entry point ``name`` of ``csrc/<lib>.cu``, its ``restype`` and
    ``argtypes`` bound once, when it is first asked for."""
    fn = _fns.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.restype, fn.argtypes = restype, argtypes
        with _lock:
            fn = _fns.setdefault((lib, name), fn)
    return fn


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_operands(kernel: str, device, operands) -> None:
    """Raise unless every ``(name, tensor, dtype, shape)`` operand lies on
    ``device`` with that dtype (or one of a tuple of dtypes) and shape and
    is contiguous: the kernel reads raw pointers."""
    for name, t, dtype, shape in operands:
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, the other "
                             f"operands on {device}")
        dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
        if t.dtype not in dtypes:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, the kernel "
                            f"takes {' or '.join(map(str, dtypes))}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} is {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")


def cs_flag(t) -> int:
    """The ``cs_bf16`` argument of the C entries that read centroid scores
    (``csrc/common.cuh``'s ``with_cs``): 1 for bf16 CS, 0 for float32."""
    import torch
    return int(t.dtype == torch.bfloat16)


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer as a ctypes argument; None gives a null
    pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream as a ctypes argument."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
