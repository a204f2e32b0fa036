"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles to an object (in parallel), and one ``nvcc`` link
makes a shared library with a plain C interface, loaded with ctypes: no
PyTorch headers. The library lands in ``csrc/build/`` under a name keyed by
the sources' hash, so an edited source rebuilds. Nothing here runs at
import: the first kernel launch builds and loads.

Every launcher returns 0, a ``cudaError_t`` from ``cudaGetLastError()``
right after the launch, or ``ARCNERF_BAD_ARGUMENT``; ``check`` raises on
anything but 0.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
BAD_ARGUMENT = 100000

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "arcnerf_fused_mlp_fwd": [_P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P],
    "arcnerf_fused_mlp_bwd": [_P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "arcnerf_hash_encode_fwd": [_P, _LL, _P, _I, _I, _I, _P, _F, _F, _I, _I, _P, _P],
    "arcnerf_hash_encode_bwd": [_P, _LL, _P, _I, _I, _I, _P, _F, _F, _I, _P, _P],
    "arcnerf_segment_march_fwd": [_P, _P, _P, _P, _P, _I, _LL, _I, _P, _I, _P, _P, _P, _P, _P],
    "arcnerf_segment_march_bwd": [_P, _P, _P, _P, _P, _I, _LL, _I, _P, _I, _P, _P, _P, _P, _P, _P],
}

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path():
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / "libarcnerf_kernels_{}.so".format(digest.hexdigest()[:12])


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in {}/bin)".format(cuda_home))
    return path


def build(verbose=False):
    """Compile every ``csrc/*.cu`` into one library unless it exists.
    Returns the seconds spent compiling (0.0 when the library was there).
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report."""
    out = library_path()
    if out.exists():
        return 0.0
    work = BUILD_DIR / "tmp{}".format(os.getpid())
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        cmd = [nvcc] + NVCC_FLAGS + extra + ["-c", str(src), "-o", str(work / (src.stem + ".o"))]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in jobs]
    for cmd, report, rc in reports:
        if rc != 0:
            raise RuntimeError("nvcc failed ({}):\n{}".format(" ".join(cmd), report))
        if verbose:
            print(report)
    objs = [cmd[-1] for cmd, _, _ in reports]
    link = [nvcc] + NVCC_FLAGS + ["-shared", "-o", str(work / out.name)] + objs
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc link failed ({}):\n{}{}".format(" ".join(link), proc.stdout, proc.stderr))
    os.replace(work / out.name, out)
    shutil.rmtree(work)
    return time.perf_counter() - t0


def lib():
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        build()
        handle = ctypes.CDLL(str(library_path()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream_handle(device):
    return torch.cuda.current_stream(device).cuda_stream


def float3(values):
    return (ctypes.c_float * 3)(*[float(v) for v in values])


def check(status, name):
    if status == BAD_ARGUMENT:
        raise ValueError("{}: the kernel does not take these arguments".format(name))
    if status != 0:
        raise RuntimeError("{}: CUDA launch failed with cudaError {}".format(name, status))


def require_cuda(name, *tensors, dtype=torch.float32):
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``."""
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
            raise ValueError("{}: expected contiguous CUDA {} tensors, got {} {} contiguous={}".format(
                name, dtype, t.device, t.dtype, t.is_contiguous()))
