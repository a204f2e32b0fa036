"""Build and load the port's CUDA kernels (``csrc/*.cu``) and their Python
binding (``csrc/bindings.cpp``).

Every ``.cu`` source compiles to an object with nvcc, and ``bindings.cpp`` -
a pybind11 module with one function per ``extern "C"`` launcher, which
checks the tensors, allocates the outputs and launches on PyTorch's current
stream - compiles against torch's headers through nvcc's host compiler, all
at once, in parallel. One nvcc link makes the extension module
``arcnerf_kernels_<hash>`` in ``csrc/build/``: the hash covers every source,
so an edited one rebuilds. The binding includes only light headers (not
``torch/extension.h``), and neither ninja nor
``torch.utils.cpp_extension.load`` takes part. Nothing here runs at import:
the first kernel launch builds and loads (``ops()``). A failed build or
import raises; no wrapper has another way to launch.

The launchers stay exported from the module, so ``lib()`` opens the same
file with ctypes to time a kernel through its C entry point alone
(``chip_smoke.py``); no wrapper calls it.
"""

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
BINDING = CSRC / "bindings.cpp"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# torch's headers want C++20 (they warn under C++17); the binding holds no device code
BINDING_FLAGS = ["-std=c++20", "-O2", "-Xcompiler", "-fPIC"]
TORCH_LIBS = ["c10", "c10_cuda", "torch", "torch_cpu", "torch_python"]
BAD_ARGUMENT = 100000  # ARCNERF_BAD_ARGUMENT of csrc/launchers.h

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _IP, _FV = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int), ctypes.c_float
_SIGNATURES = {
    "arcnerf_fused_mlp_fwd": [_P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P],
    "arcnerf_fused_mlp_bwd": [_P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "arcnerf_hash_encode_fwd": [_P, _LL, _P, _I, _I, _I, _P, _F, _F, _I, _I, _P, _P],
    "arcnerf_hash_encode_bwd": [_P, _LL, _P, _I, _I, _I, _P, _F, _F, _I, _P, _P],
    "arcnerf_segment_march_fwd": [_P, _P, _P, _P, _P, _I, _LL, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P],
    "arcnerf_segment_march_bwd": [_P, _P, _P, _P, _P, _I, _LL, _I, _P, _I, _P, _P, _P, _P, _P, _P],
    "arcnerf_row_gather": [_P, _LL, _I, _P, _LL, _P, _P],
    "arcnerf_lane_gather": [_P, _LL, _LL, _P, _LL, _LL, _P, _P],
    "arcnerf_scatter_add_rows": [_P, _LL, _I, _P, _P, _LL, _P, _LL, _P],
    "arcnerf_build_update_rows": [_P, _P, _LL, _IP, _I, _I, _P, _P],
    "arcnerf_sample_count": [_P, _P, _I, _P, _I, _F, _F, _P, _I, _FV, _I, _I, _LL, _I] + [_P] * 9,
    "arcnerf_sample_write": [_P, _P, _I, _P, _I, _F, _F, _P, _I, _FV, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _P, _P,
                             _P, _P, _P, _P],
    "arcnerf_hash_dx": [_P, _LL, _P, _P, _I, _I, _I, _P, _F, _F, _I, _I, _P, _P],
    "arcnerf_hash_dx_bwd": [_P, _LL, _P, _P, _P, _I, _I, _I, _P, _F, _F, _I, _I, _P, _P, _P],
    "arcnerf_geo_chain_fwd": [_P, _LL, _P, _P, _P, _FV, _P, _P, _P],
    "arcnerf_geo_chain_bwd": [_P, _LL, _P, _P, _P, _P, _P, _FV, _P, _P, _P, _P, _P],
    "arcnerf_softplus_fwd": [_P, _LL, _FV, _P, _P],
    "arcnerf_softplus_bwd": [_P, _P, _LL, _FV, _P, _P],
    "arcnerf_softplus_bwd2": [_P, _P, _P, _LL, _FV, _P, _P, _P],
}

_ops = None
_lib = None


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh", ".h", ".cpp"))


def module_name():
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return "arcnerf_kernels_" + digest.hexdigest()[:12]


def library_path():
    """The extension module's file: the binding and every kernel."""
    return BUILD_DIR / (module_name() + sysconfig.get_config_var("EXT_SUFFIX"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in {}/bin)".format(cuda_home))
    return path


def build_commands(nvcc, work, out, verbose=False):
    """The build as commands: (one compile command per ``.cu`` source,
    the binding's compile command, the link command) for objects in
    ``work`` and the module ``out``. ``verbose`` adds ``-Xptxas -v`` to the
    kernels. Runs nothing."""
    from torch.utils.cpp_extension import include_paths, library_paths

    extra = ["-Xptxas", "-v"] if verbose else []
    kernels = [[nvcc] + NVCC_FLAGS + extra + ["-c", str(src), "-o", str(Path(work) / (src.stem + ".o"))]
               for src in sorted(CSRC.glob("*.cu"))]
    includes = [sysconfig.get_paths()["include"]] + list(include_paths())
    binding = ([nvcc] + BINDING_FLAGS +
               ["-D_GLIBCXX_USE_CXX11_ABI={}".format(int(torch._C._GLIBCXX_USE_CXX11_ABI)),
                "-DARCNERF_MODULE=" + Path(out).name.split(".")[0]] +
               ["-I" + p for p in includes] + ["-c", str(BINDING), "-o", str(Path(work) / "bindings.o")])
    libs = list(library_paths())
    link = ([nvcc, "-shared", "-o", str(out)] + [cmd[-1] for cmd in kernels] + [binding[-1]] +
            ["-L" + p for p in libs] + ["-Xlinker", "-rpath," + ":".join(libs)] + ["-l" + n for n in TORCH_LIBS])
    return kernels, binding, link


def build(verbose=False):
    """Compile the kernels and the binding into the module unless it exists.
    Returns {"nvcc": s, "binding": s, "link": s}: the seconds until the last
    kernel object and until the binding's object (both start together), and
    of the link; all 0.0 when the module was there. ``verbose`` adds
    ``-Xptxas -v`` and prints the compiler's report."""
    out = library_path()
    if out.exists():
        return {"nvcc": 0.0, "binding": 0.0, "link": 0.0}
    work = BUILD_DIR / "tmp{}".format(os.getpid())
    work.mkdir(parents=True, exist_ok=True)
    kernels, binding, link = build_commands(_nvcc(), work, work / out.name, verbose)
    t0 = time.perf_counter()

    def run(cmd):  # one compiler process; returns its report, exit code and finishing second
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc.stdout, proc.returncode, time.perf_counter() - t0

    with ThreadPoolExecutor(len(kernels) + 1) as pool:
        results = list(zip(kernels + [binding], pool.map(run, kernels + [binding])))
    for cmd, (report, rc, _) in results:
        if rc != 0:
            raise RuntimeError("build failed ({}):\n{}".format(" ".join(cmd), report))
        if verbose and report:
            print(report)
    seconds = {"nvcc": max(s for _, (_, _, s) in results[:-1]), "binding": results[-1][1][2]}
    t1 = time.perf_counter()
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("link failed ({}):\n{}{}".format(" ".join(link), proc.stdout, proc.stderr))
    os.replace(work / out.name, out)
    shutil.rmtree(work)
    seconds["link"] = time.perf_counter() - t1
    return seconds


def ops():
    """The binding module (built first if needed): one function per kernel,
    taking tensors."""
    global _ops
    if _ops is None:
        build()
        path = library_path()
        spec = importlib.util.spec_from_file_location(module_name(), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[spec.name] = module
        _ops = module
    return _ops


def lib():
    """The same module opened with ctypes, its C launchers typed: for timing
    a kernel through its entry point alone. No wrapper calls it."""
    global _lib
    if _lib is None:
        ops()
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
    """Raise on a launcher's status through ctypes (``lib()``)."""
    if status == BAD_ARGUMENT:
        raise ValueError("{}: the kernel does not take these arguments".format(name))
    if status != 0:
        raise RuntimeError("{}: CUDA launch failed with cudaError {}".format(name, status))

