"""Build and load the port's hand-written CUDA kernels (``csrc/``).

The ``.cu`` sources have a plain C interface. At first use each is compiled
with ``nvcc`` for ``sm_90a`` into an object, all of them at once in parallel
processes, and the objects are linked into one shared library under
``build/torch_kernels/`` at the repository root, loaded with ``ctypes``.
The library's name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing here runs
at import time: the CPU-only test host imports this module without a GPU or a
compiler.

Two CPython extensions with no CUDA in them, the open-set evaluation's
native matcher (``csrc/osod_eval.cpp``, :func:`osod_matcher`) and the data
loader's batch assembly (``csrc/dataloader.cpp``, :func:`dataloader`), are
built the same way with the host's C++ compiler, on any host.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "CSRC", "build", "check", "dataloader", "device_guard", "library", "osod_matcher"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # (clouds, out, B, n, d, k, register width, static k, block width, min_dist, const, stream)
    "runia_marginal_entropy": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    # (weights, fmap, out, B, S, HW, C, k, register width, sample-minor weights,
    #  static k, block width, bf16 map, min_dist, const, stream)
    "runia_fused_mc_entropy": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    # (x, wq, scale, out, scratch, counters, rows, K, N, block rows, splits,
    #  K per split, dtype, stream)
    "runia_quant_matmul": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # (q, k, v, out, q_start, kv_start, k_scale, v_scale, dims[21] int64 on
    #  the host, sm_scale, dtype, kv8, stream)
    "runia_flash_prefix_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _P),
    # (sorted boxes, mask scratch, keep, n, iou threshold, scan threads, stream)
    "runia_nms": (_P, _P, _P, _I, _F, _I, _P),
    # (fmap, boxes, out, K, rois per image, H, W, C, out_h, out_w, spatial scale,
    #  aligned, sampling ratio, max samples, bf16 map, mean, threads, shared bytes, stream)
    "runia_roi_align": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for candidate in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if candidate and os.access(candidate, os.X_OK):
            return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "toolkit is needed to build runia_core_tpu_torch's kernels"
    )


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (if not yet built) and
    return its path. The compiler's output, ptxas register and shared-memory
    counts included, is kept beside it as ``<name>.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib_path = BUILD_DIR / f"librunia_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib_path.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    # One compiler process per source, all started together.
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objects)
    ]
    outputs = [proc.communicate()[0] for proc in procs]
    log = "".join(f"== {src.name}\n{out}" for src, out in zip(sources, outputs))
    failed = [src.name for src, proc in zip(sources, procs) if proc.returncode != 0]
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(tmp), *map(str, objects)],
            capture_output=True, text=True,
        )
        log += f"== link\n{link.stdout}{link.stderr}"
        if link.returncode != 0:
            failed.append("link")
    for obj in objects:
        obj.unlink(missing_ok=True)
    lib_path.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log[-4000:]}")
    os.replace(tmp, lib_path)  # atomic: a concurrent builder never loads half a file
    return lib_path


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use. Raises when there is no
    CUDA device or it is not a Hopper (sm_90) card; never returns a stand-in."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: runia_core_tpu_torch's kernels need an NVIDIA "
            "Hopper GPU; CPU tensors take the plain PyTorch versions instead"
        )
    capability = torch.cuda.get_device_capability()
    if capability != (9, 0):
        raise RuntimeError(
            f"the kernels are compiled for sm_90a; this device is sm_{capability[0]}{capability[1]}"
        )
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.runia_cuda_error_string.argtypes = [ctypes.c_int]
    lib.runia_cuda_error_string.restype = ctypes.c_char_p
    return lib


HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def _host_extension(module: str, source: str, what: str):
    """The CPython extension ``module`` built from ``csrc/<source>`` (and
    ``parallel_util.h``) with the host's C++ compiler (``$CXX``, else
    ``g++``) against this Python's headers into ``build/torch_kernels/``,
    imported. The file's name carries a hash of the sources, flags and
    Python; a failed build raises."""
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode() + sys.version.encode())
    for name in (source, "parallel_util.h"):
        digest.update((CSRC / name).read_bytes())
    path = BUILD_DIR / f"{module.lstrip('_')}_{digest.hexdigest()[:16]}{sysconfig.get_config_var('EXT_SUFFIX')}"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
        if compiler is None:
            raise RuntimeError(f"no C++ compiler (looked at $CXX, g++ and c++) to build {what}")
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        done = subprocess.run(
            [compiler, *HOST_FLAGS, f"-I{sysconfig.get_paths()['include']}", f"-I{CSRC}",
             str(CSRC / source), "-o", str(tmp)],
            capture_output=True, text=True,
        )
        if done.returncode != 0:
            raise RuntimeError(f"building {what} failed:\n{done.stdout}{done.stderr}"[-4000:])
        os.replace(tmp, path)
    spec = importlib.util.spec_from_file_location(module, path)
    extension = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(extension)
    return extension


@functools.cache
def osod_matcher():
    """The native open-set matcher (``greedy_match``, ``max_overlap_flags``):
    ``csrc/osod_eval.cpp``, built at first use (:func:`_host_extension`)."""
    return _host_extension("_runia_osod", "osod_eval.cpp", "the open-set matcher")


@functools.cache
def dataloader():
    """The native batch assembly (``gather_normalize``,
    ``gather_resize_normalize``, ``normalize_u8``): ``csrc/dataloader.cpp``,
    built at first use (:func:`_host_extension`)."""
    return _host_extension("_runia_dataloader", "dataloader.cpp", "the native data loader")


def device_guard(device: torch.device):
    """A context that makes ``device`` the current CUDA device for a launch.
    It costs nothing when it already is, as in every single-GPU process: a
    decode step launches some ninety kernels through these wrappers."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(code: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch)."""
    if code != 0:
        message = library().runia_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {message} (cudaError {code})")
