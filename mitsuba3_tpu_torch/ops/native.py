"""Build and load the native code of ``mitsuba3_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is a hand-written CUDA kernel with a plain
``extern "C"`` interface, compiled with ``nvcc`` with ``csrc/`` on the
include path (for the ``.cuh`` headers kernels share); each
``csrc/<name>.cpp`` is host code (the SAH builder), compiled with ``g++``.
Both go into ``build/kernels/lib<name>-<digest>.so`` at the repository
root on first use and are loaded with ``ctypes``; the digest covers the
source, the flags and, for CUDA, every ``csrc/*.cuh``, for host code what
``-march=native`` means on this machine, so an edited source or header or
another CPU gets its own build. Nothing is built when the package is
imported, and a failed build raises. ``check`` and ``launch`` are what
every kernel wrapper does around its launch.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = tuple(sorted(p.name for p in CSRC.iterdir()
                       if p.suffix in (".cu", ".cpp")))

# -fmad=false: no contraction of a*b+c into FMA, so every kernel does its
# plain PyTorch version's arithmetic operation by operation. IEEE division
# and square root stay on (nvcc's defaults; never --use_fast_math).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "--ptxas-options=-v")
# The JAX package's flags for its SAH builder
# (mitsuba3_tpu/native/__init__.py), so the leaves are bit-equal to its own.
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the SAH builder needs a host C++ "
                           "compiler on PATH")
    return found


@functools.lru_cache(maxsize=None)
def _native_target() -> bytes:
    """g++'s version and its expansion of -march=native on this machine."""
    return b"".join(
        subprocess.run([_gxx(), *args], capture_output=True,
                       check=True).stdout
        for args in (("--version",), ("-march=native", "-Q",
                                      "--help=target")))


def _source(name: str) -> Path:
    """`name` is a file of csrc/ ("bvh_build.cpp") or a CUDA stem."""
    return CSRC / (name if "." in name else f"{name}.cu")


def _command(src: Path, out: Path) -> list[str]:
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
                str(src)]
    return [_gxx(), *GXX_FLAGS, str(src), "-o", str(out)]


def library_path(name: str) -> Path:
    src = _source(name)
    if src.suffix == ".cu":
        tag = " ".join(NVCC_FLAGS).encode() + b"".join(
            h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    else:
        tag = " ".join(GXX_FLAGS).encode() + _native_target()
    digest = hashlib.sha256(src.read_bytes() + tag).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


def build(names) -> dict[str, str]:
    """Compile every source in `names` that has no current build, all
    compiler processes running at once. Returns each name's compiler log
    (for CUDA, ptxas's register and shared-memory report); raises on a
    failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(_source(name), tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build failed for csrc/{_source(name).name}:"
                               f"\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (or csrc/<name> with its
    suffix), built at first use."""
    with _lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU: a wrapper then runs its
    kernel's plain version."""
    return all(x.device.type == "cpu" for x in tensors)


def check(fn: str, name: str, x, dtype, shape, dev):
    """Raise unless `x` is a contiguous `dtype` tensor of `shape` on
    `dev`."""
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {dev}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device} (contiguous={x.is_contiguous()})")


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong}


def launch(name: str, signature: str, *args, dev):
    """Call the launcher `name` of csrc/<name>.cu (built and loaded at
    first use) with `args` and the current stream of `dev`; `signature`
    spells its arguments before the stream ("p" pointer, "i" int,
    "q" long long). Raises if the launch failed."""
    fn = getattr(load(name), name)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[c] for c in signature] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
