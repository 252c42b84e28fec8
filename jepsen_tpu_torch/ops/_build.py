"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/*.cu` file compiles on first use into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build dir>/<name>-<digest>.so csrc/<name>.cu

The library lands in `jepsen_tpu_torch/ops/_build/`, keyed by a digest
of the source, the flags and the device's compute capability, so an
edited source or another card builds anew and an unchanged one is
reused. A library once loaded is handed back by later calls without
its source being read again, so the lookup a wrapper makes at every
launch is a dict access; a source edited while a process runs is built
anew by the next process. A failed build raises with nvcc's stderr:
nothing falls back.
Different sources build at the same time when called from different
threads (one lock per library).

Host sources (`csrc/*.cpp`, the native search engine) take the g++
route through `load_host`, into the same cache keyed the same way:

    g++ -O2 -shared -fPIC -o <build dir>/<name>-<digest>.so csrc/<name>.cpp
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")

#: name -> seconds the last build of that library took (0.0 when an
#: existing library was reused)
BUILD_SECONDS: dict = {}
#: name -> nvcc's output of the last build (-Xptxas -v: registers,
#: spills, shared memory per kernel)
BUILD_LOG: dict = {}

_lock = threading.Lock()   # guards _locks
_locks: dict = {}          # so path -> the lock its build holds
_libs: dict = {}
_loaded: dict = {}         # (source, flags, capability) -> its library


class BuildError(RuntimeError):
    """nvcc failed (or is missing); the message carries its stderr."""


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def arch_flags(capability: tuple) -> list:
    """-gencode for the device: sm_90a on Hopper (the `a` unlocks wgmma
    and setmaxnreg), the plain target elsewhere."""
    major, minor = capability
    arch = f"{major}{minor}" + ("a" if major == 9 else "")
    return ["-gencode", f"arch=compute_{arch},code=sm_{arch}"]


def flags(capability: tuple) -> list:
    return arch_flags(capability) + [
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v"]


#: g++ flags of a host library
HOST_FLAGS = ["-O2", "-shared", "-fPIC"]


def load(name: str, capability: tuple, signatures: dict) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu for `capability`, building
    it if needed. `signatures` maps each C entry point to (argtypes,
    restype)."""
    return _load(name, f"{name}.cu", nvcc_path, flags(capability),
                 capability, signatures)


def load_host(name: str, signatures: dict) -> ctypes.CDLL:
    """The host library built from csrc/<name>.cpp with g++, building it
    if needed; raises BuildError when g++ is missing or fails."""
    return _load(name, f"{name}.cpp", gxx_path, HOST_FLAGS, None,
                 signatures)


def gxx_path() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise BuildError("g++ not found (the native engine needs it)")
    return gxx


def _load(name, source, compiler_path, fl, capability, signatures):
    """The library of csrc/<source>, loaded once a process; the compiler
    (`compiler_path()`) is looked for only when the library is built."""
    key = (source, tuple(fl), capability)
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    src_path = os.path.join(CSRC, source)
    with open(src_path, "rb") as fh:
        src = fh.read()
    digest = hashlib.sha256(
        src + repr((fl, capability)).encode()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    with _lock:
        lock = _locks.setdefault(so_path, threading.Lock())
    with lock:
        lib = _libs.get(so_path)
        if lib is not None:
            _loaded[key] = lib
            return lib
        if os.path.isfile(so_path):
            BUILD_SECONDS[name] = 0.0
        else:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so_path}.{os.getpid()}.tmp"
            compiler = compiler_path()
            cmd = [compiler] + fl + ["-o", tmp, src_path]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            BUILD_SECONDS[name] = time.perf_counter() - t0
            BUILD_LOG[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise BuildError(
                    f"{os.path.basename(compiler)} failed "
                    f"({proc.returncode}) building {name}:\n" + proc.stderr)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        for fn_name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _libs[so_path] = _loaded[key] = lib
        return lib
