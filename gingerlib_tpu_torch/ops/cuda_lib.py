"""Builds and loads the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``; this
takes seconds, where a build against PyTorch's headers takes minutes.  The
build happens at first use, into ``gingerlib_tpu_torch/build/`` (not under
version control); all sources are compiled side by side.  A failed build
or a missing compiler is an exception: nothing falls back to the plain
PyTorch versions.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("mont_mul", "inv_bea", "fp_addsub")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_vp, _i, _u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_ll = ctypes.c_longlong
_SIGNATURES = {
    # name: (library, argtypes)
    "gl_mont_mul": ("mont_mul", [_i, _vp, _i, _ll, _vp, _i, _ll, _vp, _i, _vp,
                                 _u32, _vp]),
    "gl_inv_bea": ("inv_bea", [_i, _vp, _vp, _i, _vp, _vp]),
    "gl_fp_addsub": ("fp_addsub", [_i, _i, _vp, _i, _ll, _vp, _i, _ll, _vp, _i,
                                   _vp, _vp]),
}

_functions: dict = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            exe = cand
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def _stale(lib: str, name: str) -> bool:
    if not os.path.exists(lib):
        return True
    t = os.path.getmtime(lib)
    deps = [os.path.join(CSRC, name + ".cu"),
            os.path.join(CSRC, "fp_limbs.cuh")]
    return any(os.path.getmtime(d) > t for d in deps)


def build(verbose: bool = False) -> dict:
    """Compile every stale source, all ``nvcc`` processes started together.
    Returns {name: path of the shared library}.  With ``verbose`` the
    compiler also reports registers and spills of each kernel."""
    os.makedirs(BUILD, exist_ok=True)
    libs = {n: os.path.join(BUILD, f"lib{n}.so") for n in SOURCES}
    procs = []
    for n in SOURCES:
        if not _stale(libs[n], n):
            continue
        tmp = libs[n] + f".tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, os.path.join(CSRC, n + ".cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
            continue
        if verbose and out:
            print(out, flush=True)
        os.replace(tmp, libs[n])  # atomic: no reader sees a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def function(name: str):
    """The C entry point ``name`` with its argument types set, building and
    loading its library at first use."""
    fn = _functions.get(name)
    if fn is None:
        lib_name, argtypes = _SIGNATURES[name]
        lib = ctypes.CDLL(build()[lib_name])
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn
