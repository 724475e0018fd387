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
import re
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("mont_mul", "inv_bea", "fp_addsub", "ec_add", "ec_affine",
           "inv_tree", "pow_const", "poseidon", "rns_mont", "ec_rns")
# headers: an edit of one rebuilds every library
HEADERS = ("fp_limbs.cuh", "fp_group.cuh", "fp_inv.cuh", "rns_core.cuh",
           "pow_window.h")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_vp, _i, _u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_ll = ctypes.c_longlong
_SIGNATURES = {
    # name: (library, argtypes)
    "gl_mont_mul": ("mont_mul", [_i, _vp, _i, _ll, _vp, _i, _ll, _vp, _i, _vp,
                                 _u32, _vp]),
    "gl_inv_bea": ("inv_bea", [_i, _vp, _vp, _i, _vp, _u32, _vp]),
    "gl_fp_addsub": ("fp_addsub", [_i, _i, _vp, _i, _ll, _vp, _i, _ll, _vp, _i,
                                   _vp, _vp]),
    # pointer and stride tables are host arrays (ctypes arrays)
    "gl_ec_proj_add": ("ec_add", [_i, _vp, _vp, _vp, _i, _vp, _u32, _i, _vp]),
    "gl_ec_affine_pre": ("ec_affine", [_i, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                                       _i, _vp, _u32, _vp]),
    "gl_ec_affine_post": ("ec_affine", [_i, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                                        _vp, _i, _vp, _u32, _vp]),
    "gl_inv_tree_up": ("inv_tree", [_i, _vp, _vp, _vp, _i, _i, _vp, _u32,
                                    _vp]),
    "gl_inv_tree_tail": ("inv_tree", [_i, _vp, _vp, _i, _i, _vp, _u32, _vp]),
    "gl_inv_tree_down": ("inv_tree", [_i, _vp, _vp, _vp, _i, _i, _vp, _u32,
                                      _vp]),
    # the exponent is a host array of bytes, one a bit
    "gl_pow_const": ("pow_const", [_i, _vp, _vp, _i, _vp, _i, _vp, _u32,
                                   _vp]),
    # the window the pow launcher picks for an exponent (bytes, count, and
    # a host int for the multiplies)
    "gl_pow_const_window": ("pow_const", [_vp, _i, _vp]),
    # the constants are a device buffer
    "gl_poseidon_permute": ("poseidon", [_i, _vp, _vp, _i, _vp, _i, _i, _i,
                                         _u32, _vp]),
    # the sponges a block the Poseidon launcher takes for a batch
    "gl_poseidon_block_sponges": ("poseidon", [_i]),
    # the constant blocks are device buffers
    "gl_rns_mont": ("rns_mont", [_i, _vp, _ll, _i, _vp, _ll, _i, _vp, _i, _vp,
                                 _vp]),
    "gl_ecr_pre": ("ec_rns", [_i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                              _vp, _vp, _vp, _i, _vp, _vp, _vp]),
    "gl_ecr_post": ("ec_rns", [_i, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                               _vp, _vp, _vp, _vp, _i, _vp, _vp, _vp]),
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


def _stale(lib: str, name: str, csrc: str, out: str) -> bool:
    if not (os.path.exists(lib)
            and os.path.exists(os.path.join(out, name + ".log"))):
        return True
    t = os.path.getmtime(lib)
    deps = [os.path.join(csrc, f) for f in (name + ".cu",) + HEADERS]
    return any(os.path.getmtime(d) > t for d in deps if os.path.exists(d))


def build(csrc: str | None = None, out: str | None = None,
          names=SOURCES) -> dict:
    """Compile every stale source of ``names`` in ``csrc`` into ``out``
    (by default all of the package's own, into its build directory), all
    ``nvcc`` processes started together.  Returns {name: path of the shared
    library}.  What the compiler printed -- registers, stack frame and
    spills of each kernel, from ``ptxas -v`` -- is kept beside the library
    as ``<out>/<name>.log``."""
    csrc, out = csrc or CSRC, out or BUILD
    os.makedirs(out, exist_ok=True)
    libs = {n: os.path.join(out, f"lib{n}.so") for n in names}
    procs = []
    for n in names:
        if not _stale(libs[n], n, csrc, out):
            continue
        tmp = libs[n] + f".tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", csrc, "-o", tmp,
               os.path.join(csrc, n + ".cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, tmp, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{text}")
            continue
        with open(os.path.join(out, n + ".log"), "w") as f:
            f.write(text)
        os.replace(tmp, libs[n])  # atomic: no reader sees a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def resource_usage() -> dict:
    """{kernel<template arguments> (or kernel): {registers, stack_bytes,
    spill_store_bytes, spill_load_bytes}} for every kernel, read from the
    logs of ``build``; beside them the non-inlined inverse, ``{library}:
    inv_divsteps<L>``, with its own stack frame and spills (its registers
    count in each kernel that calls it)."""
    out = {}
    entry = re.compile(
        r"Compiling entry function '\w*?\d([a-z_]+_kernel)"
        r"(?:ILi(\d+(?:ELi\d+)*)E)?\w*'.*?"
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
        r"(\d+) bytes spill loads.*?Used (\d+) registers", re.S)
    callee = re.compile(
        r"Function properties for \w*inv_divstepsILi(\d+)E\w*\s+"
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
        r"(\d+) bytes spill loads")
    for n in build():
        with open(os.path.join(BUILD, n + ".log")) as f:
            text = f.read()
        for m in entry.finditer(text):
            args = ",".join(m.group(2).split("ELi")) if m.group(2) else ""
            out[f"{m.group(1)}<{args}>" if args else m.group(1)] = {
                "registers": int(m.group(6)), "stack_bytes": int(m.group(3)),
                "spill_store_bytes": int(m.group(4)),
                "spill_load_bytes": int(m.group(5))}
        for m in callee.finditer(text):
            out[f"{n}: inv_divsteps<{m.group(1)}>"] = {
                "stack_bytes": int(m.group(2)),
                "spill_store_bytes": int(m.group(3)),
                "spill_load_bytes": int(m.group(4))}
    return out


def function(name: str):
    """The C entry point ``name`` with its argument types set, building and
    loading its library at first use."""
    fn = _functions.get(name)
    if fn is None:
        lib = build()[_SIGNATURES[name][0]]
        fn = _functions[name] = load(lib, (name,))[name]
    return fn


def load(path: str, names) -> dict:
    """{name: the C entry point ``name`` of the shared library at ``path``,
    with its argument types set} -- the library's own build or another
    build of the same sources (``build`` with another ``csrc``)."""
    lib = ctypes.CDLL(path)
    fns = {}
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns
