"""Builds the port's CUDA sources (``beyondff_tpu_torch/csrc``) at first use.

Each ``.cu`` file compiles with its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects link into one shared library with a
plain C interface, loaded through ``ctypes``. The library's name carries a
hash of every file under ``csrc`` (sources and the headers they share,
which compile with ``-I csrc``), so an edited source or header never loads
a stale build. The build directory, ``beyondff_tpu_torch/_build``, is
listed in ``.gitignore``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
_EXTENSIONS = (".cu", ".cuh", ".h")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _files() -> list:
    """The names of the sources and headers under ``CSRC``, sorted."""
    return sorted(n for n in os.listdir(CSRC) if n.endswith(_EXTENSIONS))


def _digest() -> str:
    h = hashlib.sha256()
    for name in _files():
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile (if needed) and return the path of the shared library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = _digest()
    lib = os.path.join(BUILD_DIR, f"libbff_kernels_{tag}.so")
    if os.path.exists(lib):
        return lib
    nvcc = _nvcc()
    procs = []
    for name in (n for n in _files() if n.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, f"{name[:-3]}_{tag}_{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", os.path.join(CSRC, name), "-o", obj]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, _obj, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    tmp = lib + f".tmp{os.getpid()}"
    link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                           "-o", tmp, *[obj for _n, obj, _p in procs]],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed\n{link.stdout}")
    os.replace(tmp, lib)
    for _name, obj, _proc in procs:
        os.remove(obj)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call, with its C signatures."""
    lib = ctypes.CDLL(build())
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bff_flash_attention.argtypes = [i, p, p, p, p, i, i, i, i, f, p, p]
    lib.bff_flash_attention.restype = i
    lib.bff_flash_tf32_takes.argtypes = [i, i, i, i, f, p, p, p, p]
    lib.bff_flash_tf32_takes.restype = i
    lib.bff_flash_tf32_scratch_floats.argtypes = [i, i, i]
    lib.bff_flash_tf32_scratch_floats.restype = ctypes.c_longlong
    lib.bff_flash_wgmma_takes.argtypes = [i, i, i, i, f, p, p, p, p]
    lib.bff_flash_wgmma_takes.restype = i
    lib.bff_flash_masked_wgmma_takes.argtypes = [i, i, i, i, f, p, p, p, p]
    lib.bff_flash_masked_wgmma_takes.restype = i
    lib.bff_flash_wide_wgmma_takes.argtypes = [i, i, i, i, f, p, p, p, p]
    lib.bff_flash_wide_wgmma_takes.restype = i
    lib.bff_flash_wide_tf32_takes.argtypes = [i, i, i, i, f, p, p, p, p]
    lib.bff_flash_wide_tf32_takes.restype = i
    lib.bff_flash_wide_tf32_scratch_floats.argtypes = [i, i, i]
    lib.bff_flash_wide_tf32_scratch_floats.restype = ctypes.c_longlong
    lib.bff_relpos_wgmma_takes.argtypes = [i, i, i, i, i, i, f, p, p, p, p, p, p]
    lib.bff_relpos_wgmma_takes.restype = i
    lib.bff_relpos_tf32_takes.argtypes = [i, i, i, i, i, i, f, p, p, p, p, p, p]
    lib.bff_relpos_tf32_takes.restype = i
    lib.bff_relpos_tf32_streamed_takes.argtypes = [i, i, i, i, i, i, f, p, p, p, p, p, p]
    lib.bff_relpos_tf32_streamed_takes.restype = i
    lib.bff_relpos_streamed_takes.argtypes = [i, i, i, i, i, i, f, p, p, p, p, p, p]
    lib.bff_relpos_streamed_takes.restype = i
    lib.bff_relpos_wide_wgmma_takes.argtypes = [i, i, i, i, i, i, f, p, p, p, p, p, p]
    lib.bff_relpos_wide_wgmma_takes.restype = i
    lib.bff_relpos_wide_tf32_takes.argtypes = [i, i, i, i, i, i, f, p, p, p, p, p, p]
    lib.bff_relpos_wide_tf32_takes.restype = i
    lib.bff_relpos_tf32_scratch_floats.argtypes = [i, i, i]
    lib.bff_relpos_tf32_scratch_floats.restype = ctypes.c_longlong
    lib.bff_ms_deform_sample.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i,
                                         ctypes.POINTER(ctypes.c_int), p, p]
    lib.bff_ms_deform_sample.restype = i
    ll = ctypes.c_longlong
    lib.bff_mask_iou.argtypes = [p, p, i, i, ll, ll, ll, p, p, p]
    lib.bff_mask_iou.restype = i
    lib.bff_mask_iou_wgmma_takes.argtypes = [i, i, ll, ll, ll, p, p]
    lib.bff_mask_iou_wgmma_takes.restype = i
    lib.bff_nms_fixed.argtypes = [p, p, i, i, i, f, p, p, p]
    lib.bff_nms_fixed.restype = i
    lib.bff_nms_fixed_large.argtypes = [p, p, i, i, i, f, p, p, p, p]
    lib.bff_nms_fixed_large.restype = i
    lib.bff_nms_large_scratch_words.argtypes = [i, i]
    lib.bff_nms_large_scratch_words.restype = ll
    lib.bff_flash_attention_relpos.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, f, p, p]
    lib.bff_flash_attention_relpos.restype = i
    lib.bff_window_attention_relpos.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, f, p, p]
    lib.bff_window_attention_relpos.restype = i
    # the FMA kernels whatever the routes say: measurement yardsticks only
    lib.bff_flash_attention_f32_fma.argtypes = [p, p, p, p, i, i, i, i, f, p]
    lib.bff_flash_attention_f32_fma.restype = i
    lib.bff_flash_attention_relpos_f32_fma.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, p]
    lib.bff_flash_attention_relpos_f32_fma.restype = i
    return lib
