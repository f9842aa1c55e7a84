"""ctypes binding of the C++ host runtime (``native/bff_native.cpp``).

The port's own binding of the JAX package's source file, with the same
entry points: the RLE batch decoder and encoder, the 16-bit PNG depth
decoder (single and batched, threaded), the baseline-JPEG entropy decoder
behind the JXT transport (``core/jxt.py``), the JXT wire scan and the
depth-pack scan (``core/depth_pack.py``).

The library builds at first use with ``g++ -O3 -march=native`` into
``beyondff_tpu_torch/_build/`` (listed in ``.gitignore``). Its file name
carries a hash of the source and of the host (name, machine and the CPU
that ``-march=native`` resolves to), since code built for one CPU can fault
on another. Each build writes a temporary file of its own and renames it
into place, so processes that build at once never load a half-written
library. A failed build raises with the compiler's output: nothing falls
back silently. ``BFF_NO_NATIVE=1`` (any non-empty value, read at each call)
is the one way to choose the numpy/OpenCV paths; every entry point then
returns ``None``, as it does for an input the runtime does not take (a
malformed file, a progressive JPEG, RLEs of mixed lengths).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "bff_native.cpp")
BUILD_DIR = os.path.join(_REPO, "beyondff_tpu_torch", "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
LIBS = ("-lz", "-lpthread")
_LOCK = threading.Lock()


def _host_tag(cxx: str) -> str:
    """What ``-march=native`` compiles for on this host, with its name."""
    out = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True)
    march = [ln.split()[-1] for ln in out.stdout.splitlines()
             if ln.strip().startswith("-march=")]
    return "|".join([platform.node(), platform.machine(), *march])


def library_path(cxx: str = CXX) -> str:
    """Where this host's build of the current source lives."""
    with open(SOURCE, "rb") as f:
        src = hashlib.sha256(f.read()).hexdigest()[:16]
    host = hashlib.sha256(_host_tag(cxx).encode()).hexdigest()[:8]
    return os.path.join(BUILD_DIR, f"libbff_native_{src}_{host}.so")


def build() -> str:
    """Compile the runtime if this host has no build of this source; return
    the library's path. Raises ``RuntimeError`` with the compiler's output
    when the build fails."""
    cxx = CXX
    lib = library_path(cxx)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp{os.getpid()}.{threading.get_ident()}"
    try:
        out = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LIBS],
                             capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"building {SOURCE} failed: {e}") from e
    if out.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building {SOURCE} failed ({cxx}, exit {out.returncode}):\n"
                           f"{out.stderr}{out.stdout}")
    os.replace(tmp, lib)
    return lib


def _p(ctype):
    return ctypes.POINTER(ctype)


_i32, _i64, _f32 = ctypes.c_int, ctypes.c_int64, ctypes.c_float
_u8, _i8, _i16, _u16 = ctypes.c_uint8, ctypes.c_int8, ctypes.c_int16, ctypes.c_uint16
# (restype, argtypes) of each entry point, as native/bff_native.cpp declares them
_SIGNATURES = {
    "bff_rle_decode_batch": (_i32, [_p(_i64), _p(_i64), _i32, _i64, _p(_u8)]),
    "bff_rle_encode": (_i64, [_p(_u8), _i64, _p(_i64)]),
    "bff_decode_depth": (_i32, [_p(_u8), _i64, _f32, _i32, _i32, _p(_f32)]),
    "bff_decode_depth_batch": (_i32, [_p(_u8), _p(_i64), _i32, _f32, _i32, _i32, _p(_f32),
                                      _i32]),
    "bff_jpeg_info": (_i32, [_p(_u8), _i64, _p(ctypes.c_int32), _p(ctypes.c_int32)]),
    "bff_jpeg_coeffs": (_i32, [_p(_u8), _i64] + [_p(_i16)] * 4),
    "bff_jxt_scan": (_i64, [_p(_i16), _i64, _p(_u8), _p(_i8), _p(_i16), _p(_i64), _p(_i64)]),
    "bff_depth_pack": (_i32, [_p(_u16), _i64, _p(_u8), _p(_i8), _p(_u16), _p(_u8), _p(_i64),
                              _p(ctypes.c_int32), _p(ctypes.c_int32), _p(_i64)]),
}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    with _LOCK:
        lib = ctypes.CDLL(build())
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded runtime, built on first call; ``None`` under
    ``BFF_NO_NATIVE``."""
    if os.environ.get("BFF_NO_NATIVE"):
        return None
    return _library()


def available() -> bool:
    return load_library() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ------------------------------------------------------------------ RLE
def rle_decode_batch_native(rles: Sequence[dict]) -> Optional[np.ndarray]:
    """Dense (M, L) uint8 from RLE dicts; ``None`` without the runtime or
    when the masks have mixed lengths."""
    lib = load_library()
    if lib is None or not rles:
        return None
    length = int(rles[0]["length"])
    if any(int(r["length"]) != length for r in rles):
        return None
    counts = np.concatenate([np.asarray(r["counts"], np.int64) for r in rles])
    offsets = np.zeros(len(rles) + 1, np.int64)
    np.cumsum([len(np.asarray(r["counts"])) for r in rles], out=offsets[1:])
    out = np.empty((len(rles), length), np.uint8)
    rc = lib.bff_rle_decode_batch(_ptr(counts, ctypes.c_int64), _ptr(offsets, ctypes.c_int64),
                                  len(rles), length, _ptr(out, ctypes.c_uint8))
    return out if rc == 0 else None


def rle_encode_native(mask: np.ndarray) -> Optional[dict]:
    lib = load_library()
    if lib is None:
        return None
    mask = np.ascontiguousarray(np.asarray(mask, np.uint8).ravel())
    out = np.empty(mask.size + 2, np.int64)
    n = lib.bff_rle_encode(_ptr(mask, ctypes.c_uint8), mask.size,
                           _ptr(out, ctypes.c_int64))
    return {"length": int(mask.size), "counts": out[:n].copy()}


# ------------------------------------------------------------------ depth
def decode_depth_native(path: str, depth_scale: float, out_hw: tuple) -> Optional[np.ndarray]:
    """A 16-bit PNG depth map as metric float32 at ``out_hw`` (the runtime's
    bilinear, OpenCV's half-pixel convention)."""
    lib = load_library()
    if lib is None:
        return None
    with open(path, "rb") as f:
        blob = np.frombuffer(f.read(), np.uint8)
    out = np.empty(out_hw, np.float32)
    rc = lib.bff_decode_depth(_ptr(blob, ctypes.c_uint8), blob.size,
                              depth_scale, out_hw[0], out_hw[1],
                              _ptr(out, ctypes.c_float))
    return out if rc == 0 else None


def decode_depth_batch_native(paths: List[str], depth_scale: float, out_hw: tuple,
                              n_threads: Optional[int] = None) -> Optional[np.ndarray]:
    """:func:`decode_depth_native` over many files, on ``n_threads`` threads."""
    lib = load_library()
    if lib is None:
        return None
    blobs, offsets = [], [0]
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
        offsets.append(offsets[-1] + len(blobs[-1]))
    blob = np.frombuffer(b"".join(blobs), np.uint8)
    offs = np.asarray(offsets, np.int64)
    out = np.empty((len(paths), *out_hw), np.float32)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    rc = lib.bff_decode_depth_batch(_ptr(blob, ctypes.c_uint8), _ptr(offs, ctypes.c_int64),
                                    len(paths), depth_scale, out_hw[0],
                                    out_hw[1], _ptr(out, ctypes.c_float), n_threads)
    return out if rc == 0 else None


# ------------------------------------------------------------------ JPEG
def jpeg_coeffs_native(blob: bytes) -> Optional[dict]:
    """Entropy-decode a baseline JPEG to its quantized DCT coefficients (no
    IDCT and no color conversion: the device finishes, ``core/jxt.py``).

    ``None`` without the runtime or for a file it does not take
    (progressive, malformed, more than 4 components). Otherwise
    ``{"hw": (height, width), "comps": [{"coeffs": int16 (bh, bw, 64)
    natural-order blocks, "samp": (Hi, Vi), "grid": (bh, bw), "qtab": int32
    (64,)}, ...]}``."""
    lib = load_library()
    if lib is None:
        return None
    buf = np.frombuffer(blob, np.uint8)
    info = np.zeros(32, np.int32)
    qtabs = np.zeros(4 * 64, np.int32)
    rc = lib.bff_jpeg_info(_ptr(buf, ctypes.c_uint8), buf.size,
                           _ptr(info, ctypes.c_int32), _ptr(qtabs, ctypes.c_int32))
    if rc != 0:
        return None
    w, h, ncomp = int(info[0]), int(info[1]), int(info[2])
    if ncomp < 1 or ncomp > 4:
        return None
    outs, ptrs = [], []
    for i in range(4):
        if i < ncomp:
            arr = np.zeros((int(info[8 + 5 * i]), int(info[7 + 5 * i]), 64), np.int16)
            outs.append(arr)  # the decoder writes the nonzero coefficients only
            ptrs.append(_ptr(arr, ctypes.c_int16))
        else:
            ptrs.append(ctypes.POINTER(ctypes.c_int16)())
    rc = lib.bff_jpeg_coeffs(_ptr(buf, ctypes.c_uint8), buf.size, *ptrs)
    if rc != 0:
        return None
    comps = [{"coeffs": outs[i],
              "samp": (int(info[4 + 5 * i]), int(info[5 + 5 * i])),
              "grid": outs[i].shape[:2],
              "qtab": qtabs[int(info[6 + 5 * i]) * 64:][:64].copy()} for i in range(ncomp)]
    return {"hw": (h, w), "comps": comps}


def jxt_scan_native(flat: np.ndarray):
    """One pass over the concatenated dense coefficients building the JXT
    streams (``core/jxt.pack`` semantics). Returns (total entries, nonzero
    count, delta, val, esc): delta and val sized to the worst case, esc
    trimmed; ``None`` without the runtime."""
    lib = load_library()
    if lib is None:
        return None
    flat = np.ascontiguousarray(flat, np.int16)
    cap = flat.size + flat.size // 255 + 8
    delta = np.empty(cap, np.uint8)
    val = np.empty(cap, np.int8)
    esc = np.empty(max(flat.size, 1), np.int16)
    nz, ne = ctypes.c_int64(), ctypes.c_int64()
    total = lib.bff_jxt_scan(_ptr(flat, ctypes.c_int16), flat.size,
                             _ptr(delta, ctypes.c_uint8), _ptr(val, ctypes.c_int8),
                             _ptr(esc, ctypes.c_int16), ctypes.byref(nz), ctypes.byref(ne))
    return int(total), int(nz.value), delta, val, esc[:int(ne.value)]


def depth_pack_native(flat: np.ndarray):
    """One pass of the depth-pack scan (``core/depth_pack`` wire semantics)
    over a flattened uint16 depth map whose length is a multiple of 64.
    Returns (classes u8, preds i8, bases u16, stream u8, esc_pos i32,
    esc_corr i32), stream and escapes trimmed; ``None`` without the
    runtime."""
    lib = load_library()
    if lib is None:
        return None
    flat = np.ascontiguousarray(flat, np.uint16)
    nb = flat.size // 64
    classes = np.empty(nb, np.uint8)
    preds = np.empty(nb, np.int8)
    bases = np.empty(nb, np.uint16)
    stream = np.empty(2 * flat.size, np.uint8)
    esc_pos = np.empty(max(flat.size, 1), np.int32)
    esc_corr = np.empty(max(flat.size, 1), np.int32)
    slen, nesc = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.bff_depth_pack(_ptr(flat, ctypes.c_uint16), flat.size,
                            _ptr(classes, ctypes.c_uint8), _ptr(preds, ctypes.c_int8),
                            _ptr(bases, ctypes.c_uint16), _ptr(stream, ctypes.c_uint8),
                            ctypes.byref(slen), _ptr(esc_pos, ctypes.c_int32),
                            _ptr(esc_corr, ctypes.c_int32), ctypes.byref(nesc))
    if rc != 0:
        return None
    n, e = int(slen.value), int(nesc.value)
    return classes, preds, bases, stream[:n].copy(), esc_pos[:e].copy(), esc_corr[:e].copy()
