"""Times variants of the port's CUDA kernels against the shipped sources on
one card, in one process, in alternating order.

    python -m beyondff_tpu_torch.tools.kernel_variants [--parent-csrc DIR] [--variants a,b]
        [--cases k1,k6] [--out DIR]

A variant is the ``csrc`` tree with textual edits (each edit must match its
file exactly once), built from the sources it names; ``--parent-csrc`` adds
the variant ``parent``, built from another ``csrc`` tree (an earlier
commit's, unpacked with ``git archive``). Every source of every variant
compiles at once, one nvcc each (the port's flags plus ``-Xptxas -v``), into
a library under ``beyondff_tpu_torch/_build/variants``; each ptxas report is
written beside it. At every case a variant's output is held against the
plain version (mask IoU bit for bit with nan at the same places, bf16
attention within ``flash_attention.bf16_error_bound``, deformable sampling
(K1) within 1e-4 in f32 and 3e-2 in bf16) and its launches are timed with
CUDA events over a loop of calls, once in each of three rounds, the order of
the variants reversed every other round (the best round is reported); K1's
cases also take the device time per call from ``torch.profiler``
(``profiling.device_ms``), the rate of unique bytes it gives, the rate of
the corner rows it loads (``corner_gbps``: value rows of in-map corners,
each load counted) and the byte bound. K1's ``tile_order`` variant walks
the encoder raster's queries in the order :func:`tile_order` gives.
Prints one JSON line per (case, variant) with the card's name and power
limit; the lines also go to
``kernel_variants.json`` in ``--out`` (the build directory by default),
beside each variant's ptxas report.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess

import numpy as np
import torch

from beyondff_tpu_torch.kernels import _build
from beyondff_tpu_torch.kernels import deform_window as dw
from beyondff_tpu_torch.kernels import flash_attention as fa
from beyondff_tpu_torch.kernels import mask_iou as kiou
from beyondff_tpu_torch.models import sam as sam_mod
from beyondff_tpu_torch.models.gdino import deformable
from beyondff_tpu_torch.utils.profiling import HBM_BYTES_PER_S, device_ms

OUT = os.path.join(_build.BUILD_DIR, "variants")
RELPOS, IOU, MSD = "relpos_attention.cu", "mask_iou.cu", "ms_deform_sample.cu"
ROUNDS = 3
SET_ORDER = "bff_ms_deform_set_order"

# K1's row walk, which the query-order variants replace
_RASTER_ROWS = """  if (r >= (long long)B * Q * H) return;
  const int h = (int)(r % H);
  const int q = (int)(r / H % Q);
  const int b = (int)(r / H / Q);
  const long long row = r;  // (b * Q + q) * H + h
"""


def _head_run(warps):
    """K1's rows walk ``warps`` warps' worth of queries of one head before
    the next head (the last run padded past Q)."""
    run = f"const int run = ({warps} * 32 + lanes - 1) / lanes;"
    return ((MSD,), (
        (MSD, _RASTER_ROWS, f"""  {run}
  const int runs = (Q + run - 1) / run;
  if (r >= (long long)B * runs * run * H) return;
  const int h = (int)(r / run % H);
  const int q = (int)(r / run / H % runs) * run + (int)(r % run);
  const int b = (int)(r / run / H / runs);
  if (q >= Q) return;
  const long long row = ((long long)b * Q + q) * H + h;
"""),
        (MSD, "  const long long rows = (long long)g.B * g.Q * g.H;\n",
         f"  {run}\n  const long long rows = "
         "(long long)g.B * ((g.Q + run - 1) / run) * run * g.H;\n")))


# name -> (sources to build, edits as (file, old, new))
VARIANTS = {
    "shipped": ((RELPOS, IOU, MSD), ()),
    # K1: a warp's rows are 8 queries of one head (not one query's 8 heads)
    "head_run_warp": _head_run(1),
    # K1: a block's rows are 64 queries of one head
    "head_run_block": _head_run(8),
    # K1: the rows walk a query permutation set by bff_ms_deform_set_order
    # (null: the raster), each output at its query's own index
    "tile_order": ((MSD,), (
        (MSD, "constexpr int kThreads = 256;\n",
         "constexpr int kThreads = 256;\n__device__ const int* g_order;\n"),
        (MSD, _RASTER_ROWS, _RASTER_ROWS.replace(
            "const int q = (int)(r / H % Q);",
            "const int q = g_order ? __ldg(g_order + r / H % Q) : (int)(r / H % Q);").replace(
            "const long long row = r;  // (b * Q + q) * H + h",
            "const long long row = ((long long)b * Q + q) * H + h;")),
        (MSD, 'extern "C" int bff_ms_deform_sample(',
         'extern "C" int ' + SET_ORDER + '(const void* order) {\n'
         '  const int* p = static_cast<const int*>(order);\n'
         '  return (int)cudaMemcpyToSymbol(g_order, &p, sizeof(p));\n}\n\n'
         'extern "C" int bff_ms_deform_sample('))),
    # K1: registers for 2 or 4 blocks of 256 threads per SM (shipped: 3)
    **{f"min_blocks_{n}": ((MSD,), ((MSD, "constexpr int kMinBlocks = 3;",
                                     f"constexpr int kMinBlocks = {n};"),)) for n in (2, 4)},
    # K1: one point's four corners in flight instead of a level's sixteen, or two points'
    "point_at_a_time": ((MSD,), ((MSD, "constexpr int PB = PT > 0 ? PT : 1;",
                                  "constexpr int PB = 1;"),)),
    "two_points": ((MSD,), ((MSD, "constexpr int PB = PT > 0 ? PT : 1;",
                             "constexpr int PB = PT > 0 ? 2 : 1;"),)),
    # K5 (and K4) with the general window modifier, one key at a time
    "singles": ((RELPOS,), (
        (RELPOS, "  if (ww % 2 == 0)\n    return launch_window_tc_kind<DP, true>",
         "  if (false)\n    return launch_window_tc_kind<DP, true>"),
        (RELPOS, "  if (kw % 2 == 0)\n    return launch_flash_tc<DP, kPairs>",
         "  if (false)\n    return launch_flash_tc<DP, kPairs>"))),
    # the factor tables by plain loads instead of 4-byte cp.async
    "plain_table": ((RELPOS,), (
        ("attention_tc.cuh", "const bool words = ((kh | kw) & 1) == 0 &&",
         "const bool words = false &&"),)),
    # K6's unaligned rows loaded after the mma instead of before it
    "load_after_mma": ((IOU,), (
        (IOU, "      if (c + 1 < chunks) cr.load(g, c + 1);  // in flight during the mma\n", ""),
        (IOU, "      if (c + 1 < chunks) cr.cut(",
         "      if (c + 1 < chunks) cr.load(g, c + 1);\n      if (c + 1 < chunks) cr.cut("))),
    # K6's unaligned rows cut 128 bytes a step
    "cut128": ((IOU,), ((IOU, "constexpr int kCut = 64;", "constexpr int kCut = 128;"),)),
}
VARIANTS["singles_plain_table"] = ((RELPOS,), VARIANTS["singles"][1] + VARIANTS["plain_table"][1])


def tile_order(shapes, tile, device):
    """(Q,) int32 permutation of the all-level raster's queries that walks
    them tile by tile of level 0 (``build_assignment``'s buckets, the
    queries of a tile in raster order), on ``device``."""
    a = dw.build_assignment(shapes, 0, tile)
    return torch.from_numpy(a.idx[a.valid].astype(np.int32)).to(device)


def build_all(parent_csrc, names=None):
    """Compile the variants (all, or ``names``) at once; returns {name:
    ctypes library}."""
    shutil.rmtree(OUT, ignore_errors=True)
    specs = {n: v for n, v in VARIANTS.items() if names is None or n in names}
    if parent_csrc:
        specs["parent"] = ((RELPOS, IOU, MSD), ())
    procs = {}
    for name, (sources, edits) in specs.items():
        src_dir = os.path.join(OUT, name, "csrc")
        shutil.copytree(parent_csrc if name == "parent" else _build.CSRC, src_dir)
        for fname, old, new in edits:
            path = os.path.join(src_dir, fname)
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: edit of {fname} matches {text.count(old)} times")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        for src in sources:
            obj = os.path.join(OUT, name, src[:-3] + ".o")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", src_dir, "-c",
                   os.path.join(src_dir, src), "-o", obj]
            procs[(name, src)] = (obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True))
    objs = {}
    for (name, src), (obj, proc) in procs.items():
        out, _ = proc.communicate()
        with open(os.path.join(OUT, name, src[:-3] + ".ptxas.txt"), "w") as f:
            f.write(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}/{src}:\n{out[-4000:]}")
        objs.setdefault(name, []).append(obj)
    libs = {}
    for name, names in objs.items():
        lib = os.path.join(OUT, name, "lib.so")
        subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                        "-o", lib, *names], check=True)
        libs[name] = ctypes.CDLL(lib)
    return libs


def has(lib, fn):
    try:
        getattr(lib, fn)
    except AttributeError:
        return False
    return True


def attention_case(g, grid, window):
    """(launch(lib) -> out, check(out) -> excess over the bound) for K4 or K5
    in bf16 at SAM's factors, as ``chip_smoke.py`` builds them."""
    hh, ww = grid
    s, d = hh * ww, 80
    gen = torch.Generator(device="cuda").manual_seed(s + g)
    q, k, v = (torch.randn(g, s, d, device="cuda", generator=gen).bfloat16() for _ in range(3))
    rel_h = (0.1 * torch.randn(2 * hh - 1, d, device="cuda", generator=gen)).bfloat16()
    rel_w = (0.1 * torch.randn(2 * ww - 1, d, device="cuda", generator=gen)).bfloat16()
    bias_h, bias_w = (t.bfloat16().contiguous() for t in
                      sam_mod._rel_pos_factors((hh, ww), (hh, ww), rel_h, rel_w, q))
    want = fa.attend_relpos_plain(q, k, v, bias_h, bias_w, ww)
    bound = fa.bf16_error_bound(q, k, v, want, bias_h=bias_h, bias_w=bias_w)
    out = torch.empty_like(q)
    fn = "bff_window_attention_relpos" if window else "bff_flash_attention_relpos"
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib):
        f = getattr(lib, fn)
        rc = f(ctypes.c_int(1), *(ctypes.c_void_p(t.data_ptr()) for t in
                                  (q, k, v, bias_h, bias_w, out)),
               g, s, d, hh, ww, ctypes.c_float(d ** -0.5), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"{fn} failed (code {rc})")
        return out

    def check(got):
        return float(((got.float() - want.float()).abs() - bound).max())

    return fn, launch, check


def iou_case(ia, ib, n):
    gen = torch.Generator(device="cuda").manual_seed(ia + n)
    dens = torch.rand(ia, 1, device="cuda", generator=gen) * 0.3
    dens[::17] = 0.0
    a = torch.rand(ia, n, device="cuda", generator=gen) < dens
    b = None
    if ib is not None:
        dens_b = torch.rand(ib, 1, device="cuda", generator=gen) * 0.3
        b = torch.rand(ib, n, device="cuda", generator=gen) < dens_b
    want = kiou.pairwise_iou_plain(a, b)
    ib_n = ia if b is None else ib
    out = torch.empty(ia, ib_n, dtype=torch.float32, device="cuda")
    ws = torch.empty(ia * ib_n + ia + ib_n, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib):
        rc = lib.bff_mask_iou(ctypes.c_void_p(a.data_ptr()),
                              ctypes.c_void_p(None if b is None else b.data_ptr()), ia, ib_n,
                              ctypes.c_longlong(n), ctypes.c_void_p(ws.data_ptr()),
                              ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"bff_mask_iou failed (code {rc})")
        return out

    def check(got):
        same_nan = torch.equal(torch.isnan(got), torch.isnan(want))
        fin = ~torch.isnan(want)
        same = torch.equal(got[fin].view(torch.int32), want[fin].view(torch.int32))
        return 0.0 if same_nan and same else 1.0

    return "bff_mask_iou", launch, check


def corner_rows(shapes, locs, modes):
    """How many (query, head, level, point, corner) rows of ``value`` the
    kernel loads for these locations: the corners that lie in the map of a
    sample that counts (clamp mode drops samples off the map)."""
    q = locs.shape[1]
    origins = dw.window_origins(shapes, modes, locs.device) if modes[0] is not None else None
    n = 0
    for li, (h, w) in enumerate(shapes):
        gx = locs[:, :, :, li, :, 0] * w - 0.5
        gy = locs[:, :, :, li, :, 1] * h - 0.5
        if modes[li] is None:
            live, y0, x0 = torch.ones_like(gx, dtype=torch.bool), gy.floor(), gx.floor()
        else:
            w3 = modes[li][0] + 2 * modes[li][1]
            oy = origins[li, :, 0].view(1, q, 1, 1).float()
            ox = origins[li, :, 1].view(1, q, 1, 1).float()
            live = (gy > -1) & (gy < h) & (gx > -1) & (gx < w)
            y0 = (gy - oy).clamp(0, w3 - 2).floor() + oy
            x0 = (gx - ox).clamp(0, w3 - 2).floor() + ox
        for dy in (0, 1):
            for dx in (0, 1):
                yy, xx = y0 + dy, x0 + dx
                n += int((live & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).sum())
    return n


def deform_case(which, b, dtype):
    """K1 at the 800x1072 encoder raster (``encoder_clamp``,
    ``encoder_exact``) or for 900 decoder queries (``decoder_exact``), on
    ``dw.sample_inputs`` as ``chip_smoke.py`` makes them. A library with
    ``bff_ms_deform_set_order`` walks the encoder raster in level-0 tile
    order."""
    rng = np.random.default_rng(b + 2 * (dtype == torch.float32))
    shapes = dw.ENC_SHAPES
    anchors = (rng.uniform(0.0, 1.0, (900, 2)).astype(np.float32) if which == "decoder_exact"
               else dw.raster_centers(shapes))
    value, tl, ta = dw.sample_inputs(rng, anchors, b, dtype, "cuda")
    _b, q, heads, n_levels, p = ta.shape
    s, hd = value.shape[1], value.shape[3]
    modes = (deformable.level_modes(shapes) if which == "encoder_clamp" else (None,) * 4)
    want = dw.ms_deform_sample_plain(value, shapes, tl, ta, modes).float()
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    origins = dw.window_origins(shapes, modes, tl.device) if modes[0] is not None else None
    order = tile_order(shapes, dw.TILE, tl.device) if which != "decoder_exact" else None
    levels = dw.level_table(shapes, modes)
    out = torch.empty(b, q, heads * hd, dtype=dtype, device="cuda")
    fn = "bff_ms_deform_sample"
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    ordered = set()  # libraries whose order is set for this case

    def launch(lib):
        if has(lib, SET_ORDER) and id(lib) not in ordered:
            if getattr(lib, SET_ORDER)(ptr(order)) != 0:
                raise RuntimeError(f"{SET_ORDER} failed")
            ordered.add(id(lib))
        rc = getattr(lib, fn)(int(dtype == torch.bfloat16), ptr(value), ptr(tl), ptr(ta),
                              ptr(origins), ptr(out), b, s, q, heads, hd, n_levels, p, levels,
                              ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"{fn} failed (code {rc})")
        return out

    def check(got):
        return float((got.float() - want).abs().max()) - tol

    es = value.element_size()
    return (fn, launch, check, dw.sample_bytes(value, tl, ta),
            corner_rows(shapes, tl, modes) * hd * es)


def event_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", default=None,
                    help="a csrc tree to build as the variant 'parent'")
    ap.add_argument("--variants", default=None,
                    help="comma-separated names to build (default: all)")
    ap.add_argument("--cases", default=None,
                    help="comma-separated prefixes of the cases to run (default: all)")
    ap.add_argument("--out", default=OUT, help="where the results and ptxas reports go")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    libs = build_all(args.parent_csrc, args.variants and args.variants.split(","))
    cases = {}
    for which in ("encoder_clamp", "encoder_exact", "decoder_exact"):
        for b in (1, 4):
            for dtype in (torch.bfloat16, torch.float32):
                name = f"k1 {which} b{b} {str(dtype)[6:]}"
                cases[name] = lambda w=which, b=b, d=dtype: deform_case(w, b, d)
    cases.update({
        "k4 (64, 4096, 80)": lambda: attention_case(64, (64, 64), False),
        "k5 (1600, 196, 80)": lambda: attention_case(1600, (14, 14), True),
        "k5 (400, 196, 80)": lambda: attention_case(400, (14, 14), True),
        "k6 self (600, 250000)": lambda: iou_case(600, None, 250_000),
        "k6 self (600, 250007)": lambda: iou_case(600, None, 250_007),
        "k6 cross (20 x 150, 250000)": lambda: iou_case(20, 150, 250_000),
        "k6 cross (20 x 150, 250007)": lambda: iou_case(20, 150, 250_007),
    })
    if args.cases:
        cases = {k: v for k, v in cases.items()
                 if any(k.startswith(c) for c in args.cases.split(","))}
    os.makedirs(args.out, exist_ok=True)
    lines = []
    for case, make in cases.items():
        fn, launch, check, *nbytes = make()  # K1: (unique bytes, corner-row bytes)
        names = [n for n, lib in libs.items() if has(lib, fn)]
        excess = {n: check(launch(libs[n])) for n in names}
        times = {n: [] for n in names}
        for r in range(ROUNDS):
            for n in names if r % 2 == 0 else names[::-1]:
                times[n].append(event_ms(lambda: launch(libs[n]), 20))
        for n in names:
            rec = {"case": case, "variant": n, "ms": min(times[n]), "ms_rounds": times[n],
                   "right": excess[n] <= 0.0, "excess": excess[n], "card": card}
            if nbytes:  # K1: device time, the rates of unique and corner bytes, the bound
                rec["device_ms"] = device_ms(lambda: launch(libs[n]))
                rec["gbps"] = nbytes[0] / rec["device_ms"] / 1e6
                rec["corner_gbps"] = nbytes[1] / rec["device_ms"] / 1e6
                rec["bound_ms"] = nbytes[0] / HBM_BYTES_PER_S * 1e3
            lines.append(rec)
            print(json.dumps(rec), flush=True)
        del launch, check
        torch.cuda.empty_cache()
    with open(os.path.join(args.out, "kernel_variants.json"), "w") as f:
        f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    for name in libs:
        for rep in sorted(os.listdir(os.path.join(OUT, name))):
            if rep.endswith(".ptxas.txt"):
                shutil.copy(os.path.join(OUT, name, rep),
                            os.path.join(args.out, f"ptxas_{name}_{rep}"))
    if not all(x["right"] for x in lines):
        raise SystemExit("a variant disagrees with the plain version")


if __name__ == "__main__":
    main()
