"""Measure the windowed clamp of the deformable sampler against exact sampling.

The port's counterpart of tools/measure_deform_window.py. On the card the
Grounding-DINO encoder samples every level in clamp mode by default
(``models/gdino/deformable.level_modes``: L0 tile 16 radius 8, the other
levels tile 8 radius 8), the TPU kernel's window approximation: a sample
inside its query's window ``[origin, origin + w3 - 2]`` is exact, an in-map
sample beyond it clamps to the window's edge, a sample outside the map reads
0 (``kernels/deform_window.py``). Two measurements:

1. ``kernel_level``: seeded N(0, sigma cells) offsets around the all-level
   raster's centres, one level at a time, through ``ms_deform_sample`` in
   clamp mode and in exact mode with the same attention weights. Columns:
   the JAX tool's ``frac_beyond_R`` (a sample with an offset beyond
   R = radius - 1 cells on either axis, the window's least reach),
   ``mean_abs_err``, ``max_abs_err`` and ``rel_l2``; beside them
   ``clamped_share``, the share of in-map samples that the kernel really
   clamps (from ``window_origins`` and the clamp rule), and
   ``mismatched``, the outputs whose bits differ. Every row names its level's
   ``(tile, radius)``. ``--tiles a,b`` keeps the JAX tool's meaning
   (L0 ``(a, a)``, L1 ``(b, b)``: radius = tile), which reproduces its rows.
2. ``full_model``: a Grounding-DINO forward with every encoder layer's
   ``sampling_offsets`` weight and bias scaled by alpha (on a copy of the
   parameters, through ``torch.func.functional_call``; the model keeps its
   own), windowed sampling off and on (``BFF_DEFORM_WINDOWED``): the
   largest box and logit deltas, the top-8 overlap by max-sigmoid score,
   the share of the encoder's in-map samples that clamp, counted by a
   forward hook on each encoder ``MSDeformAttn`` from the locations it
   computes, and the encoder output's relative L2 deviation
   (``memory_rel_l2``).

    python -m beyondff_tpu_torch.tools.measure_deform_window [--sigmas 1,2,4,8,16,32] \
        [--alphas 0.05,0.25,1.0,4.0] [--tiles 16,8] [--skip-full] \
        [--dtype bfloat16] [--device cuda]

On the card it samples the 800x1072 encoder raster (8 heads x 32, 4
points) and runs Grounding-DINO Swin-B at full width; with ``--device
cpu`` a 32x48-level raster (2 heads x 8) and the JAX tool's small model
(``SMALL_CONFIG``, 256x384 input), which the plain gather runs in seconds.
Prints one JSON line a row.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from beyondff_tpu_torch.kernels import deform_window as dw
from beyondff_tpu_torch.kernels.dispatch import resolve_device
from beyondff_tpu_torch.models.gdino import bert as bert_mod
from beyondff_tpu_torch.models.gdino import deformable
from beyondff_tpu_torch.models.gdino import model as gdino_model
from beyondff_tpu_torch.models.gdino import swin as swin_mod
from beyondff_tpu_torch.tools.profile_common import DTYPES, env_set

SHAPES_800 = dw.ENC_SHAPES
TEST_SHAPES = ((32, 48), (16, 24), (8, 12), (4, 6))
# the JAX tool's full-model config, 3 levels, 2 + 2 layers, 32 queries (its
# comment calls L0 32x48; the test Swin's stride-4 first stage makes it 64x96)
SMALL_CONFIG = gdino_model.GDINOConfig(
    swin=swin_mod.PRESETS["test"], bert=bert_mod.PRESETS["test"], hidden=32, heads=4,
    levels=3, enc_layers=2, dec_layers=2, ffn_dim=64, num_queries=32, max_text_len=16,
    image_size=(256, 384))
TOP_K = 8
TEXT_LEN = 8


def _centers(shapes):
    """(Q, 2) float64 (x, y) centres of the all-level raster's cells, as the
    JAX tool's, so the locations round as its do (``dw.raster_centers``
    is float32)."""
    cs = []
    for h, w in shapes:
        ys = (np.arange(h) + 0.5) / h
        xs = (np.arange(w) + 0.5) / w
        cs.append(np.stack(np.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2))
    return np.concatenate(cs, 0)


def tile_modes(shapes, tiles) -> Tuple[dw.Mode, ...]:
    """The JAX tool's ``--tiles``: L0 and L1 in clamp mode with radius =
    tile, the other levels not measured (exact)."""
    return tuple((int(t), int(t)) for t in tiles) + (None,) * (len(shapes) - len(tiles))


def clamp_counts(locs: torch.Tensor, shapes, modes) -> List[Tuple[int, int]]:
    """(clamped, in map) sample counts of each level of ``locs``
    (``deform_window.clamped_samples``)."""
    return [(int(c.sum()), int(m.sum())) for c, m in dw.clamped_samples(locs, shapes, modes)]


def kernel_level(rng: np.random.Generator, sigmas: Sequence[float],
                 modes: Optional[Sequence[dw.Mode]] = None, shapes=SHAPES_800,
                 heads: int = 8, hd: int = 32, p: int = 4, dtype=torch.bfloat16,
                 device=None) -> List[dict]:
    """One row a (level, sigma) for every level whose mode is a clamp
    ``(tile, radius)``; ``modes`` defaults to the main path's,
    ``level_modes(shapes)``. Draws from ``rng`` in the JAX tool's order
    (values, then per level and sigma the offsets and the weights)."""
    dev = resolve_device(device)
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    modes = tuple(deformable.level_modes(shapes) if modes is None else modes)
    n_levels = len(shapes)
    centers = _centers(shapes)
    q = centers.shape[0]
    value = rng.normal(size=(1, q, heads, hd)).astype(np.float32)
    v = torch.from_numpy(value).to(dev, dtype)
    exact = (None,) * n_levels
    rows = []
    for level, mode in enumerate(modes):
        if mode is None:
            continue
        h, w = shapes[level]
        tile, radius = mode
        only = tuple(mode if li == level else None for li in range(n_levels))
        for sigma in sigmas:
            off = rng.normal(0, sigma, (1, q, heads, p, 2)).astype(np.float32)
            aw1 = rng.uniform(0.1, 1.0, (1, q, heads, 1, p)).astype(np.float32)
            aw1 /= aw1.sum((-1, -2), keepdims=True)
            # the other levels: outside the map, weight 0 (no corner is read)
            locs = np.full((1, q, heads, n_levels, p, 2), -1.0, np.float32)
            locs[:, :, :, level, :, 0] = centers[None, :, None, None, 0] + off[..., 0] / w
            locs[:, :, :, level, :, 1] = centers[None, :, None, None, 1] + off[..., 1] / h
            aw = np.zeros((1, q, heads, n_levels, p), np.float32)
            aw[:, :, :, level] = aw1[:, :, :, 0]
            tl = torch.from_numpy(locs).to(dev)
            ta = torch.from_numpy(aw).to(dev, dtype)
            got = dw.ms_deform_sample(v, shapes, tl, ta, only)
            want = dw.ms_deform_sample(v, shapes, tl, ta, exact)
            mismatched = int((got != want).sum())
            got = got.double().cpu().numpy()
            want = want.double().cpu().numpy()
            err = np.abs(got - want)
            clamped, inmap = clamp_counts(tl, shapes, only)[level]
            rows.append({
                "part": "kernel_level", "level": level, "tile": tile, "radius": radius,
                "sigma_cells": float(sigma),
                "frac_beyond_R": float((np.abs(off) > radius - 1).any(-1).mean()),
                "clamped_share": clamped / max(inmap, 1), "clamped": clamped,
                "in_map": inmap, "mean_abs_err": float(err.mean()),
                "max_abs_err": float(err.max()),
                "rel_l2": float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)),
                "mismatched": mismatched, "values": int(got.size),
                "shapes": [list(s) for s in shapes], "queries": q, "heads": heads,
                "head_dim": hd, "points": p, "dtype": str(dtype).split(".")[-1],
                "device": _device_name(dev)})
    return rows


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def forward_inputs(rng: np.random.Generator, cfg, dtype, dev):
    """One seeded image and an 8-token caption, drawn as the JAX tool draws
    them: image (1, H, W, 3) standard normal, ids, every token valid,
    position ids 0."""
    gh, gw = cfg.image_size
    img = torch.from_numpy(rng.normal(size=(1, gh, gw, 3)).astype(np.float32)).to(dev, dtype)
    ids = rng.integers(1, cfg.bert.vocab_size, (1, TEXT_LEN)).astype(np.int64)
    return (img, torch.from_numpy(ids).to(dev),
            torch.ones(1, TEXT_LEN, TEXT_LEN, dtype=torch.bool, device=dev),
            torch.ones(1, TEXT_LEN, dtype=torch.bool, device=dev),
            torch.zeros(1, TEXT_LEN, dtype=torch.long, device=dev))


def scaled_offsets(module, alpha: float) -> dict:
    """New tensors for every encoder layer's ``self_attn.sampling_offsets``
    weight and bias, scaled by ``alpha``; the module keeps its own."""
    return {f"transformer.encoder.layers.{li}.self_attn.sampling_offsets.{name}":
            getattr(layer.self_attn.sampling_offsets, name) * alpha
            for li, layer in enumerate(module.transformer.encoder.layers)
            for name in ("weight", "bias")}


class EncoderProbe:
    """Forward hooks on the encoder: every layer's ``MSDeformAttn`` counts
    the clamped and in-map samples of the locations it computes, under the
    main path's ``level_modes``; the last layer's output is the memory."""

    def __init__(self, module):
        self.clamped = self.in_map = 0
        self.shapes = ()
        self.memory = None
        layers = module.transformer.encoder.layers
        self._handles = [layer.self_attn.register_forward_hook(self._count)
                         for layer in layers]
        self._handles.append(layers[-1].register_forward_hook(self._memory))

    def _count(self, attn, args, _out):
        query, reference_points, _value, spatial_shapes = args
        shapes = self.shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
        locs = attn.sampling_locations(query, reference_points, spatial_shapes)
        for clamped, inmap in clamp_counts(locs, shapes, deformable.level_modes(shapes)):
            self.clamped += clamped
            self.in_map += inmap

    def _memory(self, _layer, _args, out):
        self.memory = out.double().cpu().numpy()

    def remove(self):
        for handle in self._handles:
            handle.remove()


def _top_k(logits: np.ndarray) -> set:
    """The TOP_K queries of frame 0 by max-sigmoid score."""
    return set(np.argsort((1.0 / (1.0 + np.exp(-logits))).max(-1)[0])[-TOP_K:].tolist())


def full_model(rng: np.random.Generator, alphas: Sequence[float], cfg=SMALL_CONFIG,
               dtype=torch.float32, device=None, seed: int = 0, module=None) -> List[dict]:
    """One row an alpha: windowed (clamp) against exact encoder sampling on
    a Grounding-DINO built from ``seed`` (or ``module``, already built).
    Beside the JAX tool's columns, ``memory_rel_l2`` is the encoder
    output's relative L2 deviation: with random weights the 900 proposals'
    order flips on any change of the memory, so the box and logit deltas of
    a query index say little at full width. Each row also holds both runs'
    logits and boxes (``outputs``)."""
    dev = resolve_device(device)
    if module is None:
        module = gdino_model.GroundingDINO.create(cfg, seed=seed, dtype=dtype,
                                                  device=dev).module
    cfg = module.cfg
    inputs = forward_inputs(rng, cfg, next(module.parameters()).dtype, dev)
    rows = []
    for alpha in alphas:
        params = scaled_offsets(module, alpha)
        runs = {}
        for windowed in ("0", "1"):
            probe = EncoderProbe(module)
            try:
                with env_set("BFF_DEFORM_WINDOWED", windowed), torch.inference_mode():
                    logits, boxes = torch.func.functional_call(module, params, inputs)
            finally:
                probe.remove()
            runs[windowed] = (logits.float().cpu().numpy(), boxes.float().cpu().numpy(), probe)
        (exact_logits, exact_boxes, exact), (win_logits, win_boxes, win) = runs["0"], runs["1"]
        rows.append({
            "part": "full_model", "alpha": float(alpha),
            "max_dbox": float(np.abs(win_boxes - exact_boxes).max()),
            "max_dlogit": float(np.abs(win_logits - exact_logits).max()),
            "topk_overlap": len(_top_k(exact_logits) & _top_k(win_logits)) / TOP_K,
            "clamped_share": win.clamped / max(win.in_map, 1),
            "clamped": win.clamped, "in_map": win.in_map,
            "memory_rel_l2": float(np.linalg.norm(win.memory - exact.memory)
                                   / (np.linalg.norm(exact.memory) + 1e-12)),
            "modes": [list(m) if m else None for m in deformable.level_modes(win.shapes)],
            "shapes": [list(s) for s in win.shapes], "image_size": list(cfg.image_size),
            "enc_layers": cfg.enc_layers, "num_queries": cfg.num_queries,
            "dtype": str(next(module.parameters()).dtype).split(".")[-1],
            "device": _device_name(dev),
            "outputs": {"exact": (exact_logits, exact_boxes),
                        "windowed": (win_logits, win_boxes)}})
    return rows


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sigmas", default="1,2,4,8,16,32")
    ap.add_argument("--alphas", default="0.05,0.25,1.0,4.0")
    ap.add_argument("--tiles", default=None,
                    help="L0,L1 tiles with radius = tile (the JAX tool's meaning), e.g. "
                         "16,8; default: the main path's level_modes")
    ap.add_argument("--skip-full", action="store_true")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    full = dev.type == "cuda"
    dtype = DTYPES[args.dtype]
    shapes = SHAPES_800 if full else TEST_SHAPES
    modes = None if args.tiles is None else tile_modes(
        shapes, [int(t) for t in args.tiles.split(",")])
    rng = np.random.default_rng(0)
    rows = kernel_level(rng, [float(s) for s in args.sigmas.split(",")], modes, shapes,
                        *((8, 32) if full else (2, 8)), dtype=dtype, device=dev)
    if not args.skip_full:
        rows += full_model(rng, [float(a) for a in args.alphas.split(",")],
                           gdino_model.PRESETS["swinb"] if full else SMALL_CONFIG, dtype, dev)
    for row in rows:
        print(json.dumps({k: v for k, v in row.items() if k != "outputs"}), flush=True)
    return rows


if __name__ == "__main__":
    main()
