"""Attribute one Grounding-DINO enhancer layer's time by component, at the
production shapes: an (800, 1072) input gives the levels (100, 134),
(50, 67), (25, 34) and (13, 17), Q = 17 821 tokens, d 256, 8 heads, P 4,
bf16 (``--scale test``: the ``"test"`` preset's levels).

The port's counterpart of tools/profile_enhancer.py. Each sub-block is
timed standalone:

  - the whole enhancer layer (text fusion, text self-attention, deformable
    image self-attention and its FFN, in the order ``GDINOModule.detect``
    runs them);
  - ``MSDeformAttn`` (projections and sampling), windowed and exact;
  - ``ms_deform_sample``: the sampling alone. The port's kernel (K1,
    ``csrc/ms_deform_sample.cu``) samples all four levels in one launch, so
    the JAX tool's per-level rows (windowed kernel for the large levels,
    matmul-interpolation for the small ones) are this one row;
  - the BiAttention fusion, the text part and the image FFN with its norm;
  - the sine position embedding of the raster (once a forward).

    python -m beyondff_tpu_torch.tools.profile_enhancer [--iters 20]
    python -m beyondff_tpu_torch.tools.profile_enhancer --device cpu --scale test
"""

from __future__ import annotations

import math

import numpy as np
import torch

from beyondff_tpu_torch.kernels import deform_window as dw
from beyondff_tpu_torch.models.gdino import deformable
from beyondff_tpu_torch.models.gdino import model as gdino_model
from beyondff_tpu_torch.models.layers import build
from beyondff_tpu_torch.tools import profile_common as pc
from beyondff_tpu_torch.utils.host_copy import to_device

TOOL = "profile_enhancer"
NOTE = ("the port's K1 samples all levels in one launch: the JAX tool's per-level "
        "windowed-kernel and matmul-interp rows are the one ms_deform_sample row")


def level_shapes(cfg: gdino_model.GDINOConfig):
    """The encoder's levels for the configured input: strides 8, 16, 32
    (the backbone's three used maps) and the extra stride-2 level."""
    h, w = (math.ceil(n / 8) for n in cfg.image_size)
    shapes = []
    for _ in range(cfg.levels):
        shapes.append((h, w))
        h, w = math.ceil(h / 2), math.ceil(w / 2)
    return tuple(shapes)


def raster_refs(shapes, b: int, dev, dtype) -> torch.Tensor:
    """Per-level normalized reference points of the encoder raster,
    (B, Q, levels, 2) (x, y)."""
    refs = []
    for h, w in shapes:
        ys, xs = (np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w
        refs.append(np.stack(np.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2))
    c = np.concatenate(refs, 0).astype(np.float32)
    return to_device(np.broadcast_to(c[None, :, None, :], (b, len(c), len(shapes), 2)).copy(),
                     dev).to(dtype)


def main(argv=None) -> dict:
    args = pc.parser(__doc__.splitlines()[0], iters=20).parse_args(argv)
    dev, dtype = pc.setup(args)
    cfg = gdino_model.PRESETS["swinb" if args.scale == "full" else "test"]
    shapes = level_shapes(cfg)
    d, heads, p_pts, t_len = cfg.hidden, cfg.heads, cfg.enc_points, 8
    q = sum(h * w for h, w in shapes)
    img, pos, txt = (pc.randn(s, dev, dtype, seed=i) for i, s in
                     enumerate(((1, q, d), (1, q, d), (1, t_len, d))))
    pos_text = pc.randn((1, t_len, d), dev, dtype, seed=3)
    txt_mask = torch.ones(1, t_len, dtype=torch.bool, device=dev)
    t_mask = torch.ones(1, 1, t_len, t_len, dtype=torch.bool, device=dev)
    refs = raster_refs(shapes, 1, dev, dtype)

    fusion = build(lambda: gdino_model.BiAttentionBlock(d, d, cfg.ffn_dim // 2, heads // 2),
                   dev, dtype)
    text = build(lambda: gdino_model.TextEnhancerLayer(cfg), dev, dtype)
    layer = build(lambda: gdino_model.DeformableEncoderLayer(cfg), dev, dtype)
    exact = build(lambda: deformable.MSDeformAttn(d, heads, cfg.levels, p_pts), dev, dtype)
    exact.load_state_dict(layer.self_attn.state_dict())

    def enhancer():
        m, t = fusion(img, txt, txt_mask)
        t = text(t, pos_text, t_mask)
        return layer(m, pos, refs, shapes), t

    hd = d // heads
    value = pc.randn((1, q, heads, hd), dev, dtype, seed=4)
    locs = torch.rand(1, q, heads, cfg.levels, p_pts, 2,
                      generator=torch.Generator().manual_seed(5)).to(dev)
    aw = torch.softmax(pc.randn((1, q, heads, cfg.levels * p_pts), dev, torch.float32, seed=6),
                       -1).to(dtype).reshape(1, q, heads, cfg.levels, p_pts)
    modes = deformable.level_modes(shapes) if deformable._use_windowed(True, value) \
        else (None,) * len(shapes)

    def ffn():
        return layer.norm2(img + layer.linear2(torch.relu(layer.linear1(img))))

    rows = (("enhancer_layer", enhancer),
            ("msdeform_windowed", lambda: layer.self_attn(img + pos, refs, img, shapes)),
            ("msdeform_exact", lambda: exact(img + pos, refs, img, shapes)),
            ("ms_deform_sample", lambda: dw.ms_deform_sample(value, shapes, locs, aw, modes)),
            ("biattention_fusion", lambda: fusion(img, txt, txt_mask)),
            ("text_enhancer", lambda: text(txt, pos_text, t_mask)),
            ("image_ffn_ln", ffn),
            ("sine_pe_per_forward",
             lambda: gdino_model.sine_position_embedding(refs[0, :, 0].float(), d)))
    out = {}
    for name, fn in rows:
        out[name] = pc.timing(fn, args.iters, dev)
        pc.emit(TOOL, variant=name, **out[name])
    return pc.emit(TOOL, variant="summary", scale=args.scale, dtype=args.dtype,
                   levels=[list(s) for s in shapes], tokens=q, hidden=d, heads=heads,
                   points=p_pts, windowed_modes=[list(m) if m else None for m in modes],
                   note=NOTE, ms={k: v["ms"] for k, v in out.items()},
                   device_ms={k: v["device_ms"] for k, v in out.items()})


if __name__ == "__main__":
    main()
