"""Attribute Grounding-DINO forward time by variant differencing.

The port's counterpart of tools/profile_gdino_blocks.py: the whole Swin-B
forward at one frame (random weights, timing only) with ``enc_layers=0``,
``dec_layers=0``, both, and one encoder layer, so the post-backbone cost
splits into the feature enhancer (deformable self-attention, text fusion,
text self-attention and FFNs a layer), the decoder (self-attention, text
cross-attention, deformable cross-attention, FFN a layer) and backbone plus
glue (input projections, query selection, heads). The last line is the
attribution.

    python -m beyondff_tpu_torch.tools.profile_gdino_blocks [--iters 8]
    python -m beyondff_tpu_torch.tools.profile_gdino_blocks --device cpu --scale test
"""

from __future__ import annotations

import dataclasses

import numpy as np

from beyondff_tpu_torch.models.gdino import GroundingDINO
from beyondff_tpu_torch.models.gdino import model as gdino_model
from beyondff_tpu_torch.tools import profile_common as pc
from beyondff_tpu_torch.utils.host_copy import to_device

TOOL = "profile_gdino_blocks"
CAPTION = "a chair . a table . clothes ."


def forward_inputs(gd: GroundingDINO, batch: int = 1) -> tuple:
    """A normalized random image batch at the detector's input size and the
    caption's text tensors, as :meth:`GDINOModule.forward` takes them."""
    gh, gw = gd.cfg.image_size
    img = pc.randn((batch, gh, gw, 3), gd.device, gd.dtype)
    ids, pad, self_mask, pos_ids = gd._text(CAPTION)
    text = [to_device(np.broadcast_to(a, (batch, *a.shape[1:])).copy(), gd.device)
            for a in (ids, self_mask, pad, pos_ids)]
    return (img, text[0].long(), text[1].bool(), text[2].bool(), text[3].long())


def main(argv=None) -> dict:
    args = pc.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev, dtype = pc.setup(args)
    base = gdino_model.PRESETS["swinb" if args.scale == "full" else "test"]
    n_enc, n_dec = base.enc_layers, base.dec_layers
    variants = ((f"enc{n_enc}_dec{n_dec}", base),
                (f"enc0_dec{n_dec}", dataclasses.replace(base, enc_layers=0)),
                (f"enc{n_enc}_dec0", dataclasses.replace(base, dec_layers=0)),
                ("enc0_dec0", dataclasses.replace(base, enc_layers=0, dec_layers=0)),
                ("enc1_dec0", dataclasses.replace(base, enc_layers=1, dec_layers=0)))
    rows = {}
    for name, cfg in variants:
        gd = GroundingDINO.create(cfg, dtype=dtype, device=dev)
        inputs = forward_inputs(gd)
        t = pc.timing(lambda: gd.module(*inputs), args.iters, dev)
        rows[name] = {"ms": t["ms"], "device_ms": t["device_ms"]}
        pc.emit(TOOL, variant=name, enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
                **t)
        del gd
    full, no_enc, no_dec = (v[0] for v in variants[:3])

    def split(key):
        r = {k: v[key] for k, v in rows.items()}
        if r[full] is None:
            return None
        return {"enhancer_ms": r[full] - r[no_enc],
                "enhancer_ms_per_layer": (r[full] - r[no_enc]) / max(n_enc, 1),
                "enhancer_single_layer_ms": r["enc1_dec0"] - r["enc0_dec0"],
                "decoder_ms": r[full] - r[no_dec],
                "decoder_ms_per_layer": (r[full] - r[no_dec]) / max(n_dec, 1),
                "backbone_glue_ms": r["enc0_dec0"]}

    return pc.emit(TOOL, variant="attribution", scale=args.scale, dtype=args.dtype,
                   full_ms=rows[full]["ms"], **split("ms"), device_ms=split("device_ms"))


if __name__ == "__main__":
    main()
