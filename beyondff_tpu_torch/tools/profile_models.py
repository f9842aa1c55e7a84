"""Component-level timing of the 2D stage's model stack.

The port's counterpart of tools/profile_models.py: the pieces that matter
for kernel work, at one frame with random weights:

  - Grounding-DINO's whole forward against its Swin-B backbone alone; the
    difference is the enhancer, decoder and glue;
  - SAM ViT-H's encode against the same encoder with
    ``global_attn_indexes=()`` (every block windowed); the difference is the
    global-attention blocks.

    python -m beyondff_tpu_torch.tools.profile_models [--iters 8]
    python -m beyondff_tpu_torch.tools.profile_models --device cpu --scale test
"""

from __future__ import annotations

import dataclasses

from beyondff_tpu_torch.models import sam as sam_mod
from beyondff_tpu_torch.models.gdino import GroundingDINO
from beyondff_tpu_torch.models.gdino import model as gdino_model
from beyondff_tpu_torch.tools import profile_common as pc
from beyondff_tpu_torch.tools.profile_gdino_blocks import forward_inputs

TOOL = "profile_models"


def main(argv=None) -> dict:
    args = pc.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev, dtype = pc.setup(args)
    full = args.scale == "full"
    rows = {}

    def run(name, fn, **extra):
        t = pc.timing(fn, args.iters, dev)
        rows[name] = t
        pc.emit(TOOL, variant=name, **extra, **t)

    gd = GroundingDINO.create(gdino_model.PRESETS["swinb" if full else "test"], dtype=dtype,
                              device=dev)
    inputs = forward_inputs(gd)
    run("gdino_full", lambda: gd.module(*inputs))
    run("gdino_swin_backbone", lambda: gd.module.backbone[0](inputs[0]))
    del gd

    sam_cfg = sam_mod.PRESETS["vit_h" if full else "test"]
    x = pc.randn((1, sam_cfg.img_size, sam_cfg.img_size, 3), dev, dtype)
    for name, cfg in (("sam_encode_full", sam_cfg),
                      ("sam_encode_all_windowed",
                       dataclasses.replace(sam_cfg, global_attn_indexes=()))):
        sam = sam_mod.SAM.create(cfg, dtype=dtype, device=dev)
        run(name, lambda: sam.module.encode(x), global_blocks=len(cfg.global_attn_indexes))
        del sam

    def diff(key):
        r = {k: v[key] for k, v in rows.items()}
        if r["gdino_full"] is None:
            return None
        n_glob = max(len(sam_cfg.global_attn_indexes), 1)
        glob = r["sam_encode_full"] - r["sam_encode_all_windowed"]
        return {"gdino_enhancer_decoder_glue_ms": r["gdino_full"] - r["gdino_swin_backbone"],
                "sam_global_blocks_ms": glob, "sam_global_ms_per_block": glob / n_glob}

    return pc.emit(TOOL, variant="attribution", scale=args.scale, dtype=args.dtype,
                   **diff("ms"), device_ms=diff("device_ms"))


if __name__ == "__main__":
    main()
