"""Attribute SAM ViT-H encoder time by variant differencing.

The port's counterpart of tools/profile_sam.py. The encoder is timed on one
frame (``--batch``) under ``BFF_SAM_ABLATE`` (``models/sam.py``):

  - ``full``: the encoder as the 2D stage runs it;
  - ``norelpos``: the plain path drops the rel-pos bias;
  - ``noattn``: windowed blocks skip attention (rel-pos included);
  - ``nomlp``: every block skips its MLP;
  - ``noglobal``: ``global_attn_indexes=()``, every block windowed;
  - ``full_relpos_flash`` and ``norelpos_relpos_flash``: the first two under
    ``BFF_SAM_RELPOS_FLASH=1``, where the global blocks take the rel-pos
    flash kernel, whose branch returns before the ablation is read, so it
    keeps the bias (as in the JAX package).

Each variant's line names the branch its global blocks took (``plain``,
``flash``: no rel-pos, ``relpos_flash``) from the kernels' launch counts, and
whether they added the rel-pos bias. The last line is the attribution:
full minus each ablation.

    python -m beyondff_tpu_torch.tools.profile_sam [--scale full] [--iters 8]
    python -m beyondff_tpu_torch.tools.profile_sam --device cpu --scale test
"""

from __future__ import annotations

import dataclasses

from beyondff_tpu_torch.models import sam as sam_mod
from beyondff_tpu_torch.tools import profile_common as pc

TOOL = "profile_sam"
# (variant, BFF_SAM_ABLATE, BFF_SAM_RELPOS_FLASH, no global blocks)
VARIANTS = (("full", None, None, False), ("norelpos", "norelpos", None, False),
            ("noattn", "noattn", None, False), ("nomlp", "nomlp", None, False),
            ("noglobal", None, None, True), ("full_relpos_flash", None, "1", False),
            ("norelpos_relpos_flash", "norelpos", "1", False))


def global_branch(cfg: sam_mod.SAMConfig, launches: dict, ablate: str) -> dict:
    """Which branch the global blocks took, read from one encode's kernel
    launches, and whether they added the rel-pos bias."""
    if not cfg.global_attn_indexes:
        return {"global_branch": None, "global_relpos": None}
    if launches.get("flash_attention_relpos"):
        return {"global_branch": "relpos_flash", "global_relpos": "kept"}
    if launches.get("flash_attention") and not cfg.use_rel_pos:
        return {"global_branch": "flash", "global_relpos": None}
    kept = cfg.use_rel_pos and "norelpos" not in (ablate or "")
    return {"global_branch": "plain", "global_relpos": "kept" if kept else "dropped"}


def main(argv=None) -> dict:
    ap = pc.parser(__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args(argv)
    dev, dtype = pc.setup(args)
    base = sam_mod.PRESETS["vit_h" if args.scale == "full" else "test"]
    models = {}
    rows = {}
    for name, ablate, relpos_flash, no_global in VARIANTS:
        cfg = dataclasses.replace(base, global_attn_indexes=()) if no_global else base
        if cfg not in models:
            models[cfg] = sam_mod.SAM.create(cfg, dtype=dtype, device=dev)
        module = models[cfg].module
        x = pc.randn((args.batch, cfg.img_size, cfg.img_size, 3), dev, dtype)
        with pc.env_set("BFF_SAM_ABLATE", ablate), \
                pc.env_set("BFF_SAM_RELPOS_FLASH", relpos_flash):
            t = pc.timing(lambda: module.encode(x), args.iters, dev)
        ms_frame = t["ms"] / args.batch
        rows[name] = {"ms": ms_frame,
                      "device_ms": None if t["device_ms"] is None
                      else t["device_ms"] / args.batch}
        pc.emit(TOOL, variant=name, BFF_SAM_ABLATE=ablate or "",
                BFF_SAM_RELPOS_FLASH=relpos_flash or "", batch=args.batch,
                ms_per_frame=ms_frame, device_ms_per_frame=rows[name]["device_ms"],
                launches=t["launches"], **global_branch(cfg, t["launches"], ablate))
    diff = {key: pc.differences({k: rows[k] for k in
                                 ("full", "norelpos", "noattn", "nomlp", "noglobal")},
                                "full", key)
            for key in ("ms", "device_ms")}
    return pc.emit(TOOL, variant="attribution", scale=args.scale, dtype=args.dtype,
                   relpos_bias_ms=diff["ms"]["norelpos"],
                   windowed_attn_ms=diff["ms"]["noattn"], mlp_ms=diff["ms"]["nomlp"],
                   global_blocks_ms=diff["ms"]["noglobal"],
                   device_ms={"relpos_bias": diff["device_ms"]["norelpos"],
                              "windowed_attn": diff["device_ms"]["noattn"],
                              "mlp": diff["device_ms"]["nomlp"],
                              "global_blocks": diff["device_ms"]["noglobal"]},
                   full_ms_per_frame=rows["full"]["ms"],
                   full_device_ms_per_frame=rows["full"]["device_ms"],
                   global_blocks=len(base.global_attn_indexes),
                   windowed_blocks=base.encoder_depth - len(base.global_attn_indexes))


if __name__ == "__main__":
    main()
