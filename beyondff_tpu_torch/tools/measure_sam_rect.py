"""Measure the rect-encode (pad-free) SAM mode: speed and output deviation.

The port's counterpart of tools/measure_sam_rect.py. ``BFF_SAM_RECT=1``
encodes only the valid patch rows (48 x 64 for ScanNet's 968 x 1296 frames,
scaled to 765 x 1024) instead of the zero-padded 64 x 64 square. The
dropped tokens are pure pad content, but they take part in the square
path's global-attention softmax and boundary windows, so the mode is a
deviation, measured here at the production shape:

  - the encoder's time, square against rect (CUDA events on the card),
    and on the card also its device time from ``torch.profiler``
    (``encode_device_ms_*``: where it lies well below the events' time,
    the host's launches set the pace);
  - the embedding deviation over the valid grid (relative L2, max abs);
  - the decoded masks' IoU per box prompt, square against rect, and the
    largest change of the predicted IoU.

``--temp-sweep`` also measures the deviation with the q columns of every
encoder ``qkv`` projection scaled by 2, 4 and 8: random-init logits are
near zero, so softmax is diffuse and every pad token gets weight, the worst
case for dropping them; peakier attention bounds how much of the deviation
is a random-init artifact (the JAX tool's ``BFF_RECT_TEMP_SWEEP``).

    python -m beyondff_tpu_torch.tools.measure_sam_rect [--model efficientsam] \
        [--batch 1] [--iters 8] [--device cpu --preset test --dtype float32]

SAM ViT-H's global blocks take the rel-pos flash kernel when
``BFF_SAM_RELPOS_FLASH=1`` is set, as everywhere in the port. Prints one
JSON line.
"""

import argparse
import json

import numpy as np
import torch

from beyondff_tpu_torch.kernels.dispatch import resolve_device
from beyondff_tpu_torch.tools.profile_common import env_set, time_ms
from beyondff_tpu_torch.utils.profiling import device_ms

FRAME_HW = (968, 1296)  # ScanNet's color frames
# box prompts in padded-square pixels of a 1024 px input (the JAX tool's)
BOXES_1024 = np.array([[100, 80, 600, 500], [300, 200, 900, 700],
                       [50, 50, 200, 300], [400, 100, 1000, 760]], np.float32)


def rect_mode(on: bool):
    """``BFF_SAM_RECT`` set to ``1`` or ``0`` inside the block, restored after."""
    return env_set("BFF_SAM_RECT", "1" if on else "0")


def scale_attention_temperature(module, t: float):
    """Scale the q columns of every encoder ``qkv`` projection by ``t`` in
    place (logits scale by ``t``); returns the original tensors."""
    saved = {}
    with torch.no_grad():
        for name, p in module.image_encoder.named_parameters():
            if ".attn.qkv." in f".{name}":
                saved[name] = p.detach().clone()
                p[:p.shape[0] // 3] *= t
    return saved


def restore(module, saved):
    with torch.no_grad():
        params = dict(module.image_encoder.named_parameters())
        for name, value in saved.items():
            params[name].copy_(value)


def measure(sam, frames: torch.Tensor, boxes: np.ndarray, orig_hw, iters: int = 8,
            temps=(1.0,)) -> dict:
    """Square against rect on one SAM-family model: ``frames`` (B, nh, nw, 3)
    uint8 scaled frames on the model's device, ``boxes`` (K, 4) padded-square
    pixels prompted on every frame."""
    dev = frames.device
    b, nh, nw, _ = frames.shape
    frame_idx = np.repeat(np.arange(b), len(boxes))
    all_boxes = np.tile(boxes, (b, 1))
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "dtype": str(sam.dtype).split(".")[-1], "frames": b, "input_hw": [nh, nw],
           "orig_hw": list(orig_hw), "boxes": len(boxes)}
    results = {}
    for rect in (False, True):
        with rect_mode(rect):
            tag = "rect" if rect else "square"
            out[f"encode_ms_{tag}"] = time_ms(lambda: sam.encode_frames(frames), iters, dev)
            if dev.type == "cuda":
                out[f"encode_device_ms_{tag}"] = device_ms(lambda: sam.encode_frames(frames))
            for t in temps:
                saved = scale_attention_temperature(sam.module, t) if t != 1.0 else {}
                emb = sam.encode_frames(frames)
                packed, iou = sam.decode_boxes_packed(emb, frame_idx, all_boxes, (nh, nw),
                                                      orig_hw)
                results[(rect, t)] = (emb.float().cpu().numpy(), packed.cpu().numpy(),
                                      iou.float().cpu().numpy())
                restore(sam.module, saved)
            out[f"grid_{tag}"] = list(results[(rect, 1.0)][0].shape[1:3])
    out["encode_speedup"] = out["encode_ms_square"] / out["encode_ms_rect"]
    n = orig_hw[0] * orig_hw[1]
    for t in temps:
        emb_sq, packed_sq, iou_sq = results[(False, t)]
        emb_r, packed_r, iou_r = results[(True, t)]
        gh, gw = emb_r.shape[1:3]
        valid = emb_sq[:, :gh, :gw]
        bits_sq = np.unpackbits(packed_sq, axis=-1, bitorder="little")[:, :n].astype(bool)
        bits_r = np.unpackbits(packed_r, axis=-1, bitorder="little")[:, :n].astype(bool)
        union = np.logical_or(bits_sq, bits_r).sum(-1)
        inter = np.logical_and(bits_sq, bits_r).sum(-1)
        key = "" if t == 1.0 else f"_temp{t:g}"
        out["emb_rel_l2" + key] = float(np.linalg.norm(emb_r - valid)
                                        / (np.linalg.norm(valid) + 1e-12))
        out["emb_max_abs" + key] = float(np.abs(emb_r - valid).max())
        out["mask_iou" + key] = [float(x) for x in np.where(union == 0, 1.0,
                                                             inter / np.maximum(union, 1))]
        out["iou_pred_delta" + key] = float(np.abs(iou_sq - iou_r).max())
    return out


def build(model: str, preset: str, dtype: torch.dtype, dev: torch.device, seed: int = 0):
    if model == "sam":
        from beyondff_tpu_torch.models import sam as sam_mod

        return sam_mod.SAM.create(preset, seed=seed, dtype=dtype, device=dev)
    from beyondff_tpu_torch.models import efficientsam as esam

    return esam.EfficientSAM.create(preset, seed=seed, dtype=dtype, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description="SAM rect encode: speed and deviation")
    ap.add_argument("--model", choices=("sam", "efficientsam"), default="sam")
    ap.add_argument("--preset", default=None, help="vit_h (SAM) / vits (EfficientSAM) default")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--temp-sweep", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    preset = args.preset or ("vit_h" if args.model == "sam" else "vits")
    sam = build(args.model, preset, getattr(torch, args.dtype), dev)
    s = sam.cfg.img_size
    nh, nw = sam.scaled_hw(FRAME_HW)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 255, (args.batch, nh, nw, 3),
                                           dtype=np.uint8)).to(dev)
    out = measure(sam, frames, BOXES_1024 * (s / 1024), FRAME_HW, args.iters,
                  (1.0, 2.0, 4.0, 8.0) if args.temp_sweep else (1.0,))
    print(json.dumps({"tool": "measure_sam_rect", "model": args.model, "preset": preset, **out}),
          flush=True)


if __name__ == "__main__":
    main()
