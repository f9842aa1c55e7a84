"""Weights carried across from the JAX package's parameter trees.

``gdino_from_jax``, ``sam_from_jax``, ``clip_from_jax``,
``efficientsam_from_jax`` and ``yolo_world_from_jax`` turn a JAX package
parameter tree (nested dicts of arrays, ``{"params": {...}}``, with
``batch_stats`` for YOLO-World) into the port module's ``state_dict``. The
port's modules use the official checkpoint key names, so these are the
inverses of the JAX package's checkpoint converters
(beyondff_tpu/models/gdino/convert.py, the ``convert_torch_checkpoint`` of
``sam``, ``clip``, ``efficientsam`` and ``yolo_world``): they
undo the kernel transposes (flax Dense ``(in, out)`` -> torch ``(out, in)``,
flax conv ``(kh, kw, in, out)`` -> torch ``(out, in, kh, kw)``) and re-fuse
the split q/k/v projections of ``nn.MultiheadAttention``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


class _Writer:
    def __init__(self):
        self.sd: StateDict = {}

    def raw(self, key, x):
        self.sd[key] = _t(x)

    def dense(self, prefix, d, bias=True):
        self.sd[f"{prefix}.weight"] = _t(np.asarray(d["kernel"]).T)
        if bias:
            self.sd[f"{prefix}.bias"] = _t(d["bias"])

    def ln(self, prefix, d):
        self.sd[f"{prefix}.weight"] = _t(d["scale"])
        self.sd[f"{prefix}.bias"] = _t(d["bias"])

    def conv(self, prefix, d, bias=True):
        self.sd[f"{prefix}.weight"] = _t(np.asarray(d["kernel"]).transpose(3, 2, 0, 1))
        if bias:
            self.sd[f"{prefix}.bias"] = _t(d["bias"])

    def mha(self, prefix, d):
        self.sd[f"{prefix}.in_proj_weight"] = _t(np.concatenate(
            [np.asarray(d[n]["kernel"]).T for n in ("q", "k", "v")], 0))
        self.sd[f"{prefix}.in_proj_bias"] = _t(np.concatenate(
            [np.asarray(d[n]["bias"]) for n in ("q", "k", "v")]))
        self.dense(f"{prefix}.out_proj", d["proj"])


def clip_from_jax(params, cfg) -> StateDict:
    """JAX CLIP params -> OpenAI-layout state dict of ``CLIPModule``."""
    p = params["params"]
    w = _Writer()

    def block(prefix, blk):
        w.mha(f"{prefix}.attn", blk["attn"])
        w.ln(f"{prefix}.ln_1", blk["ln1"])
        w.ln(f"{prefix}.ln_2", blk["ln2"])
        w.dense(f"{prefix}.mlp.c_fc", blk["mlp"]["fc1"])
        w.dense(f"{prefix}.mlp.c_proj", blk["mlp"]["fc2"])

    vis = p["visual"]
    w.conv("visual.conv1", vis["patch_embed"]["proj"], bias=False)
    w.raw("visual.class_embedding", vis["class_embedding"])
    w.raw("visual.positional_embedding", vis["positional_embedding"])
    w.ln("visual.ln_pre", vis["ln_pre"])
    w.ln("visual.ln_post", vis["ln_post"])
    w.raw("visual.proj", vis["proj"])
    for i in range(cfg.vision_layers):
        block(f"visual.transformer.resblocks.{i}", vis[f"block{i}"])
    txt = p["text"]
    w.raw("token_embedding.weight", txt["token_embedding"]["embedding"])
    w.raw("positional_embedding", txt["positional_embedding"])
    w.ln("ln_final", txt["ln_final"])
    w.raw("text_projection", txt["text_projection"])
    for i in range(cfg.text_layers):
        block(f"transformer.resblocks.{i}", txt[f"block{i}"])
    w.raw("logit_scale", p["logit_scale"])
    return w.sd


def sam_from_jax(params, cfg) -> StateDict:
    """JAX SAM params -> official-layout state dict of ``SAMModule``."""
    p = params["params"]
    w = _Writer()
    enc = p["encoder"]
    w.conv("image_encoder.patch_embed.proj", enc["patch_embed"])
    w.raw("image_encoder.pos_embed", enc["pos_embed"])
    w.conv("image_encoder.neck.0", enc["neck_conv1"], bias=False)
    w.ln("image_encoder.neck.1", enc["neck_ln1"])
    w.conv("image_encoder.neck.2", enc["neck_conv2"], bias=False)
    w.ln("image_encoder.neck.3", enc["neck_ln2"])
    for i in range(cfg.encoder_depth):
        blk, pfx = enc[f"block{i}"], f"image_encoder.blocks.{i}"
        w.ln(f"{pfx}.norm1", blk["ln1"])
        w.ln(f"{pfx}.norm2", blk["ln2"])
        w.dense(f"{pfx}.attn.qkv", blk["attn"]["qkv"])
        w.dense(f"{pfx}.attn.proj", blk["attn"]["proj"])
        if cfg.use_rel_pos:
            w.raw(f"{pfx}.attn.rel_pos_h", blk["attn"]["rel_pos_h"])
            w.raw(f"{pfx}.attn.rel_pos_w", blk["attn"]["rel_pos_w"])
        w.dense(f"{pfx}.mlp.lin1", blk["mlp"]["fc1"])
        w.dense(f"{pfx}.mlp.lin2", blk["mlp"]["fc2"])

    pr = p["prompt"]
    w.raw("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix", pr["pe_gaussian"])
    for i in range(4):
        w.raw(f"prompt_encoder.point_embeddings.{i}.weight",
              np.asarray(pr["point_embeddings"])[i][None])
    w.raw("prompt_encoder.not_a_point_embed.weight", np.asarray(pr["not_a_point"])[None])
    w.raw("prompt_encoder.no_mask_embed.weight", np.asarray(pr["no_mask"])[None])

    dec = p["decoder"]
    w.raw("mask_decoder.iou_token.weight", dec["iou_token"])
    w.raw("mask_decoder.mask_tokens.weight", dec["mask_tokens"])
    w.conv("mask_decoder.output_upscaling.0", dec["up1"])
    w.ln("mask_decoder.output_upscaling.1", dec["up_ln"])
    w.conv("mask_decoder.output_upscaling.3", dec["up2"])
    w.ln("mask_decoder.transformer.norm_final_attn", dec["ln_final"])

    def attn(prefix, d):
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("proj", "out_proj")):
            w.dense(f"{prefix}.{theirs}", d[ours])

    attn("mask_decoder.transformer.final_attn_token_to_image", dec["final_t2i"])
    for i in range(cfg.decoder_depth):
        blk, pfx = dec[f"block{i}"], f"mask_decoder.transformer.layers.{i}"
        attn(f"{pfx}.self_attn", blk["self_attn"])
        w.ln(f"{pfx}.norm1", blk["ln1"])
        attn(f"{pfx}.cross_attn_token_to_image", blk["cross_t2i"])
        w.ln(f"{pfx}.norm2", blk["ln2"])
        w.dense(f"{pfx}.mlp.lin1", blk["mlp"]["fc1"])
        w.dense(f"{pfx}.mlp.lin2", blk["mlp"]["fc2"])
        w.ln(f"{pfx}.norm3", blk["ln3"])
        attn(f"{pfx}.cross_attn_image_to_token", blk["cross_i2t"])
        w.ln(f"{pfx}.norm4", blk["ln4"])
    for m in range(cfg.num_multimask_outputs + 1):
        for li in range(3):
            w.dense(f"mask_decoder.output_hypernetworks_mlps.{m}.layers.{li}",
                    dec[f"hyper{m}_fc{li}"])
    for li in range(3):
        w.dense(f"mask_decoder.iou_prediction_head.layers.{li}", dec[f"iou_fc{li}"])
    return w.sd


def gdino_from_jax(params, cfg) -> StateDict:
    """JAX Grounding-DINO params -> official-layout state dict of ``GDINOModule``."""
    p = params["params"]
    w = _Writer()

    bk = p["backbone"]
    w.conv("backbone.0.patch_embed.proj", bk["patch_embed"])
    w.ln("backbone.0.patch_embed.norm", bk["patch_norm"])
    for si, depth in enumerate(cfg.swin.depths):
        for bi in range(depth):
            blk, pfx = bk[f"stage{si}_block{bi}"], f"backbone.0.layers.{si}.blocks.{bi}"
            w.ln(f"{pfx}.norm1", blk["ln1"])
            w.ln(f"{pfx}.norm2", blk["ln2"])
            w.dense(f"{pfx}.attn.qkv", blk["attn"]["qkv"])
            w.dense(f"{pfx}.attn.proj", blk["attn"]["proj"])
            w.raw(f"{pfx}.attn.relative_position_bias_table", blk["attn"]["rel_bias_table"])
            w.dense(f"{pfx}.mlp.fc1", blk["mlp_fc1"])
            w.dense(f"{pfx}.mlp.fc2", blk["mlp_fc2"])
        if si < len(cfg.swin.depths) - 1:
            mg = bk[f"merge{si}"]
            w.ln(f"backbone.0.layers.{si}.downsample.norm", mg["norm"])
            w.dense(f"backbone.0.layers.{si}.downsample.reduction", mg["reduction"], bias=False)
    for si in cfg.swin.out_indices:
        w.ln(f"backbone.0.norm{si}", bk[f"out_norm{si}"])

    bt = p["bert"]
    w.raw("bert.embeddings.word_embeddings.weight", bt["word_emb"]["embedding"])
    w.raw("bert.embeddings.position_embeddings.weight", bt["pos_emb"])
    w.raw("bert.embeddings.token_type_embeddings.weight", bt["type_emb"])
    w.ln("bert.embeddings.LayerNorm", bt["emb_ln"])
    for i in range(cfg.bert.layers):
        lyr, pfx = bt[f"layer{i}"], f"bert.encoder.layer.{i}"
        w.dense(f"{pfx}.attention.self.query", lyr["q"])
        w.dense(f"{pfx}.attention.self.key", lyr["k"])
        w.dense(f"{pfx}.attention.self.value", lyr["v"])
        w.dense(f"{pfx}.attention.output.dense", lyr["attn_out"])
        w.ln(f"{pfx}.attention.output.LayerNorm", lyr["ln1"])
        w.dense(f"{pfx}.intermediate.dense", lyr["fc1"])
        w.dense(f"{pfx}.output.dense", lyr["fc2"])
        w.ln(f"{pfx}.output.LayerNorm", lyr["ln2"])

    w.dense("feat_map", p["feat_map"])
    for li in range(cfg.levels):
        w.conv(f"input_proj.{li}.0", p[f"input_proj{li}"])
        w.ln(f"input_proj.{li}.1", p[f"input_gn{li}"])
    w.raw("transformer.level_embed", p["level_embed"])

    def deform(prefix, d):
        for name in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            w.dense(f"{prefix}.{name}", d[name])

    for i in range(cfg.enc_layers):
        enc = p[f"enc{i}"]
        img_p = f"transformer.encoder.layers.{i}"
        deform(f"{img_p}.self_attn", enc["deform"])
        w.ln(f"{img_p}.norm1", enc["img_ln1"])
        w.dense(f"{img_p}.linear1", enc["img_fc1"])
        w.dense(f"{img_p}.linear2", enc["img_fc2"])
        w.ln(f"{img_p}.norm2", enc["img_ln2"])
        txt_p = f"transformer.encoder.text_layers.{i}"
        w.mha(f"{txt_p}.self_attn", enc["text_attn"])
        w.ln(f"{txt_p}.norm1", enc["text_ln1"])
        w.dense(f"{txt_p}.linear1", enc["text_fc1"])
        w.dense(f"{txt_p}.linear2", enc["text_fc2"])
        w.ln(f"{txt_p}.norm2", enc["text_ln2"])
        fus, fus_p = enc["fusion"], f"transformer.encoder.fusion_layers.{i}"
        for name in ("v_proj", "l_proj", "values_v_proj", "values_l_proj",
                     "out_v_proj", "out_l_proj"):
            w.dense(f"{fus_p}.attn.{name}", fus[name])
        w.raw(f"{fus_p}.gamma_v", fus["gamma_v"])
        w.raw(f"{fus_p}.gamma_l", fus["gamma_l"])
        w.ln(f"{fus_p}.layer_norm_v", fus["ln_v"])
        w.ln(f"{fus_p}.layer_norm_l", fus["ln_l"])

    w.dense("transformer.enc_output", p["enc_output"])
    w.ln("transformer.enc_output_norm", p["enc_output_ln"])
    w.raw("transformer.tgt_embed.weight", p["tgt_embed"])
    for i in range(3):
        w.dense(f"transformer.enc_out_bbox_embed.layers.{i}", p["enc_bbox_head"][f"fc{i}"])
    for i in range(cfg.dec_layers):
        dec, pfx = p[f"dec{i}"], f"transformer.decoder.layers.{i}"
        w.mha(f"{pfx}.self_attn", dec["self_attn"])
        w.ln(f"{pfx}.norm2", dec["ln1"])
        w.mha(f"{pfx}.ca_text", dec["text_cross"])
        w.ln(f"{pfx}.catext_norm", dec["ln_text"])
        deform(f"{pfx}.cross_attn", dec["deform"])
        w.ln(f"{pfx}.norm1", dec["ln2"])
        w.dense(f"{pfx}.linear1", dec["fc1"])
        w.dense(f"{pfx}.linear2", dec["fc2"])
        w.ln(f"{pfx}.norm3", dec["ln3"])
    w.ln("transformer.decoder.norm", p["dec_norm"])
    w.dense("transformer.decoder.ref_point_head.layers.0", p["ref_point_fc1"])
    w.dense("transformer.decoder.ref_point_head.layers.1", p["ref_point_fc2"])
    for i in range(3):
        w.dense(f"bbox_embed.0.layers.{i}", p["bbox_head"][f"fc{i}"])
    return w.sd


def efficientsam_from_jax(params, cfg) -> StateDict:
    """JAX EfficientSAM params -> state dict of the port's ``SAMModule``
    (EfficientSAM's parameter tree is SAM's without rel-pos tables; the
    position embedding is the grid the JAX converter keeps)."""
    return sam_from_jax(params, cfg)


# the JAX YOLO-World's submodule per ultralytics layer index (None: the layer
# holds no weights), and its C2f depths at depth multiplier 1
_YOLO_LAYERS = [
    ("stem", "conv"), ("down1", "conv"), ("c2f1", "c2f"), ("down2", "conv"),
    ("c2f2", "c2f"), ("down3", "conv"), ("c2f3", "c2f"), ("down4", "conv"),
    ("c2f4", "c2f"), ("sppf", "sppf"), (None, None), (None, None),
    ("t4", "c2fattn"), (None, None), (None, None), ("t3", "c2fattn"),
    ("pan_d3", "conv"), (None, None), ("t4b", "c2fattn"), ("pan_d4", "conv"),
    (None, None), ("t5", "c2fattn"), (None, "detect"),
]
_YOLO_DEPTHS = {"c2f1": 3, "c2f2": 6, "c2f3": 6, "c2f4": 3,
                "t4": 3, "t3": 3, "t4b": 3, "t5": 3}


def yolo_world_from_jax(variables, cfg) -> StateDict:
    """JAX YOLO-World variables (``params`` and ``batch_stats``) ->
    ultralytics-layout state dict of ``YOLOWorldModule``: the inverse of the
    JAX ``yolo_world.convert_torch_checkpoint``."""
    p, st = variables["params"], variables.get("batch_stats", {})
    w = _Writer()

    def bn(prefix, pp, ss):
        w.sd[f"{prefix}.weight"] = _t(pp["scale"])
        w.sd[f"{prefix}.bias"] = _t(pp["bias"])
        w.sd[f"{prefix}.running_mean"] = _t(ss["mean"])
        w.sd[f"{prefix}.running_var"] = _t(ss["var"])

    def conv_bn(prefix, pp, ss):
        w.conv(f"{prefix}.conv", pp["conv"], bias=False)
        bn(f"{prefix}.bn", pp["bn"], ss["bn"])

    def c2f(prefix, pp, ss, n):
        conv_bn(f"{prefix}.cv1", pp["cv1"], ss["cv1"])
        conv_bn(f"{prefix}.cv2", pp["cv2"], ss["cv2"])
        for j in range(n):
            for cv in ("cv1", "cv2"):
                conv_bn(f"{prefix}.m.{j}.{cv}", pp[f"m{j}"][cv], ss[f"m{j}"][cv])

    def depth(n):
        return max(1, round(n * cfg.depth))

    for i, (name, kind) in enumerate(_YOLO_LAYERS):
        pfx = f"model.{i}"
        if kind == "conv":
            conv_bn(pfx, p[name], st[name])
        elif kind == "sppf":
            conv_bn(f"{pfx}.cv1", p[name]["cv1"], st[name]["cv1"])
            conv_bn(f"{pfx}.cv2", p[name]["cv2"], st[name]["cv2"])
        elif kind in ("c2f", "c2fattn"):
            c2f(pfx, p[name], st[name], depth(_YOLO_DEPTHS[name]))
            if kind == "c2fattn":
                att = p[name]["attn"]
                w.dense(f"{pfx}.attn.gl", att["gl"], bias=False)
                w.raw(f"{pfx}.attn.bias", att["bias"])
                conv_bn(f"{pfx}.attn.proj_conv", att["proj_conv"],
                        st[name]["attn"]["proj_conv"])
        elif kind == "detect":
            for s in range(3):
                for branch, ours in (("cv2", "reg"), ("cv3", "cls")):
                    for j in range(2):
                        conv_bn(f"{pfx}.{branch}.{s}.{j}", p[f"{ours}{s}_{j}"],
                                st[f"{ours}{s}_{j}"])
                    w.conv(f"{pfx}.{branch}.{s}.2", p[f"{ours}{s}_2"])
                w.raw(f"{pfx}.cv4.{s}.bias", p[f"head{s}_bias"])
                w.raw(f"{pfx}.cv4.{s}.logit_scale", p[f"head{s}_logit_scale"])
                if cfg.bn_head:
                    bn(f"{pfx}.cv4.{s}.norm", p[f"head{s}_norm"], st[f"head{s}_norm"])
    return w.sd
