"""HF-transformers checkpoint compatibility.

The port's copy of beyondff_tpu/models/hf_compat.py. The port's loaders
(:func:`beyondff_tpu_torch.models.gdino.convert.load_torch_checkpoint`,
:func:`beyondff_tpu_torch.models.sam.load_torch_checkpoint`,
:func:`beyondff_tpu_torch.models.clip.load`) read the ORIGINAL releases'
key layouts: pip ``groundingdino`` (``groundingdino_swinb_cogcoor.pth``),
``segment_anything`` (``sam_vit_h_4b8939.pth``) and OpenAI ``clip``. The
same architectures also ship on the HF hub in transformers naming
(``IDEA-Research/grounding-dino-*``, ``facebook/sam-vit-*``,
``openai/clip-vit-*``). These functions rename an HF-format state dict to
the original layout; saved with ``torch.save``, it loads through the same
loaders and their key accounting.

All functions take/return ``dict[str, numpy.ndarray]`` (or torch tensors —
values pass through untouched except explicit merges/transposes, which then
require numpy/tensor semantics shared by both).
"""

from __future__ import annotations

import re
from typing import Dict


def _cat0(parts):
    try:
        import numpy as np

        if isinstance(parts[0], np.ndarray):
            return np.concatenate(parts, axis=0)
    except ImportError:  # pragma: no cover
        pass
    import torch

    return torch.cat(list(parts), dim=0)


def _t(x):
    return x.T if hasattr(x, "T") else x.t()


class _Renamer:
    """Ordered regex rules; q/k/v Linear triples merge into in_proj_*."""

    def __init__(self, rules, merges=(), drops=()):
        self.rules = [(re.compile(p), r) for p, r in rules]
        self.merges = [(re.compile(p), r) for p, r in merges]
        self.drops = [re.compile(p) for p in drops]

    def __call__(self, sd: Dict) -> Dict:
        out: Dict = {}
        pending: Dict = {}
        unmatched = []
        for k, v in sd.items():
            if any(d.search(k) for d in self.drops):
                continue
            hit = False
            for pat, repl in self.merges:
                m = pat.match(k)
                if m:
                    target = m.expand(repl)  # ".../in_proj" style prefix
                    which = {"q": "query", "k": "key", "v": "value"}.get(
                        m.group("which"), m.group("which"))
                    kind = m.group("kind")  # weight | bias
                    pending.setdefault((target, kind), {})[which] = v
                    hit = True
                    break
            if hit:
                continue
            for pat, repl in self.rules:
                if pat.match(k):
                    out[pat.match(k).expand(repl)] = v
                    hit = True
                    break
            if not hit:
                unmatched.append(k)
        if unmatched:
            raise KeyError(
                f"{len(unmatched)} HF keys not covered by the rename map "
                f"(first 10): {unmatched[:10]}")
        for (target, kind), parts in pending.items():
            missing = {"query", "key", "value"} - set(parts)
            if missing:
                raise KeyError(f"incomplete q/k/v triple for {target}: missing {missing}")
            # torch MultiheadAttention fuses as in_proj_weight/in_proj_bias;
            # fused Linears (Swin qkv) use plain .weight/.bias
            sep = "_" if target.endswith("in_proj") else "."
            out[f"{target}{sep}{kind}"] = _cat0(
                [parts["query"], parts["key"], parts["value"]])
        return out


# --------------------------------------------------------------------- GDINO
_SWIN = r"model\.backbone\.conv_encoder\.model"
_gdino_renamer = _Renamer(
    rules=[
        # ---- Swin backbone (HF SwinBackbone -> original gdino SwinTransformer)
        (rf"{_SWIN}\.embeddings\.patch_embeddings\.projection\.(.*)",
         r"backbone.0.patch_embed.proj.\1"),
        (rf"{_SWIN}\.embeddings\.norm\.(.*)", r"backbone.0.patch_embed.norm.\1"),
        (rf"{_SWIN}\.encoder\.layers\.(\d+)\.blocks\.(\d+)\.layernorm_before\.(.*)",
         r"backbone.0.layers.\1.blocks.\2.norm1.\3"),
        (rf"{_SWIN}\.encoder\.layers\.(\d+)\.blocks\.(\d+)\.layernorm_after\.(.*)",
         r"backbone.0.layers.\1.blocks.\2.norm2.\3"),
        (rf"{_SWIN}\.encoder\.layers\.(\d+)\.blocks\.(\d+)\.attention\.self\.relative_position_bias_table",
         r"backbone.0.layers.\1.blocks.\2.attn.relative_position_bias_table"),
        (rf"{_SWIN}\.encoder\.layers\.(\d+)\.blocks\.(\d+)\.attention\.output\.dense\.(.*)",
         r"backbone.0.layers.\1.blocks.\2.attn.proj.\3"),
        (rf"{_SWIN}\.encoder\.layers\.(\d+)\.blocks\.(\d+)\.intermediate\.dense\.(.*)",
         r"backbone.0.layers.\1.blocks.\2.mlp.fc1.\3"),
        (rf"{_SWIN}\.encoder\.layers\.(\d+)\.blocks\.(\d+)\.output\.dense\.(.*)",
         r"backbone.0.layers.\1.blocks.\2.mlp.fc2.\3"),
        (rf"{_SWIN}\.encoder\.layers\.(\d+)\.downsample\.(reduction|norm)\.(.*)",
         r"backbone.0.layers.\1.downsample.\2.\3"),
        # ---- text branch (HF BertModel keys are the original's 'bert.' keys)
        (r"model\.text_backbone\.(.*)", r"bert.\1"),
        (r"model\.text_projection\.(.*)", r"feat_map.\1"),
        # ---- input projections / level embedding
        (r"model\.input_proj_vision\.(\d+)\.(\d+)\.(.*)", r"input_proj.\1.\2.\3"),
        (r"model\.level_embed", r"transformer.level_embed"),
        # ---- encoder (deformable / text enhancer / fusion sublayers)
        (r"model\.encoder\.layers\.(\d+)\.deformable_layer\.self_attn\.(sampling_offsets|attention_weights|value_proj|output_proj)\.(.*)",
         r"transformer.encoder.layers.\1.self_attn.\2.\3"),
        (r"model\.encoder\.layers\.(\d+)\.deformable_layer\.self_attn_layer_norm\.(.*)",
         r"transformer.encoder.layers.\1.norm1.\2"),
        (r"model\.encoder\.layers\.(\d+)\.deformable_layer\.fc1\.(.*)",
         r"transformer.encoder.layers.\1.linear1.\2"),
        (r"model\.encoder\.layers\.(\d+)\.deformable_layer\.fc2\.(.*)",
         r"transformer.encoder.layers.\1.linear2.\2"),
        (r"model\.encoder\.layers\.(\d+)\.deformable_layer\.final_layer_norm\.(.*)",
         r"transformer.encoder.layers.\1.norm2.\2"),
        (r"model\.encoder\.layers\.(\d+)\.text_enhancer_layer\.self_attn\.out_proj\.(.*)",
         r"transformer.encoder.text_layers.\1.self_attn.out_proj.\2"),
        (r"model\.encoder\.layers\.(\d+)\.text_enhancer_layer\.layer_norm_before\.(.*)",
         r"transformer.encoder.text_layers.\1.norm1.\2"),
        (r"model\.encoder\.layers\.(\d+)\.text_enhancer_layer\.layer_norm_after\.(.*)",
         r"transformer.encoder.text_layers.\1.norm2.\2"),
        (r"model\.encoder\.layers\.(\d+)\.text_enhancer_layer\.fc1\.(.*)",
         r"transformer.encoder.text_layers.\1.linear1.\2"),
        (r"model\.encoder\.layers\.(\d+)\.text_enhancer_layer\.fc2\.(.*)",
         r"transformer.encoder.text_layers.\1.linear2.\2"),
        (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.layer_norm_vision\.(.*)",
         r"transformer.encoder.fusion_layers.\1.layer_norm_v.\2"),
        (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.layer_norm_text\.(.*)",
         r"transformer.encoder.fusion_layers.\1.layer_norm_l.\2"),
        (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.attn\.vision_proj\.(.*)",
         r"transformer.encoder.fusion_layers.\1.attn.v_proj.\2"),
        (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.attn\.text_proj\.(.*)",
         r"transformer.encoder.fusion_layers.\1.attn.l_proj.\2"),
        (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.attn\.values_vision_proj\.(.*)",
         r"transformer.encoder.fusion_layers.\1.attn.values_v_proj.\2"),
        (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.attn\.values_text_proj\.(.*)",
         r"transformer.encoder.fusion_layers.\1.attn.values_l_proj.\2"),
        (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.attn\.out_vision_proj\.(.*)",
         r"transformer.encoder.fusion_layers.\1.attn.out_v_proj.\2"),
        (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.attn\.out_text_proj\.(.*)",
         r"transformer.encoder.fusion_layers.\1.attn.out_l_proj.\2"),
        (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.vision_param",
         r"transformer.encoder.fusion_layers.\1.gamma_v"),
        (r"model\.encoder\.layers\.(\d+)\.fusion_layer\.text_param",
         r"transformer.encoder.fusion_layers.\1.gamma_l"),
        # ---- decoder
        (r"model\.decoder\.layers\.(\d+)\.self_attn\.out_proj\.(.*)",
         r"transformer.decoder.layers.\1.self_attn.out_proj.\2"),
        (r"model\.decoder\.layers\.(\d+)\.self_attn_layer_norm\.(.*)",
         r"transformer.decoder.layers.\1.norm2.\2"),
        (r"model\.decoder\.layers\.(\d+)\.encoder_attn_text\.out_proj\.(.*)",
         r"transformer.decoder.layers.\1.ca_text.out_proj.\2"),
        (r"model\.decoder\.layers\.(\d+)\.encoder_attn_text_layer_norm\.(.*)",
         r"transformer.decoder.layers.\1.catext_norm.\2"),
        (r"model\.decoder\.layers\.(\d+)\.encoder_attn\.(sampling_offsets|attention_weights|value_proj|output_proj)\.(.*)",
         r"transformer.decoder.layers.\1.cross_attn.\2.\3"),
        (r"model\.decoder\.layers\.(\d+)\.encoder_attn_layer_norm\.(.*)",
         r"transformer.decoder.layers.\1.norm1.\2"),
        (r"model\.decoder\.layers\.(\d+)\.fc1\.(.*)",
         r"transformer.decoder.layers.\1.linear1.\2"),
        (r"model\.decoder\.layers\.(\d+)\.fc2\.(.*)",
         r"transformer.decoder.layers.\1.linear2.\2"),
        (r"model\.decoder\.layers\.(\d+)\.final_layer_norm\.(.*)",
         r"transformer.decoder.layers.\1.norm3.\2"),
        (r"model\.decoder\.layer_norm\.(.*)", r"transformer.decoder.norm.\1"),
        (r"model\.decoder\.reference_points_head\.layers\.(\d+)\.(.*)",
         r"transformer.decoder.ref_point_head.layers.\1.\2"),
        (r"model\.decoder\.bbox_embed\.(.*)", r"transformer.decoder.bbox_embed.\1"),
        (r"model\.decoder\.class_embed\.(.*)", r"transformer.decoder.class_embed.\1"),
        # ---- two-stage query selection
        (r"model\.enc_output\.(.*)", r"transformer.enc_output.\1"),
        (r"model\.enc_output_norm\.(.*)", r"transformer.enc_output_norm.\1"),
        (r"model\.encoder_output_bbox_embed\.layers\.(\d+)\.(.*)",
         r"transformer.enc_out_bbox_embed.layers.\1.\2"),
        (r"model\.query_position_embeddings\.weight", r"transformer.tgt_embed.weight"),
        # ---- shared per-layer box heads (same top-level name)
        (r"bbox_embed\.(.*)", r"bbox_embed.\1"),
    ],
    merges=[
        (rf"{_SWIN}\.encoder\.layers\.(\d+)\.blocks\.(\d+)\.attention\.self\."
         r"(?P<which>query|key|value)\.(?P<kind>weight|bias)",
         r"backbone.0.layers.\1.blocks.\2.attn.qkv"),
        (r"model\.encoder\.layers\.(\d+)\.text_enhancer_layer\.self_attn\."
         r"(?P<which>query|key|value)\.(?P<kind>weight|bias)",
         r"transformer.encoder.text_layers.\1.self_attn.in_proj"),
        (r"model\.decoder\.layers\.(\d+)\.self_attn\."
         r"(?P<which>query|key|value)\.(?P<kind>weight|bias)",
         r"transformer.decoder.layers.\1.self_attn.in_proj"),
        (r"model\.decoder\.layers\.(\d+)\.encoder_attn_text\."
         r"(?P<which>query|key|value)\.(?P<kind>weight|bias)",
         r"transformer.decoder.layers.\1.ca_text.in_proj"),
    ],
    drops=[
        r"relative_position_index$",
        r"position_ids$",
    ],
)


def gdino_hf_to_original(sd: Dict) -> Dict:
    """HF ``GroundingDinoForObjectDetection`` state dict -> original
    ``groundingdino_swin*.pth`` layout (consumable by
    :func:`beyondff_tpu_torch.models.gdino.convert.load_torch_checkpoint`)."""
    # out-feature norms: HF names them stage{k} (1-based); the original names
    # them norm{k-1} (0-based out_indices)
    pre = {}
    stage_norm = re.compile(
        rf"{_SWIN}\.hidden_states_norms\.stage(\d+)\.(.*)")
    for k, v in sd.items():
        m = stage_norm.match(k)
        if m:
            pre[f"backbone.0.norm{int(m.group(1)) - 1}.{m.group(2)}"] = v
        else:
            pre[k] = v
    out = _gdino_renamer({k: v for k, v in pre.items()
                          if not k.startswith("backbone.0.norm")})
    out.update({k: v for k, v in pre.items() if k.startswith("backbone.0.norm")})
    return out


# ----------------------------------------------------------------------- SAM
def sam_hf_to_original(sd: Dict) -> Dict:
    """HF ``SamModel`` state dict -> official ``sam_vit_*.pth`` layout."""
    renamer = _Renamer(
        rules=[
            (r"shared_image_embedding\.positional_embedding",
             r"prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
            (r"vision_encoder\.patch_embed\.projection\.(.*)",
             r"image_encoder.patch_embed.proj.\1"),
            (r"vision_encoder\.pos_embed", r"image_encoder.pos_embed"),
            (r"vision_encoder\.layers\.(\d+)\.layer_norm1\.(.*)",
             r"image_encoder.blocks.\1.norm1.\2"),
            (r"vision_encoder\.layers\.(\d+)\.layer_norm2\.(.*)",
             r"image_encoder.blocks.\1.norm2.\2"),
            (r"vision_encoder\.layers\.(\d+)\.attn\.(qkv|proj|rel_pos_h|rel_pos_w)(.*)",
             r"image_encoder.blocks.\1.attn.\2\3"),
            (r"vision_encoder\.layers\.(\d+)\.mlp\.(lin1|lin2)\.(.*)",
             r"image_encoder.blocks.\1.mlp.\2.\3"),
            (r"vision_encoder\.neck\.conv1\.(.*)", r"image_encoder.neck.0.\1"),
            (r"vision_encoder\.neck\.layer_norm1\.(.*)", r"image_encoder.neck.1.\1"),
            (r"vision_encoder\.neck\.conv2\.(.*)", r"image_encoder.neck.2.\1"),
            (r"vision_encoder\.neck\.layer_norm2\.(.*)", r"image_encoder.neck.3.\1"),
            (r"prompt_encoder\.point_embed\.(\d+)\.(.*)",
             r"prompt_encoder.point_embeddings.\1.\2"),
            (r"prompt_encoder\.not_a_point_embed\.(.*)",
             r"prompt_encoder.not_a_point_embed.\1"),
            (r"prompt_encoder\.no_mask_embed\.(.*)", r"prompt_encoder.no_mask_embed.\1"),
            # mask prompts are unused by the box-prompted pipeline; keep them
            # under the converter's ignored mask_downscaling prefix
            (r"prompt_encoder\.mask_embed\.conv1\.(.*)",
             r"prompt_encoder.mask_downscaling.0.\1"),
            (r"prompt_encoder\.mask_embed\.layer_norm1\.(.*)",
             r"prompt_encoder.mask_downscaling.1.\1"),
            (r"prompt_encoder\.mask_embed\.conv2\.(.*)",
             r"prompt_encoder.mask_downscaling.3.\1"),
            (r"prompt_encoder\.mask_embed\.layer_norm2\.(.*)",
             r"prompt_encoder.mask_downscaling.4.\1"),
            (r"prompt_encoder\.mask_embed\.conv3\.(.*)",
             r"prompt_encoder.mask_downscaling.6.\1"),
            (r"mask_decoder\.iou_token\.(.*)", r"mask_decoder.iou_token.\1"),
            (r"mask_decoder\.mask_tokens\.(.*)", r"mask_decoder.mask_tokens.\1"),
            (r"mask_decoder\.transformer\.layers\.(\d+)\.layer_norm(\d)\.(.*)",
             r"mask_decoder.transformer.layers.\1.norm\2.\3"),
            (r"mask_decoder\.transformer\.layers\.(\d+)\.(self_attn|cross_attn_token_to_image|cross_attn_image_to_token)\.(.*)",
             r"mask_decoder.transformer.layers.\1.\2.\3"),
            (r"mask_decoder\.transformer\.layers\.(\d+)\.mlp\.(lin1|lin2)\.(.*)",
             r"mask_decoder.transformer.layers.\1.mlp.\2.\3"),
            (r"mask_decoder\.transformer\.final_attn_token_to_image\.(.*)",
             r"mask_decoder.transformer.final_attn_token_to_image.\1"),
            (r"mask_decoder\.transformer\.layer_norm_final_attn\.(.*)",
             r"mask_decoder.transformer.norm_final_attn.\1"),
            (r"mask_decoder\.upscale_conv1\.(.*)", r"mask_decoder.output_upscaling.0.\1"),
            (r"mask_decoder\.upscale_layer_norm\.(.*)",
             r"mask_decoder.output_upscaling.1.\1"),
            (r"mask_decoder\.upscale_conv2\.(.*)", r"mask_decoder.output_upscaling.3.\1"),
            (r"mask_decoder\.output_hypernetworks_mlps\.(\d+)\.proj_in\.(.*)",
             r"mask_decoder.output_hypernetworks_mlps.\1.layers.0.\2"),
            (r"mask_decoder\.output_hypernetworks_mlps\.(\d+)\.layers\.0\.(.*)",
             r"mask_decoder.output_hypernetworks_mlps.\1.layers.1.\2"),
            (r"mask_decoder\.output_hypernetworks_mlps\.(\d+)\.proj_out\.(.*)",
             r"mask_decoder.output_hypernetworks_mlps.\1.layers.2.\2"),
            (r"mask_decoder\.iou_prediction_head\.proj_in\.(.*)",
             r"mask_decoder.iou_prediction_head.layers.0.\1"),
            (r"mask_decoder\.iou_prediction_head\.layers\.0\.(.*)",
             r"mask_decoder.iou_prediction_head.layers.1.\1"),
            (r"mask_decoder\.iou_prediction_head\.proj_out\.(.*)",
             r"mask_decoder.iou_prediction_head.layers.2.\1"),
        ],
        # prompt_encoder.shared_embedding is the same tensor as the top-level
        # shared_image_embedding (HF registers it twice)
        drops=[r"position_ids$",
               r"^prompt_encoder\.shared_embedding\."],
    )
    return renamer(sd)


# ---------------------------------------------------------------------- CLIP
def clip_hf_to_original(sd: Dict) -> Dict:
    """HF ``CLIPModel`` state dict -> OpenAI ``clip`` layout. The two
    projection Linears transpose into the OpenAI matmul-parameter convention."""
    out = {}
    renamer = _Renamer(
        rules=[
            (r"logit_scale", r"logit_scale"),
            (r"text_model\.embeddings\.token_embedding\.weight",
             r"token_embedding.weight"),
            (r"text_model\.embeddings\.position_embedding\.weight",
             r"positional_embedding"),
            (r"text_model\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.(.*)",
             r"transformer.resblocks.\1.attn.out_proj.\2"),
            (r"text_model\.encoder\.layers\.(\d+)\.layer_norm1\.(.*)",
             r"transformer.resblocks.\1.ln_1.\2"),
            (r"text_model\.encoder\.layers\.(\d+)\.layer_norm2\.(.*)",
             r"transformer.resblocks.\1.ln_2.\2"),
            (r"text_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.(.*)",
             r"transformer.resblocks.\1.mlp.c_fc.\2"),
            (r"text_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.(.*)",
             r"transformer.resblocks.\1.mlp.c_proj.\2"),
            (r"text_model\.final_layer_norm\.(.*)", r"ln_final.\1"),
            (r"vision_model\.embeddings\.class_embedding",
             r"visual.class_embedding"),
            (r"vision_model\.embeddings\.patch_embedding\.weight",
             r"visual.conv1.weight"),
            (r"vision_model\.embeddings\.position_embedding\.weight",
             r"visual.positional_embedding"),
            (r"vision_model\.pre_layrnorm\.(.*)", r"visual.ln_pre.\1"),
            (r"vision_model\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.(.*)",
             r"visual.transformer.resblocks.\1.attn.out_proj.\2"),
            (r"vision_model\.encoder\.layers\.(\d+)\.layer_norm1\.(.*)",
             r"visual.transformer.resblocks.\1.ln_1.\2"),
            (r"vision_model\.encoder\.layers\.(\d+)\.layer_norm2\.(.*)",
             r"visual.transformer.resblocks.\1.ln_2.\2"),
            (r"vision_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.(.*)",
             r"visual.transformer.resblocks.\1.mlp.c_fc.\2"),
            (r"vision_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.(.*)",
             r"visual.transformer.resblocks.\1.mlp.c_proj.\2"),
            (r"vision_model\.post_layernorm\.(.*)", r"visual.ln_post.\1"),
        ],
        merges=[
            (r"text_model\.encoder\.layers\.(\d+)\.self_attn\."
             r"(?P<which>q|k|v)_proj\.(?P<kind>weight|bias)",
             r"transformer.resblocks.\1.attn.in_proj"),
            (r"vision_model\.encoder\.layers\.(\d+)\.self_attn\."
             r"(?P<which>q|k|v)_proj\.(?P<kind>weight|bias)",
             r"visual.transformer.resblocks.\1.attn.in_proj"),
        ],
        drops=[r"position_ids$"],
    )
    sd2 = {}
    transposed = {}
    for k, v in sd.items():
        if k == "text_projection.weight":
            transposed["text_projection"] = _t(v)
        elif k == "visual_projection.weight":
            transposed["visual.proj"] = _t(v)
        else:
            sd2[k] = v
    out = renamer(sd2)
    out.update(transposed)
    return out
