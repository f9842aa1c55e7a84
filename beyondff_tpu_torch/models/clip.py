"""CLIP (ViT image tower + causal text tower) in PyTorch.

Port of beyondff_tpu/models/clip.py. Module and parameter names are the
OpenAI checkpoint's (``visual.conv1``, ``visual.transformer.resblocks.{i}``,
``token_embedding``, ...), so ``ViT-L-14.pt``'s state dict loads with
``load_state_dict``. The seg2d stage uses ``encode_image`` for the box-crop
filter and ``encode_text`` for the query embedding. ViT-L/14 at 224 px runs
257 tokens, below the flash cutoff, so its attention stays plain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from beyondff_tpu_torch.core import resize as _resize
from beyondff_tpu_torch.kernels.dispatch import resolve_device
from beyondff_tpu_torch.models.convert_util import load_module, require_file
from beyondff_tpu_torch.models.layers import TransformerBlock, build, quick_gelu
from beyondff_tpu_torch.models.tokenizers import ClipTokenizer, HashTokenizer

# image preprocessing constants (reference: segmentation_2d.py:315-322)
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 768
    image_resolution: int = 224
    vision_layers: int = 24
    vision_width: int = 1024
    vision_heads: int = 16
    vision_patch: int = 14
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 768
    text_heads: int = 12
    text_layers: int = 12


PRESETS = {
    "ViT-L/14": CLIPConfig(),
    "ViT-B/32": CLIPConfig(embed_dim=512, vision_layers=12, vision_width=768,
                           vision_heads=12, vision_patch=32, text_width=512, text_heads=8),
    "ViT-B/16": CLIPConfig(embed_dim=512, vision_layers=12, vision_width=768,
                           vision_heads=12, vision_patch=16, text_width=512, text_heads=8),
    "test": CLIPConfig(embed_dim=32, image_resolution=28, vision_layers=2, vision_width=32,
                       vision_heads=2, vision_patch=14, context_length=16, vocab_size=512,
                       text_width=32, text_heads=2, text_layers=2),
}


def _block(width: int, heads: int) -> TransformerBlock:
    """CLIP residual block: pre-LN, QuickGELU MLP, OpenAI names."""
    return TransformerBlock(width, heads, activation=quick_gelu,
                            ln_names=("ln_1", "ln_2"), mlp_names=("c_fc", "c_proj"))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(_block(width, heads) for _ in range(layers))

    def forward(self, x, mask=None):
        for blk in self.resblocks:
            x = blk(x, mask=mask)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        d = cfg.vision_width
        grid = cfg.image_resolution // cfg.vision_patch
        self.conv1 = nn.Conv2d(3, d, cfg.vision_patch, cfg.vision_patch, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, d))
        self.ln_pre = nn.LayerNorm(d, eps=1e-6)
        self.transformer = Transformer(d, cfg.vision_layers, cfg.vision_heads)
        self.ln_post = nn.LayerNorm(d, eps=1e-6)
        self.proj = nn.Parameter(torch.empty(d, cfg.embed_dim))

    def forward(self, images):  # (B, H, W, 3) normalized
        x = self.conv1(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        b, _, d = x.shape
        cls = self.class_embedding.to(x.dtype).expand(b, 1, d)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0]) @ self.proj.to(x.dtype)


class CLIPModule(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTransformer(cfg)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.text_width))
        self.transformer = Transformer(cfg.text_width, cfg.text_layers, cfg.text_heads)
        self.ln_final = nn.LayerNorm(cfg.text_width, eps=1e-6)
        self.text_projection = nn.Parameter(torch.empty(cfg.text_width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))
        self.init_overrides = {"logit_scale": (float(np.log(1 / 0.07)), 0.0)}

    def encode_image(self, images):
        return self.visual(images)

    def encode_text(self, tokens):  # (B, L) int64
        x = self.token_embedding(tokens)
        n = x.shape[1]
        x = x + self.positional_embedding[:n].to(x.dtype)
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()[None, None]
        x = self.ln_final(self.transformer(x, mask=causal))
        # pool at the EOT token (highest id in each row, like the reference clip)
        eot = tokens.argmax(dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return x @ self.text_projection.to(x.dtype)

    def embed(self, images, tokens):
        """Both towers' features, L2-normalised in the towers' dtype."""
        img = self.encode_image(images)
        txt = self.encode_text(tokens)
        return (img / torch.linalg.vector_norm(img, dim=-1, keepdim=True),
                txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True))

    def logits(self, img, txt):
        """Scaled cosine similarities of normalised features: (Bi, Bt)."""
        return self.logit_scale.exp() * img @ txt.T

    def forward(self, images, tokens):
        """(B, H, W, 3) normalized images, (B, L) tokens -> (B, B) scaled
        cosine similarities (the JAX ``CLIPModule.__call__``), the logits
        the contrastive loss reads."""
        return self.logits(*self.embed(images, tokens))


class CLIP:
    """Inference wrapper: crop preprocessing + both encoders on one device."""

    def __init__(self, cfg: CLIPConfig, module: CLIPModule):
        self.cfg = cfg
        self.module = module
        p = next(module.parameters())
        self.device, self.dtype = p.device, p.dtype
        self._mean = torch.as_tensor(IMAGE_MEAN, device=self.device)
        self._std = torch.as_tensor(IMAGE_STD, device=self.device)

    @classmethod
    def create(cls, name_or_cfg="ViT-L/14", seed: int = 0, dtype=torch.float32,
               device=None) -> "CLIP":
        cfg = PRESETS[name_or_cfg] if isinstance(name_or_cfg, str) else name_or_cfg
        dev = resolve_device(device)
        return cls(cfg, build(lambda: CLIPModule(cfg), dev, dtype, seed))

    def preprocess(self, images: Sequence) -> torch.Tensor:
        """uint8 RGB crops (tensors or arrays) -> (B, n, n, 3) uint8 on the
        model's device: bicubic resize of the short side to n (OpenCV-exact,
        core/resize.py), centre crop (segmentation_2d.py:315-322)."""
        n = self.cfg.image_resolution
        out = []
        for img in images:
            img = torch.as_tensor(img, device=self.device)
            h, w = img.shape[:2]
            scale = n / min(h, w)
            nh, nw = round(h * scale), round(w * scale)
            r = _resize.resize_cubic(img, (nh, nw))
            top, left = (nh - n) // 2, (nw - n) // 2
            out.append(r[top:top + n, left:left + n])
        return torch.stack(out)

    @torch.inference_mode()
    def encode_image(self, images) -> torch.Tensor:
        """(B, H, W, 3) uint8 crops (host or device) -> (B, embed_dim)."""
        x = torch.as_tensor(images, device=self.device).float()
        x = (x / 255.0 - self._mean) / self._std
        return self.module.encode_image(x.to(self.dtype))

    @torch.inference_mode()
    def encode_text(self, tokens) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)
        return self.module.encode_text(t)


# the scalars OpenAI's TorchScript archives carry beside the weights
IGNORED_CHECKPOINT_KEYS = (r"^input_resolution$", r"^context_length$", r"^vocab_size$")


def read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """OpenAI CLIP weights: the TorchScript archive (``ViT-L-14.pt``, fp16
    tensors) or a plain ``torch.save`` file of a state dict or a module."""
    require_file(path, "CLIP")
    try:
        return torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=False)
        return sd.state_dict() if hasattr(sd, "state_dict") else sd


def save_torchscript_archive(state: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``state`` as a TorchScript archive whose ``state_dict()`` gives
    it back under the same dotted names: the container format of OpenAI's
    released ``.pt`` files, for tests and smoke runs that have no download."""
    root = nn.Module()
    for key, val in state.items():
        *path_names, leaf = key.split(".")
        mod = root
        for name in path_names:
            if not hasattr(mod, name):
                mod.add_module(name, nn.Module())
            mod = getattr(mod, name)
        mod.register_buffer(leaf, val)
    torch.jit.save(torch.jit.script(root), path)


def load(model_size: str, checkpoint_path: str, bpe_path: Optional[str] = None,
         dtype=torch.float32, device=None) -> Tuple[CLIP, object]:
    """CLIP from an OpenAI checkpoint, and its tokenizer: ``(model,
    tokenizer)``. fp16 archive tensors widen to float32 and then cast to
    ``dtype``; the tokenizer is :class:`ClipTokenizer` over ``bpe_path``, or
    :class:`HashTokenizer` without one (the JAX package's ``clip.load``)."""
    cfg = PRESETS[model_size]
    module = load_module(lambda: CLIPModule(cfg), read_checkpoint(checkpoint_path),
                         IGNORED_CHECKPOINT_KEYS, resolve_device(device), dtype,
                         context="CLIP checkpoint")
    if bpe_path:
        tokenizer = ClipTokenizer(bpe_path, context_length=cfg.context_length)
    else:
        tokenizer = HashTokenizer(cfg.vocab_size, cfg.context_length)
    return CLIP(cfg, module), tokenizer
