"""Shared transformer building blocks (PyTorch).

Port of beyondff_tpu/models/layers.py. The blocks keep the official
checkpoints' parameter names (``nn.MultiheadAttention``'s fused
``in_proj_weight`` for the CLIP and Grounding-DINO attention, named MLP
layers) so those state dicts load with ``load_state_dict``; the forward
math follows the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` default (tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's GELU variant: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class MLP(nn.Module):
    """Two linear layers with an activation; the layer names are the
    checkpoint's (``fc1``/``fc2``, ``lin1``/``lin2``, ``c_fc``/``c_proj``)."""

    def __init__(self, dim: int, hidden_dim: int, activation: Callable = gelu_tanh,
                 names: Tuple[str, str] = ("fc1", "fc2")):
        super().__init__()
        self.names = names
        self.activation = activation
        self.add_module(names[0], nn.Linear(dim, hidden_dim))
        self.add_module(names[1], nn.Linear(hidden_dim, dim))

    def forward(self, x):
        x = getattr(self, self.names[0])(x)
        return getattr(self, self.names[1])(self.activation(x))


class MLPHead(nn.Module):
    """``layers.{i}`` linears with ReLU between: the checkpoints' box, point
    and hypernetwork heads (Grounding-DINO, SAM)."""

    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class Attention(nn.Module):
    """Multi-head self/cross attention with an optional mask.

    Parameters in ``nn.MultiheadAttention``'s layout (``in_proj_weight``,
    ``in_proj_bias``, ``out_proj``). ``forward(q, kv, v, mask)`` follows the
    JAX ``Attention``: keys default to the queries and values to the keys,
    so positional embeddings can join queries/keys but not values. Routes to
    the flash kernel exactly where the JAX package routes to its Pallas
    kernel (:meth:`_use_flash`), with "on CUDA" in place of "on a TPU".
    """

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, kv=None, v=None, mask=None):
        kv = q if kv is None else kv
        v_in = kv if v is None else v
        dim = q.shape[-1]
        head_dim = dim // self.num_heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        qh = F.linear(q, wq, bq).unflatten(-1, (self.num_heads, head_dim))
        kh = F.linear(kv, wk, bk).unflatten(-1, (self.num_heads, head_dim))
        vh = F.linear(v_in, wv, bv).unflatten(-1, (self.num_heads, head_dim))
        if self._use_flash(qh, kh, mask):
            from beyondff_tpu_torch.kernels import flash_attention as fa

            b, s = qh.shape[:2]
            fq, fk, fv = (t.transpose(1, 2).reshape(b * self.num_heads, s, head_dim)
                          for t in (qh, kh, vh))
            out = fa.attend(fq, fk, fv)
            out = out.reshape(b, self.num_heads, s, head_dim).transpose(1, 2)
            out = out.reshape(b, s, dim)
        else:
            out = attention_plain(qh, kh, vh, mask).flatten(-2)
        return self.out_proj(out)

    @staticmethod
    def _use_flash(qh, kh, mask) -> bool:
        if mask is not None or qh.dim() != 4:
            return False
        if qh.shape[1] != kh.shape[1] or qh.shape[1] < 512:
            return False
        return qh.is_cuda


def attention_plain(qh, kh, vh, mask=None):
    """(..., Sq, heads, d) x (..., Sk, heads, d) -> (..., Sq, heads, d): the
    JAX package's dense path (scale on q, mask with the dtype's min, softmax
    in f32, weights cast back)."""
    scale = qh.shape[-1] ** -0.5
    logits = torch.einsum("...qhd,...khd->...hqk", qh * scale, kh)
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    weights = torch.softmax(logits.float(), dim=-1).to(qh.dtype)
    return torch.einsum("...hqk,...khd->...qhd", weights, vh)


class TransformerBlock(nn.Module):
    """Pre-LN transformer block (CLIP/ViT style); layer names configurable
    to the checkpoint's."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 activation: Callable = gelu_tanh, eps: float = 1e-6,
                 ln_names: Tuple[str, str] = ("ln1", "ln2"),
                 mlp_names: Tuple[str, str] = ("fc1", "fc2")):
        super().__init__()
        self.ln_names = ln_names
        self.add_module(ln_names[0], nn.LayerNorm(dim, eps=eps))
        self.add_module(ln_names[1], nn.LayerNorm(dim, eps=eps))
        self.attn = Attention(dim, num_heads)
        self.mlp = MLP(dim, int(dim * mlp_ratio), activation=activation, names=mlp_names)

    def forward(self, x, mask=None):
        x = x + self.attn(getattr(self, self.ln_names[0])(x), mask=mask)
        return x + self.mlp(getattr(self, self.ln_names[1])(x))


class PatchEmbed(nn.Module):
    """Image (B, H, W, 3) -> patch tokens (B, H', W', D) via a strided conv."""

    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, patch_size)

    def forward(self, x):
        return self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def window_partition(x: torch.Tensor, window: int):
    """(B, H, W, C) -> (B*nW, win, win, C) with zero padding; returns padded hw."""
    b, h, w, c = x.shape
    pad_h, pad_w = (-h) % window, (-w) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c), (hp, wp)


def window_unpartition(x: torch.Tensor, window: int, padded_hw, hw) -> torch.Tensor:
    hp, wp = padded_hw
    h, w = hw
    b = x.shape[0] // ((hp // window) * (wp // window))
    x = x.reshape(b, hp // window, wp // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)[:, :h, :w]


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW conv (or transposed conv) to a channels-last tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def init_weights(module: nn.Module, seed: int = 0) -> nn.Module:
    """Random init from one seeded generator on the module's device: norm
    scales 1 and biases 0; matrices and embeddings N(0, 1/fan_in) (fan_in =
    product of all but the first dim, at least 1); other vectors N(0, 0.02).
    Parameters named in ``module.init_overrides`` (name -> (mean, std)) take
    those instead. Batch-norm statistics (``running_mean``/``running_var``
    buffers) start at 0 and 1."""
    overrides = getattr(module, "init_overrides", {})
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    norm_types = (nn.LayerNorm, nn.GroupNorm)
    norm_params = {id(p) for m in module.modules() if isinstance(m, norm_types)
                   for p in m.parameters(recurse=False)}
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name in overrides:
                mean, std = overrides[name]
                p.copy_(torch.randn(p.shape, generator=gen, device=dev, dtype=torch.float32)
                        * std + mean)
            elif id(p) in norm_params:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias") and p.dim() == 1:
                p.zero_()
            else:
                fan_in = max(1, math.prod(p.shape[1:])) if p.dim() > 1 else 0
                std = fan_in ** -0.5 if fan_in else 0.02
                p.copy_(torch.randn(p.shape, generator=gen, device=dev, dtype=torch.float32)
                        * std)
        for name, b in module.named_buffers():
            if name.endswith("running_mean"):
                b.zero_()
            elif name.endswith("running_var"):
                b.fill_(1.0)
    return module


def build(module_fn, device, dtype=torch.float32, seed: int = 0) -> nn.Module:
    """Create a model directly on ``device``: build on ``meta``, materialize
    with ``to_empty`` and fill with :func:`init_weights` there, so a full-width
    model never passes through host memory."""
    with torch.device("meta"):
        module = module_fn()
    module = module.to_empty(device=device)
    init_weights(module, seed)
    return module.to(dtype).eval().requires_grad_(False)
