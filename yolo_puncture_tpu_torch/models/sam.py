"""Segment Anything (SAM): ViT image encoder, prompt encoder, mask decoder and the
automatic mask generator, the annotation tool's model.

Counterpart of ``yolo_puncture_tpu/models/sam.py``.  Module names are
segment-anything's own (``image_encoder.blocks.N.attn.qkv|proj|rel_pos_h|rel_pos_w``,
``image_encoder.neck.{0..3}``, ``prompt_encoder.pe_layer``, ``point_embeddings.N``,
``mask_downscaling.{0,1,3,4,6}``, ``mask_decoder.transformer.layers.N.…``,
``output_upscaling.{0,1,3}``, ``output_hypernetworks_mlps.N.layers.M``,
``iou_prediction_head.layers.M``), so a released ``sam_vit_*.pth`` loads strictly
by key (``utils/convert.py load_sam_state_dict``), and ``export_sam_state_dict``
carries the JAX package's variables across.

Where the JAX package and upstream SAM differ, the JAX package is followed:
  * ``decode_points`` always appends one padding point with label −1, and its
    points are pixel-centre coordinates in [0, 1];
  * the generator's stability is ``(m > 1).sum() / max((m > −1).sum(), 1)``
    (``stability_score`` is reported as 1.0), each crop is resized to S×S (the
    aspect ratio squashed), and the best of the three multimask tokens (1..3) is
    chosen by predicted IoU;
  * LayerNorm eps 1e-6 in the encoder blocks, the neck, ``up_ln`` and the mask
    downscaling, 1e-5 in the two-way blocks and ``norm_final_attn``; exact GELU in
    the encoder MLP and the upscaling, ReLU in the decoder MLP;
  * windowed blocks pad the token grid up to a multiple of 14 and crop back; the
    rel-pos tables are sized to the window (windowed blocks) or to the grid
    (global blocks).

The encoder's attention goes through ``F.scaled_dot_product_attention`` (no
Pallas kernel stands behind it in the JAX package); its decomposed
relative-position bias enters as the float mask, (B, heads, N, N): 0.8 GB a
global block for ``vit_b`` at 1024² (4096 tokens), 1.07 GB for ``vit_h``.  The
decoder's attention (a few tokens against the embedding) is written out as
flax's: logits in the compute type, softmax in fp32, cast back.

The generator encodes each crop once and decodes its point batches against that
embedding; the JAX generator's jitted ``run`` re-encodes the crop for every batch
of points.  The outputs are the same, the work is not: the two are not timed alike.
Its host arithmetic is cv2's without cv2: ``ops/resize.py resize_linear_u8``
(``INTER_LINEAR``) for the crops and ``resize_nearest`` (``INTER_NEAREST``) for
the masks pasted back.

A model built with ``dtype=torch.bfloat16`` runs its linear and convolution
layers in bf16 on bf16 weights; LayerNorms keep fp32 parameters, normalise in
fp32 and round to bf16, and the embeddings, tokens and tables stay fp32, as
flax keeps its parameters.

Importing this module registers ``sam`` (``models/__init__.py`` leaves it out,
as the JAX package's does).
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolo_puncture_tpu_torch.registry import register_model

# variant: (embed_dim, depth, num_heads, global_attn_indexes)
_VIT_CFG = {
    "vit_b": (768, 12, 12, (2, 5, 8, 11)),
    "vit_l": (1024, 24, 16, (5, 11, 17, 23)),
    "vit_h": (1280, 32, 16, (7, 15, 23, 31)),
}
PATCH = 16
WINDOW = 14
PROMPT_DIM = 256
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def _wide(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, statistics in fp32 (or wider), its output in
    the model's compute type (``compute_dtype``), as flax's ``LayerNorm(dtype=)``."""

    compute_dtype = torch.float32

    def forward(self, x):
        w = _wide(x)
        return F.layer_norm(x.to(w), self.normalized_shape, self.weight.to(w), self.bias.to(w),
                            self.eps).to(self.compute_dtype)


class LayerNorm2d(LayerNorm):
    """segment-anything's ``LayerNorm2d``: over the channels of an NCHW tensor."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(channels, eps=eps)

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, act=F.gelu):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


# ---------------------------------------------------------------------------
# Image encoder
# ---------------------------------------------------------------------------


def _rel_index(n: int, device) -> torch.Tensor:
    """(n, n) indices i − j + n − 1 into a (2n − 1, hd) table (q and k of one size)."""
    r = torch.arange(n, device=device)
    return r[:, None] - r[None, :] + (n - 1)


class Attention(nn.Module):
    """Encoder attention: fused qkv, decomposed relative-position bias over an
    ``input_size`` grid of tokens (the window, or the whole grid)."""

    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x):  # (B, H, W, C)
        B, H, W, C = x.shape
        nh = self.num_heads
        q, k, v = self.qkv(x).reshape(B, H * W, 3, nh, C // nh).permute(2, 0, 3, 1, 4).unbind(0)  # (B, nh, N, hd)
        rh = self.rel_pos_h[_rel_index(H, x.device)].to(q.dtype)           # (H, H, hd)
        rw = self.rel_pos_w[_rel_index(W, x.device)].to(q.dtype)           # (W, W, hd)
        r_q = q.reshape(B, nh, H, W, -1)
        bias_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rh)                  # (B, nh, H, W, H)
        bias_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rw)                  # (B, nh, H, W, W)
        bias = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(B, nh, H * W, H * W)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)       # softmax(q·kᵀ/√hd + bias) v
        return self.proj(out.transpose(1, 2).reshape(B, H, W, C))


class Block(nn.Module):
    """Pre-norm transformer block; windowed (``window`` > 0) or global attention."""

    def __init__(self, dim: int, num_heads: int, window: int, grid: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, (window, window) if window else (grid, grid))
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, dim * 4)
        self.window = window

    def forward(self, x):  # (B, H, W, C)
        B, H, W, C = x.shape
        y = self.norm1(x)
        w = self.window
        if w:
            ph, pw = (w - H % w) % w, (w - W % w) % w
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
            Hp, Wp = H + ph, W + pw
            y = y.reshape(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, C)
            y = self.attn(y)
            y = y.reshape(B, Hp // w, Wp // w, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)[:, :H, :W]
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, PATCH)

    def forward(self, x):  # (B, 3, S, S) → (B, S/16, S/16, C)
        return self.proj(x).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, variant: str = "vit_b", img_size: int = 1024):
        super().__init__()
        dim, depth, heads, global_idx = _VIT_CFG[variant]
        grid = img_size // PATCH
        self.patch_embed = PatchEmbed(dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, dim))
        self.blocks = nn.ModuleList(Block(dim, heads, 0 if i in global_idx else WINDOW, grid) for i in range(depth))
        self.neck = nn.Sequential(
            nn.Conv2d(dim, PROMPT_DIM, 1, bias=False),
            LayerNorm2d(PROMPT_DIM),
            nn.Conv2d(PROMPT_DIM, PROMPT_DIM, 3, padding=1, bias=False),
            LayerNorm2d(PROMPT_DIM),
        )

    def forward(self, x):  # (B, 3, S, S) normalised → (B, 256, S/16, S/16)
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, :x.shape[1], :x.shape[2]]
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# Prompt encoder
# ---------------------------------------------------------------------------


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier encoding of [0, 1]² coordinates."""

    def __init__(self, num_pos_feats: int = PROMPT_DIM // 2):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.randn(2, num_pos_feats))

    def forward(self, coords_01):  # (..., 2) → (..., 2 · num_pos_feats)
        g = self.positional_encoding_gaussian_matrix
        x = 2 * math.pi * ((2 * coords_01.to(g.dtype) - 1) @ g)
        return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


class PromptEncoder(nn.Module):
    """Point prompts (the mask-prompt layers are carried so that a checkpoint loads whole)."""

    def __init__(self, embed_dim: int = PROMPT_DIM):
        super().__init__()
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))  # neg, pos, box corners
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, 4, 2, 2), LayerNorm2d(4), nn.GELU(),
            nn.Conv2d(4, 16, 2, 2), LayerNorm2d(16), nn.GELU(),
            nn.Conv2d(16, embed_dim, 1),
        )

    def embed_points(self, points_01, labels):
        """points_01 (B, P, 2) in [0, 1] (pixel centres); labels 1 fg, 0 bg, −1 pad."""
        pe = self.pe_layer(points_01)
        lab = labels[..., None]
        pe = torch.where(lab < 0, torch.zeros_like(pe), pe)
        pe = pe + torch.where(lab < 0, self.not_a_point_embed.weight[0], 0.0)
        pe = pe + torch.where(lab == 0, self.point_embeddings[0].weight[0], 0.0)
        return pe + torch.where(lab == 1, self.point_embeddings[1].weight[0], 0.0)

    def dense_pe(self, h: int, w: int) -> torch.Tensor:
        """(h, w, C): the encoding of each embedding pixel's centre."""
        dev = self.no_mask_embed.weight.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        return self.pe_layer(torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1))


# ---------------------------------------------------------------------------
# Mask decoder
# ---------------------------------------------------------------------------


class DecoderAttention(nn.Module):
    """Separate q/k/v/out projections with internal downsampling."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        idim = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, idim)
        self.k_proj = nn.Linear(dim, idim)
        self.v_proj = nn.Linear(dim, idim)
        self.out_proj = nn.Linear(idim, dim)

    def _heads(self, x):
        B, N, C = x.shape
        return x.reshape(B, N, self.num_heads, C // self.num_heads).transpose(1, 2)

    def forward(self, q, k, v):
        q, k, v = self._heads(self.q_proj(q)), self._heads(self.k_proj(k)), self._heads(self.v_proj(v))
        B, nh, N, hd = q.shape
        attn = (q @ k.transpose(-1, -2)) / math.sqrt(hd)                  # rounded to the compute type, as flax's
        out = torch.softmax(attn.float(), -1).to(v.dtype) @ v             # softmax in fp32, cast back
        return self.out_proj(out.transpose(1, 2).reshape(B, N, nh * hd))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int = PROMPT_DIM, num_heads: int = 8, mlp_dim: int = 2048,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.self_attn = DecoderAttention(dim, num_heads)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.cross_attn_token_to_image = DecoderAttention(dim, num_heads, 2)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = MLPBlock(dim, mlp_dim, act=F.relu)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.norm4 = LayerNorm(dim, eps=1e-5)
        self.cross_attn_image_to_token = DecoderAttention(dim, num_heads, 2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, dim: int = PROMPT_DIM, num_heads: int = 8, mlp_dim: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(TwoWayAttentionBlock(dim, num_heads, mlp_dim, skip_first_layer_pe=(i == 0))
                                    for i in range(depth))
        self.final_attn_token_to_image = DecoderAttention(dim, num_heads, 2)
        self.norm_final_attn = LayerNorm(dim, eps=1e-5)

    def forward(self, src, pos_src, tokens):  # src, pos_src (B, HW, C); tokens (B, T, C)
        queries, keys = tokens, src
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, pos_src)
        q, k = queries + tokens, keys + pos_src
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MLP(nn.Module):
    """A ReLU MLP of ``num_layers`` linear layers (the hypernetworks, the IoU head)."""

    def __init__(self, cin: int, hidden: int, cout: int, num_layers: int = 3):
        super().__init__()
        h = [hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip([cin] + h, h + [cout]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, dim: int = PROMPT_DIM, num_multimask_outputs: int = 3):
        super().__init__()
        self.num_mask_tokens = num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, dim)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, dim)
        self.transformer = TwoWayTransformer(dim=dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(dim, dim // 4, 2, 2), LayerNorm2d(dim // 4), nn.GELU(),
            nn.ConvTranspose2d(dim // 4, dim // 8, 2, 2), nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(MLP(dim, dim, dim // 8) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(dim, dim, self.num_mask_tokens)

    def forward(self, image_emb, image_pe, point_emb):
        """image_emb, image_pe (B, C, H, W); point_emb (B, P, C) → masks (B, 4, 4H, 4W), IoU (B, 4)."""
        B, C, H, W = image_emb.shape
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], 0)[None].expand(B, -1, -1)
        tokens = torch.cat([tokens.to(point_emb.dtype), point_emb], 1)
        queries, keys = self.transformer(image_emb.flatten(2).transpose(1, 2), image_pe.flatten(2).transpose(1, 2),
                                         tokens)
        mask_out = queries[:, 1:1 + self.num_mask_tokens]
        up = self.output_upscaling(keys.transpose(1, 2).reshape(B, C, H, W))
        hyper = torch.stack([mlp(mask_out[:, i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)], 1)
        masks = torch.einsum("bmc,bchw->bmhw", hyper.to(up.dtype), up)
        return masks, self.iou_prediction_head(queries[:, 0])


# ---------------------------------------------------------------------------
# SAM
# ---------------------------------------------------------------------------


def _input_to_weight_type(module, args):
    return (args[0].to(module.weight.dtype),) + args[1:]


class SAM(nn.Module):
    """The three parts under segment-anything's prefixes.  ``encode_image`` takes
    normalised NCHW images of ``img_size``²; ``decode_points`` the embedding and
    point prompts."""

    def __init__(self, variant: str = "vit_b", img_size: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.dtype = img_size, dtype
        self.image_encoder = ImageEncoderViT(variant, img_size)
        self.prompt_encoder = PromptEncoder()
        self.mask_decoder = MaskDecoder()
        self._cast(dtype)
        self.eval()

    def _cast(self, dtype: torch.dtype) -> None:
        """Linear and convolution layers in ``dtype`` (each casts its input to its
        weight's type, as flax's ``Dense(dtype=)`` does); LayerNorms compute in fp32
        and round to ``dtype``; embeddings, tokens and tables stay fp32."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(dtype)
                if not getattr(m, "_casts_input", False):
                    m.register_forward_pre_hook(_input_to_weight_type)
                    m._casts_input = True
            elif isinstance(m, LayerNorm):
                m.compute_dtype = dtype

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "SAM":
        """Seeded random init in fp32: LeCun-normal linear and convolution weights,
        zero biases, unit LayerNorms, embeddings, tokens and the Fourier matrix
        N(0, 1), ``pos_embed`` N(0, 0.02²) (the JAX package's initialisers), and
        rel-pos tables N(0, 0.02²) where the JAX package's start at zero, so that
        a seeded model's attention carries a position bias."""
        self._cast(torch.float32)
        for name, m in self.named_modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                w = m.weight
                w.copy_(torch.randn(w.shape, generator=generator) * math.sqrt(1.0 / w[0].numel()))
            elif isinstance(m, nn.ConvTranspose2d):      # (I, O, k, k): fan-in I·k²
                w = m.weight
                w.copy_(torch.randn(w.shape, generator=generator) * math.sqrt(1.0 / (w.shape[0] * w[0, 0].numel())))
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
            elif isinstance(m, Attention):
                for t in (m.rel_pos_h, m.rel_pos_w):
                    t.copy_(0.02 * torch.randn(t.shape, generator=generator))
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)) and m.bias is not None:
                m.bias.zero_()
        pe = self.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix
        pe.copy_(torch.randn(pe.shape, generator=generator))
        pos = self.image_encoder.pos_embed
        pos.copy_(0.02 * torch.randn(pos.shape, generator=generator))
        self._cast(self.dtype)
        return self

    @torch.no_grad()
    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) normalised → (B, 256, S/16, S/16)."""
        return self.image_encoder(image.to(self.dtype))

    @torch.no_grad()
    def decode_points(self, image_emb: torch.Tensor, points_01: torch.Tensor, labels: torch.Tensor):
        """image_emb (B or 1, 256, H, W); points_01 (B, P, 2) in [0, 1]; labels (B, P)
        1 fg, 0 bg, −1 pad → (masks (B, 4, 4H, 4W), IoU (B, 4)).  One (0, 0) point
        with label −1 is appended (segment-anything's ``_embed_points(pad=True)``,
        with which the released checkpoints were trained); the dense prompt is
        ``no_mask_embed``."""
        B = points_01.shape[0]
        points_01 = torch.cat([points_01, points_01.new_zeros((B, 1, 2))], 1)
        labels = torch.cat([labels, labels.new_full((B, 1), -1)], 1)
        pe = self.prompt_encoder.embed_points(points_01, labels)
        H, W = image_emb.shape[2:]
        dense = self.prompt_encoder.dense_pe(H, W).permute(2, 0, 1)[None].expand(B, -1, -1, -1)
        src = image_emb + self.prompt_encoder.no_mask_embed.weight[0][:, None, None]
        return self.mask_decoder(src.expand(B, -1, -1, -1), dense, pe)

    def forward(self, image, points_01, labels):
        return self.decode_points(self.encode_image(image), points_01, labels)


def build_sam(model_type: str = "vit_b", checkpoint: Optional[str] = None, dtype: torch.dtype = torch.float32,
              img_size: int = 1024, device=None) -> SAM:
    """``sam_model_registry`` counterpart: a ``SAM`` on ``device`` (``None``: the card;
    ``"cpu"``), from a segment-anything checkpoint or a random init from seed 0 (the JAX package's ``PRNGKey(0)``).

    ``img_size`` 1024 is the released geometry; at another size a checkpoint's
    ``pos_embed`` and global rel-pos tables are interpolated (with a warning), and
    the generator squashes its crops to that size."""
    from yolo_puncture_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    with dev:                                   # torch's default init runs where the weights will live
        model = SAM(model_type, img_size=img_size, dtype=dtype)
    if checkpoint:
        from yolo_puncture_tpu_torch.utils.convert import extract_state_dict, load_sam_state_dict

        if img_size != 1024:
            warnings.warn(f"SAM img_size={img_size} != released 1024: pos_embed/rel-pos "
                          "tables will be interpolated (non-reference geometry)")
        load_sam_state_dict(model, extract_state_dict(checkpoint))
    else:
        model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(dev).eval()


sam_model_registry = {name: functools.partial(build_sam, name) for name in _VIT_CFG}


# ---------------------------------------------------------------------------
# Automatic mask generation
# ---------------------------------------------------------------------------


class SamAutomaticMaskGenerator:
    """Grid-prompted automatic mask generation, the JAX package's contract:
    ``points_per_side``² points per crop (fewer in deeper crop layers), batches
    of ``points_per_batch`` through the decoder, IoU and stability filters, a box
    NMS within each crop and another across crops.  ``timer`` (a
    ``utils/profiling.py StageTimer``) splits ``generate``'s time into the
    device stages (``resize``, ``encode``, ``decode``: each waits for the card)
    and the host's (``filter``: the scores, boxes and kept masks copied over and
    filtered; ``nms``; ``paste``)."""

    def __init__(self, sam: SAM, points_per_side: int = 32, points_per_batch: int = 64,
                 pred_iou_thresh: float = 0.5, stability_score_thresh: float = 0.6, box_nms_thresh: float = 0.7,
                 crop_n_layers: int = 0, crop_n_points_downscale_factor: int = 1, min_mask_region_area: int = 0,
                 input_size: Optional[int] = None):
        from yolo_puncture_tpu_torch.utils.profiling import StageTimer

        self.sam = sam
        self.points_per_side = points_per_side
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_downscale = crop_n_points_downscale_factor
        self.min_mask_region_area = min_mask_region_area
        self.input_size = input_size or sam.img_size
        self.timer = StageTimer()

    @staticmethod
    def _grid(n: int) -> np.ndarray:
        side = (np.arange(n) + 0.5) / n
        gx, gy = np.meshgrid(side, side)
        return np.stack([gx.ravel(), gy.ravel()], -1)  # (n², 2) in [0, 1]

    @staticmethod
    def _nms_on_boxes(items, thresh):
        """Greedy NMS over (box, score, payload), highest score first (a stable sort)."""
        kept, boxes = [], []
        for box, score, payload in sorted(items, key=lambda t: -t[1]):
            dup = False
            for kb in boxes:
                ix1, iy1 = max(box[0], kb[0]), max(box[1], kb[1])
                ix2, iy2 = min(box[2], kb[2]), min(box[3], kb[3])
                inter = max(0, ix2 - ix1) * max(0, iy2 - iy1)
                union = (box[2] - box[0]) * (box[3] - box[1]) + (kb[2] - kb[0]) * (kb[3] - kb[1]) - inter
                if union > 0 and inter / union > thresh:
                    dup = True
                    break
            if not dup:
                boxes.append(box)
                kept.append((box, score, payload))
        return kept

    def _crops(self, h: int, w: int):
        crops = [(0, 0, w, h, self.points_per_side)]
        for layer in range(1, self.crop_n_layers + 1):
            n = 2 ** layer
            pps = max(1, self.points_per_side // (self.crop_downscale ** layer))
            crops += [(j * w // n, i * h // n, (j + 1) * w // n, (i + 1) * h // n, pps)
                      for i in range(n) for j in range(n)]
        return crops

    def _sync(self, dev: torch.device) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @torch.no_grad()
    def _candidates(self, crop_u8: torch.Tensor, pps: int):
        """One crop on the card: resize, normalise, encode once, decode the point
        batches; → (boolean masks at the decoder's resolution, scores, boxes
        (x1, y1, x2 + 1, y2 + 1) in mask pixels), on the host, of the points that
        pass both filters and whose mask is not empty, in the points' order."""
        from yolo_puncture_tpu_torch.ops.resize import resize_linear_u8

        sam, S, dev = self.sam, self.input_size, crop_u8.device
        with self.timer.stage("resize"):
            img = resize_linear_u8(crop_u8, (S, S)).to(torch.float64)
            mean = torch.tensor(PIXEL_MEAN, dtype=torch.float64, device=dev)
            std = torch.tensor(PIXEL_STD, dtype=torch.float64, device=dev)
            img = ((img - mean) / std).to(torch.float32).permute(2, 0, 1)[None]
            self._sync(dev)
        with self.timer.stage("encode"):
            emb = sam.encode_image(img)
            self._sync(dev)
        pts = torch.from_numpy(self._grid(pps)).to(dev, torch.float32)
        masks, scores, stab_hi, stab_lo, boxes = [], [], [], [], []
        with self.timer.stage("decode"):
            for s in range(0, len(pts), self.points_per_batch):
                chunk = pts[s:s + self.points_per_batch, None, :]
                m, iou = sam.decode_points(emb, chunk, torch.ones(chunk.shape[:2], dtype=torch.int64, device=dev))
                m, iou = m.float(), iou.float()
                best = iou[:, 1:].argmax(-1) + 1
                m = m[torch.arange(len(best), device=dev), best]
                fg = m > 0
                rows, cols = fg.any(2), fg.any(1)
                H, W = fg.shape[1:]
                boxes.append(torch.stack([cols.int().argmax(1), rows.int().argmax(1),
                                          W - cols.flip(1).int().argmax(1), H - rows.flip(1).int().argmax(1),
                                          rows.any(1).int()], 1))
                masks.append(fg)
                scores.append(iou.gather(1, best[:, None])[:, 0])
                stab_hi.append((m > 1.0).sum((1, 2)))
                stab_lo.append((m > -1.0).sum((1, 2)))
            self._sync(dev)
        with self.timer.stage("filter"):            # on the host: scores and boxes copied over and filtered
            scores = torch.cat(scores).tolist()
            hi, lo = torch.cat(stab_hi).tolist(), torch.cat(stab_lo).tolist()
            boxes = torch.cat(boxes).tolist()
            keep = [i for i, sc in enumerate(scores)
                    if sc >= self.pred_iou_thresh and hi[i] / max(lo[i], 1) >= self.stability_score_thresh
                    and boxes[i][4]]
            masks = torch.cat(masks)[torch.tensor(keep, dtype=torch.int64, device=dev)].cpu().numpy()
        return masks, [scores[i] for i in keep], [tuple(boxes[i][:4]) for i in keep]

    def generate(self, image: np.ndarray) -> List[Dict]:
        """image (H, W, 3) uint8 → the kept masks, each a dict with ``segmentation``
        (bool (H, W)), ``bbox`` (x, y, w, h), ``area``, ``predicted_iou``,
        ``crop_box``, ``stability_score`` (1.0) and ``point_coords``."""
        from yolo_puncture_tpu_torch.ops.resize import resize_nearest

        dev = next(self.sam.parameters()).device
        h, w = image.shape[:2]
        frame = torch.from_numpy(np.ascontiguousarray(image)).to(dev)
        all_cands = []
        for cx1, cy1, cx2, cy2, pps in self._crops(h, w):
            ch, cw = cy2 - cy1, cx2 - cx1
            if ch <= 0 or cw <= 0:
                continue
            masks, scores, boxes = self._candidates(frame[cy1:cy2, cx1:cx2].contiguous(), pps)
            with self.timer.stage("nms"):
                mh, mw = masks.shape[1:] if len(masks) else (1, 1)
                for box, score, i in self._nms_on_boxes(list(zip(boxes, scores, range(len(scores)))),
                                                        self.box_nms_thresh):
                    # the full-frame box from the crop-space box: the cross-crop NMS scans no mask
                    fbox = (cx1 + box[0] * cw / mw, cy1 + box[1] * ch / mh, cx1 + box[2] * cw / mw,
                            cy1 + box[3] * ch / mh)
                    all_cands.append((fbox, score, (masks[i], (cx1, cy1, cx2, cy2))))
        results: List[Dict] = []
        with self.timer.stage("nms"):
            kept = self._nms_on_boxes(all_cands, self.box_nms_thresh)
        with self.timer.stage("paste"):
            for _, score, (m, crop_box) in kept:
                cx1, cy1, cx2, cy2 = crop_box
                seg = np.zeros((h, w), bool)
                seg[cy1:cy2, cx1:cx2] = resize_nearest(m, (cy2 - cy1, cx2 - cx1))
                ys, xs = np.where(seg)
                if len(xs) == 0:
                    continue
                area = int(len(xs))
                if self.min_mask_region_area and area < self.min_mask_region_area:
                    continue
                bx1, by1 = int(xs.min()), int(ys.min())
                results.append({
                    "segmentation": seg,
                    "bbox": [bx1, by1, int(xs.max() - bx1 + 1), int(ys.max() - by1 + 1)],
                    "area": area,
                    "predicted_iou": score,
                    "crop_box": list(crop_box),
                    "stability_score": 1.0,
                    "point_coords": [[0, 0]],
                })
        return results


register_model(lambda model_type="vit_b", **kw: SAM(variant=model_type), name="sam")
