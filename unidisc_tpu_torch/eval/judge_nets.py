"""Judge networks of the evaluation battery (port of
``unidisc_tpu/eval/judge_nets.py``, plus the two networks that the JAX
package takes from ``transformers``, which the card's machine lacks).

Eval-only torch modules whose parameter names match the published files,
so a dropped asset loads as it is:

  * FIDInceptionV3 -- pytorch-fid's modified torchvision InceptionV3
    (``pt_inception-2015-12-05.pt``); a copy of the JAX package's.
  * OpenClipModel -- an open_clip-layout CLIP sized from its state dict
    (the HPSv2 ViT-H-14 checkpoint); a copy of the JAX package's.
  * AestheticPredictor -- the LAION aesthetic v2 MLP head; a copy.
  * CLIPModel -- HuggingFace's ``CLIPModel`` (keys, config.json, math:
    pre-LN encoder layers, quick_gelu, the text pooled at the end token,
    the vision tower's class token after post_layernorm, bias-free
    projections), read from an HF CLIP directory by ``load_clip``;
    ``clip_preprocess`` is its image processor (shortest side resized
    with PIL's bicubic, bit for bit; center crop; rescale; normalize).
  * GPT2LMHeadModel -- HuggingFace's GPT-2 LM (learned positions, pre-LN,
    gelu_new, Conv1D weights stored (in, out), the head tied to the token
    table), read by ``load_gpt2``.

Weights are read from ``model.safetensors`` (through
``models/port.py::read_safetensors``, sharded files through their
index) or ``pytorch_model.bin`` (``torch.load``).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from unidisc_tpu_torch.device import resolve_device


# ---------------------------------------------------------------------------
# pytorch-fid InceptionV3 (torchvision inception_v3 key layout)
# ---------------------------------------------------------------------------

class BasicConv2d(nn.Module):
    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, bias=False, **kw)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)), inplace=True)


class InceptionA(nn.Module):
    """FID variant: avg pool uses count_include_pad=False."""

    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(cin, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(F.avg_pool2d(x, 3, stride=1, padding=1,
                                           count_include_pad=False))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    """FID variant: avg pool uses count_include_pad=False."""

    def __init__(self, cin, channels_7x7):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7),
                                       padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1),
                                       padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1),
                                          padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7),
                                          padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1),
                                          padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7),
                                          padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_5(self.branch7x7dbl_4(self.branch7x7dbl_3(
            self.branch7x7dbl_2(self.branch7x7dbl_1(x)))))
        bp = self.branch_pool(F.avg_pool2d(x, 3, stride=1, padding=1,
                                           count_include_pad=False))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7),
                                         padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1),
                                         padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(
            self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """pool_mode: 'avg' (Mixed_7b / FIDInceptionE_1, count_include_pad
    False) or 'max' (Mixed_7c / FIDInceptionE_2 — the TF FID model's
    quirk: a MAX pool where torchvision has avg)."""

    def __init__(self, cin, pool_mode):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(cin, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(cin, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3),
                                        padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1),
                                        padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3,
                                          padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3),
                                           padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1),
                                           padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd),
                        self.branch3x3dbl_3b(bd)], 1)
        if self.pool_mode == "max":
            p = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            p = F.avg_pool2d(x, 3, stride=1, padding=1,
                             count_include_pad=False)
        return torch.cat([b1, b3, bd, self.branch_pool(p)], 1)


class FIDInceptionV3(nn.Module):
    """pytorch-fid's modified inception_v3 (num_classes=1008,
    aux_logits absent). state_dict keys match the published
    pt_inception-2015-12-05 file (torchvision layout)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, pool_features=32)
        self.Mixed_5c = InceptionA(256, pool_features=64)
        self.Mixed_5d = InceptionA(288, pool_features=64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, channels_7x7=128)
        self.Mixed_6c = InceptionC(768, channels_7x7=160)
        self.Mixed_6d = InceptionC(768, channels_7x7=160)
        self.Mixed_6e = InceptionC(768, channels_7x7=192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool_mode="avg")
        self.Mixed_7c = InceptionE(2048, pool_mode="max")
        self.fc = nn.Linear(2048, 1008)

    def features(self, x):
        """x: (B, 3, H, W) in [0, 1] -> (B, 2048) pool3 features,
        with pytorch-fid's 299-resize + [-1, 1] input scaling."""
        if x.shape[-2:] != (299, 299):
            x = F.interpolate(x, size=(299, 299), mode="bilinear",
                              align_corners=False)
        x = 2 * x - 1
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Mixed_5b(x)
        x = self.Mixed_5c(x)
        x = self.Mixed_5d(x)
        x = self.Mixed_6a(x)
        x = self.Mixed_6b(x)
        x = self.Mixed_6c(x)
        x = self.Mixed_6d(x)
        x = self.Mixed_6e(x)
        x = self.Mixed_7a(x)
        x = self.Mixed_7b(x)
        x = self.Mixed_7c(x)
        x = F.adaptive_avg_pool2d(x, (1, 1))
        return torch.flatten(x, 1)

    def forward(self, x):
        return self.features(x)


# ---------------------------------------------------------------------------
# open_clip-compatible CLIP (HPSv2 checkpoint layout)
# ---------------------------------------------------------------------------

class _QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class ResidualAttentionBlock(nn.Module):
    """open_clip resblock: pre-LN MHA + MLP; key layout
    resblocks.{i}.{ln_1,attn.in_proj_*,attn.out_proj,ln_2,
    mlp.c_fc,mlp.c_proj}."""

    def __init__(self, width, heads, quick_gelu=False):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = nn.MultiheadAttention(width, heads, batch_first=False)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, width * 4))
        self.mlp.add_module("gelu",
                            _QuickGELU() if quick_gelu else nn.GELU())
        self.mlp.add_module("c_proj", nn.Linear(width * 4, width))

    def forward(self, x, attn_mask=None):
        a = self.ln_1(x)
        a = self.attn(a, a, a, need_weights=False, attn_mask=attn_mask)[0]
        x = x + a
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width, layers, heads, quick_gelu=False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, quick_gelu)
             for _ in range(layers)])

    def forward(self, x, attn_mask=None):
        for blk in self.resblocks:
            x = blk(x, attn_mask=attn_mask)
        return x


class VisionTower(nn.Module):
    def __init__(self, image_size, patch, width, layers, heads, embed_dim,
                 quick_gelu=False):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, kernel_size=patch, stride=patch,
                               bias=False)
        n = (image_size // patch) ** 2
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(n + 1, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = Transformer(width, layers, heads, quick_gelu)
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(torch.zeros(width, embed_dim))

    def forward(self, x):
        x = self.conv1(x)                       # (B, W, g, g)
        x = x.flatten(2).transpose(1, 2)        # (B, g*g, W)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.ln_pre(x).transpose(0, 1)      # (L, B, W)
        x = self.transformer(x).transpose(0, 1)
        return self.ln_post(x[:, 0]) @ self.proj


class OpenClipModel(nn.Module):
    """Inference CLIP with open_clip parameter names. Use
    ``from_state_dict`` to size the towers from a checkpoint — loads
    both the real ViT-H-14 HPSv2 weights and tiny random test ones."""

    def __init__(self, *, image_size, patch, v_width, v_layers, v_heads,
                 t_width, t_layers, t_heads, vocab, ctx, embed_dim,
                 quick_gelu=False):
        super().__init__()
        self.visual = VisionTower(image_size, patch, v_width, v_layers,
                                  v_heads, embed_dim, quick_gelu)
        self.token_embedding = nn.Embedding(vocab, t_width)
        self.positional_embedding = nn.Parameter(torch.zeros(ctx, t_width))
        self.transformer = Transformer(t_width, t_layers, t_heads,
                                       quick_gelu)
        self.ln_final = nn.LayerNorm(t_width)
        self.text_projection = nn.Parameter(torch.zeros(t_width, embed_dim))
        self.logit_scale = nn.Parameter(torch.zeros(()))
        mask = torch.full((ctx, ctx), float("-inf")).triu(1)
        self.register_buffer("_causal_mask", mask, persistent=False)

    @staticmethod
    def infer_dims(sd: dict) -> dict:
        """Read tower sizes off an open_clip state_dict."""
        v_width = sd["visual.conv1.weight"].shape[0]
        patch = sd["visual.conv1.weight"].shape[-1]
        n_tok = sd["visual.positional_embedding"].shape[0] - 1
        image_size = patch * int(round(n_tok ** 0.5))
        v_layers = 1 + max(int(k.split(".")[3]) for k in sd
                           if k.startswith("visual.transformer.resblocks."))
        t_width = sd["token_embedding.weight"].shape[1]
        t_layers = 1 + max(int(k.split(".")[2]) for k in sd
                           if k.startswith("transformer.resblocks."))
        return dict(
            image_size=image_size, patch=patch, v_width=v_width,
            v_layers=v_layers, v_heads=max(v_width // 80, 1),
            t_width=t_width, t_layers=t_layers,
            t_heads=max(t_width // 64, 1),
            vocab=sd["token_embedding.weight"].shape[0],
            ctx=sd["positional_embedding"].shape[0],
            embed_dim=sd["text_projection"].shape[1])

    @classmethod
    def from_state_dict(cls, sd: dict, **over) -> "OpenClipModel":
        dims = cls.infer_dims(sd)
        dims.update(over)
        model = cls(**dims)
        missing, unexpected = model.load_state_dict(sd, strict=False)
        missing = [k for k in missing if not k.endswith("_causal_mask")]
        assert not missing, f"missing keys: {missing[:8]}"
        # open_clip checkpoints may carry extras (e.g. the bundled
        # preprocess cfg or score heads) — surface genuinely unknown
        # model weights only
        bad = [k for k in unexpected
               if k.split(".")[0] in ("visual", "transformer",
                                      "token_embedding", "ln_final")]
        assert not bad, f"unmapped keys: {bad[:8]}"
        model.eval()
        return model

    def encode_image(self, images, normalize=True):
        f = self.visual(images)
        return F.normalize(f, dim=-1) if normalize else f

    def encode_text(self, tokens, normalize=True):
        x = self.token_embedding(tokens) + \
            self.positional_embedding[: tokens.shape[1]]
        x = x.transpose(0, 1)
        x = self.transformer(
            x, attn_mask=self._causal_mask[: x.shape[0], : x.shape[0]])
        x = self.ln_final(x.transpose(0, 1))
        # take features at the EOT token (highest id per row, as open_clip)
        f = x[torch.arange(x.shape[0]), tokens.argmax(dim=-1)] \
            @ self.text_projection
        return F.normalize(f, dim=-1) if normalize else f

    def forward(self, images, tokens):
        return {"image_features": self.encode_image(images),
                "text_features": self.encode_text(tokens),
                "logit_scale": self.logit_scale.exp()}


# ---------------------------------------------------------------------------
# LAION aesthetic v2 head
# ---------------------------------------------------------------------------

class AestheticPredictor(nn.Module):
    """MLP over 768-d CLIP ViT-L/14 image embeddings; state keys
    layers.{0,2,4,6,8}.* match the published
    ava+logos-l14-linearMSE.pth (reference:
    unidisc/tokenizers/laion_aesthetic_v2.py:12-29)."""

    def __init__(self, input_size=768):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Linear(input_size, 1024), nn.Dropout(0.2),
            nn.Linear(1024, 128), nn.Dropout(0.2),
            nn.Linear(128, 64), nn.Dropout(0.1),
            nn.Linear(64, 16), nn.Linear(16, 1))

    def forward(self, x):
        return self.layers(x)


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------

def read_hf_weights(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a HF model directory: ``model.safetensors`` (or
    its sharded index), else ``pytorch_model.bin``."""
    from unidisc_tpu_torch.models.port import read_safetensors

    single = os.path.join(path, "model.safetensors")
    index = single + ".index.json"
    if os.path.isfile(single):
        return read_safetensors(single)
    if os.path.isfile(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        out = {}
        for name in files:
            out.update(read_safetensors(os.path.join(path, name)))
        return out
    binary = os.path.join(path, "pytorch_model.bin")
    if os.path.isfile(binary):
        return torch.load(binary, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in "
                            f"{path}")


def read_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def load_strict(module: nn.Module, sd: Dict[str, torch.Tensor],
                ignore=()) -> None:
    """Load `sd` into `module`: every parameter and buffer of the module
    must be there, and nothing else but keys ending in one of `ignore`."""
    sd = {k: v for k, v in sd.items() if not k.endswith(tuple(ignore))}
    missing, unexpected = module.load_state_dict(sd, strict=False)
    if missing or unexpected:
        raise KeyError(f"{type(module).__name__}: missing {missing[:8]}, "
                       f"unexpected {unexpected[:8]}")


def _activation(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name in ("gelu_new", "gelu_pytorch_tanh"):
        return lambda x: 0.5 * x * (1.0 + torch.tanh(
            math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))))
    if name == "gelu":
        return F.gelu
    raise ValueError(f"unsupported activation {name!r}")


def _attention(q, k, v, mask=None) -> torch.Tensor:
    """Softmax attention over (B, H, L, D) in fp32; mask: (B or 1, 1, Lq,
    Lk) bool, True where a query may see a key."""
    w = (q @ k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if mask is not None:
        w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
    return torch.softmax(w, dim=-1) @ v


# ---------------------------------------------------------------------------
# HuggingFace CLIPModel
# ---------------------------------------------------------------------------

# CLIPTextConfig / CLIPVisionConfig / CLIPConfig defaults: a saved
# config.json leaves out the values equal to them
_CLIP_TEXT = dict(vocab_size=49408, hidden_size=512, intermediate_size=2048,
                  num_hidden_layers=12, num_attention_heads=8,
                  max_position_embeddings=77, hidden_act="quick_gelu",
                  layer_norm_eps=1e-5, eos_token_id=49407)
_CLIP_VISION = dict(hidden_size=768, intermediate_size=3072,
                    num_hidden_layers=12, num_attention_heads=12,
                    num_channels=3, image_size=224, patch_size=32,
                    hidden_act="quick_gelu", layer_norm_eps=1e-5)


class _ClipAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, mask=None):
        b, n, d = x.shape
        split = lambda t: t.reshape(b, n, self.heads, -1).transpose(1, 2)
        o = _attention(split(self.q_proj(x)), split(self.k_proj(x)),
                       split(self.v_proj(x)), mask)
        return self.out_proj(o.transpose(1, 2).reshape(b, n, d))


class _ClipMLP(nn.Module):
    def __init__(self, width: int, inner: int, act: str):
        super().__init__()
        self.fc1 = nn.Linear(width, inner)
        self.fc2 = nn.Linear(inner, width)
        self.act = _activation(act)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class _ClipLayer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        w, eps = c["hidden_size"], c["layer_norm_eps"]
        self.self_attn = _ClipAttention(w, c["num_attention_heads"])
        self.layer_norm1 = nn.LayerNorm(w, eps=eps)
        self.mlp = _ClipMLP(w, c["intermediate_size"], c["hidden_act"])
        self.layer_norm2 = nn.LayerNorm(w, eps=eps)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _ClipEncoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layers = nn.ModuleList(_ClipLayer(c)
                                    for _ in range(c["num_hidden_layers"]))

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class _ClipTextEmbeddings(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.token_embedding = nn.Embedding(c["vocab_size"],
                                            c["hidden_size"])
        self.position_embedding = nn.Embedding(
            c["max_position_embeddings"], c["hidden_size"])


class _ClipTextTransformer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.eos_token_id = c["eos_token_id"]
        self.embeddings = _ClipTextEmbeddings(c)
        self.encoder = _ClipEncoder(c)
        self.final_layer_norm = nn.LayerNorm(c["hidden_size"],
                                             eps=c["layer_norm_eps"])

    def forward(self, ids, attention_mask=None):
        b, n = ids.shape
        e = self.embeddings
        x = e.token_embedding(ids) + e.position_embedding(
            torch.arange(n, device=ids.device))[None]
        mask = torch.ones(n, n, dtype=torch.bool,
                          device=ids.device).tril()[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask.bool()[:, None, None, :]
        x = self.final_layer_norm(self.encoder(x, mask))
        # HF's pooling: the highest id when the config's eos_token_id is the
        # legacy 2, else the first end token
        at = ids.argmax(-1) if self.eos_token_id == 2 else \
            (ids == self.eos_token_id).int().argmax(-1)
        return x[torch.arange(b, device=ids.device), at]


class _ClipVisionEmbeddings(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        w, p = c["hidden_size"], c["patch_size"]
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.patch_embedding = nn.Conv2d(c["num_channels"], w, kernel_size=p,
                                         stride=p, bias=False)
        self.position_embedding = nn.Embedding(
            (c["image_size"] // p) ** 2 + 1, w)


class _ClipVisionTransformer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        w, eps = c["hidden_size"], c["layer_norm_eps"]
        self.embeddings = _ClipVisionEmbeddings(c)
        self.pre_layrnorm = nn.LayerNorm(w, eps=eps)
        self.encoder = _ClipEncoder(c)
        self.post_layernorm = nn.LayerNorm(w, eps=eps)

    def forward(self, pixels):
        e = self.embeddings
        x = e.patch_embedding(pixels.to(e.patch_embedding.weight.dtype))
        x = x.flatten(2).transpose(1, 2)
        cls = e.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + e.position_embedding.weight[None]
        x = self.encoder(self.pre_layrnorm(x))
        return self.post_layernorm(x[:, 0])


class CLIPModel(nn.Module):
    """HF ``CLIPModel`` for scoring: ``get_image_features``,
    ``get_text_features`` and ``forward`` (unit embeddings of both)."""

    def __init__(self, config: dict):
        super().__init__()
        text = {**_CLIP_TEXT, **config.get("text_config", {})}
        vision = {**_CLIP_VISION, **config.get("vision_config", {})}
        dim = config.get("projection_dim", 512)
        self.text_model = _ClipTextTransformer(text)
        self.vision_model = _ClipVisionTransformer(vision)
        self.visual_projection = nn.Linear(vision["hidden_size"], dim,
                                           bias=False)
        self.text_projection = nn.Linear(text["hidden_size"], dim,
                                         bias=False)
        self.logit_scale = nn.Parameter(torch.zeros(()))
        self.image_size = vision["image_size"]

    def get_image_features(self, pixel_values):
        return self.visual_projection(self.vision_model(pixel_values))

    def get_text_features(self, input_ids, attention_mask=None):
        return self.text_projection(self.text_model(input_ids,
                                                    attention_mask))

    def forward(self, input_ids, pixel_values, attention_mask=None):
        img = self.get_image_features(pixel_values)
        txt = self.get_text_features(input_ids, attention_mask)
        return (img / img.norm(dim=-1, keepdim=True),
                txt / txt.norm(dim=-1, keepdim=True))


def load_clip(path: str, device="cuda") -> CLIPModel:
    """An HF CLIP directory's model (config.json + weights), in eval mode
    on `device` (the card unless asked for the CPU)."""
    model = CLIPModel(read_config(path))
    load_strict(model, read_hf_weights(path), ignore=("position_ids",))
    return model.to(resolve_device(device)).eval()


# CLIPImageProcessor's defaults
CLIP_PREPROCESS = dict(do_resize=True, size={"shortest_edge": 224},
                        resample=3, do_center_crop=True,
                        crop_size={"height": 224, "width": 224},
                        do_rescale=True, rescale_factor=1 / 255,
                        do_normalize=True,
                        image_mean=[0.48145466, 0.4578275, 0.40821073],
                        image_std=[0.26862954, 0.26130258, 0.27577711])


def read_preprocess(path: str) -> dict:
    """An HF CLIP directory's ``preprocessor_config.json`` over
    CLIPImageProcessor's defaults."""
    conf = dict(CLIP_PREPROCESS)
    p = os.path.join(path, "preprocessor_config.json")
    if os.path.isfile(p):
        with open(p) as f:
            conf.update(json.load(f))
    if conf["do_resize"] and conf["resample"] != 3:
        raise NotImplementedError("only bicubic (resample 3) resizing")
    return conf


def clip_preprocess(images, conf: dict) -> torch.Tensor:
    """(B, H, W, 3) images, cast to uint8 as HF's processor receives them,
    -> (B, 3, h, w) float32 pixel values: CLIPImageProcessor's resize of the
    shortest side (PIL bicubic, bit for bit), center crop, rescale (in
    float64, then float32) and normalize (float32). On the host."""
    from unidisc_tpu_torch.utils.resize import pil_resize_uint8

    out = []
    for img in np.asarray(images):
        img = np.asarray(img, np.uint8)
        if conf["do_resize"]:
            h, w = img.shape[:2]
            short = conf["size"]["shortest_edge"]
            if w <= h:
                size = (int(short * h / w), short)
            else:
                size = (short, int(short * w / h))
            img = pil_resize_uint8(img, size[1], size[0])
        if conf["do_center_crop"]:
            ch, cw = conf["crop_size"]["height"], conf["crop_size"]["width"]
            h, w = img.shape[:2]
            if h < ch or w < cw:
                raise NotImplementedError("center crop larger than the "
                                          "image")
            top, left = (h - ch) // 2, (w - cw) // 2
            img = img[top:top + ch, left:left + cw]
        x = img.astype(np.float32)
        if conf["do_rescale"]:
            x = (img.astype(np.float64) * conf["rescale_factor"]).astype(
                np.float32)
        if conf["do_normalize"]:
            x = (x - np.asarray(conf["image_mean"], np.float32)) / \
                np.asarray(conf["image_std"], np.float32)
        out.append(x.transpose(2, 0, 1))
    return torch.from_numpy(np.ascontiguousarray(np.stack(out)))


# ---------------------------------------------------------------------------
# HuggingFace GPT2LMHeadModel
# ---------------------------------------------------------------------------

_GPT2 = dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
             n_head=12, n_inner=None, activation_function="gelu_new",
             layer_norm_epsilon=1e-5, scale_attn_weights=True,
             scale_attn_by_inverse_layer_idx=False)


class _Conv1D(nn.Module):
    """HF's Conv1D: a linear layer whose weight is stored (in, out)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return torch.addmm(self.bias, x.reshape(-1, x.shape[-1]),
                           self.weight).reshape(*x.shape[:-1], -1)


class _Gpt2Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.heads = c["n_head"]
        self.c_attn = _Conv1D(c["n_embd"], 3 * c["n_embd"])
        self.c_proj = _Conv1D(c["n_embd"], c["n_embd"])

    def forward(self, x):
        b, n, d = x.shape
        q, k, v = (t.reshape(b, n, self.heads, -1).transpose(1, 2)
                   for t in self.c_attn(x).split(d, dim=-1))
        mask = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        o = _attention(q, k, v, mask[None, None])
        return self.c_proj(o.transpose(1, 2).reshape(b, n, d))


class _Gpt2MLP(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        inner = c["n_inner"] or 4 * c["n_embd"]
        self.c_fc = _Conv1D(c["n_embd"], inner)
        self.c_proj = _Conv1D(inner, c["n_embd"])
        self.act = _activation(c["activation_function"])

    def forward(self, x):
        return self.c_proj(self.act(self.c_fc(x)))


class _Gpt2Block(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        eps = c["layer_norm_epsilon"]
        self.ln_1 = nn.LayerNorm(c["n_embd"], eps=eps)
        self.attn = _Gpt2Attention(c)
        self.ln_2 = nn.LayerNorm(c["n_embd"], eps=eps)
        self.mlp = _Gpt2MLP(c)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Gpt2Model(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.wte = nn.Embedding(c["vocab_size"], c["n_embd"])
        self.wpe = nn.Embedding(c["n_positions"], c["n_embd"])
        self.h = nn.ModuleList(_Gpt2Block(c) for _ in range(c["n_layer"]))
        self.ln_f = nn.LayerNorm(c["n_embd"], eps=c["layer_norm_epsilon"])


class GPT2LMHeadModel(nn.Module):
    """HF ``GPT2LMHeadModel`` for judging: ``forward(ids) -> (logits,
    last hidden state after ln_f)``."""

    def __init__(self, config: dict):
        super().__init__()
        c = {**_GPT2, **config}
        if not c["scale_attn_weights"] or \
                c["scale_attn_by_inverse_layer_idx"]:
            raise NotImplementedError("GPT-2 attention scaled other than "
                                      "by 1/sqrt(head_dim)")
        self.n_positions = c["n_positions"]
        self.transformer = _Gpt2Model(c)

    def forward(self, ids):
        t = self.transformer
        if ids.shape[1] > self.n_positions:
            raise ValueError(f"{ids.shape[1]} tokens; the model has "
                             f"{self.n_positions} positions")
        x = t.wte(ids) + t.wpe(torch.arange(ids.shape[1],
                                            device=ids.device))[None]
        for block in t.h:
            x = block(x)
        hidden = t.ln_f(x)
        return hidden @ t.wte.weight.T, hidden


def load_gpt2(path: str, device="cuda") -> GPT2LMHeadModel:
    """An HF GPT-2 directory's LM (config.json + weights; the keys with or
    without the ``transformer.`` prefix, the head tied to the token
    table), in eval mode on `device` (the card unless asked for the
    CPU)."""
    model = GPT2LMHeadModel(read_config(path))
    sd = {k if k.startswith(("transformer.", "lm_head.")) else
          f"transformer.{k}": v for k, v in read_hf_weights(path).items()}
    head = sd.pop("lm_head.weight", None)
    if head is not None and not torch.equal(
            head, sd["transformer.wte.weight"]):
        raise ValueError("lm_head.weight differs from the token table; "
                         "GPT2LMHeadModel ties them")
    load_strict(model, sd, ignore=(".attn.bias", ".attn.masked_bias"))
    return model.to(resolve_device(device)).eval()
