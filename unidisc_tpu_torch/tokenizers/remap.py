"""Structural checkpoint key remapping (port of
``unidisc_tpu/tokenizers/remap.py``): load same-architecture torch
checkpoints whose key NAMES follow a foreign convention.

The codec loaders (``tokenizers/{magvit,vqgan,titok}.py``) read the mirror
naming. Published checkpoints of the same architectures (taming /
open-magvit2 / Show-o releases of the MAGVITv2 VQGAN, bytedance's TiTok)
carry the same tensors under other module paths. A torch ``state_dict()``
lists a module's tensors in registration order, and for a fixed
architecture the order of the tensors inside each top-level section
(encoder / decoder / quantizer) is the forward order in both
implementations, so the match is structural:

  1. pair top-level sections by the overlap of their shape multisets;
  2. within each pair, align the two ordered key lists by the longest
     common subsequence of their tensor SHAPES.

Keys that do not align (discriminators, EMA copies, loss buffers in the
foreign file; absent weights on ours) are reported, not guessed.
``auto_remap`` and ``RemapReport`` are the JAX module's numpy code.

The templates give the mirror names and torch shapes in JAX's order, which
decides the alignment: ``conv_mirror_template`` JAX derives from the flax
tree that ``model.init`` returns, whose order is the flax modules'
creation order (a tree that went through ``jax.tree_util`` is key-sorted
and no longer aligns); the port's MAGVIT module registers its submodules
and tensors in that order under those names, so its template is its
state_dict's. ``vqgan_mirror_template`` and ``titok_mirror_template`` are
derived from the config, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch.nn as nn

Shape = Tuple[int, ...]


@dataclass
class RemapReport:
    """What auto_remap did: audit it before trusting a foreign load."""
    mapping: Dict[str, str] = field(default_factory=dict)   # foreign -> mirror
    section_pairs: List[Tuple[str, str]] = field(default_factory=list)
    skipped_foreign: List[str] = field(default_factory=list)
    unmatched_mirror: List[str] = field(default_factory=list)

    @property
    def complete(self) -> bool:
        return not self.unmatched_mirror

    def summary(self) -> str:
        return (f"matched {len(self.mapping)} tensors across "
                f"{len(self.section_pairs)} sections; "
                f"skipped {len(self.skipped_foreign)} foreign keys; "
                f"{len(self.unmatched_mirror)} mirror keys unmatched")


def _section(key: str) -> str:
    return key.split(".", 1)[0] if "." in key else ""


def _shape_multiset(shapes: Sequence[Shape]) -> Dict[Shape, int]:
    out: Dict[Shape, int] = {}
    for s in shapes:
        out[s] = out.get(s, 0) + 1
    return out


def _overlap(a: Dict[Shape, int], b: Dict[Shape, int]) -> int:
    return sum(min(n, b.get(s, 0)) for s, n in a.items())


def _lcs_align(fkeys: List[str], fshapes: List[Shape],
               mkeys: List[str], mshapes: List[Shape]) -> Dict[str, str]:
    """Longest common subsequence over the SHAPE sequences; equal shapes
    match in order."""
    n, m = len(fshapes), len(mshapes)
    # dp[i][j] = LCS length of fshapes[i:], mshapes[j:]
    dp = np.zeros((n + 1, m + 1), dtype=np.int32)
    for i in range(n - 1, -1, -1):
        for j in range(m - 1, -1, -1):
            if fshapes[i] == mshapes[j]:
                dp[i, j] = dp[i + 1, j + 1] + 1
            else:
                dp[i, j] = max(dp[i + 1, j], dp[i, j + 1])
    out: Dict[str, str] = {}
    i = j = 0
    while i < n and j < m:
        if fshapes[i] == mshapes[j]:
            out[fkeys[i]] = mkeys[j]
            i += 1
            j += 1
        elif dp[i + 1, j] >= dp[i, j + 1]:
            i += 1
        else:
            j += 1
    return out


def auto_remap(foreign: Mapping, template: Dict[str, Shape]
               ) -> Tuple[Dict[str, object], RemapReport]:
    """Rename `foreign` (a state_dict as name -> array or tensor, its
    iteration order its registration order) into the mirror convention of
    `template` (mirror name -> torch shape, in mirror registration order).

    Returns (renamed_state_dict, report). Check ``report.complete``: an
    incomplete match means architecture drift, not just naming."""
    f_items = [(k, tuple(v.shape)) for k, v in foreign.items()]
    m_items = list(template.items())

    f_secs: Dict[str, List[int]] = {}
    for idx, (k, _) in enumerate(f_items):
        f_secs.setdefault(_section(k), []).append(idx)
    m_secs: Dict[str, List[int]] = {}
    for idx, (k, _) in enumerate(m_items):
        m_secs.setdefault(_section(k), []).append(idx)

    # pair sections greedily by shape-multiset overlap (identical names
    # pair first at full score)
    pairs: List[Tuple[str, str, int]] = []
    for fs, fidx in f_secs.items():
        fms = _shape_multiset([f_items[i][1] for i in fidx])
        for ms, midx in m_secs.items():
            mms = _shape_multiset([m_items[i][1] for i in midx])
            score = _overlap(fms, mms)
            if score:
                bonus = 1 if fs == ms else 0
                pairs.append((fs, ms, 2 * score + bonus))
    pairs.sort(key=lambda t: -t[2])
    used_f, used_m = set(), set()
    report = RemapReport()
    renamed: Dict[str, object] = {}
    for fs, ms, _score in pairs:
        if fs in used_f or ms in used_m:
            continue
        used_f.add(fs)
        used_m.add(ms)
        report.section_pairs.append((fs, ms))
        fidx, midx = f_secs[fs], m_secs[ms]
        sub = _lcs_align([f_items[i][0] for i in fidx],
                         [f_items[i][1] for i in fidx],
                         [m_items[i][0] for i in midx],
                         [m_items[i][1] for i in midx])
        for fk, mk in sub.items():
            report.mapping[fk] = mk
            renamed[mk] = foreign[fk]

    for k, _ in f_items:
        if k not in report.mapping:
            report.skipped_foreign.append(k)
    matched_m = set(report.mapping.values())
    for k, _ in m_items:
        if k not in matched_m:
            report.unmatched_mirror.append(k)
    return renamed, report


# ---------------------------------------------------------------------------
# mirror templates

def conv_mirror_template(model: nn.Module) -> Dict[str, Shape]:
    """Template of a conv codec module whose names are the mirror's (the
    port's MAGVIT): its state_dict's names and shapes, in its registration
    order."""
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _remapped(state_dict: Mapping, template: Dict[str, Shape]):
    renamed, report = auto_remap(state_dict, template)
    if report.unmatched_mirror:
        raise ValueError(
            "foreign checkpoint does not cover the architecture: "
            + report.summary()
            + f"; first unmatched: {report.unmatched_mirror[:5]}")
    return renamed, report


def load_magvit_foreign(model, state_dict: Mapping):
    """Auto-remap a foreign-named MAGVITv2 checkpoint onto `model`
    (``magvit.MagvitLFQ``). Returns (the state_dict for `model`, report);
    raises if the foreign tensors do not cover the architecture."""
    from unidisc_tpu_torch.tokenizers.magvit import load_torch_state_dict
    renamed, report = _remapped(state_dict, conv_mirror_template(model))
    return load_torch_state_dict(model, renamed), report


def vqgan_mirror_template(cfg) -> Dict[str, Shape]:
    """Expected LlamaGen VQModel state_dict (key -> torch shape), in
    registration order, from a VQConfig: the naming
    ``vqgan.load_torch_state_dict`` reads (public LlamaGen
    tokenizer/tokenizer_image/vq_model.py layout)."""
    out: Dict[str, Shape] = {}

    def conv(name, cout, cin, k):
        out[f"{name}.weight"] = (cout, cin, k, k)
        out[f"{name}.bias"] = (cout,)

    def norm(name, c):
        out[f"{name}.weight"] = (c,)
        out[f"{name}.bias"] = (c,)

    def resblock(name, cin, cout):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cout, cin, 3)
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.nin_shortcut", cout, cin, 1)

    def attn(name, c):
        norm(f"{name}.norm", c)
        for p in ("q", "k", "v", "proj_out"):
            conv(f"{name}.{p}", c, c, 1)

    # encoder
    conv("encoder.conv_in", cfg.ch, 3, 3)
    cin = cfg.ch
    for i, mult in enumerate(cfg.ch_mult):
        cout = cfg.ch * mult
        for j in range(cfg.num_res_blocks):
            resblock(f"encoder.conv_blocks.{i}.res.{j}", cin, cout)
            cin = cout
        if i != len(cfg.ch_mult) - 1:
            conv(f"encoder.conv_blocks.{i}.downsample.conv", cin, cin, 3)
    resblock("encoder.mid.0", cin, cin)
    attn("encoder.mid.1", cin)
    resblock("encoder.mid.2", cin, cin)
    norm("encoder.norm_out", cin)
    conv("encoder.conv_out", cfg.z_channels, cin, 3)

    # decoder
    cin = cfg.ch * cfg.ch_mult[-1]
    conv("decoder.conv_in", cin, cfg.z_channels, 3)
    resblock("decoder.mid.0", cin, cin)
    attn("decoder.mid.1", cin)
    resblock("decoder.mid.2", cin, cin)
    for bi, i in enumerate(reversed(range(len(cfg.ch_mult)))):
        cout = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            resblock(f"decoder.conv_blocks.{bi}.res.{j}", cin, cout)
            cin = cout
        if i != 0:
            conv(f"decoder.conv_blocks.{bi}.upsample.conv", cin, cin, 3)
    norm("decoder.norm_out", cin)
    conv("decoder.conv_out", 3, cin, 3)

    out["quantize.embedding.weight"] = (cfg.codebook_size, cfg.codebook_dim)
    conv("quant_conv", cfg.codebook_dim, cfg.z_channels, 1)
    conv("post_quant_conv", cfg.z_channels, cfg.codebook_dim, 1)
    return out


def titok_mirror_template(cfg) -> Dict[str, Shape]:
    """Expected TiTok mirror state_dict (key -> torch shape) in
    registration order: the root's tensors first, then the submodules
    (the public bytedance/1d-tokenizer ViT layout)."""
    h = cfg.hidden_size
    n = cfg.grid * cfg.grid + cfg.num_latent_tokens
    out: Dict[str, Shape] = {}

    def linear(name, dout, din):
        out[f"{name}.weight"] = (dout, din)
        out[f"{name}.bias"] = (dout,)

    def norm(name):
        out[f"{name}.weight"] = (h,)
        out[f"{name}.bias"] = (h,)

    def vit(prefix):
        for i in range(cfg.n_layers):
            norm(f"{prefix}.{i}.norm1")
            out[f"{prefix}.{i}.attn.in_proj_weight"] = (3 * h, h)
            out[f"{prefix}.{i}.attn.in_proj_bias"] = (3 * h,)
            linear(f"{prefix}.{i}.attn.out_proj", h, h)
            norm(f"{prefix}.{i}.norm2")
            linear(f"{prefix}.{i}.mlp_0", cfg.mlp_ratio * h, h)
            linear(f"{prefix}.{i}.mlp_2", h, cfg.mlp_ratio * h)

    out["enc_pos"] = (n, h)
    out["latent_tokens"] = (cfg.num_latent_tokens, h)
    out["codebook"] = (cfg.codebook_size, cfg.codebook_dim)
    out["mask_token"] = (h,)
    out["dec_pos"] = (n, h)
    out["patch_embed.weight"] = (h, 3, cfg.patch_size, cfg.patch_size)
    out["patch_embed.bias"] = (h,)
    vit("encoder")
    norm("enc_norm")
    linear("to_code", cfg.codebook_dim, h)
    linear("from_code", h, cfg.codebook_dim)
    vit("decoder")
    norm("dec_norm")
    linear("to_pixels", cfg.patch_size * cfg.patch_size * 3, h)
    return out


def load_titok_foreign(model, state_dict: Mapping):
    """Auto-remap a foreign-named TiTok checkpoint onto `model`
    (``titok.TiTok``, whose config gives the template). Returns (the
    state_dict for `model`, report)."""
    from unidisc_tpu_torch.tokenizers.titok import load_torch_state_dict
    renamed, report = _remapped(state_dict, titok_mirror_template(model.cfg))
    return load_torch_state_dict(model, renamed), report


def load_vqgan_foreign(model, state_dict: Mapping):
    """Auto-remap a foreign-named taming-style VQGAN onto `model`
    (``vqgan.VQGAN``, whose config gives the template) through the
    LlamaGen layout ``vqgan.load_torch_state_dict`` reads."""
    from unidisc_tpu_torch.tokenizers.vqgan import load_torch_state_dict
    renamed, report = _remapped(state_dict, vqgan_mirror_template(model.cfg))
    return load_torch_state_dict(model, renamed), report
