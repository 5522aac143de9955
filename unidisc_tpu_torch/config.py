"""Configuration for the PyTorch port.

The port keeps its own copy of the JAX package's configuration
(``unidisc_tpu/config.py``): the same frozen dataclasses, presets and
experiment overlays, so one dotted override means the same thing on both
sides. ``tests/test_torch_config.py`` fails on any drift between the two.

Fields whose meaning was tied to the TPU map as follows in the port:

  * ``model.attn_backend``: "auto" and "pallas" both mean the hand-written
    attention kernel (``ops/flash_attention.py``) for every unmasked
    self-attention; "xla" means the plain PyTorch attention
    (``ops/attention.py``).
  * ``model.quant_backend`` (with ``model.quant="int8"``): "pallas" means
    the hand-written int8 GEMM (``ops/int8_matmul.py``) for every int8
    product; "xla" means its plain PyTorch version, as ``attn_backend="xla"``
    means the plain attention.
  * ``model.quant_fused``: attn_qkv and mlp.0 of every block take their
    norm and adaLN modulation through the hand-written fused quantize
    kernel (``ops/fused_qmm.py``) on the card, its plain version on the
    CPU.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, replace
from typing import Any, Optional, Tuple

# LLaMA-2 tokenizer: 32000 ids, no mask token -> mask_index = 32000, text
# vocab becomes 32001; LlamaGen VQ-16 image codebook: 16384 ids offset by the
# text vocab size.
LLAMA2_VOCAB = 32000
DEFAULT_TEXT_VOCAB = LLAMA2_VOCAB + 1  # +1 mask token
DEFAULT_IMAGE_VOCAB = 16384


@dataclass(frozen=True)
class ModelConfig:
    """Backbone (DiT) hyperparameters."""

    name: str = "small"
    hidden_size: int = 768
    cond_dim: int = 128
    n_blocks: int = 12
    n_heads: int = 12
    mlp_ratio: int = 4
    dropout: float = 0.1
    attn_dropout: float = 0.0
    # sequence layout: [txt(txt_length) | img(img_length)] (non-interleaved)
    length: int = 1024
    txt_length: int = 128
    img_length: int = 256
    text_vocab_size: int = DEFAULT_TEXT_VOCAB
    image_vocab_size: int = DEFAULT_IMAGE_VOCAB
    # class labels as extra vocab tokens (distinct from cond_label)
    add_labels: Optional[int] = None
    norm_type: str = "layernorm"  # layernorm | rms
    qk_norm: bool = False
    sandwich_normalization: bool = False
    time_conditioning: bool = False
    cond_label: bool = False
    # cross-attention image conditioning (not in the port yet)
    img_cond: bool = False
    cond_image_vocab_size: Optional[int] = None
    cond_length: Optional[int] = None
    n_cond_blocks: int = 8
    cond_img_embed_dim: Optional[int] = None
    rope_2d: bool = False
    # interleaved variable-resolution batches: one 2D rope block per grid
    # size, rope_index absolute into the combined table
    img_resolutions: Optional[Tuple[int, ...]] = None
    img_count_embed: bool = False
    max_images_per_sample: int = 16
    # split text/image embedding tables (not in the port yet)
    split_embed: bool = False
    img_embed_dim: int = 8
    modality_embed: bool = False
    zero_linear_init: bool = True
    full_attention: bool = True  # False => causal (AR mode)
    force_argmax_valid_indices: bool = False
    rope_base: float = 10_000.0
    # "auto" | "pallas": hand-written attention kernel; "xla": plain
    # PyTorch attention (see the module docstring)
    attn_backend: str = "auto"
    # logits dtype: fp32 for training; bf16 halves the logits traffic for
    # inference
    logits_dtype: str = "float32"
    # LoRA fine-tuning (training/lora.py)
    lora_rank: int = 0
    lora_alpha: float = 32.0
    lora_targets: Tuple[str, ...] = ("attn_qkv", "qkv_proj")
    lora_train_full: Tuple[str, ...] = ()
    # inference quantization: None | "int8" (see the module docstring)
    quant: Optional[str] = None
    quant_backend: str = "xla"
    quant_fused: bool = False
    kv_cache_dtype: str = "bf16"
    # activation checkpointing policy: "none" | "dots" | "dots_all"
    # (models/dit.py)
    remat_policy: str = "none"
    mup: bool = False
    mup_base_width: int = 256
    # Mixture-of-Experts MLP (not in the port yet)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    @property
    def vocab_size(self) -> int:
        return (self.text_vocab_size + self.image_vocab_size
                + (self.add_labels or 0))

    @property
    def label_shift(self) -> int:
        """First label token id."""
        assert self.add_labels
        return self.vocab_size - self.add_labels

    @property
    def mask_index(self) -> int:
        return self.text_vocab_size - 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_heads


@dataclass(frozen=True)
class NoiseConfig:
    """Noise schedule."""

    type: str = "loglinear"  # loglinear | cosine | cosinesqr | linear | geometric
    eps: float = 1e-3
    sigma_min: float = 1e-3  # linear/geometric only
    sigma_max: float = 10.0


@dataclass(frozen=True)
class TrainerConfig:
    """Training hyperparameters. The port's train step
    (``training/train_state.py``) takes every optimizer, the four LR
    schedules, the ``subs``, ``ar``, ``sedd`` and ``d3pm``
    parameterizations, add_label, remat, host offload and packed
    interleaved batches."""

    optimizer: str = "adamw"  # adamw | adafactor | lion | ademamix | muon
    grad_accum_steps: int = 1
    lr: float = 3e-4
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    opt_eps: float = 1e-8
    warmup_steps: int = 2500
    lr_schedule: str = "constant_warmup"
    lr_min: float = 1e-6
    warmup_lr_init: float = 0.0
    num_cycles: int = 1
    max_steps: int = 1_000_000
    gradient_clip_val: float = 1.0
    ema_decay: float = 0.9999
    antithetic_sampling: bool = True
    sampling_eps: float = 1e-3
    importance_sampling: bool = False
    softmin_snr: Optional[float] = None
    no_ce_weighting: bool = False
    moe_aux_weight: float = 0.01
    scale_lr_by_batch_size: bool = False
    low_precision_params: bool = False
    host_offload_optimizer: bool = False
    host_offload_chunks: int = 8
    text_loss_weight: Optional[float] = None
    img_loss_weight: Optional[float] = None
    mask_entire_modality: Optional[float] = None
    parameterization: str = "subs"
    ar_shift: bool = False
    joint_ar_nar_prob: Optional[float] = None
    joint_ar_nar_prob_warmup_steps: Optional[int] = None
    ar_llm_loss: bool = False
    ar_inpainting: bool = False
    add_label: bool = False
    first_token_dropout: Optional[float] = None
    change_of_variables: bool = False
    discrete_diffusion_mode: str = "absorbing"
    rand_flip_ar_prob: Optional[float] = None
    rand_ar_modality_dropout: Optional[float] = None
    force_timestep: Optional[float] = None
    ar_inpainting_force_val: Optional[float] = None
    global_batch_size: int = 512
    dtype: str = "bfloat16"
    use_gradient_checkpointing: bool = False
    multimodal_batches: bool = False
    interleaved: bool = False


@dataclass(frozen=True)
class SamplingConfig:
    """Sampler settings."""

    predictor: str = "ddpm_cache"  # ddpm | ddpm_cache | maskgit | maskgit_nucleus | first_hitting
    steps: int = 128
    noise_removal: bool = True
    cfg: Optional[float] = None  # classifier-free guidance weight
    cfg_min_timestep: Optional[float] = None
    cfg_max_timestep: Optional[float] = None
    force_cfg_value: bool = False
    maskgit_r_temp: float = 10.0
    maskgit_mode: str = "arccos"  # root | linear | square | cosine | arccos
    # dilated unmasking: each maskgit step reveals only within one of d^2
    # spatially dilated groups of the image grid. 0 = off.
    maskgit_dilation: int = 0
    # conditioning-frozen t2i sampling (sampling/t2i_fast.py)
    cached_cond: bool = False
    cached_cond_refresh: int = 0
    top_p: Optional[float] = None
    temperature: float = 1.0
    sampling_eps: float = 1e-5


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (``parallel/mesh.py``): one process per device.
    A size of -1 means "all remaining devices"; ``pp_microbatches`` is the
    pipeline's microbatch count under pp > 1."""

    dcn: int = 1
    fsdp: int = -1
    tensor: int = 1
    seq: int = 1
    pp: int = 1
    pp_microbatches: int = 4
    ep: int = 1

    def axis_names(self) -> Tuple[str, ...]:
        return ("dcn", "fsdp", "tensor", "seq", "pp", "ep")


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"
    data_dir: Optional[str] = None
    num_workers: int = 4
    dataset_weights: Optional[Tuple[float, ...]] = None


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    noise: NoiseConfig = field(default_factory=NoiseConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)
    seed: int = 42

    @staticmethod
    def make(model: str = "small", **overrides: Any) -> "Config":
        cfg = Config(model=MODEL_PRESETS[model])
        return cfg.override(**overrides)

    def apply_experiments(self, *names: str) -> "Config":
        """Compose experiment overlays in order."""
        for name in names:
            if name not in EXPERIMENTS:
                raise KeyError(f"unknown experiment {name!r}; "
                               f"have {sorted(EXPERIMENTS)}")
            self = self.override(**EXPERIMENTS[name])
        return self

    def override(self, **overrides: Any) -> "Config":
        """Apply dotted-path overrides, e.g. override(**{"model.n_blocks": 2})."""
        cfg = self
        for key, value in overrides.items():
            parts = key.split(".")
            objs = [cfg]
            for p in parts[:-1]:
                objs.append(getattr(objs[-1], p))
            new = replace(objs[-1], **{parts[-1]: value})
            for obj, p in zip(reversed(objs[:-1]), reversed(parts[:-1])):
                new = replace(obj, **{p: new})
            cfg = new
        return cfg

    def validate(self) -> "Config":
        """Flag-combination legality checks; returns self, raises
        ValueError listing every offending combination."""
        m, t, s = self.model, self.trainer, self.sampling
        errs = []
        if m.hidden_size % m.n_heads != 0:
            errs.append(f"hidden_size {m.hidden_size} not divisible by "
                        f"n_heads {m.n_heads}")
        if not t.interleaved and m.txt_length + m.img_length != m.length:
            errs.append(f"txt_length {m.txt_length} + img_length "
                        f"{m.img_length} != length {m.length} "
                        f"(non-interleaved layout)")
        if t.parameterization == "ar":
            if m.full_attention:
                errs.append("parameterization=ar needs "
                            "model.full_attention=False (causal)")
            if not t.ar_shift:
                errs.append("parameterization=ar needs trainer.ar_shift")
        if t.parameterization not in ("subs", "ar", "sedd", "d3pm"):
            errs.append(f"unknown parameterization {t.parameterization!r}")
        if t.importance_sampling and t.parameterization == "sedd":
            errs.append("sedd excludes importance_sampling")
        if s.maskgit_dilation:
            side = int(round(m.img_length ** 0.5))
            if side * side != m.img_length:
                errs.append(f"maskgit_dilation needs a square image grid; "
                            f"img_length={m.img_length}")
        if s.cfg is not None and s.cfg < 0 and s.cfg != -1:
            errs.append("sampling.cfg must be >= 0 or the sweep "
                        "sentinel -1")
        if t.change_of_variables and t.importance_sampling:
            errs.append("change_of_variables excludes importance_sampling")
        if t.discrete_diffusion_mode not in ("absorbing", "uniform"):
            errs.append(f"unknown discrete_diffusion_mode "
                        f"{t.discrete_diffusion_mode!r}")
        if m.moe_experts > 0:
            if m.moe_top_k < 1:
                errs.append("model.moe_top_k must be >= 1")
            ep = self.mesh.ep
            if ep > 1 and m.moe_experts % ep != 0:
                errs.append(f"model.moe_experts {m.moe_experts} not "
                            f"divisible by mesh.ep {ep}")
            if m.quant is not None and m.quant_fused:
                errs.append("moe_experts excludes quant_fused (the fused "
                            "prologue has no MoE path)")
        elif self.mesh.ep > 1:
            errs.append("mesh.ep > 1 needs model.moe_experts > 0 (the "
                        "'ep' axis only shards MoE expert weights)")
        if t.add_label and not m.add_labels:
            errs.append("trainer.add_label needs model.add_labels > 0")
        if t.first_token_dropout is not None:
            if not t.add_label or not m.add_labels:
                errs.append("first_token_dropout needs trainer.add_label "
                            "and model.add_labels > 0")
            if t.joint_ar_nar_prob is not None:
                errs.append("first_token_dropout excludes "
                            "joint_ar_nar_prob")
            if t.mask_entire_modality is not None:
                errs.append("first_token_dropout excludes "
                            "mask_entire_modality")
        if t.optimizer not in ("adamw", "adafactor", "lion", "ademamix",
                               "muon"):
            errs.append(f"unknown trainer.optimizer {t.optimizer!r}")
        if m.remat_policy not in ("none", "dots", "dots_all"):
            errs.append(f"unknown model.remat_policy {m.remat_policy!r}")
        if m.lora_rank < 0:
            errs.append("model.lora_rank must be >= 0")
        if t.host_offload_optimizer:
            if t.optimizer not in ("adamw", "lion"):
                errs.append("host_offload_optimizer takes adamw or lion "
                            "(its flat chunks hold no per-leaf shapes)")
            if m.mup:
                errs.append("host_offload_optimizer excludes model.mup")
            if t.grad_accum_steps != 1:
                errs.append("host_offload_optimizer excludes grad "
                            "accumulation")
            if m.lora_rank > 0:
                errs.append("host_offload_optimizer excludes LoRA")
            if t.low_precision_params:
                errs.append("host_offload_optimizer excludes "
                            "low_precision_params")
            if t.host_offload_chunks < 1:
                errs.append("host_offload_chunks must be >= 1")
        if m.mup and m.mup_base_width > m.hidden_size:
            errs.append(f"mup_base_width {m.mup_base_width} > hidden_size "
                        f"{m.hidden_size} (transfer goes small -> large)")
        if m.quant not in (None, "int8"):
            errs.append(f"unknown model.quant {m.quant!r}")
        if t.lr_schedule not in ("constant_warmup", "cosine_decay",
                                 "constant_warmup_cosine_decay",
                                 "cosine_hard_restarts"):
            errs.append(f"unknown lr_schedule {t.lr_schedule!r}")
        if m.cond_label and m.time_conditioning:
            errs.append("cond_label and time_conditioning are exclusive "
                        "conditioning paths")
        if m.img_cond:
            if not m.cond_image_vocab_size or not m.cond_length:
                errs.append("img_cond needs cond_image_vocab_size and "
                            "cond_length")
            if m.sandwich_normalization:
                errs.append("img_cond excludes sandwich_normalization")
            if m.qk_norm:
                errs.append("img_cond excludes qk_norm")
            if m.rope_2d or m.img_resolutions is not None:
                errs.append("img_cond supports 1D rope only (rope_2d / "
                            "img_resolutions off)")
            if self.mesh.pp > 1 or self.mesh.seq > 1:
                errs.append("img_cond is not wired through pipeline/"
                            "sequence parallelism")
        if self.mesh.seq > 1 and m.length % self.mesh.seq != 0:
            errs.append(f"model.length {m.length} not divisible by "
                        f"mesh.seq {self.mesh.seq}")
        if self.mesh.pp > 1:
            if m.n_blocks % self.mesh.pp != 0:
                errs.append(f"model.n_blocks {m.n_blocks} not divisible "
                            f"by mesh.pp {self.mesh.pp}")
            if m.dropout > 0:
                errs.append("pipeline parallelism requires model."
                            "dropout=0")
        if m.kv_cache_dtype not in ("bf16", "int8"):
            errs.append(f"unknown model.kv_cache_dtype "
                        f"{m.kv_cache_dtype!r}")
        if errs:
            raise ValueError("invalid configuration:\n  " +
                             "\n  ".join(errs))
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s: str) -> "Config":
        def build(cls, d):
            kwargs = {}
            for f in dataclasses.fields(cls):
                if f.name not in d:
                    continue
                v = d[f.name]
                if f.name in _SECTIONS:
                    kwargs[f.name] = build(_SECTIONS[f.name], v)
                elif isinstance(v, list):
                    kwargs[f.name] = tuple(v)
                else:
                    kwargs[f.name] = v
            return cls(**kwargs)

        return build(Config, json.loads(s))


_SECTIONS = {
    "model": ModelConfig,
    "noise": NoiseConfig,
    "trainer": TrainerConfig,
    "sampling": SamplingConfig,
    "mesh": MeshConfig,
    "data": DataConfig,
}


# Experiment overlays, applied as dotted overrides on top of a preset:
#   Config.make("extra_large").apply_experiments("large_scale_train")
EXPERIMENTS = {
    # production 1.4B recipe
    "large_scale_train": {
        "trainer.global_batch_size": 512,
        "trainer.lr": 1e-4,
        "trainer.warmup_steps": 10_000,
        "trainer.softmin_snr": 5.0,
        "trainer.text_loss_weight": 1.0,
        "trainer.img_loss_weight": 0.6,
        "trainer.mask_entire_modality": 0.15,
        "trainer.use_gradient_checkpointing": True,
        "trainer.multimodal_batches": True,
        "sampling.steps": 128,
        "sampling.cfg": 5.0,
        "model.force_argmax_valid_indices": True,
        "model.norm_type": "rms",
        "model.qk_norm": True,
        "model.sandwich_normalization": True,
        "model.modality_embed": True,
        "model.rope_2d": True,
        "model.time_conditioning": False,
    },
    # VQ-16 text->image 256px layout: 128 txt + 256 img tokens
    "vq16_t2i": {
        "model.length": 384,
        "model.txt_length": 128,
        "model.img_length": 256,
        "model.image_vocab_size": 16384,
    },
    # FID-eval sampling recipe
    "fid_eval": {
        "sampling.predictor": "maskgit",
        "sampling.cfg": 2.0,
        "sampling.steps": 128,
    },
    # AR baseline: causal attention, shifted targets
    "ar_baseline": {
        "trainer.parameterization": "ar",
        "trainer.ar_shift": True,
        "model.full_attention": False,
        "model.time_conditioning": False,
    },
    # dilated unmasking at 8 denoise steps
    "fast_nfe": {
        "sampling.steps": 8,
        "sampling.maskgit_dilation": 2,
        "sampling.predictor": "maskgit",
    },
    # conditioning-frozen t2i serving
    "frozen_cond": {
        "sampling.cached_cond": True,
        "sampling.cached_cond_refresh": 0,
        "sampling.predictor": "maskgit",
    },
    # CFG-distilled serving: one conditional forward per denoise step
    "cfg_distilled": {
        "sampling.cfg": None,
    },
    # cfg_distilled + frozen_cond + fast_nfe
    "distilled_stack": {
        "sampling.cfg": None,
        "sampling.cached_cond": True,
        "sampling.cached_cond_refresh": 0,
        "sampling.steps": 8,
        "sampling.maskgit_dilation": 2,
        "sampling.predictor": "maskgit",
    },
    # 8192-token long-context layout
    "big_seq_len_eval": {
        "model.length": 8192,
        "model.txt_length": 4096,
        "model.img_length": 4096,
        "sampling.steps": 32,
    },
    # interleaved variable-length training
    "interleaved": {
        "trainer.interleaved": True,
        "trainer.multimodal_batches": True,
        "model.modality_embed": True,
        "model.rope_2d": True,
    },
}


# Model size presets (reference configs/model/{small,medium,large,extra_large,xxl}.yaml)
MODEL_PRESETS = {
    "tiny": ModelConfig(name="tiny", hidden_size=128, cond_dim=64, n_blocks=2,
                        n_heads=2, length=48, txt_length=16, img_length=32),
    "small": ModelConfig(name="small", hidden_size=768, cond_dim=128, n_blocks=12,
                         n_heads=12, length=1024, txt_length=128, img_length=896),
    "medium": ModelConfig(name="medium", hidden_size=1024, cond_dim=128, n_blocks=24,
                          n_heads=16, length=1024, txt_length=128, img_length=896),
    "large": ModelConfig(name="large", hidden_size=1280, cond_dim=128, n_blocks=28,
                         n_heads=20, length=1024, txt_length=128, img_length=896),
    # production 1.4B-class config
    "extra_large": ModelConfig(name="extra_large", hidden_size=2048, cond_dim=128,
                               n_blocks=24, n_heads=16, length=384, txt_length=128,
                               img_length=256, qk_norm=True, norm_type="rms",
                               sandwich_normalization=True, modality_embed=True,
                               rope_2d=True, force_argmax_valid_indices=True),
    "xxl": ModelConfig(name="xxl", hidden_size=4096, cond_dim=128, n_blocks=30,
                       n_heads=32, length=1024, txt_length=128, img_length=896),
}


# The flagship text->image serving configuration: the production
# architecture at the "small" width on the VQ-16 t2i layout (128 text +
# 256 image tokens), maskgit with 32 steps and CFG 2.0, bf16 logits.
FLAGSHIP_OVERRIDES = {
    "model.length": 384,
    "model.txt_length": 128,
    "model.img_length": 256,
    "model.time_conditioning": True,
    "model.qk_norm": True,
    "model.norm_type": "rms",
    "model.sandwich_normalization": True,
    "model.modality_embed": True,
    "model.rope_2d": True,
    "model.force_argmax_valid_indices": True,
    "model.dropout": 0.0,
    "model.logits_dtype": "bfloat16",
    "sampling.predictor": "maskgit",
    "sampling.steps": 32,
    "sampling.cfg": 2.0,
}


# The flagship text->image serving configuration in int8 W8A8: every trunk
# and head product through the int8 kernel, the adaLN prologues of attn_qkv
# and mlp.0 through the fused quantize kernel. The model becomes int8 with
# ``build_engine(quantize="int8")`` (``ops/quant.py::quantize_model``).
FLAGSHIP_INT8_OVERRIDES = {
    **FLAGSHIP_OVERRIDES,
    "model.quant_backend": "pallas",
    "model.quant_fused": True,
}


# The flagship training configuration: the flagship model settings
# (``__graft_entry__.py`` ``_flagship_config()``) with fp32 logits, the
# default for training, and the production loss settings of the
# large_scale_train recipe (entire-modality masking 0.15, softmin-SNR 5,
# text/image loss weights 1.0 / 0.6). Everything else keeps the
# TrainerConfig defaults: AdamW, constant_warmup, clip 1.0, EMA 0.9999,
# bf16 compute, no gradient accumulation.
FLAGSHIP_TRAIN_OVERRIDES = {
    **{k: v for k, v in FLAGSHIP_OVERRIDES.items()
       if k.startswith("model.") and k != "model.logits_dtype"},
    "trainer.mask_entire_modality": 0.15,
    "trainer.softmin_snr": 5.0,
    "trainer.text_loss_weight": 1.0,
    "trainer.img_loss_weight": 0.6,
}
