"""The port's own copy of the configuration equals the JAX package's:
field names, defaults, presets and experiment overlays, so any drift
between the two fails here."""

import dataclasses

import pytest

from unidisc_tpu import config as jax_config
from unidisc_tpu_torch import config
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

SECTIONS = ["ModelConfig", "NoiseConfig", "TrainerConfig", "SamplingConfig",
            "MeshConfig", "DataConfig", "Config"]


def fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        default = f.default if f.default is not dataclasses.MISSING \
            else f.default_factory()
        out[f.name] = default
    return out


@pytest.mark.parametrize("name", SECTIONS)
def test_sections_have_the_same_fields_and_defaults(name):
    ours, theirs = fields(getattr(config, name)), \
        fields(getattr(jax_config, name))
    assert list(ours) == list(theirs)
    for key in ours:
        a, b = ours[key], theirs[key]
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, key


def test_presets_and_experiments_match():
    assert set(config.MODEL_PRESETS) == set(jax_config.MODEL_PRESETS)
    for name, preset in config.MODEL_PRESETS.items():
        assert dataclasses.asdict(preset) == \
            dataclasses.asdict(jax_config.MODEL_PRESETS[name]), name
    assert config.EXPERIMENTS == jax_config.EXPERIMENTS
    assert config.DEFAULT_TEXT_VOCAB == jax_config.DEFAULT_TEXT_VOCAB
    assert config.DEFAULT_IMAGE_VOCAB == jax_config.DEFAULT_IMAGE_VOCAB


def test_make_override_experiments_and_json_agree():
    over = {"model.n_blocks": 3, "sampling.cfg": 2.0, "seed": 7}
    ours = config.Config.make("small", **over).apply_experiments(
        "vq16_t2i", "fast_nfe")
    theirs = jax_config.Config.make("small", **over).apply_experiments(
        "vq16_t2i", "fast_nfe")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.to_json() == theirs.to_json()
    assert config.Config.from_json(ours.to_json()) == ours
    with pytest.raises(KeyError):
        ours.apply_experiments("no_such_experiment")


def test_flagship_overrides_match_the_benchmark_config():
    """FLAGSHIP_OVERRIDES is __graft_entry__._flagship_config() plus the
    sampling settings bench.py applies."""
    from __graft_entry__ import _flagship_config
    want = _flagship_config().override(**{
        "sampling.predictor": "maskgit", "sampling.steps": 32,
        "sampling.cfg": 2.0, "model.logits_dtype": "bfloat16"})
    ours = config.Config.make("small", **config.FLAGSHIP_OVERRIDES)
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)


@pytest.mark.parametrize("over", [
    {"model.hidden_size": 100, "model.n_heads": 3},
    {"model.txt_length": 10},
    {"trainer.parameterization": "ar"},
    {"sampling.cfg": -2.0},
    {"model.quant": "int4"},
    {"model.cond_label": True, "model.time_conditioning": True},
    {"mesh.ep": 2},
    # the training settings
    {"trainer.add_label": True},
    {"trainer.first_token_dropout": 0.1},
    {"trainer.host_offload_optimizer": True, "model.mup": True},
    {"trainer.host_offload_optimizer": True, "trainer.grad_accum_steps": 2},
    {"trainer.host_offload_optimizer": True, "model.lora_rank": 4},
    {"trainer.host_offload_optimizer": True,
     "trainer.low_precision_params": True},
    {"trainer.host_offload_optimizer": True,
     "trainer.host_offload_chunks": 0},
    {"model.mup": True, "model.mup_base_width": 256},
    # the MoE and img_cond rules
    {"model.moe_experts": 4, "model.moe_top_k": 0},
    {"model.moe_experts": 4, "mesh.ep": 3},
    {"model.moe_experts": 4, "model.quant": "int8",
     "model.quant_fused": True},
    {"model.img_cond": True},
    {"model.img_cond": True, "model.cond_image_vocab_size": 8,
     "model.cond_length": 4, "model.sandwich_normalization": True},
    {"model.img_cond": True, "model.cond_image_vocab_size": 8,
     "model.cond_length": 4, "model.qk_norm": True},
    {"model.img_cond": True, "model.cond_image_vocab_size": 8,
     "model.cond_length": 4, "model.rope_2d": True},
    {"model.img_cond": True, "model.cond_image_vocab_size": 8,
     "model.cond_length": 4, "model.img_resolutions": (4,)},
    {"model.img_cond": True, "model.cond_image_vocab_size": 8,
     "model.cond_length": 4, "mesh.pp": 2, "model.dropout": 0.0},
])
def test_validate_rejects_what_the_jax_config_rejects(over):
    with pytest.raises(ValueError):
        jax_config.Config.make("tiny", **over).validate()
    with pytest.raises(ValueError):
        config.Config.make("tiny", **over).validate()
    config.Config.make("tiny").validate()


@pytest.mark.parametrize("over", [
    {"trainer.optimizer": "sgd"},
    {"model.remat_policy": "everything"},
    {"model.lora_rank": -1},
    {"trainer.host_offload_optimizer": True,
     "trainer.optimizer": "adafactor"},
])
def test_validate_rejects_the_port_training_settings(over):
    """What the JAX package fails on later (an unknown optimizer falls
    back to adamw there; offload asserts its optimizer at init), the
    port's validate rejects."""
    with pytest.raises(ValueError):
        config.Config.make("tiny", **over).validate()
