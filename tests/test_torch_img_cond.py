"""The port's img_cond cross-attention, split embedding and class-label
conditioning against the JAX package's.

* The img_cond DIT (conditioning trunk, cross-attention in every block)
  with and without ``cond_img_embed_dim``, with and without ``x_cond``, at
  identical weights: logits atol 2e-4 / rtol 1e-3 as
  tests/test_torch_dit.py (fp32 on both sides; the port's trunk and
  cross-attention through the kernels' plain versions, JAX's through
  XLA). The weights' reference names load back through JAX's
  ``port_dit_state_dict``.
* One img_cond train step with ``x_cond`` against ``make_train_step`` at
  tests/test_torch_train_step.py's tolerance; the trunk, the cond table
  and the cross-attention move.
* Sampling through the forward closure over ``x_cond``: maskgit token for
  token under injected noise, and two conditions give different tokens.
* The split-embed and cond_label forwards (mask tokens, label 1000, the
  CFG null slot) at the same tolerance; the training-mode label drop's
  share from a seeded generator.
* A synthetic reference-named split-embed checkpoint served by
  ``build_engine(reference_ckpt=)``; an img_cond one through
  ``reference_dit_state_dict`` (the cond blocks' adaLN tables dropped, the
  cross-attention's attn_qkv_cond kept) equal to JAX's mapping.
* Muon, muP and LoRA routing of the cross-attention and trunk leaves.
* The engine refuses img_cond and cond_label models.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from optax.contrib import MuonDimensionNumbers

from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.models.dit import LabelEmbedder as JaxLabelEmbedder
from unidisc_tpu.models.port import port_dit_state_dict
from unidisc_tpu.sampling import sampler as jax_sampler
from unidisc_tpu.training import lora as jlora
from unidisc_tpu.training import train_state as jts
from unidisc_tpu.training.muon import muon_dimension_numbers
from unidisc_tpu.training.mup import mup_multiplier as jax_mup_multiplier
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.models.dit import DIT, LabelEmbedder, randomize_
from unidisc_tpu_torch.models.port import (dit_state_dict_from_jax,
                                           read_reference_state_dict,
                                           reference_dit_state_dict,
                                           train_state_from_jax)
from unidisc_tpu_torch.sampling import sampler
from unidisc_tpu_torch.serving.engine import build_engine
from unidisc_tpu_torch.training import lora as tlora
from unidisc_tpu_torch.training import train_state as tts
from unidisc_tpu_torch.training.layout import ParamLayout
from unidisc_tpu_torch.training.muon import muon_routes
from unidisc_tpu_torch.training.mup import mup_multipliers

import test_torch_dit as tdit
import test_torch_train_step as tstep

cap_test_threads()

LC, CV = 12, 24      # conditioning positions and vocabulary
IMG_COND = {"model.img_cond": True, "model.cond_image_vocab_size": CV,
            "model.cond_length": LC, "model.n_cond_blocks": 2,
            "model.qk_norm": False, "model.sandwich_normalization": False,
            "model.rope_2d": False}


def abstract_params(jcfg, seed=0, **init_kw):
    """Every parameter of the JAX DIT drawn from its abstract shape (norm
    scales near 1, everything else small), the init called with
    init_kw (x_cond, label)."""
    m = jcfg.model
    shapes = jax.eval_shape(
        lambda k: JaxDIT(m, compute_dtype=jnp.float32).init(
            {"params": k}, jnp.zeros((1, m.length), jnp.int32),
            jnp.zeros((1,)), modality=jnp.zeros((1, m.length), jnp.int32),
            **init_kw)["params"], jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in traverse_util.flatten_dict(shapes, sep="/").items():
        if k.endswith(("weight", "scale")):
            arr = 1.0 + 0.1 * rng.standard_normal(v.shape)
        else:
            fan = v.shape[-2] if len(v.shape) >= 2 else v.shape[-1]
            arr = rng.standard_normal(v.shape) / np.sqrt(fan)
        out[k] = jnp.asarray(arr, jnp.float32)
    return traverse_util.unflatten_dict(out, sep="/")


def x_conds(b, seed=3):
    return np.random.RandomState(seed).randint(0, CV, (b, LC)).astype(
        np.int32)


def img_cond_setup(embed_dim=None, **extra):
    jcfg, tcfg = tdit.configs(**IMG_COND, **{
        "model.cond_img_embed_dim": embed_dim, **extra})
    xc = jnp.zeros((1, LC), jnp.int32)
    return jcfg, tcfg, abstract_params(jcfg, seed=1, x_cond=xc)


@pytest.mark.parametrize("embed_dim", [None, 8], ids=["table", "proj"])
def test_img_cond_forward_matches_jax(embed_dim):
    jcfg, tcfg, params = img_cond_setup(embed_dim)
    ids, sigma, modality = tdit.inputs(jcfg.model)
    xc = x_conds(tdit.B)
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    model = tdit.port_model(tcfg, params)
    tin = (torch.from_numpy(ids).long(), torch.from_numpy(sigma))
    tmod = torch.from_numpy(modality).long()
    for cond in (xc, None):
        want = jmodel.apply({"params": params}, ids, sigma,
                            modality=modality, x_cond=cond)
        with torch.no_grad():
            got = model(*tin, modality=tmod, x_cond=None if cond is None
                        else torch.from_numpy(cond))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=tdit.ATOL, rtol=tdit.RTOL)
    with torch.no_grad():
        other = model(*tin, modality=tmod,
                      x_cond=torch.from_numpy((xc + 5) % CV))
    assert float((other - got).abs().max()) > 1e-3   # a live input
    # the reference names map back onto JAX's tree
    sd = dit_state_dict_from_jax(jax.device_get(params))
    assert ("cond_img_vocab_proj.weight" in sd) == (embed_dim is not None)
    back = port_dit_state_dict(params, {k: v.numpy() for k, v in sd.items()})
    want = traverse_util.flatten_dict(params, sep="/")
    got = traverse_util.flatten_dict(back, sep="/")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="KV-cache"):
        kv = torch.zeros((tcfg.model.n_blocks, tdit.B, tdit.L, 2, 64))
        model(*tin, modality=tmod, x_cond=torch.from_numpy(xc),
              kv_cache=(kv, kv.clone()), cache_index=0)


def test_img_cond_train_step_matches_jax():
    jcfg, tcfg = tstep.configs(**IMG_COND)
    params = abstract_params(jcfg, seed=2,
                             x_cond=jnp.zeros((1, LC), jnp.int32))
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    jstate = jts.init_train_state(jcfg, params)
    batch = {**tstep.make_batch(jcfg.model), "x_cond": x_conds(tstep.B)}
    rng = jax.random.PRNGKey(7)
    jnew, jmetrics = jax.jit(jts.make_train_step(jcfg, jmodel))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    state = tts.init_train_state(tcfg, model)
    state.load_state_dict(train_state_from_jax(jax.device_get(jstate)))
    state, metrics = tts.make_train_step(tcfg, model)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        draws=tstep.step_draws(rng, 0, 1, jcfg.model))
    tstep.compare_states(jnew, jmetrics, state, metrics)
    before = dit_state_dict_from_jax(jax.device_get(params))
    for name in ("img_cond_blocks.0.attn_qkv.weight",
                 "img_cond_blocks.1.mlp.2.weight",
                 "blocks.0.cross_attention.attn_qkv_cond.weight",
                 "cond_img_vocab_embed.embedding"):
        moved = float((state.params[name].detach() - before[name]).abs()
                      .max())
        assert moved > 1e-5, name


def test_img_cond_samples_through_the_closure_as_jax():
    over = {"sampling.predictor": "maskgit", "sampling.steps": 4,
            "sampling.cfg": None, "model.force_argmax_valid_indices": True,
            "model.time_conditioning": False}
    jcfg, tcfg, params = img_cond_setup(**over)
    m = jcfg.model
    jmodel = JaxDIT(m, compute_dtype=jnp.float32)
    model = tdit.port_model(tcfg, params)
    b = tdit.B
    x0 = np.zeros((b, m.length), np.int32)
    unmask = np.zeros((b, m.length), bool)
    modality = np.concatenate([np.zeros((b, tdit.TXT)),
                               np.ones((b, m.length - tdit.TXT))],
                              1).astype(np.int32)
    rng = np.random.RandomState(4)
    shape = (4, b, m.length)
    injected = {"exp": rng.exponential(size=shape + (m.vocab_size,))
                .astype(np.float32),
                "gumbel": rng.gumbel(size=shape).astype(np.float32)}
    tokens = []
    for xc in (x_conds(b, 3), x_conds(b, 9)):
        def forward(p, x, sigma, mod, xc=xc):
            return jmodel.apply({"params": p}, x, sigma, modality=mod,
                                x_cond=jnp.asarray(xc))
        want = jax.jit(jax_sampler.build_sampler(forward, jcfg,
                                                 inject_noise=True))(
            params, jax.random.PRNGKey(0), jnp.asarray(x0),
            jnp.asarray(unmask), jnp.asarray(modality),
            injected={k: jnp.asarray(v) for k, v in injected.items()})
        sample = sampler.build_sampler(
            sampler.ConditionedModel(model, torch.from_numpy(xc)), tcfg,
            inject_noise=True, device="cpu")
        got = sample(x0, unmask, modality,
                     injected={k: torch.from_numpy(v)
                               for k, v in injected.items()})
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        assert got.nfe == int(want.nfe)
        tokens.append(got.tokens)
    assert int((tokens[0] != tokens[1]).sum()) > 0


# ---------------------------------------------------------------------------
# split embedding and class labels
# ---------------------------------------------------------------------------

def test_split_embed_forward_matches_jax():
    jcfg, tcfg = tdit.configs(**{"model.split_embed": True,
                                 "model.img_embed_dim": 8})
    params = abstract_params(jcfg, seed=5)
    ids, sigma, modality = tdit.inputs(jcfg.model, seed=5)
    ids[:, ::5] = jcfg.model.mask_index        # mask tokens of both spans
    want = JaxDIT(jcfg.model, compute_dtype=jnp.float32).apply(
        {"params": params}, ids, sigma, modality=modality)
    model = tdit.port_model(tcfg, params)
    assert model.vocab_embed.embedding.shape[0] == \
        tcfg.model.text_vocab_size + 1
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(sigma),
                    modality=torch.from_numpy(modality).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=tdit.ATOL, rtol=tdit.RTOL)


def test_cond_label_forward_matches_jax():
    jcfg, tcfg = tdit.configs(**{"model.cond_label": True,
                                 "model.time_conditioning": False})
    label = np.asarray([3, 1000], np.int32)        # 1000: the null slot
    params = abstract_params(jcfg, seed=6, label=jnp.zeros((1,), jnp.int32))
    ids, sigma, modality = tdit.inputs(jcfg.model, seed=6)
    want = JaxDIT(jcfg.model, compute_dtype=jnp.float32).apply(
        {"params": params}, ids, sigma, modality=modality, label=label)
    model = tdit.port_model(tcfg, params)
    assert model.y_embedder.embedding_table.weight.shape == (1001, 32)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(sigma),
                    modality=torch.from_numpy(modality).long(),
                    label=torch.from_numpy(label))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=tdit.ATOL, rtol=tdit.RTOL)
    # the label rows themselves: the table's, the null slot included
    table = params["y_embedder"]["embedding_table"]
    want_rows = JaxLabelEmbedder(1000, 32).apply(
        {"params": {"embedding_table": table}}, jnp.asarray(label))
    with torch.no_grad():
        rows = model.y_embedder(torch.from_numpy(label))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    with pytest.raises(ValueError, match="label"):
        model(torch.from_numpy(ids).long(), torch.from_numpy(sigma),
              modality=torch.from_numpy(modality).long())


def test_label_drop_draws_from_the_generator():
    emb = LabelEmbedder(1000, 8)
    labels = torch.randint(0, 1000, (20_000,),
                           generator=torch.Generator().manual_seed(0))
    rows = [emb(labels, train=True,
                generator=torch.Generator().manual_seed(1))
            for _ in range(2)]
    assert torch.equal(rows[0], rows[1])
    null = torch.all(rows[0] == emb.embedding_table.weight[1000], dim=-1)
    assert abs(float(null.float().mean()) - 0.1) < 0.01
    # the kept labels keep their rows; eval mode drops nothing
    kept = ~null
    assert torch.equal(rows[0][kept], emb(labels)[kept])
    assert not torch.all(emb(labels) == emb.embedding_table.weight[1000],
                         dim=-1).any()
    with pytest.raises(ValueError, match="generator"):
        emb(labels, train=True)


# ---------------------------------------------------------------------------
# reference-named checkpoints
# ---------------------------------------------------------------------------

SPLIT_REF = {"model.hidden_size": 128, "model.n_blocks": 2,
             "model.text_vocab_size": 300, "model.image_vocab_size": 64,
             "model.time_conditioning": True, "model.cond_dim": 32,
             "model.qk_norm": True, "model.norm_type": "rms",
             "model.sandwich_normalization": True,
             "model.modality_embed": True, "model.dropout": 0.0,
             "model.split_embed": True, "model.img_embed_dim": 8}
LAYOUT = {"model.length": 24, "model.txt_length": 8, "model.img_length": 16,
          "model.rope_2d": True}


def reference_named(model):
    """The model's state_dict in the published checkpoints' naming
    (attention nested under blocks.{i}.attention, a rotary table)."""
    sd = {}
    for k, v in model.state_dict().items():
        if k.startswith("blocks."):
            for leaf in ("attn_qkv", "attn_out", "q_norm", "k_norm"):
                k = k.replace(f".{leaf}.", f".attention.{leaf}.")
        sd[k] = v
    sd["blocks.0.attention.rotary_emb.inv_freq"] = torch.ones(32)
    return sd


def test_split_embed_reference_checkpoint_is_served(tmp_path):
    from safetensors.numpy import save_file
    from unidisc_tpu.models.port import infer_dit_overrides as jax_infer
    from unidisc_tpu.models.port import read_reference_state_dict as jax_read
    cfg = Config.make("tiny", **SPLIT_REF, **LAYOUT)
    model = DIT(cfg.model, compute_dtype=torch.float32)
    randomize_(model, 3)
    path = str(tmp_path / "model.safetensors")
    save_file({k: v.numpy() for k, v in reference_named(model).items()},
              path)
    eng = build_engine(preset="tiny", reference_ckpt=path, overrides=LAYOUT,
                       device="cpu")
    assert eng.config.model.split_embed
    assert eng.config.model.img_embed_dim == 8
    for name, value in eng.model.state_dict().items():
        assert torch.equal(value, model.state_dict()[name]), name
    r = eng.run_batch([eng.prepare(text="a cat")])[0]
    assert r["image_ids"].shape == (1, 16)
    # JAX reads the same file into its tree; the two forwards agree
    jsd = jax_read(path)
    jcfg = JaxConfig.make("tiny", **{**jax_infer(jsd), **LAYOUT})
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    template = jax.eval_shape(
        lambda k: jmodel.init({"params": k}, jnp.zeros((1, 24), jnp.int32),
                              jnp.zeros((1,)),
                              modality=jnp.zeros((1, 24), jnp.int32))[
            "params"], jax.random.PRNGKey(0))
    params = port_dit_state_dict(template, jsd)
    ids, sigma, modality = tdit.inputs(cfg.model, seed=8)
    want = jmodel.apply({"params": params}, ids, sigma, modality=modality)
    port = DIT(eng.config.model, compute_dtype=torch.float32).eval()
    port.load_state_dict(reference_dit_state_dict(
        read_reference_state_dict(path)))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(sigma),
                   modality=torch.from_numpy(modality).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=tdit.ATOL, rtol=tdit.RTOL)


def test_img_cond_reference_names_load_as_jax_maps_them():
    jcfg, tcfg, params = img_cond_setup(8)
    model = tdit.port_model(tcfg, params)
    sd = reference_named(model)
    for i in range(tcfg.model.n_cond_blocks):
        # the reference builds the cond blocks with adaLN tables it never
        # uses; both mappings drop them
        sd[f"img_cond_blocks.{i}.adaLN_modulation.weight"] = torch.ones(3)
        sd[f"img_cond_blocks.{i}.adaLN_modulation.bias"] = torch.ones(3)
    got = reference_dit_state_dict(sd)
    assert "blocks.0.cross_attention.attn_qkv_cond.weight" in got
    fresh = DIT(tcfg.model, compute_dtype=torch.float32)
    fresh.load_state_dict(got)           # strict: every key, no other
    back = port_dit_state_dict(params, {k: v.numpy() for k, v in sd.items()})
    mine = dit_state_dict_from_jax(jax.device_get(back))
    for name, value in fresh.state_dict().items():
        assert torch.equal(value, mine[name]), name


# ---------------------------------------------------------------------------
# the optimizers' and LoRA's routing of the new leaves
# ---------------------------------------------------------------------------

def test_muon_mup_and_lora_route_the_img_cond_leaves_as_jax(tmp_path):
    jcfg, tcfg, params = img_cond_setup(8, **{
        "model.mup": True, "model.mup_base_width": 64})
    flags = jax.tree_util.tree_map(
        lambda d, p: np.full(np.shape(p), float(d is not None), np.float32),
        muon_dimension_numbers(params), params,
        is_leaf=lambda x: x is None or isinstance(x, MuonDimensionNumbers))
    want_muon = {k: bool(v.flatten()[0]) for k, v in
                 dit_state_dict_from_jax(jax.device_get(flags)).items()}
    mults = jax.tree_util.tree_map_with_path(
        lambda path, p: np.full(np.shape(p), jax_mup_multiplier(
            path, p, base_width=64, width=128), np.float32), params)
    want_mup = {k: float(v.flatten()[0]) for k, v in
                dit_state_dict_from_jax(jax.device_get(mults)).items()}
    tp = {k: torch.nn.Parameter(v) for k, v in
          dit_state_dict_from_jax(jax.device_get(params)).items()}
    layout = ParamLayout(tp)
    routes = muon_routes(layout)
    got_muon = {n: routes[leaf.key] for leaf in layout.leaves
                for n in leaf.names}
    assert got_muon == want_muon
    # the cross-attention is under blocks (Muon), the trunk is not (Adam)
    assert got_muon["blocks.0.cross_attention.attn_qkv_cond.weight"]
    assert not got_muon["img_cond_blocks.0.attn_qkv.weight"]
    got = tts.flat_views(mup_multipliers(tp, tcfg), tp)
    assert {k: float(v.flatten()[0]) for k, v in got.items()} == want_mup
    flat = traverse_util.flatten_dict(params, sep="/")
    assert {"/".join(leaf.path) for leaf in layout.leaves} == set(flat)
    for leaf in layout.leaves:
        assert leaf.shape == np.shape(flat["/".join(leaf.path)]), leaf.key

    # LoRA's substring targets take the cross-attention's two qkv
    # projections and the trunk's attn_qkv, as in JAX
    jad = jlora.init_lora(jax.random.PRNGKey(1), params, rank=4)
    jad = jax.tree_util.tree_map(lambda x: jnp.asarray(
        np.random.RandomState(2).standard_normal(x.shape) * 0.1,
        jnp.float32), jad)
    want_targets = {"/".join(p[:-1]) for p in traverse_util.flatten_dict(
        jad["lora"]) if p[-1] == "a"}
    assert "blocks/cross_attention/attn_qkv_cond/kernel" in want_targets
    assert "img_cond_blocks/attention/attn_qkv/kernel" in want_targets
    adapter = tlora.init_lora({k: v.detach() for k, v in tp.items()},
                              rank=4)
    got_targets = {"/".join(leaf.path[1:-1]) for leaf in
                   ParamLayout(adapter).leaves if leaf.path[0] == "lora"}
    assert got_targets == want_targets
    path = str(tmp_path / "lora_adapter.npz")
    jlora.save_lora(path, jax.device_get(jad), alpha=8.0, rank=4)
    loaded, alpha, rank = tlora.load_lora(path)
    want = dit_state_dict_from_jax(jax.device_get(
        jlora.merge_lora(params, jad, alpha=8.0, rank=4)))
    merged = tlora.merge_lora({k: v.detach() for k, v in tp.items()},
                              loaded, alpha=alpha, rank=rank)
    for name in want:
        np.testing.assert_allclose(merged[name].numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("over", [
    {**IMG_COND}, {"model.cond_label": True,
                   "model.time_conditioning": False}],
    ids=["img_cond", "cond_label"])
def test_engine_refuses_models_no_request_can_condition(over):
    with pytest.raises(ValueError, match="cannot be served"):
        build_engine(preset="tiny", device="cpu", overrides=over)
