"""LoRA (``training/lora.py``) against the JAX package's, and the LoRA
paths of the Trainer and the engine, on the CPU.

* A JAX-written ``lora_adapter.npz`` (the DIT's scan-stacked attn_qkv
  adapter and a full delta; OpenELM's qkv_proj adapter) loads through the
  port's name map and merges to JAX's merged weights (rtol 1e-6: one fp32
  rank-4 product each side); the port's file reads back in JAX array for
  array.
* One LoRA train step (JAX's ``lora_param_map`` as ``param_map``) equals
  JAX's on the same adapter, base and replayed draws: the new adapter,
  its EMA, the loss and the grad norm within the whole-step tolerance of
  tests/test_torch_train_step.py.
* A LoRA Trainer over a base run dir keeps the base bit-equal, writes the
  adapter file, and the run dir is served (``build_engine(checkpoint=)``)
  as base + EMA adapter; ``build_engine(lora=)`` and
  ``build_elm_engine(lora=)`` merge a file.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from test_torch_dit import param_tree
from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.models.elm import ELM_PRESETS as JAX_ELM_PRESETS
from unidisc_tpu.models.elm import init_elm
from unidisc_tpu.training import lora as jlora
from unidisc_tpu.training import train_state as jts
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.data.synthetic import SyntheticDataLoader
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.models.port import (dit_state_dict_from_jax,
                                           elm_state_dict_from_jax)
from unidisc_tpu_torch.serving.engine import (build_elm_engine, build_engine,
                                              elm_model, restore_run)
from unidisc_tpu_torch.training import lora as tlora
from unidisc_tpu_torch.training import train_state as tts
from unidisc_tpu_torch.training.trainer import Trainer

from test_torch_train_step import (TINY, assert_tree_close, make_batch,
                                   random_params, step_draws)

cap_test_threads()


def jax_adapter(base, rank, seed, train_full=()):
    """A JAX adapter with b (and the full deltas) redrawn non-zero."""
    adapter = jlora.init_lora(jax.random.PRNGKey(seed), base, rank=rank,
                              train_full=train_full)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.1,
                              jnp.float32), adapter)


@pytest.fixture(scope="module")
def dit_base():
    jcfg = JaxConfig.make("tiny", **TINY)
    return random_params(param_tree(jcfg.model, jnp.float32))


def test_jax_written_dit_adapter_merges_to_jax(dit_base, tmp_path):
    adapter = jax_adapter(dit_base, 4, 1, train_full=("output_layer",))
    path = str(tmp_path / "lora_adapter.npz")
    jlora.save_lora(path, jax.device_get(adapter), alpha=8.0, rank=4)
    want = dit_state_dict_from_jax(jax.device_get(
        jlora.merge_lora(dit_base, adapter, alpha=8.0, rank=4)))
    got_adapter, alpha, rank = tlora.load_lora(path)
    assert (alpha, rank) == (8.0, 4)
    assert {k for k in got_adapter if k.startswith("lora.")} == {
        f"lora.blocks.{i}.attn_qkv.weight.{ab}" for i in range(2)
        for ab in "AB"}
    got = tlora.merge_lora(dit_state_dict_from_jax(dit_base), got_adapter,
                           alpha=alpha, rank=rank)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    # the port's file, read by JAX: the same arrays under the same keys
    back = str(tmp_path / "port.npz")
    tlora.save_lora(back, got_adapter, alpha=alpha, rank=rank)
    again, a2, r2 = jlora.load_lora(back)
    assert (a2, r2) == (8.0, 4)
    flat_want = traverse_util.flatten_dict(jax.device_get(adapter))
    flat_got = traverse_util.flatten_dict(jax.device_get(again))
    assert set(flat_got) == set(flat_want)
    for k in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[k]),
                                      np.asarray(flat_want[k]))


def test_jax_written_elm_adapter_merges_to_jax(tmp_path):
    cfg = JAX_ELM_PRESETS["tiny"]
    _, params = init_elm(jax.random.PRNGKey(0), cfg)
    adapter = jax_adapter(params, 4, 2)
    path = str(tmp_path / "elm.npz")
    jlora.save_lora(path, jax.device_get(adapter), alpha=16.0, rank=4)
    want = elm_state_dict_from_jax(jax.device_get(
        jlora.merge_lora(params, adapter, alpha=16.0, rank=4)))
    got_adapter, alpha, rank = tlora.load_lora(path)
    got = tlora.merge_lora(elm_state_dict_from_jax(jax.device_get(params)),
                           got_adapter, alpha=alpha, rank=rank)
    changed = [k for k in want if "qkv_proj" in k]
    assert changed and all(k in got for k in want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    # build_elm_engine(lora=) merges it into its seeded weights
    from unidisc_tpu_torch.models.elm import ELM_PRESETS
    plain = elm_model(ELM_PRESETS["tiny"], 0, None, "cpu").state_dict()
    eng = build_elm_engine(preset="tiny", lora=path, device="cpu")
    for k, v in eng.model.state_dict().items():
        if k in changed:
            assert not torch.equal(v, plain[k]), k
        else:
            assert torch.equal(v, plain[k]), k


def test_lora_train_step_matches_jax(dit_base, tmp_path):
    over = {**TINY, "model.lora_rank": 4, "model.lora_alpha": 8.0,
            "model.attn_backend": "xla"}
    jcfg = JaxConfig.make("tiny", **over).validate()
    tcfg = Config.make("tiny", **{**over, "model.attn_backend": "auto"})
    adapter = jax_adapter(dit_base, 4, 3)
    batch = make_batch(jcfg.model, seed=6)
    rng = jax.random.PRNGKey(13)
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    jstate = jts.init_train_state(jcfg, adapter)
    pmap = jlora.lora_param_map(dit_base, alpha=8.0, rank=4)
    jnew, jm = jax.jit(jts.make_train_step(jcfg, jmodel, param_map=pmap))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)

    path = str(tmp_path / "a.npz")
    jlora.save_lora(path, jax.device_get(adapter), alpha=8.0, rank=4)
    start, _, _ = tlora.load_lora(path)
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    model.load_state_dict(dit_state_dict_from_jax(dit_base))
    base = dict(model.named_parameters())
    for p in base.values():
        p.requires_grad_(False)
    frozen = {k: v.clone() for k, v in base.items()}
    state = tts.init_train_state(tcfg, start)
    step = tts.make_train_step(tcfg, model, param_map=tlora.lora_param_map(
        base, alpha=8.0, rank=4))
    state, m = step(state, {k: torch.from_numpy(v)
                            for k, v in batch.items()},
                    draws=step_draws(rng, 0, 1, jcfg.model))
    for tree, want_tree, what in ((state.params, jnew.params, "adapter"),
                                  (state.ema_params, jnew.ema_params,
                                   "ema")):
        out = str(tmp_path / f"{what}.npz")
        jlora.save_lora(out, jax.device_get(want_tree), alpha=8.0, rank=4)
        want, _, _ = tlora.load_lora(out)
        assert_tree_close(tree, want, what)
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(getattr(m, name)),
                                   float(getattr(jm, name)), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    for k, v in base.items():
        assert torch.equal(v, frozen[k]), k


def test_trainer_lora_run_dir_is_served(tmp_path):
    base_over = {**TINY, "model.zero_linear_init": False,
                 "model.dropout": 0.1}
    cfg = Config.make("tiny", **base_over)
    batch = next(SyntheticDataLoader(cfg, 4, seed=0))
    base_run = Trainer(cfg, str(tmp_path / "base"), device="cpu",
                       log_every=1)
    base_run.fit(itertools.repeat(batch), max_steps=2)
    base_ema = {k: v.clone() for k, v in base_run.state.ema_params.items()}
    base_run.close()

    lcfg = Config.make("tiny", **{**base_over, "model.lora_rank": 4,
                                  "trainer.optimizer": "lion"})
    run = Trainer(lcfg, str(tmp_path / "lora"), device="cpu", log_every=1,
                  base_checkpoint=str(tmp_path / "base"))
    adapter0 = {k: v.detach().clone() for k, v in run.state.params.items()}
    out = run.fit(itertools.repeat(batch), max_steps=3)
    run.close()
    assert out["step"] == 3 and np.isfinite(out["loss"])
    for k, v in run.model.state_dict().items():
        assert torch.equal(v, base_ema[k]), k          # the base is frozen
    assert any(not torch.equal(v, adapter0[k])
               for k, v in run.state.params.items())
    ema = {k: v.clone() for k, v in run.state.ema_params.items()}
    want = tlora.merge_lora(base_ema, ema, alpha=32.0, rank=4)
    snap, weights, step = restore_run(str(tmp_path / "lora"))
    assert step == 3 and snap.model.lora_rank == 4
    eng = build_engine(checkpoint=str(tmp_path / "lora"), device="cpu")
    for k, v in eng.model.state_dict().items():
        assert torch.equal(v, want[k]), k
        assert torch.equal(weights[k], want[k]), k
    # the live adapter's file, merged over the base run by lora=
    live = tlora.merge_lora(base_ema, dict(run.state.params), alpha=32.0,
                            rank=4)
    eng = build_engine(checkpoint=str(tmp_path / "base"), device="cpu",
                       lora=str(tmp_path / "lora" / "lora_adapter.npz"))
    for k, v in eng.model.state_dict().items():
        torch.testing.assert_close(v, live[k], rtol=0, atol=0)


def test_lora_on_a_zero_head_random_base_raises(tmp_path):
    cfg = Config.make("tiny", **{**TINY, "model.lora_rank": 4,
                                 "model.zero_linear_init": True})
    with pytest.raises(ValueError, match="zero_linear_init"):
        Trainer(cfg, str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="no parameters matched"):
        tlora.init_lora({"x.weight": torch.zeros(3, 3)}, rank=2)
