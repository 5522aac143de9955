"""Distillation (``training/distill.py``) against the JAX package's
``training/distill.py`` on the CPU.

* ``masked_token_kl`` on SUBS log-probs with their -inf support: rtol
  1e-6 (fp32 both sides, another summation order over the vocab).
* ``distill_t_max`` exactly, and ``sample_t_window`` from the same uniform
  draws: rtol 1e-6.
* One distillation step (a frozen teacher, a student with its optimizer,
  replayed draws): plain with a t window and a hard-loss weight, and CFG
  distillation at guidance 2.0 (the batched [cond || uncond] teacher
  forward). The new student parameters and EMA, the loss, the KL, the
  grad norm and the masked count within the whole-step tolerance of
  tests/test_torch_train_step.py (rtol 1e-4, floor 1e-4 x the largest
  magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.diffusion.subs import subs_parameterization as jax_subs
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.training import distill as jdistill
from unidisc_tpu.training import train_state as jts
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.models.port import dit_state_dict_from_jax
from unidisc_tpu_torch.training import distill as tdistill
from unidisc_tpu_torch.training import train_state as tts

from test_torch_dit import param_tree
from test_torch_train_step import (TINY, B, assert_tree_close, loss_draws,
                                   make_batch, random_params)

cap_test_threads()


def test_masked_token_kl_matches_jax():
    jcfg = JaxConfig.make("tiny", **TINY)
    m = jcfg.model
    rng = np.random.RandomState(0)
    b, l, v = 2, m.length, m.vocab_size
    xt = rng.randint(0, v, (b, l)).astype(np.int32)
    xt[:, ::3] = m.mask_index
    modality = (np.arange(l) >= m.txt_length).astype(np.int32)[None]
    modality = np.repeat(modality, b, 0)
    logps = [jax_subs(jnp.asarray(rng.standard_normal((b, l, v)),
                                  jnp.float32), jnp.asarray(xt),
                      m.mask_index, modality=jnp.asarray(modality),
                      text_vocab_size=m.text_vocab_size) for _ in range(2)]
    move = xt == m.mask_index
    valid = rng.rand(b, l) > 0.2
    want, wcount = jdistill.masked_token_kl(*logps, jnp.asarray(move),
                                            jnp.asarray(valid))
    got, gcount = tdistill.masked_token_kl(
        *(torch.from_numpy(np.asarray(x)) for x in logps),
        torch.from_numpy(move), torch.from_numpy(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert int(gcount) == int(wcount) > 0


def test_t_window_matches_jax():
    jcfg = JaxConfig.make("tiny", **{**TINY, "sampling.steps": 8})
    tcfg = Config.make("tiny", **{**TINY, "sampling.steps": 8})
    for split in (-1, 0, 3, 8, 9):
        assert tdistill.distill_t_max(tcfg, split) == \
            jdistill.distill_t_max(jcfg, split)
    key = jax.random.PRNGKey(4)
    for t_max in (None, 0.4, 1.0):
        want = jdistill.sample_t_window(key, 6, t_max=t_max)
        got = tdistill.sample_t_window(
            6, t_max=t_max, draws={"t": torch.from_numpy(np.asarray(
                jax.random.uniform(key, (6,))))})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("guidance,t_max,hard", [(None, 0.6, 0.5),
                                                 (2.0, None, 0.0)])
def test_distill_step_matches_jax(guidance, t_max, hard):
    over = {**TINY, "model.attn_backend": "xla",
            "trainer.mask_entire_modality": None}
    jcfg = JaxConfig.make("tiny", **over).validate()
    tcfg = Config.make("tiny", **{**over, "model.attn_backend": "auto"})
    jteacher = jstudent = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    tree = param_tree(jcfg.model, jnp.float32)
    tparams, sparams = random_params(tree, seed=1), random_params(tree,
                                                                   seed=2)

    def jax_teacher(p, x, sigma, modality):
        return jteacher.apply({"params": p}, x, sigma, modality=modality)

    batch = make_batch(jcfg.model, seed=7)
    rng = jax.random.PRNGKey(17)
    jstate = jts.init_train_state(jcfg, sparams)
    jnew, jm = jax.jit(jdistill.make_distill_step(
        jcfg, jstudent, jax_teacher, t_max=t_max, hard_weight=hard,
        guidance=guidance))(jstate, tparams,
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            rng)

    teacher = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    teacher.load_state_dict(dit_state_dict_from_jax(tparams))
    student = DIT(tcfg.model, compute_dtype=torch.float32)
    student.load_state_dict(dit_state_dict_from_jax(sparams))
    state = tts.init_train_state(tcfg, student)
    step = tdistill.make_distill_step(
        tcfg, student, lambda x, s, m: teacher(x, s, modality=m),
        t_max=t_max, hard_weight=hard, guidance=guidance)
    state, m = step(state, {k: torch.from_numpy(v)
                            for k, v in batch.items()},
                    draws=loss_draws(jax.random.fold_in(rng, 0), B,
                                     jcfg.model))
    assert_tree_close(state.params, dit_state_dict_from_jax(
        jax.device_get(jnew.params)), "params")
    assert_tree_close(state.ema_params, dit_state_dict_from_jax(
        jax.device_get(jnew.ema_params)), "ema")
    for name in ("loss", "kl", "hard_loss", "grad_norm"):
        np.testing.assert_allclose(float(getattr(m, name)),
                                   float(getattr(jm, name)), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert int(m.masked_count) == int(jm.masked_count) > 0
    assert float(m.kl) > 0
