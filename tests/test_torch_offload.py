"""Host-offloaded fp32-master training (``training/offload.py``) on the
CPU, held to the JAX package's ``test_offload_*`` properties:

* the fused update equals optax's adamw and lion over 4 steps with the
  schedule and weight decay active (rtol 1e-6, atol 1e-7, as the JAX
  test), and JAX's own ``_fused_update`` (rtol 1e-6);
* the flat chunks round-trip the parameters exactly, and a chunk's
  gradient row is its slice of the flattened gradients;
* the step: chunked (K 4) equals unchunked (K 1) bit for bit (the same
  elementwise ops on every element), the loss falls, the working weights
  are exactly bf16(master), the EMA is not a copy of the master, and a
  non-finite loss leaves the master, moments and EMA bit-equal, rebuilds
  the working weights from the master, advances the step and not the
  optimizer count;
* a run checkpointed at step 2 and resumed equals a straight run, and the
  run dir is served with its gathered EMA.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.training.offload import _fused_update as jax_fused_update
from unidisc_tpu.training.train_state import make_lr_schedule
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.data.synthetic import SyntheticDataLoader
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.serving.engine import build_engine
from unidisc_tpu_torch.training import offload as toff
from unidisc_tpu_torch.training.trainer import Trainer

cap_test_threads()

SMALL = {"model.length": 24, "model.txt_length": 8, "model.img_length": 16,
         "model.text_vocab_size": 24, "model.image_vocab_size": 40,
         "model.hidden_size": 64, "model.n_heads": 1, "model.dropout": 0.0,
         "model.time_conditioning": True, "model.modality_embed": True,
         "model.zero_linear_init": False, "trainer.warmup_steps": 0,
         "trainer.lr": 2e-3, "trainer.host_offload_optimizer": True}


def config(**extra):
    return Config.make("tiny", **{**SMALL, **extra}).validate()


@pytest.mark.parametrize("opt_name", ["adamw", "lion"])
def test_fused_update_matches_optax_and_jax(opt_name):
    over = {"trainer.optimizer": opt_name, "trainer.warmup_steps": 2,
            "trainer.lr": 3e-3, "trainer.weight_decay": 0.01}
    jcfg, tcfg = JaxConfig.make("tiny", **over), Config.make("tiny", **over)
    t = jcfg.trainer
    sched = make_lr_schedule(jcfg)
    if opt_name == "adamw":
        opt = optax.adamw(sched, b1=t.beta1, b2=t.beta2, eps=t.opt_eps,
                          weight_decay=t.weight_decay)
    else:
        opt = optax.lion(sched, b1=t.beta1, b2=t.beta2,
                         weight_decay=t.weight_decay)
    rng = np.random.RandomState(0)
    m = rng.standard_normal(513).astype(np.float32)
    opt_state = opt.init(jnp.asarray(m))
    mu = np.zeros_like(m)
    nu = np.zeros_like(m)
    for step in range(4):
        g = rng.standard_normal(513).astype(np.float32)
        updates, opt_state = opt.update(jnp.asarray(g), opt_state,
                                        jnp.asarray(m))
        m_ref = np.asarray(optax.apply_updates(jnp.asarray(m), updates))
        jm, jmu, jnu = jax_fused_update(jcfg, jnp.asarray(m), jnp.asarray(mu),
                                        jnp.asarray(nu), jnp.asarray(g),
                                        jnp.int32(step))
        tm, tmu, tnu = toff.fused_update(
            tcfg, *(torch.from_numpy(x) for x in (m, mu, nu, g)),
            torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(tm.numpy(), m_ref, rtol=1e-6, atol=1e-7)
        for got, want in ((tm, jm), (tmu, jmu), (tnu, jnu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-9)
        m, mu, nu = m_ref, tmu.numpy(), tnu.numpy()


def test_flat_chunks_round_trip():
    cfg = config()
    model = DIT(cfg.model, compute_dtype=torch.float32)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    spec = toff.make_flat_spec(params, 3)
    assert spec.chunk_size % 128 == 0 and 3 * spec.chunk_size >= spec.total
    state = toff.init_offload_state(cfg, model, "cpu", chunks=3)
    back = state.gathered("masters")
    assert list(back) == list(params)
    for k, v in params.items():
        assert torch.equal(back[k], v), k
        assert torch.equal(state.params[k], v.to(torch.bfloat16)), k
    grads = [torch.randn(p.shape) for p in params.values()]
    flat = torch.cat([g.reshape(-1) for g in grads])
    for k in range(3):
        lo, hi = spec.bounds(k)
        row = toff._chunk_grad(grads, spec, k, torch.tensor(0.5))
        assert torch.equal(row[:hi - lo], flat[lo:hi] * 0.5)
        assert not row[hi - lo:].any()


def test_offload_step_properties():
    cfg = config()
    batch = {k: torch.from_numpy(v) for k, v in
             next(SyntheticDataLoader(cfg, 8, seed=0)).items()}
    runs = {}
    for chunks in (1, 4):
        model = DIT(cfg.model, compute_dtype=torch.bfloat16)
        model.reset_parameters(torch.Generator().manual_seed(0))
        state = toff.init_offload_state(cfg, model, "cpu", chunks=chunks)
        step = toff.make_offload_train_step(cfg, model)
        losses = []
        for i in range(12):
            gen = torch.Generator().manual_seed(i)
            state, metrics = step(state, batch, generator=gen)
            losses.append(float(metrics.loss))
        runs[chunks] = (state, step, model, losses)
    s1, step, model, losses = runs[1]
    s4 = runs[4][0]
    assert len(s4.masters) == 4 and len(s1.masters) == 1
    assert losses == runs[4][3]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    m1, m4 = s1.gathered("masters"), s4.gathered("masters")
    for k in m1:
        assert torch.equal(m1[k], m4[k]), k
        assert s1.params[k].dtype == torch.bfloat16
        assert torch.equal(s1.params[k].detach(), m1[k].to(torch.bfloat16))
    ema = s1.gathered("emas")
    assert max(float((ema[k] - m1[k]).abs().max()) for k in m1) > 0

    # the non-finite skip: poisoned working weights, a NaN loss
    saved = [t.clone() for f in ("masters", "mus", "nus", "emas")
             for t in getattr(s1, f)]
    count, at = int(s1.opt_count), int(s1.step)
    with torch.no_grad():
        s1.work.fill_(float("nan"))
    s1, metrics = step(s1, batch, generator=torch.Generator().manual_seed(0))
    assert not np.isfinite(float(metrics.loss))
    now = [t for f in ("masters", "mus", "nus", "emas")
           for t in getattr(s1, f)]
    assert all(torch.equal(a, b) for a, b in zip(now, saved))
    master = s1.gathered("masters")
    for k, w in s1.params.items():
        assert torch.equal(w.detach(), master[k].to(torch.bfloat16)), k
    assert int(s1.step) == at + 1 and int(s1.opt_count) == count
    s1, metrics = step(s1, batch, generator=torch.Generator().manual_seed(1))
    assert np.isfinite(float(metrics.loss))
    assert int(s1.opt_count) == count + 1


def test_offload_resume_equals_straight_and_is_served(tmp_path):
    cfg = config(**{"trainer.host_offload_chunks": 3,
                    "trainer.optimizer": "lion"})
    batch = next(SyntheticDataLoader(cfg, 4, seed=1))
    straight = Trainer(cfg, str(tmp_path / "a"), device="cpu", log_every=1)
    straight.fit(itertools.repeat(batch), max_steps=3)
    first = Trainer(cfg, str(tmp_path / "b"), device="cpu", log_every=1)
    first.fit(itertools.repeat(batch), max_steps=2)
    resumed = Trainer(cfg, str(tmp_path / "b"), device="cpu", log_every=1)
    resumed.fit(itertools.repeat(batch), max_steps=3)
    want, got = straight.state.state_dict(), resumed.state.state_dict()
    for f in ("masters", "mus", "nus", "emas"):
        for k in want[f]:
            assert torch.equal(got[f][k], want[f][k]), (f, k)
    assert int(got["step"]) == 3 and int(got["opt_count"]) == 3
    for k, v in straight.state.params.items():
        assert torch.equal(resumed.state.params[k], v), k
    ema = straight.state.ema_params
    eng = build_engine(checkpoint=str(tmp_path / "a"), device="cpu")
    for k, v in eng.model.state_dict().items():
        assert torch.equal(v, ema[k]), k
