"""The port's optimizers (``training/optimizers.py``), Muon routing
(``training/muon.py``) and muP (``training/mup.py``) against the JAX
package's optax chains.

* Three updates of each optimizer (adamw, lion, ademamix, adafactor,
  muon; adamw, adafactor and muon also with muP) from the same parameters
  (a tiny DIT's flax tree, carried to the port's names by
  ``models/port.py``) and the same gradients, the global-norm clip
  triggered on one of them: every parameter within rtol 1e-5, with an
  absolute floor of 1e-6 x the parameter's largest magnitude (fp32 on both
  sides; the JAX side computes pow(x, -0.5) as rsqrt, mean and Frobenius
  norms in another summation order, and Newton-Schulz's fp32 products in
  another order).
* Muon and muP route the same leaves: ``muon_dimension_numbers`` and
  ``mup_multiplier`` over the flax tree, carried to the port's names,
  equal the port's rules over its parameters.
* The non-finite skip of the new chains keeps every state tensor and
  count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
from optax.contrib import MuonDimensionNumbers
import pytest
import torch
from flax import traverse_util

from test_torch_dit import param_tree
from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.training import train_state as jts
from unidisc_tpu.training.muon import muon_dimension_numbers
from unidisc_tpu.training.mup import mup_multiplier as jax_mup_multiplier
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.models.port import dit_state_dict_from_jax, flax_path
from unidisc_tpu_torch.training import train_state as tts
from unidisc_tpu_torch.training.layout import ParamLayout
from unidisc_tpu_torch.training.muon import muon_routes
from unidisc_tpu_torch.training.mup import mup_multipliers

cap_test_threads()

OVER = {"model.hidden_size": 128, "model.n_heads": 2, "model.n_blocks": 2,
        "model.cond_dim": 32, "model.length": 24, "model.txt_length": 8,
        "model.img_length": 16, "model.text_vocab_size": 24,
        "model.image_vocab_size": 40, "model.time_conditioning": True,
        "model.qk_norm": True, "model.norm_type": "rms",
        "model.sandwich_normalization": True, "model.modality_embed": True,
        "trainer.warmup_steps": 0, "trainer.lr": 1e-2,
        "trainer.weight_decay": 0.1, "trainer.gradient_clip_val": 1.0}


def configs(**extra):
    over = {**OVER, **extra}
    return (JaxConfig.make("tiny", **over).validate(),
            Config.make("tiny", **over).validate())


@pytest.fixture(scope="module")
def flax_params():
    jcfg, _ = configs()
    params = param_tree(jcfg.model, jnp.float32)
    rng = np.random.RandomState(0)
    flat = traverse_util.flatten_dict(params, sep="/")
    return traverse_util.unflatten_dict(
        {k: jnp.asarray(rng.standard_normal(np.shape(v)) * 0.2, jnp.float32)
         for k, v in flat.items()}, sep="/")


def tree_like(params, fn):
    flat = traverse_util.flatten_dict(params, sep="/")
    return traverse_util.unflatten_dict({k: fn(k, v) for k, v in flat.items()},
                                        sep="/")


def port_params(tree):
    return {k: torch.nn.Parameter(v) for k, v in
            dit_state_dict_from_jax(jax.device_get(tree)).items()}


CASES = [("adamw", False), ("lion", False), ("ademamix", False),
         ("adafactor", False), ("muon", False), ("adamw", True),
         ("adafactor", True), ("muon", True)]


@pytest.mark.parametrize("optimizer,mup", CASES)
def test_three_updates_match_optax(flax_params, optimizer, mup):
    extra = {"trainer.optimizer": optimizer}
    if mup:
        extra.update({"model.mup": True, "model.mup_base_width": 64})
    jcfg, tcfg = configs(**extra)
    opt = jts.make_optimizer(jcfg)
    jparams = flax_params
    jstate = opt.init(jparams)
    params = port_params(jparams)
    flat = tts.flat_parameters(params)
    topt = tts.make_optimizer(tcfg)
    state = topt.init(flat, params)
    rng = np.random.RandomState(1)
    # one compiled update: optax op by op compiles each primitive apart
    update = jax.jit(lambda g, s, p: (lambda u, s2: (
        optax.apply_updates(p, u), s2))(*opt.update(g, s, p)))
    for step, scale in enumerate((0.3, 1e-3, 5e-4)):
        grads = tree_like(jparams, lambda k, v: jnp.asarray(
            rng.standard_normal(np.shape(v)) * scale, jnp.float32))
        norm = float(optax.global_norm(grads))
        assert (norm >= 1.0) == (step == 0)       # the clip fires once
        jparams, jstate = update(grads, jstate, jparams)
        g = tts.flatten(dit_state_dict_from_jax(jax.device_get(grads))[k]
                        for k in params)
        topt.apply(flat, g, state, params=params)
    want = dit_state_dict_from_jax(jax.device_get(jparams))
    for k, p in params.items():
        w = want[k].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=f"{optimizer} mup={mup}: {k}")
    counts = getattr(state, "counts", None) or {
        "adam": state.adam.count, "schedule": state.schedule_count}
    assert all(int(c) == 3 for c in counts.values()), counts


def test_muon_and_mup_route_the_same_leaves(flax_params):
    jcfg, tcfg = configs(**{"model.mup": True, "model.mup_base_width": 64})
    flags = jax.tree_util.tree_map(
        lambda d, p: np.full(np.shape(p), float(d is not None), np.float32),
        muon_dimension_numbers(flax_params), flax_params,
        is_leaf=lambda x: x is None or isinstance(x, MuonDimensionNumbers))
    want_muon = {k: bool(v.flatten()[0]) for k, v in
                 dit_state_dict_from_jax(flags).items()}
    mults = jax.tree_util.tree_map_with_path(
        lambda path, p: np.full(np.shape(p), jax_mup_multiplier(
            path, p, base_width=64, width=128), np.float32), flax_params)
    want_mup = {k: float(v.flatten()[0]) for k, v in
                dit_state_dict_from_jax(mults).items()}

    params = port_params(flax_params)
    layout = ParamLayout(params)
    routes = muon_routes(layout)
    got_muon = {n: routes[leaf.key] for leaf in layout.leaves
                for n in leaf.names}
    assert got_muon == want_muon
    assert sum(got_muon.values()) == 5 * 2       # 5 matrices x 2 blocks
    got = tts.flat_views(mup_multipliers(params, tcfg), params)
    assert {k: float(v.flatten()[0]) for k, v in got.items()} == want_mup
    assert set(want_mup.values()) == {0.5, 1.0}
    # the flax paths the rules read
    flat = traverse_util.flatten_dict(flax_params, sep="/")
    have = {"/".join(leaf.path) for leaf in layout.leaves}
    assert have == set(flat)
    for leaf in layout.leaves:
        assert leaf.shape == np.shape(flat["/".join(leaf.path)])
        assert flax_path(leaf.names[0], params[leaf.names[0]].ndim) \
            == leaf.path


@pytest.mark.parametrize("optimizer", ["lion", "ademamix", "adafactor",
                                       "muon"])
def test_skip_keeps_the_whole_state(flax_params, optimizer):
    _, tcfg = configs(**{"trainer.optimizer": optimizer})
    params = port_params(flax_params)
    flat = tts.flat_parameters(params)
    before = flat.clone()
    opt = tts.make_optimizer(tcfg)
    state = opt.init(flat, params)
    opt.apply(flat, torch.full_like(flat, 0.01), state, params=params)
    saved = {k: v.clone() for k, v in state.tensors().items()}
    moved = flat.clone()
    assert not torch.equal(moved, before)
    opt.apply(flat, torch.full_like(flat, 0.02), state,
              ok=torch.tensor(False), params=params)
    assert torch.equal(flat, moved)
    for k, v in state.tensors().items():
        assert torch.equal(v, saved[k]), k


@pytest.mark.parametrize("optimizer", ["adamw", "lion", "ademamix"])
def test_sliced_elementwise_update_is_bit_equal(flax_params, optimizer,
                                                monkeypatch):
    """The elementwise chains update their flat buffers a slice at a time
    (bounded temporaries): 3 updates with 1,000-element slices, the skip
    on the last, equal bit for bit to the whole-buffer update."""
    _, tcfg = configs(**{"trainer.optimizer": optimizer,
                         "model.mup": True, "model.mup_base_width": 64})
    rng = np.random.RandomState(2)
    grads = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
             for n in [sum(np.size(v) for v in jax.tree_util.tree_leaves(
                 flax_params))] * 3]
    out = []
    for size in (1 << 26, 1000):
        opt = tts.make_optimizer(tcfg)
        monkeypatch.setattr(type(opt), "SLICE", size)
        params = port_params(flax_params)
        flat = tts.flat_parameters(params)
        state = opt.init(flat, params)
        for i, g in enumerate(grads):
            opt.apply(flat, g * 0.01, state, params=params,
                      ok=torch.tensor(i < 2))
        out.append((flat.clone(), {k: v.clone()
                                   for k, v in state.tensors().items()}))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k
    assert all(int(v) == 2 for k, v in out[1][1].items() if v.dim() == 0)


def test_coord_check_matches_jax():
    """muP's coordinate check on a 2-layer tanh MLP of widths 64 and 128
    (fp32, rtol 1e-5): the same activations before and after one
    muP-scaled SGD step as JAX's coord_check."""
    from unidisc_tpu.training.mup import coord_check as jax_coord_check
    from unidisc_tpu_torch.training.mup import coord_check
    jcfg, tcfg = configs(**{"model.mup": True, "model.mup_base_width": 64})
    rng = np.random.RandomState(5)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    weights = {w: {"dense/kernel": rng.standard_normal((32, w)) / 6,
                   "out/kernel": rng.standard_normal((w, w)) / np.sqrt(w)}
               for w in (64, 128)}

    def jax_model(w):
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float32),
            {"dense": {"kernel": weights[w]["dense/kernel"]},
             "out": {"kernel": weights[w]["out/kernel"]}})
        return (lambda p, b: jnp.tanh(b @ p["dense"]["kernel"])
                @ p["out"]["kernel"]), params

    def torch_model(w):
        params = {k: torch.from_numpy(v.astype(np.float32))
                  for k, v in weights[w].items()}
        return (lambda p, b: torch.tanh(b @ p["dense/kernel"])
                @ p["out/kernel"]), params

    want = jax_coord_check(jax_model, (64, 128), jnp.asarray(x),
                           config=jcfg)
    got = coord_check(torch_model, (64, 128), torch.from_numpy(x),
                      config=tcfg)
    assert set(got) == set(want) == {64, 128}
    for w in want:
        for k in ("act_before", "act_after", "delta"):
            np.testing.assert_allclose(got[w][k], want[w][k], rtol=1e-5,
                                       err_msg=f"{w} {k}")
