"""The mesh train step's other objectives, optimizers and modes, against
the JAX package's mesh step on its 8 virtual CPU devices and against the
port's one-rank step.

The port's side runs once, in one gloo world of 4 CPU ranks
(``tests/torch_mesh_worker.py``, job "modes"), two steps of each case
from the same start, batch and draws on every rank:

* held to JAX's ``make_train_step`` + ``shard_train_step`` on the same
  mesh (the JAX draws replayed): ``ar`` with ``ar_inpainting`` and the
  row flip on fsdp 2 x seq 2 (L 48 after the doubling; the causal ring);
  Adafactor, and Muon with muP, on fsdp 2 x tensor 2; LoRA (rank 4, the
  default targets, a redrawn non-zero adapter) on fsdp 2 x tensor 2; the
  MoE DIT (4 experts, top-2) on seq 2 x ep 2. Both sides compute in fp32:
  the metrics within rtol 1e-4, the parameters, the EMA (and AdamW's
  moments) within tests/test_torch_train_step.py's tolerance (rtol 1e-4
  with a floor of 1e-4 x each tensor's largest magnitude).
* held to the port's one-rank step (which tests/test_torch_{ar_train,
  legacy,optimizers,lora,train_step}.py hold to JAX): every case above and
  sedd (dcn 2 x tensor 2), d3pm (dcn 2 x pp 2), joint AR+NAR with the
  AR-LLM loss (dcn 2 x seq 2), Lion (fsdp 2 x pp 2), AdEMAMix (dcn 2 x
  fsdp 2), dropout with img_cond (dcn 2 x fsdp 2, the dropout seed
  injected) within rtol 1e-5 on the metrics and the whole state
  (optimizer state included) at the same tensor tolerance. bf16
  parameters under FSDP (``low_precision_params`` on dcn 2 x fsdp 2, a
  bf16 DIT on both sides): the metrics within rtol 1e-3 (the forward's
  bf16 products run over other row blocks), the parameters and the fp32
  EMA within 2^-7 of each tensor's largest magnitude (two bf16 ulps at
  it), the Adam moments within 2^-5 of it: the bf16 gradients are summed
  in another order (each rank's part, then FSDP2's bf16 average over the
  ranks, scaled back), and an element that cancels to a few ulps of the
  tensor's largest differs by that much (observed: 0.52% on the
  parameters, 2.6% on the moments).
* the AR targets shifted inside each L-chunk instead of along the whole
  sequence: the loss leaves JAX's by more than 100 x the tolerance.
* Adafactor's and Muon's mesh state after step 1, gathered whole and
  scattered back, gives step 2 bit for bit; the mesh's whole state after
  step 2 loads into a one-rank state whose third step equals the one-rank
  run's.
* ``Trainer`` with LoRA on fsdp 2 x tensor 2 writes the
  ``lora_adapter.npz`` of a one-rank Trainer on the same batches: the same
  arrays, A bit for bit (B is zero at the start, so A has no gradient in
  two steps), B within 2^-4 of its largest magnitude: the Trainer
  computes in bf16, and B's first update is Adam's, which divides each
  gradient by its own magnitude (Adam's eps 1e-2 here damps the near-zero
  ones; observed 2.3%). ``Trainer.validate`` gives the one-rank numbers
  within rtol 1e-3 (bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ar_train as tar
from test_torch_dit import param_tree
from test_torch_img_cond import IMG_COND, abstract_params, x_conds
from test_torch_lora import jax_adapter
from test_torch_train_step import (B, assert_tree_close, configs, make_batch,
                                   random_params, step_draws)
from torch_mesh_worker import run_world
from unidisc_tpu.config import MeshConfig as JaxMeshConfig
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from unidisc_tpu.parallel.mesh import params_shardings as jax_shardings
from unidisc_tpu.training import lora as jlora
from unidisc_tpu.training import train_state as jts
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.data.synthetic import SyntheticDataLoader
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.models.port import (dit_state_dict_from_jax,
                                           train_state_from_jax)
from unidisc_tpu_torch.training import lora as tlora
from unidisc_tpu_torch.training import train_state as tts
from unidisc_tpu_torch.training.trainer import Trainer

cap_test_threads()

STEPS = 2
LORA = {"model.lora_rank": 4, "model.lora_alpha": 8.0}
MOE = {"model.moe_experts": 4, "model.moe_top_k": 2}
# name -> (overrides, mesh, objective family)
CASES = {
    "ar_inpainting": ({"trainer.ar_inpainting": True,
                       "trainer.rand_flip_ar_prob": 0.5},
                      dict(fsdp=2, seq=2), "ar"),
    "adafactor": ({"trainer.optimizer": "adafactor"},
                  dict(fsdp=2, tensor=2), "subs"),
    "muon_mup": ({"trainer.optimizer": "muon", "model.mup": True,
                  "model.mup_base_width": 64}, dict(fsdp=2, tensor=2),
                 "subs"),
    "lora": (LORA, dict(fsdp=2, tensor=2), "lora"),
    "moe_seq": (MOE, dict(fsdp=1, seq=2, ep=2), "subs"),
    "sedd": ({"trainer.parameterization": "sedd"},
             dict(dcn=2, fsdp=1, tensor=2), "subs"),
    "d3pm": ({"trainer.parameterization": "d3pm"},
             dict(dcn=2, fsdp=1, pp=2, pp_microbatches=2), "subs"),
    "joint_ar_llm": ({"trainer.joint_ar_nar_prob": 0.5,
                      "trainer.ar_llm_loss": True},
                     dict(dcn=2, fsdp=1, seq=2), "subs"),
    "lion": ({"trainer.optimizer": "lion"},
             dict(fsdp=2, pp=2, pp_microbatches=2), "subs"),
    "ademamix": ({"trainer.optimizer": "ademamix"}, dict(dcn=2, fsdp=2),
                 "subs"),
    "bf16": ({"trainer.low_precision_params": True}, dict(dcn=2, fsdp=2),
             "subs"),
    "dropout_img_cond": ({**IMG_COND, "model.dropout": 0.1},
                         dict(dcn=2, fsdp=2), "img_cond"),
}
JAX_CASES = ("ar_inpainting", "adafactor", "muon_mup", "lora", "moe_seq")
RESUMED = ("adafactor", "muon_mup")
METRICS = ("loss", "grad_norm", "txt_loss", "img_loss", "nll_sum",
           "token_count", "nll_txt_sum", "txt_count", "nll_img_sum",
           "img_count")


_SHARED: dict = {}


def _shared(key, make):
    """One value a key for the cases that share it (the parameters and
    the draws of a model configuration)."""
    if key not in _SHARED:
        _SHARED[key] = make()
    return _SHARED[key]


def build(name):
    """The case's (JAX config, port config, JAX params, batch, rng,
    draws, the world's case entry); the JAX start state for JAX_CASES."""
    over, mesh, kind = CASES[name]
    if kind == "ar":
        jcfg, tcfg = tar.configs(**over)
        tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
            tcfg.model, attn_backend="auto"))
    else:
        jcfg, tcfg = configs(**over)
    m = jcfg.model
    if kind == "img_cond":
        params = abstract_params(jcfg, x_cond=jnp.zeros((1, m.cond_length),
                                                        jnp.int32))
    else:
        seed = 3 if kind == "ar" else 0
        params = _shared(("params", m, seed), lambda: random_params(
            param_tree(m, jnp.float32), seed=seed))
    batch = make_batch(m, seed=6)
    if kind == "img_cond":
        batch["x_cond"] = x_conds(B)
    rng = jax.random.PRNGKey(13)
    if kind == "ar":
        draws = _shared(("ar_draws", m), lambda: [
            tar.ar_draws(jax.random.fold_in(rng, i), B, m)
            for i in range(STEPS)])
    else:
        draws = _shared(("draws", m), lambda: [
            step_draws(rng, i, 1, m) for i in range(STEPS)])
    draws = [dict(d) for d in draws]
    if kind == "img_cond":
        for i, d in enumerate(draws):
            d["dropout"] = 1234 + i
    entry = {"config": tcfg, "mesh": mesh, "batch": batch, "draws": draws}
    jstate0 = None
    if kind == "lora":
        adapter = jax_adapter(params, 4, 3)
        entry.update(base=dit_state_dict_from_jax(params),
                     adapter=_adapter_of(adapter))
        jstate0 = jts.init_train_state(jcfg, adapter)
    else:
        if name in JAX_CASES:
            jstate0 = jts.init_train_state(jcfg, params)
        # the JAX parameters in a fresh one-rank state of the optimizer
        # (JAX's init: the EMA the parameters, every moment and count 0)
        st = tts.init_train_state(tcfg, DIT(tcfg.model, init=False))
        sd = dit_state_dict_from_jax(params)
        with torch.no_grad():
            for key in ("params", "ema_params"):
                for n, v in getattr(st, key).items():
                    v.copy_(sd[n])
        entry["sd0"] = {k: {n: t.clone() for n, t in v.items()}
                        if isinstance(v, dict) else v.clone()
                        for k, v in st.state_dict().items()}
    if kind == "subs" and over.get("trainer.low_precision_params"):
        entry["dtype"] = torch.bfloat16
    if name in RESUMED:
        entry["resume"] = True
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, jstate0=jstate0,
                batch=batch, rng=rng, draws=draws, entry=entry, kind=kind)


TRAINER_OVER = {"model.length": 24, "model.txt_length": 8,
                "model.img_length": 16, "model.text_vocab_size": 24,
                "model.image_vocab_size": 40, "model.hidden_size": 64,
                "model.n_heads": 2, "model.dropout": 0.0,
                "model.zero_linear_init": False, "trainer.warmup_steps": 1,
                "trainer.lr": 1e-3, "trainer.opt_eps": 1e-2, **LORA}
TRAINER_STEPS = 2


def trainer_config(**mesh):
    return Config.make("tiny", **{**TRAINER_OVER, **{
        f"mesh.{k}": v for k, v in mesh.items()}})


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    built = {name: build(name) for name in CASES}
    cases = {name: b["entry"] for name, b in built.items()}
    cases["ar_in_chunk"] = {**cases["ar_inpainting"], "in_chunk": True}
    batch = next(SyntheticDataLoader(trainer_config(), 4, seed=0))
    root = tmp_path_factory.mktemp("modes")
    inputs = {"cases": cases, "dir": str(root),
              "trainer": {"config": trainer_config(fsdp=2, tensor=2),
                          "batch": batch, "steps": TRAINER_STEPS}}
    world = run_world("modes", 4, root, inputs=inputs)
    return dict(built=built, world=world, batch=batch, root=root)


def _doubling_split_metrics(out, modality, loss, grad_norm,
                            _orig=jts._split_metrics):
    """JAX's _split_metrics with ar_inpainting's doubled modality (the
    JAX step fails to broadcast it; tests/test_torch_ar_train.py)."""
    if modality is not None and modality.shape[-1] < out.token_mask.shape[-1]:
        modality = jnp.concatenate([modality, modality], axis=-1)
    return _orig(out, modality, loss, grad_norm)


def jax_mesh_steps(b, spec):
    """JAX's make_train_step on the mesh of `spec` (port mesh fields):
    (state, metrics) after STEPS steps of the built case `b`."""
    spec = {"dcn": 1, "tensor": 1, "seq": 1, **spec}
    jcfg = dataclasses.replace(b["jcfg"], mesh=JaxMeshConfig(**spec))
    n = int(np.prod([spec.get(a, 1) for a in ("dcn", "fsdp", "tensor",
                                               "seq", "pp", "ep")]))
    mesh = jax_make_mesh(jcfg.mesh, devices=jax.devices()[:n])
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    pmap = None
    if b["kind"] == "lora":
        base = jax.device_put(b["params"], jax_shardings(b["params"], mesh))
        pmap = jlora.lora_param_map(base, alpha=8.0, rank=4)
    step = jts.make_train_step(jcfg, jmodel, mesh=mesh, param_map=pmap)
    jitted, state, data_sh = jts.shard_train_step(
        step, jax.tree_util.tree_map(jnp.array, b["jstate0"]), mesh)
    batch = jax.device_put({k: jnp.asarray(v) for k, v in b["batch"].items()},
                           data_sh)
    metrics = []
    for _ in range(STEPS):
        state, m = jitted(state, batch, b["rng"])
        metrics.append(m)
    return state, metrics


@pytest.fixture(scope="module")
def jax_refs(case):
    """JAX's mesh steps by case, computed while the ranks run."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jts, "_split_metrics", _doubling_split_metrics)
    try:
        return {name: jax_mesh_steps(case["built"][name], CASES[name][1])
                for name in JAX_CASES}
    finally:
        mp.undo()


def one_rank(b, sd=None, steps=STEPS, draws=None):
    """The port's one-rank step from the case's start (or state dict
    `sd`): (whole state dict, metrics per step)."""
    tcfg, entry = b["tcfg"], b["entry"]
    model = DIT(tcfg.model, compute_dtype=entry.get("dtype", torch.float32))
    if b["kind"] == "lora":
        model.load_state_dict(entry["base"])
        base = dict(model.named_parameters())
        for p in base.values():
            p.requires_grad_(False)
        state = tts.init_train_state(
            tcfg, {k: v.clone() for k, v in entry["adapter"].items()})
        step = tts.make_train_step(tcfg, model, param_map=tlora.lora_param_map(
            base, alpha=8.0, rank=4))
    else:
        state = tts.init_train_state(tcfg, model)
        state.load_state_dict(entry["sd0"])
        step = tts.make_train_step(tcfg, model)
    if sd is not None:
        state.load_state_dict(sd)
    batch = {k: torch.from_numpy(v) for k, v in entry["batch"].items()}
    metrics = []
    for d in (draws or entry["draws"])[:steps]:
        state, m = step(state, batch, draws=d)
        metrics.append({k: float(v) for k, v in m._asdict().items()})
    return ({k: {n: t.detach().clone() for n, t in v.items()}
             if isinstance(v, dict) else v.clone()
             for k, v in state.state_dict().items()}, metrics)


@pytest.fixture(scope="module")
def one_rank_refs(case, jax_refs):
    return {name: one_rank(b) for name, b in case["built"].items()}


def _adapter_of(tree):
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        jlora.save_lora(f"{d}/a.npz", jax.device_get(tree), alpha=8.0,
                        rank=4)
        return tlora.load_lora(f"{d}/a.npz")[0]


@pytest.mark.parametrize("name", JAX_CASES)
def test_mode_matches_jax_on_its_mesh(case, jax_refs, name):
    jstate, jmetrics = jax_refs[name]
    got = case["world"][0][name]
    for i, jm in enumerate(jmetrics):
        for k in METRICS:
            np.testing.assert_allclose(
                got["metrics"][i][k], float(getattr(jm, k)), rtol=1e-4,
                atol=1e-6, err_msg=f"{name} step {i}: {k}")
    sd = got["state"]
    assert int(sd["step"]) == STEPS
    if case["built"][name]["kind"] == "lora":
        assert_tree_close(sd["params"], _adapter_of(jstate.params),
                          f"{name}: adapter")
        assert_tree_close(sd["ema_params"], _adapter_of(jstate.ema_params),
                          f"{name}: ema")
        return
    host = jax.device_get(jstate)
    assert_tree_close(sd["params"], dit_state_dict_from_jax(host.params),
                      f"{name}: params")
    assert_tree_close(sd["ema_params"],
                      dit_state_dict_from_jax(host.ema_params),
                      f"{name}: ema")
    if "mu" in sd:
        want = train_state_from_jax(host)
        for k in ("mu", "nu"):
            assert_tree_close(sd[k], want[k], f"{name}: {k}")


def _close(got, want, what, bound=None):
    if bound is None:
        assert_tree_close(got, want, what)
        return
    assert set(got) == set(want), what
    for k in want:
        w = want[k].double()
        np.testing.assert_allclose(
            got[k].double().numpy(), w.numpy(), rtol=0,
            atol=bound * float(w.abs().max()) + 1e-12,
            err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_mode_matches_the_one_rank_step(case, one_rank_refs, name):
    want_sd, want_metrics = one_rank_refs[name]
    bf16 = name == "bf16"
    for r, rank in enumerate(case["world"]):
        got = rank[name]["metrics"]
        for i, wm in enumerate(want_metrics):
            for k in METRICS:
                np.testing.assert_allclose(
                    got[i][k], wm[k], rtol=1e-3 if bf16 else 1e-5,
                    atol=1e-6, err_msg=f"{name} rank {r} step {i}: {k}")
    sd = case["world"][0][name]["state"]
    for k in ("params", "ema_params", "mu", "nu"):
        if k in want_sd:
            bound = (2.0 ** -5 if k in ("mu", "nu") else 2.0 ** -7) \
                if bf16 else None
            _close(sd[k], want_sd[k], f"{name}: {k}", bound)
    if "opt_state" in want_sd:
        got, want = sd["opt_state"], want_sd["opt_state"]
        assert set(got) == set(want)
        for k in want:
            if want[k].dim() == 0:
                assert int(got[k]) == int(want[k]), k
        assert_tree_close({k: v for k, v in got.items() if v.dim()},
                          {k: v for k, v in want.items() if v.dim()},
                          f"{name}: opt_state")


def test_ar_targets_shifted_inside_a_chunk_fail_the_jax_comparison(
        case, jax_refs):
    _, jmetrics = jax_refs["ar_inpainting"]
    want = float(jmetrics[0].loss)
    right = case["world"][0]["ar_inpainting"]["metrics"][0]["loss"]
    wrong = case["world"][0]["ar_in_chunk"]["metrics"][0]["loss"]
    np.testing.assert_allclose(right, want, rtol=1e-4)
    assert abs(wrong - want) > 100 * 1e-4 * abs(want), (wrong, want)


@pytest.mark.parametrize("name", RESUMED)
def test_mesh_checkpoint_resumes_on_one_rank(case, one_rank_refs, name):
    b = case["built"][name]
    got = case["world"][0][name]
    for r, rank in enumerate(case["world"]):
        assert rank[name]["resumed_equal"], f"rank {r}"
    # one more step on one rank from the mesh's whole state
    draws = b["draws"] + [step_draws(b["rng"], STEPS, 1, b["jcfg"].model)]
    from_mesh, m_mesh = one_rank(b, sd=got["state"], steps=1,
                                 draws=draws[STEPS:])
    from_one, m_one = one_rank(b, sd=one_rank_refs[name][0], steps=1,
                               draws=draws[STEPS:])
    np.testing.assert_allclose(m_mesh[0]["loss"], m_one[0]["loss"],
                               rtol=1e-5)
    assert_tree_close(from_mesh["params"], from_one["params"], "params")
    want, got_opt = from_one["opt_state"], from_mesh["opt_state"]
    assert_tree_close({k: v for k, v in got_opt.items() if v.dim()},
                      {k: v for k, v in want.items() if v.dim()},
                      "opt_state")


def test_trainer_lora_on_a_mesh_saves_the_one_rank_adapter(case, tmp_path):
    one = Trainer(trainer_config(), str(tmp_path / "one"), device="cpu",
                  log_every=100, val_every=0, ckpt_every=0)
    one.fit(iter([case["batch"]] * TRAINER_STEPS), None,
            max_steps=TRAINER_STEPS)
    val = one.validate(iter([case["batch"]]), TRAINER_STEPS, max_batches=1)
    one.close()
    want = np.load(tmp_path / "one" / "lora_adapter.npz")
    got = np.load(case["root"] / "lora_run" / "lora_adapter.npz")
    assert set(got.files) == set(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape, k
        if k == "__meta__" or k.endswith("/a"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(
                got[k], want[k], rtol=0,
                atol=2.0 ** -4 * float(np.abs(want[k]).max()), err_msg=k)
    for rank in case["world"]:
        for k, v in val.items():
            np.testing.assert_allclose(rank["trainer_val"][k], v, rtol=1e-3,
                                       err_msg=k)


def test_the_mesh_step_refuses_only_a_param_map_it_cannot_lay_out():
    """Every objective, optimizer and mode of the one-rank step passes
    check_mesh_step; a param_map other than the LoRA map (whose additive
    delta the mesh step lays out as the base) raises."""
    _, tcfg = configs()
    for over in (*(o for o, _, _ in CASES.values()),
                 {"trainer.parameterization": "ar"}):
        if "model.img_cond" not in over:
            tts.check_mesh_step(tcfg.override(**over))
    tts.check_mesh_step(tcfg, tlora.lora_param_map({}, alpha=8.0, rank=4))
    with pytest.raises(ValueError, match="LoraParamMap"):
        tts.check_mesh_step(tcfg, lambda params: params)

