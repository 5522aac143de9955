"""Rolling admission and AR decoding in a mesh engine, led by rank 0 and
replayed by the other ranks, against the port's one-rank engine and the
JAX package's rolling state machine and continuous batcher on its CPU
mesh.

The port's side runs once, in one gloo world of 4 CPU ranks
(``tests/torch_mesh_worker.py``, job "serving"); each engine is led by
rank 0 (``lead``) while the other ranks ``follow``, replaying every op of
the leader's batcher workers on their slots:

* the generic rolling state machine on fsdp 2 x seq 2 under injected
  noise (tests/test_torch_rolling.py's staggered ragged admissions, 4
  slots, 2 a data-parallel rank) equals JAX's rolling state machine on
  its fsdp 2 x seq 2 mesh (``shard_params``), token for token and step
  for step, on every rank's slots;
* ``build_engine(mesh="fsdp=2,seq=2", rolling=4)``: six requests (t2i,
  caption, infill) submitted 10 ms apart with 4 and 8 steps give the
  one-rank rolling engine's tokens at the same seeds; the seq replicas
  hold equal states and every rank's finished t2i rows are those tokens;
  a device error planted in the leader's chunk fails its request, every
  rank replays the reset, and the request then answers as one rank does;
  ``make_server`` on port 0 answers three concurrent chats as the
  one-rank engine does and shuts down, the batchers' workers first;
* rolling on pp 2 x tensor 2 (2 microbatches, eager chunks), in bf16
  and in int8 W8A8 (the flagship's int8 settings), and the MoE
  tiny model (4 experts, top-2) on dcn 2 x ep 2 (admitted in one group:
  MoE routing spans the batch, so the comparison needs the one-rank
  engine's slots) give the one-rank engine's tokens;
* an AR tiny DIT (fp32, L 48) on fsdp 2 x seq 2: six completions (prompts
  of 3 to 32 tokens, two sharing a 26-token prefix), greedy and at
  temperature 1 with seeds, plain, with prompt lookup (2-grams) and with
  a draft DIT, give the one-rank engine's ``complete_text`` tokens; plain
  greedy gives JAX's ``ContinuousBatcher`` on its fsdp 2 x seq 2 mesh;
  the stream's deltas are the tokens;
* the refusals need no world: AR decoding on "tensor", "pp" or "ep", and
  an MoE AR model on a data-parallel mesh, raise naming item 9; nor does
  the slot split: a prefix-cache donor is a slot of the same rank.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_rolling as tr
from test_torch_ar_sampler import AR, ar_params
from test_torch_dit import OVERRIDES, configs, param_tree, port_model, \
    random_params
from torch_mesh_worker import ar_lead, rolling_lead, run_world
from unidisc_tpu.config import MeshConfig as JaxMeshConfig
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from unidisc_tpu.parallel.sample import shard_params as jax_shard_params
from unidisc_tpu.serving import rolling as jax_rolling
from unidisc_tpu.serving.engine import InferenceEngine as JaxEngine
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.serving.engine import InferenceEngine, build_engine

cap_test_threads()

MESH = dict(fsdp=2, seq=2)
ROLL_OVER = {**OVERRIDES, **tr.OVER, "sampling.steps": 8,
             "model.text_vocab_size": 300}
SLOTS = 4
MOE = {"model.moe_experts": 4, "model.moe_top_k": 2}
# the int8 headline's settings (the int8 kernel's path, the fused prologue)
INT8 = {"model.quant_backend": "pallas", "model.quant_fused": True}
AR_TEXT = {**AR, "model.length": 48, "model.txt_length": 48,
           "model.img_length": 0, "model.rope_2d": False,
           "model.text_vocab_size": 300, "model.image_vocab_size": 0,
           "model.time_conditioning": False, "sampling.cfg": None,
           "sampling.temperature": 0.0}
PREFIX = "the quick brown fox jumps "
PROMPTS = [PREFIX + "over it", PREFIX + "under", "hi", "a cat sat on",
           "zebra", "lorem ipsum dolor sit amet"]
COMPLETIONS = ([(p, 6, 0.0, 100 + i) for i, p in enumerate(PROMPTS)]
               + [(p, 6, 1.0, 200 + i) for i, p in enumerate(PROMPTS)])


def roll_requests(m):
    """Six requests of (engine.prepare kwargs, steps, seed): t2i,
    caption and infill, 4 and 8 steps."""
    rng = np.random.RandomState(3)
    img = lambda: rng.randint(0, m.image_vocab_size, m.img_length)
    mask = np.zeros(m.img_length, bool)
    mask[: m.img_length // 2] = True
    return [(dict(text="a red cube"), 8, 11),
            (dict(image_ids=img()), 4, 12),
            (dict(text="two cats"), 4, 13),
            (dict(text="a <mask:3> dog", image_ids=img(),
                  image_mask=mask), 8, 14),
            (dict(text="blue sky"), 8, 15),
            (dict(image_ids=img()), 8, 16)]


def chats():
    return [{"messages": [{"role": "user", "content": text}],
             "task": "infill", "steps": steps, "seed": seed,
             "no_batch": True}
            for text, steps, seed in (("a <mask:4> hat", 4, 31),
                                      ("<mask:2> red <mask:2>", 8, 32),
                                      ("one <mask:5>", 4, 33))]


def machine_inputs():
    """tests/test_torch_rolling.py's staggered ragged run on 4 slots."""
    jcfg, tcfg, jmodel, params, model = tr.setup()
    m = tcfg.model
    x0, unmask, modality = tr.rows(m, 3, seed=5)
    unmask[2, 3:m.txt_length] = False
    groups = []
    for chunk in range(2):
        group = [a for a in tr.ADMISSIONS if a[0] == chunk]
        idx = [a[2] for a in group] + [0]
        groups.append((np.asarray([a[1] for a in group] + [SLOTS]),
                       x0[idx], unmask[idx], modality[idx],
                       np.asarray([a[3] for a in group] + [0]),
                       np.asarray([a[4] for a in group] + [tr.STEPS])))
    return dict(config=tcfg, mesh=MESH, sd=model.state_dict(), slots=SLOTS,
                noise=tr.generic_noise(m, SLOTS, seed=9), groups=groups)


@functools.lru_cache(maxsize=None)
def ar_setup():
    """(JAX config, port config, JAX params, port DIT, draft config,
    draft DIT) of the AR engines, made once."""
    jcfg, tcfg = configs(**AR_TEXT)
    params = ar_params(jcfg)
    _, dcfg = configs(**{**AR_TEXT, "model.n_blocks": 1})
    draft = port_model(dcfg, random_params(param_tree(dcfg.model,
                                                      jnp.float32), seed=5))
    return jcfg, tcfg, params, port_model(tcfg, params), dcfg, draft


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    mach = machine_inputs()
    m = build_engine(preset="tiny", device="cpu",
                     overrides=ROLL_OVER).config.model
    jcfg, tcfg, params, model, dcfg, draft = ar_setup()
    inputs = {
        "machine": mach,
        "rolling": {"spec": "fsdp=2,seq=2", "slots": SLOTS,
                    "overrides": ROLL_OVER, "requests": roll_requests(m),
                    "after_error": 1, "chats": chats()},
        "pp_tensor": {"spec": "pp=2,tensor=2,pp_microbatches=2",
                      "slots": SLOTS, "overrides": ROLL_OVER,
                      "requests": [r for r in roll_requests(m)
                                   if "text" in r[0]
                                   and "image_ids" not in r[0]]},
        "pp_tensor_int8": {"spec": "pp=2,tensor=2,pp_microbatches=2",
                           "slots": SLOTS, "quantize": "int8",
                           "overrides": {**ROLL_OVER, **INT8},
                           "requests": [r for r in roll_requests(m)
                                        if "text" in r[0]
                                        and "image_ids" not in r[0]]},
        "moe": {"spec": "dcn=2,ep=2", "slots": SLOTS,
                "overrides": {**ROLL_OVER, **MOE}, "together": True,
                "requests": [(r, 4, 21) for r, _, _ in
                             roll_requests(m)[:4]]},
        "ar": {"config": tcfg, "mesh": MESH, "sd": model.state_dict(),
               "draft_config": dcfg, "draft_sd": draft.state_dict(),
               "completions": COMPLETIONS}}
    world = run_world("serving", 4, tmp_path_factory.mktemp("serving"),
                      timeout=240, inputs=inputs)
    return dict(world=world, inputs=inputs, ar=(jcfg, tcfg, params, model,
                                                dcfg, draft))


def one_rank_rolling(c):
    """The one-rank rolling engine's results for c's requests
    (``rolling_lead``)."""
    eng = build_engine(preset="tiny", device="cpu", rolling=c["slots"],
                       overrides=c["overrides"], quantize=c.get("quantize"))
    try:
        return rolling_lead(eng, c)
    finally:
        eng.shutdown()


def assert_served(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["text"] == w["text"], f"{what} {i}"
        np.testing.assert_array_equal(g["image_ids"], w["image_ids"],
                                      err_msg=f"{what} {i}")


def admitted_rows(state):
    """A batcher state's rows whose slots hold an admitted request (a
    rolling row stays active once done)."""
    return [state["x"][i] for i in range(len(state["active"]))
            if state["active"][i]]


def assert_seq_replicas_equal(world, part, route):
    """On fsdp 2 x seq 2 (ranks fsdp-major: 0, 1 and 2, 3 share their
    slots) the seq replicas end in equal states."""
    for a, b in ((0, 1), (2, 3)):
        sa, sb = (world[r][part]["states"][route] for r in (a, b))
        for k in ("lo", "x", "active", "at"):
            np.testing.assert_array_equal(sa[k], sb[k],
                                          err_msg=f"{route} {a}/{b} {k}")


def test_rolling_state_machine_on_the_mesh_matches_jax(case):
    mach = case["inputs"]["machine"]
    jcfg, _, jmodel, params, _ = tr.setup()
    jmesh = jax_make_mesh(JaxMeshConfig(dcn=1, fsdp=2, tensor=1, seq=2),
                          devices=jax.devices()[:4])
    sharded = jax_shard_params(params, jmesh)
    jbuilt = jax_rolling.build_rolling_sampler(
        tr.jax_forward(jmodel), jcfg, slots=SLOTS, chunk=1,
        inject_noise=True)
    jst = jbuilt.init_state()
    noise = tr.as_jax(mach["noise"])
    for slots, x0, unmask, modality, seeds, steps in mach["groups"]:
        jst = jbuilt.insert_many(
            jst, jnp.asarray(slots), jnp.asarray(x0), jnp.asarray(unmask),
            jnp.asarray(modality), jnp.asarray(seeds, jnp.int32),
            jnp.asarray(steps, jnp.int32))
        jst = jbuilt.step_chunk(sharded, jst, noise)
    jst = tr.jax_drive(jbuilt, sharded, jst, noise)
    want_x, want_step = np.asarray(jst.x), np.asarray(jst.step)
    world = case["world"]
    np.testing.assert_array_equal(world[0]["machine"]["gathered"], want_x)
    assert all(rank["machine"]["gathered"] is None for rank in world[1:])
    for r, rank in enumerate(world):
        got = rank["machine"]
        lo, n = got["lo"], got["slots"]
        assert n == SLOTS // 2
        np.testing.assert_array_equal(got["x"], want_x[lo:lo + n],
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["step"], want_step[lo:lo + n],
                                      err_msg=f"rank {r}")
    assert {rank["machine"]["lo"] for rank in world} == {0, SLOTS // 2}


def test_rolling_engine_on_fsdp_seq_gives_the_one_rank_tokens(case):
    c = case["inputs"]["rolling"]
    want = one_rank_rolling(c)
    world = case["world"]
    assert_served(world[0]["rolling"]["lead"]["results"], want["results"],
                  "request")
    # every rank's admitted t2i rows are the tokens of t2i requests (the
    # last one of each slot it held); the seq replicas computed alike
    t2i = {tuple(w["image_ids"]) for (r, _, _), w in
           zip(c["requests"], want["results"]) if "image_ids" not in r}
    rows = []
    for r, rank in enumerate(world):
        mine = admitted_rows(rank["rolling"]["states"]["rolling:t2i"])
        assert all(tuple(row[8:] - 300) in t2i for row in mine), r
        rows += mine if r in (0, 2) else []
    assert 1 <= len(rows) <= len(t2i)
    for route in ("rolling:t2i", "rolling:generic"):
        assert_seq_replicas_equal(world, "rolling", route)
    assert [world[r]["rolling"]["states"]["rolling:t2i"]["lo"]
            for r in range(4)] == [0, 0, SLOTS // 2, SLOTS // 2]


def test_a_device_error_in_the_leader_resets_every_rank(case):
    c = case["inputs"]["rolling"]
    got = case["world"][0]["rolling"]["lead"]
    assert got["error"] is not None and "planted" in got["error"]
    want = one_rank_rolling({**c, "requests": [c["requests"][
        c["after_error"]]]})
    assert_served(got["after_error"], want["results"], "after the error")
    for r, rank in enumerate(case["world"][1:], 1):
        ops = [op for route, op in rank["rolling"]["ops"]
               if route == "rolling:generic"]
        assert "reset" in ops, r
        # the reset follows a chunk the leader failed, and more ops follow
        i = ops.index("reset")
        assert ops[i - 1] == "chunk" and "insert" in ops[i + 1:], r


def test_the_server_on_rank_0_answers_as_one_rank(case):
    c = case["inputs"]["rolling"]
    got = case["world"][0]["rolling"]["lead"]
    eng = build_engine(preset="tiny", device="cpu", rolling=c["slots"],
                       overrides=c["overrides"])
    try:
        want = []
        for body in c["chats"]:
            p = eng.prepare(text=body["messages"][0]["content"],
                            task="infill")
            want.append(eng.run_batch([p], steps=body["steps"],
                                      seed=body["seed"])[0]["text"])
    finally:
        eng.shutdown()
    assert got["chats"] == want
    assert got["stopped"]


def test_rolling_on_pp_tensor_gives_the_one_rank_tokens(case):
    c = case["inputs"]["pp_tensor"]
    want = one_rank_rolling(c)
    assert_served(case["world"][0]["pp_tensor"]["lead"]["results"],
                  want["results"], "pp x tensor")
    # every rank holds every slot (dp 1) and ends in the same state
    ids = {tuple(w["image_ids"]) for w in want["results"]}
    states = [rank["pp_tensor"]["states"]["rolling:t2i"]
              for rank in case["world"]]
    for r, st in enumerate(states):
        assert all(tuple(row[8:] - 300) in ids
                   for row in admitted_rows(st)), r
        for k in ("x", "active", "at"):
            np.testing.assert_array_equal(st[k], states[0][k], err_msg=k)


def test_int8_rolling_on_pp_tensor_gives_the_one_rank_tokens(case):
    """The int8 W8A8 rolling engine on pp 2 x tensor 2 (its row-parallel
    products through qdot_row_parallel, the fused prologue on each
    microbatch's adaLN rows): the one-rank int8 engine's tokens, every
    rank in the same state."""
    c = case["inputs"]["pp_tensor_int8"]
    want = one_rank_rolling(c)
    assert_served(case["world"][0]["pp_tensor_int8"]["lead"]["results"],
                  want["results"], "int8 pp x tensor")
    states = [rank["pp_tensor_int8"]["states"]["rolling:t2i"]
              for rank in case["world"]]
    for st in states:
        for k in ("x", "active", "at"):
            np.testing.assert_array_equal(st[k], states[0][k], err_msg=k)


def test_moe_rolling_on_dcn_ep_gives_the_one_rank_tokens(case):
    c = case["inputs"]["moe"]
    want = one_rank_rolling(c)
    assert_served(case["world"][0]["moe"]["lead"]["results"],
                  want["results"], "MoE")
    # the four requests fill the four slots, two on each data-parallel
    # rank (dcn-major: ranks 0, 1 hold slots 0-1, ranks 2, 3 slots 2-3)
    ids = {tuple(w["image_ids"]) for w in want["results"]}
    for r, rank in enumerate(case["world"]):
        rows = admitted_rows(rank["moe"]["states"]["rolling:generic"])
        assert len(rows) == 2, r
        assert all(tuple(row[8:] - 300) in ids for row in rows), r


@pytest.fixture(scope="module")
def ar_one_rank(case):
    """The one-rank AR engine's complete_text tokens by mode."""
    _, tcfg, _, model, _, draft = case["ar"]
    out = {}
    for mode, kw in (("plain", {}), ("lookup", {"lookup_ngram": 2}),
                     ("draft", {"ar_draft": draft})):
        eng = InferenceEngine(tcfg, model, device="cpu", **kw)
        try:
            out[mode] = ar_lead(eng, COMPLETIONS)
        finally:
            eng.shutdown()
    return out


@pytest.mark.parametrize("mode", ["plain", "lookup", "draft"])
def test_ar_engine_on_fsdp_seq_gives_the_one_rank_tokens(case, ar_one_rank,
                                                         mode):
    world = case["world"]
    got, want = world[0]["ar"][mode]["lead"], ar_one_rank[mode]
    assert got["tokens"] == want["tokens"]
    assert got["streamed"] == got["tokens"][1]
    assert got["slots"] == 8 and got["chunks"] > 0 and got["drains"] > 0
    # the second prompt shares 26 tokens with the first, resident in slot
    # 0 (rank 0's), which the second takes: a hit on the mesh as on one
    # rank (a donor must be a slot of the same rank)
    assert got["prefix_hits"] >= 1 and want["prefix_hits"] >= 1
    for r, rank in enumerate(world[1:], 1):
        ops = {op for route, op in rank["ar"][mode]["ops"]}
        assert {"insert", "prefix", "chunk", "drain"} <= ops, r
        assert {route for route, op in rank["ar"][mode]["ops"]} == \
            {"continuous"}
    assert_seq_replicas_equal({r: world[r]["ar"] for r in range(4)}, mode,
                              "continuous")


def test_ar_greedy_on_the_mesh_matches_jax_on_its_mesh(case):
    jcfg, _, params, _, _, _ = case["ar"]
    jcfg = dataclasses.replace(jcfg, mesh=JaxMeshConfig(dcn=1, fsdp=2,
                                                        tensor=1, seq=2))
    jmesh = jax_make_mesh(jcfg.mesh, devices=jax.devices()[:4])
    eng = JaxEngine(jcfg, JaxDIT(jcfg.model, compute_dtype=jnp.float32),
                    params, mesh=jmesh)
    greedy = [c for c in COMPLETIONS if c[2] == 0.0]
    futs = [eng.complete_text(t, max_new_tokens=n, temperature=0.0, seed=s)
            for t, n, _, s in greedy]
    want = [f.result(timeout=300)["tokens"] for f in futs]
    eng.continuous.shutdown()
    got = case["world"][0]["ar"]["plain"]["lead"]["tokens"][:len(greedy)]
    assert got == [list(w) for w in want]


@pytest.mark.parametrize("spec,extra", [
    ("tensor=2", {}), ("pp=2", {}), ("ep=2", MOE), ("dcn=2", MOE)])
def test_ar_decoding_where_the_mesh_cannot_run_it_raises_item_9(spec,
                                                                extra):
    with pytest.raises(NotImplementedError, match="item 9"):
        build_engine(preset="tiny", device="cpu", mesh=spec,
                     overrides={**AR_TEXT, **extra})


def test_a_prefix_donor_is_a_slot_of_the_same_rank():
    """The continuous batcher's 8 slots on a data-parallel rank 0 of 2:
    slots 0-3 its own; a resident prompt in slot 1 is a donor for slot 2
    and not for slot 5 (rank 1's)."""
    import types

    from unidisc_tpu_torch.parallel.comm import Axis
    from unidisc_tpu_torch.serving.continuous import ContinuousBatcher
    _, tcfg, _, model, _, _ = ar_setup()
    one = Axis(None, 0, 1)
    layout = types.SimpleNamespace(
        sizes={"pp": 1}, dp_size=2, dp_rank=0, seq_rank=0, tensor=one,
        pp=one, ep=one)
    b = ContinuousBatcher(model, tcfg, slots=7, mesh=layout, worker=False,
                          prefix_min=4)
    assert (b.slots, b.split.local, b.split.lo) == (8, 4, 0)
    assert b.decoder.slots == 4 and b.state.x.shape[0] == 4
    b._slot_prompt[1] = np.arange(1, 11)
    prompt = np.concatenate([np.arange(1, 9), [40, 41]])
    assert b._find_prefix_donor(prompt, 2) == (1, 8)
    assert b._find_prefix_donor(prompt, 5) is None
    assert list(b.split.own([0, 3, 4, 7, 8])) == [0, 3, 4, 4, 4]
    # a batcher's chunk runs a seq group replicated: no collective there
    from unidisc_tpu_torch.parallel.sample import has_collectives
    sizes = dict(dcn=1, fsdp=2, tensor=1, seq=2, pp=1, ep=1)
    layout.sizes = sizes
    assert has_collectives(tcfg, layout) and \
        not has_collectives(tcfg, layout, ring=False)
    layout.sizes = {**sizes, "seq": 1, "pp": 2}
    assert has_collectives(tcfg, layout, ring=False)
    with pytest.raises(RuntimeError, match="replays"):
        b.submit([1, 2, 3])
