"""Autoregressive decoding with a KV cache (port of
``unidisc_tpu/sampling/ar_sampler.py``): the cache allocation and the
decode loop.

The JAX loop is one ``lax.scan`` over positions. Here the loop's state
lives on the device (``ARState``) and the step index is a device tensor,
so ``step_chunk`` runs `chunk` decode steps with no host read, and a
sample is ``n_chunks`` of them: eager, or on the card as one captured
CUDA graph replayed ``n_chunks`` times (``sampling/graph.py::
CapturedARSampler``). Per step the model reads one token at every row's
position i, writes its K/V at i and attends over positions <= i; the next
token is sampled (greedy at temperature <= 0, nucleus with ``top_p``, else
Gumbel-argmax), and positions whose conditioning is given are
teacher-forced. With CFG, rows [0:b] are conditional and [b:2b]
unconditional, their conditioning masked at every step, with the
time-annealed weight over each row's rank among its predicted tokens, or
``force_cfg_value``. Steps past the last position change no token.

Noise: the JAX contract ``injected["gumbel"][i]`` / ``injected["exp"][i]``
((L - 1, b, V) each) for parity; otherwise the keyed noise of
``serving/rolling.py`` (a pure function of the row's seed, the position
written and a tag), bit-identical on the card and the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import resolve_device
from unidisc_tpu_torch.diffusion.subs import (NEG_INFINITY,
                                              restrict_modality_logits)
from unidisc_tpu_torch.sampling.sampler import (SampleResult,
                                                guidance_weight_t,
                                                nucleus_sample)
from unidisc_tpu_torch.serving.rolling import keyed_gumbel, keyed_uniform


def init_kv_cache(n_blocks: int, batch: int, max_len: int, n_heads: int,
                  head_dim: int, dtype=torch.bfloat16, quant: bool = False,
                  device="cpu") -> tuple:
    """A (k, v) cache, each (n_blocks, B, max_len, H, D) zeros in `dtype`.

    With quant=True (``model.kv_cache_dtype == "int8"``): the 4-tuple
    (k_q, k_scale, v_q, v_scale) of int8 zeros and per-(position, head)
    fp32 scales (n_blocks, B, max_len, H, 1) set to 1."""
    shape = (n_blocks, batch, max_len, n_heads, head_dim)
    if quant:
        sshape = (n_blocks, batch, max_len, n_heads, 1)
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(sshape, dtype=torch.float32, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(sshape, dtype=torch.float32, device=device))
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_kv_cache_for(m, batch: int, max_len: Optional[int] = None,
                      device="cpu") -> tuple:
    """The cache of a ModelConfig `m`: bf16, or int8 under
    ``m.kv_cache_dtype == "int8"``."""
    return init_kv_cache(m.n_blocks, batch, max_len or m.length, m.n_heads,
                         m.head_dim, quant=m.kv_cache_dtype == "int8",
                         device=device)


def make_apply_token(model):
    """The DIT as the decode loop calls it: apply_token(tok (B, l), kv,
    cache_index, modality_tok (B, l)) -> (logits (B, l, V), kv), at
    sigma 0."""
    def apply_token(tok, kv_cache, cache_index, modality_tok):
        sigma = torch.zeros((tok.shape[0],), device=tok.device)
        return model(tok, sigma, modality=modality_tok, kv_cache=kv_cache,
                     cache_index=cache_index)
    return apply_token


# the keyed-noise tags of the decode loop's draws
TAG_GUMBEL, TAG_EXP = 5, 6


def row_seeds(seed: int, b: int) -> np.ndarray:
    """The per-row seeds of a call's seed (the rolling engine's
    derivation)."""
    return np.asarray([(seed * 0x9E3779B1 + r) & 0x7FFFFFFF
                       for r in range(b)], np.int64)


class ARState(NamedTuple):
    x: torch.Tensor          # (bb, L) long tokens (bb = 2b under CFG)
    x0: torch.Tensor         # (bb, L) long given tokens
    unmask: torch.Tensor     # (bb, L) bool teacher-forced positions
    modality: torch.Tensor   # (bb, L) long
    kv: tuple                # the DIT's stacked cache
    i: torch.Tensor          # () long: the position read next; L - 1 = done
    seed: torch.Tensor       # (b,) long row seeds
    pred_rank: torch.Tensor  # (b, L) long 1-based rank among predicted
    num_pred: torch.Tensor   # (b,) fp32 predicted count, at least 1
    noise: dict              # injected noise buffers (L - 1, b, V)


class ARSampler:
    """The decode loop of ``build_ar_sampler``."""

    def __init__(self, apply_token, config: Config, chunk: int,
                 inject_noise: bool, device):
        self.device = resolve_device(device)
        self.apply_token, self.config = apply_token, config
        m, s = config.model, config.sampling
        if m.full_attention:
            raise ValueError("AR decoding needs a causal model "
                             "(model.full_attention=False)")
        self.use_cfg = s.cfg is not None
        self.chunk = chunk
        self.inject_noise = inject_noise
        self.length = m.length
        self.n_chunks = math.ceil((m.length - 1) / chunk)
        self.graphs = {}    # sampling/graph.py's cache, by batch size

    def noise_keys(self) -> tuple:
        s = self.config.sampling
        if s.temperature <= 0:
            return ()
        return ("exp",) if s.top_p is not None else ("gumbel",)

    def init_state(self, b: int) -> ARState:
        """Buffers for b requests, in the done state (a chunk changes no
        token)."""
        m, dev, L = self.config.model, self.device, self.length
        bb = 2 * b if self.use_cfg else b
        z = lambda *shape: torch.zeros(shape, dtype=torch.long, device=dev)
        return ARState(
            x=z(bb, L), x0=z(bb, L),
            unmask=torch.zeros((bb, L), dtype=torch.bool, device=dev),
            modality=z(bb, L), kv=init_kv_cache_for(m, bb, L, device=dev),
            i=torch.full((), L - 1, dtype=torch.long, device=dev),
            seed=z(b), pred_rank=z(b, L),
            num_pred=torch.ones((b,), device=dev),
            noise={k: torch.zeros((L - 1, b, m.vocab_size), device=dev)
                   for k in (self.noise_keys() if self.inject_noise
                             else ())})

    @torch.no_grad()
    def load(self, state: ARState, x0, x0_unmask, modality=None, *,
             seed: int = 0, injected=None) -> None:
        """Write one call's inputs into `state` in place and set i = 0."""
        if (injected is not None) != self.inject_noise:
            raise ValueError("pass `injected` exactly when the sampler was "
                             "built with inject_noise=True")
        m = self.config.model
        x0 = np.asarray(torch.as_tensor(x0).cpu(), np.int64)
        unmask = np.asarray(torch.as_tensor(x0_unmask).cpu(), bool)
        b, L = x0.shape
        if L != self.length or state.seed.shape[0] != b:
            raise ValueError(f"inputs {x0.shape} differ from the state's "
                             f"({state.seed.shape[0]}, {self.length})")
        mod = np.zeros((b, L), np.int64) if modality is None else \
            np.asarray(torch.as_tensor(modality).cpu(), np.int64)
        x_init = np.where(unmask, x0, m.mask_index)
        rows = {"x": x_init, "x0": x0, "unmask": unmask, "modality": mod}
        if self.use_cfg:
            masked = np.full_like(x0, m.mask_index)
            rows = {"x": np.concatenate([x_init, masked]),
                    "x0": np.concatenate([x0, masked]),
                    "unmask": np.concatenate([unmask, unmask]),
                    "modality": np.concatenate([mod, mod])}
        for name, value in rows.items():
            getattr(state, name).copy_(torch.from_numpy(value))
        state.seed.copy_(torch.from_numpy(row_seeds(seed, b)))
        state.pred_rank.copy_(torch.from_numpy(np.cumsum(~unmask, axis=1)))
        state.num_pred.copy_(torch.from_numpy(
            np.maximum((~unmask).sum(-1), 1).astype(np.float32)))
        for key, buf in state.noise.items():
            buf.copy_(torch.as_tensor(np.asarray(injected[key]),
                                      dtype=torch.float32))
        state.i.zero_()

    def _step(self, st: ARState) -> None:
        m, s = self.config.model, self.config.sampling
        L, b = self.length, st.seed.shape[0]
        bb = st.x.shape[0]
        live = st.i < L - 1
        i = st.i.clamp(max=L - 1).view(1, 1)
        nxt = (st.i + 1).clamp(max=L - 1).view(1, 1)
        tok = st.x.gather(1, i.expand(bb, 1))
        mod_tok = st.modality.gather(1, i.expand(bb, 1))
        logits, _ = self.apply_token(tok, st.kv, i.view(1).expand(bb),
                                     mod_tok)
        logits = logits[:, 0].float()
        mod_next = st.modality.gather(1, nxt.expand(bb, 1))[:, 0]
        ids = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits + torch.where(ids == m.mask_index, NEG_INFINITY, 0.0)
        if m.force_argmax_valid_indices:
            logits = restrict_modality_logits(logits, mod_next,
                                              m.text_vocab_size)
        if self.use_cfg:
            lc, lu = logits.chunk(2, dim=0)
            if s.force_cfg_value:
                w = torch.full((b, 1), s.cfg, device=logits.device)
            else:
                pr = st.pred_rank.gather(1, nxt.expand(b, 1))[:, 0]
                t_i = 1.0 - (pr - 1).float() / st.num_pred
                w = guidance_weight_t(s, t_i.clamp(0.0, 1.0))[:, None]
            logits = (1 + w) * lc - w * lu
        noise_i = (st.i.clamp(max=L - 2)).view(1)
        pos = nxt.view(1).expand(b)
        if s.top_p is not None and s.temperature > 0:
            probs = torch.softmax(logits / s.temperature, dim=-1)
            e = st.noise["exp"].index_select(0, noise_i)[0] \
                if "exp" in st.noise else -torch.log(keyed_uniform(
                    st.seed, pos, TAG_EXP, probs.shape[-1]))
            new = nucleus_sample(probs, s.top_p, exp_noise=e)
        elif s.temperature <= 0:
            new = torch.argmax(logits, dim=-1)
        else:
            g = st.noise["gumbel"].index_select(0, noise_i)[0] \
                if "gumbel" in st.noise else keyed_gumbel(
                    st.seed, pos, TAG_GUMBEL, logits.shape[-1])
            new = torch.argmax(logits / s.temperature + g, dim=-1)
        if self.use_cfg:
            new = torch.cat([new, new])
        forced = st.unmask.gather(1, nxt.expand(bb, 1))
        given = st.x0.gather(1, nxt.expand(bb, 1))
        old = st.x.gather(1, nxt.expand(bb, 1))
        new = torch.where(forced, given, new[:, None])
        st.x.scatter_(1, nxt.expand(bb, 1), torch.where(live, new, old))
        st.i.add_(live.long())

    @torch.no_grad()
    def step_chunk(self, state: ARState, injected=None) -> ARState:
        """`chunk` decode steps, in place; no host read."""
        for _ in range(self.chunk):
            self._step(state)
        return state

    def result(self, state: ARState) -> SampleResult:
        b = state.seed.shape[0]
        return SampleResult(tokens=state.x[:b].clone(), nfe=self.length - 1)

    @torch.no_grad()
    def __call__(self, x0, x0_unmask, modality=None, *, seed: int = 0,
                 injected=None) -> SampleResult:
        """sample(x0 (b, L), x0_unmask (b, L) bool, modality) eager: the
        whole decode, ``n_chunks`` chunks."""
        state = self.init_state(np.shape(x0)[0])
        self.load(state, x0, x0_unmask, modality, seed=seed,
                  injected=injected)
        for _ in range(self.n_chunks):
            self.step_chunk(state)
        return self.result(state)


def build_ar_sampler(apply_token, config: Config, *, chunk: int = 16,
                     inject_noise: bool = False, device="cuda") -> ARSampler:
    """The AR decode loop over `apply_token` (``make_apply_token(model)``,
    the model on `device` and in eval mode): sample(x0, x0_unmask,
    modality=None, *, seed=0, injected=None) -> SampleResult, x0 (b, L)
    with the given tokens where x0_unmask is True, the rest generated left
    to right; ``config.sampling``: cfg (with force_cfg_value), top_p,
    temperature. inject_noise=True: `injected` holds "gumbel" or (with
    top_p) "exp", (L - 1, b, V) each, step i reading [i], the JAX
    contract. On the card ``sampling/graph.py::captured_ar`` runs it as a
    captured chunk program."""
    return ARSampler(apply_token, config, chunk, inject_noise, device)
