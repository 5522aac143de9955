"""The samplers as captured CUDA-graph programs: the port's counterpart of
the JAX package's ``jax.jit`` around a sampler's ``lax.scan`` (one compiled
program with no host round trip, ``unidisc_tpu/sampling/sampler.py:1-8``).

``captured(sampler, batch)`` takes a built sampler
(``t2i_fast.build_t2i_sampler`` or ``sampler.build_sampler``) and a batch
size and returns a ``CapturedSampler``, cached on the sampler per batch
size. Its call

  1. copies its inputs (text tokens, or x0 / x0_unmask / modality, and any
     injected noise) into static device buffers;
  2. reseeds the program's own generator;
  3. replays one ``torch.cuda.CUDAGraph`` that holds the whole denoise
     loop (every step, every kernel);
  4. runs the sampler's noise-removal pass after it (one host read of
     whether a mask is left, and a forward only if one is) and returns the
     tokens cloned out of the graph's memory pool.

The capture: the sampler's per-batch constants are uploaded and its
denoise loop runs once on a side stream first (that builds and loads the
kernels, initialises cuBLAS and settles the allocator), then the loop is
captured on the program's generator. Every operand of the hand kernels
(their TMA tensor maps are encoded on the host at launch and reach the
kernel by value) then lies in the static buffers, the sampler's constants
or the graph's pool, so a replay reads the same addresses. A failed
capture or replay raises; nothing falls back to the eager loop.

Launch counts: ``ops/_build.launch_counts`` counts in Python where a
wrapper launches, so a capture would count launches the device never ran
and a replay none. The capture's counts are taken out again and recorded,
and each replay adds them: the counts are what the device ran.

ddpm_cache reads a device flag each step to skip its forward
(``capturable`` is False) and is not captured.

``CapturedChunk(built)`` does the same for a rolling sampler's
``step_chunk`` (``serving/rolling.py``) and for the continuous AR
decoder's (``serving/continuous.py``): one graph over the program's own
static state, replayed once a chunk, with the new rows written into that
state between replays. ``captured_ar(sampler, batch)`` holds the AR decode
loop (``sampling/ar_sampler.py``) as one captured chunk of decode steps
whose step index lives on the device, replayed until the sequence ends.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import torch

from unidisc_tpu_torch.ops import _build
from unidisc_tpu_torch.sampling.sampler import SampleResult


def capture(run, dev: torch.device, generator=None):
    """`run()` captured in a CUDA graph: a warm run on a side stream (it
    builds and loads the kernels, initialises cuBLAS and settles the
    allocator), then the capture, on `generator` if given. The launch
    counts of the capture are taken out of ``_build.launch_counts`` and
    returned, for each replay to add. Returns (graph, run's output in the
    graph's memory, launches a replay)."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    register = getattr(graph, "register_generator_state", None)
    if generator is not None and register is not None:
        register(generator)
    before = collections.Counter(_build.launch_counts)
    with torch.cuda.graph(graph):
        out = run()
    torch.cuda.synchronize(dev)
    launches = collections.Counter(_build.launch_counts)
    launches.subtract(before)
    for name, n in launches.items():
        _build.launch_counts[name] -= n
        if _build.launch_counts[name] == 0:
            del _build.launch_counts[name]
    return graph, out, +launches


class CapturedSampler:
    """One sampler's denoise loop at one batch size, captured."""

    def __init__(self, sampler, batch: int):
        dev = sampler.device
        if dev.type != "cuda":
            raise ValueError(f"a captured sampler runs on the card; this "
                             f"sampler runs on {dev}")
        if not sampler.capturable:
            raise ValueError("this sampler reads the device inside its "
                             "loop (ddpm_cache) and cannot be captured")
        if getattr(sampler, "return_trajectory", False):
            raise ValueError("a captured sampler returns no trajectory")
        self.sampler, self.batch = sampler, batch
        self.generator = torch.Generator(device=dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            self.static = sampler.example_inputs(batch)
            self.graph, (self.x, self.state), self.launches = capture(
                lambda: sampler.denoise(self.static, self.generator), dev,
                self.generator)
        self.build_s = time.perf_counter() - t0

    def __call__(self, *args, seed: int = 0, injected=None) -> SampleResult:
        """The sampler's call on `batch` rows: args are the eager sampler's
        positional inputs; `seed` seeds the program's generator (unused
        under injected noise)."""
        with torch.inference_mode():
            inputs = self.sampler.prepare(*args, injected=injected)
            if set(inputs) != set(self.static):
                raise ValueError(f"inputs {sorted(inputs)} differ from the "
                                 f"captured {sorted(self.static)}")
            for name, value in inputs.items():
                if value.shape != self.static[name].shape:
                    raise ValueError(
                        f"{name} has shape {tuple(value.shape)}; the "
                        f"program was captured at "
                        f"{tuple(self.static[name].shape)}")
                self.static[name].copy_(value)
            self.generator.manual_seed(seed)
            self.graph.replay()
            _build.launch_counts.update(self.launches)
            out = self.sampler.finish(self.x, self.state, self.static)
            return SampleResult(tokens=out.tokens.clone(), nfe=out.nfe)


class CapturedChunk:
    """A rolling sampler's ``step_chunk`` (``serving/rolling.py``) as one
    captured CUDA graph over its own static state, ``self.state`` (and,
    with inject_noise, static noise buffers), by the recipe above: a warm
    run on a side stream, the capture, the launch counts taken out and
    re-added at each replay. Both run on the freshly made state, where
    every row is inactive, so neither changes it. The state's rows are
    written between replays by ``insert_many``, in place."""

    def __init__(self, built):
        dev = built.device
        if dev.type != "cuda":
            raise ValueError(f"a captured chunk runs on the card; this "
                             f"sampler runs on {dev}")
        self.built = built
        t0 = time.perf_counter()
        with torch.no_grad():
            self.state = built.init_state()
            self.injected = None
            if getattr(built, "inject_noise", False):
                self.injected = {name: torch.ones(shape, device=dev)
                                 for name, shape in
                                 built.noise_shapes().items()}
            self.graph, _, self.launches = capture(
                lambda: built.step_chunk(self.state, self.injected), dev)
        self.build_s = time.perf_counter() - t0
        self.replays = 0

    def step_chunk(self, state=None, injected=None):
        """`chunk` denoise iterations: one replay. A state other than the
        program's own is copied in and the result copied back (in place
        both ways); injected noise is copied into the static buffers."""
        if (injected is not None) != (self.injected is not None):
            raise ValueError("pass `injected` exactly when the sampler was "
                             "built with inject_noise=True")
        own = state is None or state is self.state
        with torch.no_grad():
            if not own:
                for dst, src in zip(self.state, state):
                    dst.copy_(src)
            for name, value in (injected or {}).items():
                if value is not self.injected[name]:
                    self.injected[name].copy_(torch.as_tensor(value))
            self.graph.replay()
            self.replays += 1
            _build.launch_counts.update(self.launches)
            if not own:
                for dst, src in zip(state, self.state):
                    dst.copy_(src)
        return self.state if own else state


class CapturedARSampler:
    """The AR decode loop (``sampling/ar_sampler.py``) at one batch size:
    one chunk of decode steps captured over the program's own state,
    whose step index is a device tensor; a sample loads its inputs into
    that state and replays the chunk ``n_chunks`` times, with no host read
    between replays."""

    def __init__(self, sampler, batch: int):
        dev = sampler.device
        if dev.type != "cuda":
            raise ValueError(f"a captured sampler runs on the card; this "
                             f"sampler runs on {dev}")
        self.sampler, self.batch = sampler, batch
        t0 = time.perf_counter()
        with torch.no_grad():
            # the state starts done: the warm run and the capture change
            # no token
            self.state = sampler.init_state(batch)
            self.graph, _, self.launches = capture(
                lambda: sampler.step_chunk(self.state), dev)
        self.build_s = time.perf_counter() - t0

    def __call__(self, x0, x0_unmask, modality=None, *, seed: int = 0,
                 injected=None) -> SampleResult:
        with torch.no_grad():
            self.sampler.load(self.state, x0, x0_unmask, modality,
                              seed=seed, injected=injected)
            for _ in range(self.sampler.n_chunks):
                self.graph.replay()
                _build.launch_counts.update(self.launches)
            return self.sampler.result(self.state)


def captured_ar(sampler, batch: int) -> CapturedARSampler:
    """The captured program of an AR sampler at `batch` rows, built at
    first use and kept on the sampler."""
    program = sampler.graphs.get(batch)
    if program is None:
        program = sampler.graphs[batch] = CapturedARSampler(sampler, batch)
    return program


def captured(sampler, batch: int) -> CapturedSampler:
    """The captured program of `sampler` at `batch` rows, built at first
    use and kept on the sampler."""
    program: Optional[CapturedSampler] = sampler.graphs.get(batch)
    if program is None:
        program = sampler.graphs[batch] = CapturedSampler(sampler, batch)
    return program
