"""The step loops of the continuous samplers: a run's draws, a per-state
energy batched over chains, and a loop of fixed-shape steps replayed from
CUDA graphs.

The reference runs a whole trajectory as one ``lax.scan`` that XLA compiles.
Eager PyTorch pays the host for every small operation instead (tens of
microseconds each, two gradients and about ten elementwise operations per
Langevin step), so each sampler here runs its fixed-shape loop as a
:class:`StepLoop`: L steps on buffers that stay put. On a CUDA device each
length L is captured once as a CUDA graph and replayed; on the CPU, or when
the capture fails, the steps run eagerly.

**Draws.** The reference splits a JAX key per chain and per step. The port
draws each (L, ...) block of a loop's normals, uniforms and integers with
one call on the run's device generator, into the loop's static buffers
before each replay (:class:`Draws`). Graph and eager runs fill the buffers
alike, so they see the same draws. The tests hand the reference's own draws
in instead (``Draws(given=...)``), consumed in order along their first axis.

**Energies.** :class:`Potential` batches a per-state energy over chains with
``torch.func.vmap`` of ``torch.func.grad_and_value``. An energy that vmap
cannot batch (it calls ``.item()`` or branches on a value) is evaluated
chain by chain, eagerly, with one warning.

**Routes.** ``StepLoop.route`` is ``"graph"`` when every length it ran
replayed a graph and ``"eager"`` otherwise. A capture that fails (an energy
that copies host memory to the card, or synchronises) leaves the loop eager,
with one warning: the route is visible, not a hidden fall-back.

**Cache.** :func:`cached_loop` keeps the last few loops, keyed by the
sampler, its energy, the shapes and the static settings, so a second run
with the same key replays the graphs the first captured. Numbers that vary
between runs (temperatures, step sizes) live in device tensors of the
loop's state, not in the graph.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap

MAX_LOOPS = 8          # loops (and their graphs) kept by cached_loop


def chunks(n: int, length: int):
    """``n`` steps as runs of ``length`` (the last one shorter)."""
    length = max(1, length)
    for _ in range(n // length):
        yield length
    if n % length:
        yield n % length


class Draws:
    """The random draws of one run.

    ``gen``: a generator on the run's device; each :meth:`fill` draws a
    fresh block from it. ``given``: a dict of tensors, one per name, whose
    leading axis :meth:`fill` consumes in order (the reference's draws in
    the tests); an int stream is given as its values."""

    def __init__(self, gen: Optional[torch.Generator] = None, given: Optional[dict] = None):
        if (gen is None) == (given is None):
            raise ValueError("Draws takes a generator or given draws, not both")
        self.gen = gen
        self.given = given
        self._pos: Dict[str, int] = {}

    def fill(self, name: str, kind: str, out: torch.Tensor, low: int = 0, high: int = 1):
        """Fill ``out`` with the next draws of ``name``: ``kind`` is
        "normal", "uniform" ([0, 1)) or "int" ([low, high))."""
        if self.given is not None:
            i = self._pos.get(name, 0)
            src = torch.as_tensor(self.given[name])[i:i + out.shape[0]]
            if src.shape != out.shape:
                raise ValueError(f"given draws {name!r} ran out or have the wrong shape: "
                                 f"{tuple(src.shape)} for {tuple(out.shape)}")
            out.copy_(src)
            self._pos[name] = i + out.shape[0]
        elif kind == "normal":
            out.normal_(generator=self.gen)
        elif kind == "uniform":
            out.uniform_(generator=self.gen)
        else:
            out.random_(low, high, generator=self.gen)


class Potential:
    """A per-state energy ``fn((dim,)) -> scalar`` over a batch of states
    (chains, dim): values (chains,) and gradients (chains, dim).

    ``probe`` (chains, dim) checks once that vmap can batch ``fn``; if it
    cannot, ``batched`` is False and every call loops over the chains."""

    def __init__(self, fn: Callable, probe: torch.Tensor, what: str = "energy"):
        self.fn = fn
        self._vg = vmap(grad_and_value(fn))
        self._v = vmap(fn)
        self.batched = True
        try:
            self._vg(probe[:1])
        except RuntimeError as e:
            self.batched = False
            warnings.warn(f"the {what} cannot be batched over chains by torch.func.vmap "
                          f"({str(e).splitlines()[0]}); it runs chain by chain, eagerly",
                          RuntimeWarning, stacklevel=3)

    def value_and_grad(self, x: torch.Tensor):
        """(values (chains,), gradients (chains, dim)) at x (chains, dim)."""
        if self.batched:
            g, v = self._vg(x)
            return v, g
        out = [grad_and_value(self.fn)(xi) for xi in x]
        return (torch.stack([v.reshape(()) for _, v in out]),
                torch.stack([g for g, _ in out]))

    def grad(self, x: torch.Tensor) -> torch.Tensor:
        return self.value_and_grad(x)[1]

    def value(self, x: torch.Tensor) -> torch.Tensor:
        if self.batched:
            return self._v(x)
        return torch.stack([self.fn(xi).reshape(()) for xi in x])


class StepLoop:
    """``step(bufs, k)``, one step that reads its draws at ``bufs[name][k]``
    and writes its outputs to ``bufs[out][k]``, run L steps at a time on
    buffers that stay put.

    ``state``: name -> tensor, what the steps update in place (restored
    after the capture's warm-up step). ``draws``: name -> (kind, per-step shape,
    dtype[, low, high]) of the draws a step takes; ``outs``: name ->
    (per-step shape, dtype) of what a step records. ``graph``: capture each
    length once on a CUDA device and replay it (default); False runs the
    steps eagerly there too. ``batched``: False when the energy runs chain
    by chain (the loop is then eager)."""

    def __init__(self, name: str, device: torch.device, step: Callable, state: dict,
                 draws: dict, outs: Optional[dict] = None, graph: bool = True,
                 batched: bool = True):
        self.name = name
        self.device = torch.device(device)
        self.step = step
        self.state = state
        self.draw_specs = draws
        self.out_specs = outs or {}
        self.graph = graph and batched and self.device.type == "cuda"
        self._bufs: Dict[int, dict] = {}
        self._graphs: Dict[int, torch.cuda.CUDAGraph] = {}

    @property
    def route(self) -> str:
        return "graph" if self.graph else "eager"

    def buffers(self, L: int) -> dict:
        """The static buffers of length L: the draws and the outputs."""
        if L not in self._bufs:
            bufs = {}
            for name, (kind, shape, dtype, *_) in self.draw_specs.items():
                bufs[name] = torch.empty((L, *shape), dtype=dtype, device=self.device)
            for name, (shape, dtype) in self.out_specs.items():
                bufs[name] = torch.zeros((L, *shape), dtype=dtype, device=self.device)
            self._bufs[L] = bufs
        return self._bufs[L]

    def fill(self, draws: Draws, L: int) -> dict:
        bufs = self.buffers(L)
        for name, (kind, _, _, *bounds) in self.draw_specs.items():
            draws.fill(name, kind, bufs[name], *bounds)
        return bufs

    def steps(self, bufs: dict, L: int):
        for k in range(L):
            self.step(bufs, k)

    def _capture(self, L: int, bufs: dict):
        keep = {name: t.clone() for name, t in self.state.items()}
        current = torch.cuda.current_stream(self.device)
        try:
            # Warm up on a side stream (cuBLAS and the energy's constants are
            # set up outside the capture), then capture L steps.
            side = torch.cuda.Stream(device=self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.steps(bufs, 1)
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.steps(bufs, L)
        except RuntimeError as e:
            graph = None
            self.graph = False
            torch.cuda.synchronize(self.device)
            warnings.warn(f"{self.name}: the step loop could not be captured as a CUDA graph "
                          f"({str(e).splitlines()[0]}); it runs eagerly (route 'eager')",
                          RuntimeWarning, stacklevel=4)
        finally:
            for name, t in self.state.items():
                t.copy_(keep[name])
        return graph

    def run(self, draws: Draws, L: int) -> dict:
        """Fill the draws of L steps and run them; returns the buffers
        (read the outputs before the next run of the same length)."""
        bufs = self.fill(draws, L)
        if self.graph and L not in self._graphs:
            graph = self._capture(L, bufs)
            if graph is not None:
                self._graphs[L] = graph
        if self.graph:
            self._graphs[L].replay()
        else:
            self.steps(bufs, L)
        return bufs


def route_of(*loops: StepLoop) -> str:
    """"graph" when every loop replayed graphs, else "eager"."""
    return "graph" if all(lp.route == "graph" for lp in loops) else "eager"


_LOOPS: "OrderedDict[tuple, object]" = OrderedDict()


def cached_loop(key: tuple, build: Callable):
    """``build()``'s loop, kept under ``key`` (the MAX_LOOPS most recent);
    an unhashable key (an energy that is not hashable) builds anew."""
    try:
        hash(key)
    except TypeError:
        return build()
    loop = _LOOPS.pop(key, None)
    if loop is None:
        loop = build()
    _LOOPS[key] = loop
    while len(_LOOPS) > MAX_LOOPS:
        _LOOPS.popitem(last=False)
    return loop


def canonical(device) -> torch.device:
    """``device`` with its index (a CUDA device without one is the current
    card), so that equal devices key the cache alike."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def as_states(x, device) -> torch.Tensor:
    """States (numpy, a tensor or nested lists) as a float32 (chains, dim)
    tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.float32))
    return torch.atleast_2d(x.to(device=device, dtype=torch.float32))


def scalar(value, device) -> torch.Tensor:
    """A float32 0-dim tensor on ``device``."""
    return torch.tensor(float(value), dtype=torch.float32, device=device)


# Dual averaging of the log step size (Nesterov; Hoffman & Gelman), the
# reference's constants.
DA_GAMMA, DA_T0, DA_KAPPA = 0.05, 10.0, 0.75


def adaptation_state(step_size: float, device) -> dict:
    """The dual-averaging state, 0-dim float32 tensors: log_eps and
    log_eps_bar at log(step_size), h_bar and the count t at 0, and mu =
    log(10 step_size)."""
    s = scalar(step_size, device)
    return {"log_eps": torch.log(s), "log_eps_bar": torch.log(s), "h_bar": scalar(0.0, device),
            "t": scalar(0.0, device), "mu": torch.log(10.0 * s)}


def dual_average(st: dict, stat: torch.Tensor, target: float, clip: bool):
    """One dual-averaging update of ``st`` (:func:`adaptation_state`) toward
    ``target`` from the statistic ``stat`` (the mean over chains), in place;
    ``clip`` holds log_eps in [-10, 2]."""
    tf = st["t"] + 1.0
    h_bar = (1.0 - 1.0 / (tf + DA_T0)) * st["h_bar"] + (target - stat) / (tf + DA_T0)
    log_eps = st["mu"] - torch.sqrt(tf) / DA_GAMMA * h_bar
    if clip:
        log_eps = torch.clamp(log_eps, -10.0, 2.0)
    eta = tf ** (-DA_KAPPA)
    st["log_eps_bar"].copy_(eta * log_eps + (1.0 - eta) * st["log_eps_bar"])
    st["log_eps"].copy_(log_eps)
    st["h_bar"].copy_(h_bar)
    st["t"].copy_(tf)


def record(bufs: dict, samples: torch.Tensor, i: int, L: int) -> int:
    """Copy the L states a loop recorded (``bufs["x"]``, (L, chains, dim))
    into samples[:, i:i+L]; returns i + L."""
    samples[:, i:i + L].copy_(bufs["x"].transpose(0, 1))
    return i + L
