"""Dense-coupling Gibbs sampling of binary Boltzmann machines.

Counterpart of ``tsu_tpu/samplers/gibbs.py``. Conventions:
    E(b) = -1/2 b^T J b - h^T b over bits b in {0,1}^n
    P(b_i = 1 | rest) = sigmoid(((J b)_i - J_ii b_i + h_i) / T)

The coupling graph is coloured greedily on the host (:func:`color_groups`):
sites of one colour do not couple, so a whole colour updates at once from
one matrix product, and a sweep over the colours is a systematic-scan Gibbs
sweep with the sites reordered by colour.

**One colour step serves every route.** :class:`ColourPlan` permutes J's
rows and columns once so that each colour is a contiguous slice of the
permuted sites (n rows in all, no padding), and the chains' states live in
that order. A colour step on the slice a:b is

    field = states @ J[a:b].T + h[a:b] - diag[a:b] * states[:, a:b]
    states[:, a:b] = u[:, a:b] < sigmoid(field / T)

in float32 (the matrix product at PyTorch's default precision: no TF32)
with injected uniforms ``u``. The sequential route is the same step with one
site per colour in index order; ``random_order`` draws a fresh order of the
colours (of the sites, for the sequential route) every sweep. The JAX
package's one-hot tables and its gather budget served the TPU's matrix unit
and have no counterpart here.

**On the card a sweep is one launch or one CUDA graph** (:class:`DenseSweeper`),
as :func:`dense_route` picks from the plan's widest colour, the chain count
and the kernel's blocks that the card runs at once. A plan of narrow
colours (a site a colour for SK and the sequential route, tens of sites for
a dense MAX-CUT graph) sweeps in one launch of the hand-written kernel K10
(``ops/dense_sweep_kernel.py:dense_colour_sweep``), which computes
``colour_step`` site for site. A plan of wide colours (a dense lattice's
few colours of ~n/2 sites), where one matrix product a colour is the better
tool, replays a CUDA graph of the colour loop, captured once per (plan,
chains). Either way the sweep's uniforms are drawn by one ``torch.rand``
before the sweep and the temperature is a device tensor, so annealing and
tempering reuse the launch or the graph. A capture that fails raises.
``random_order`` runs the colour loop eagerly, one step at a time, as does
every CPU run.

Routes of :meth:`GibbsSampler.sample_boltzmann` (``last_route``):
``"native_cpp"`` for tiny sequential or random-order jobs without an initial
state (the port's copy of the native C++ sampler), ``"iid"`` for a
coupling-free J (one exact Bernoulli draw on the sampler's device) and
``"device"`` for the colour-step engine on the sampler's device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from tsu_tpu_torch import profiling
from tsu_tpu_torch.config import GibbsConfig, SamplingError, resolve_device
from tsu_tpu_torch.ops import dense_sweep_kernel
from tsu_tpu_torch.rng import as_generator, device_generator

# The widest colour, times the waves of blocks that the chains take, that
# the fused kernel sweeps. At 4,096 sites on an H100, K10 against the graph
# in ms a sweep: colours of 64, 1.09 / 1.32 at 8 chains (a wave), 4.34 /
# 2.83 at 528 (four); of 128, 1.07 / 0.68 at 8; of 16, 10.0 / 11.2 at 1,056
# (eight waves), 39.9 / 29.4 at 4,096 (PERF.md §6, chip_smoke.py phase 44).
FUSED_WIDEST = 64


def color_groups(J, atol: float = 0.0) -> np.ndarray:
    """Greedy graph colouring of the dense coupling matrix, highest degree
    first; equal to ``tsu_tpu.samplers.gibbs.color_groups``.

    Returns an int32 array ``(n_colors, group_max)`` of site indices padded
    with the sentinel ``n``. Sites of one row never couple (|J_ij| <= atol).
    """
    J = np.asarray(J)
    n = J.shape[0]
    adj = np.abs(J) > atol
    adj |= adj.T
    np.fill_diagonal(adj, False)
    order = np.argsort(-adj.sum(axis=1), kind="stable")
    color = np.full(n, -1, dtype=np.int64)
    for i in order:
        # The least colour that no coloured neighbour holds.
        used = np.zeros(n + 1, dtype=bool)
        nbr = color[adj[i]]
        used[nbr[nbr >= 0]] = True
        color[i] = int(np.argmin(used))
    n_colors = int(color.max()) + 1 if n else 1
    counts = np.bincount(color, minlength=n_colors) if n else np.zeros(1, np.int64)
    out = np.full((n_colors, max(int(counts.max()), 1) if n else 1), n, dtype=np.int32)
    for c in range(n_colors):
        g = np.nonzero(color == c)[0]
        out[c, : len(g)] = g
    return out


def boltzmann_energy_batch(states: torch.Tensor, J: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """E(b) = -1/2 b^T J b - h^T b over a batch (..., n), in the states'
    dtype on their device."""
    return -0.5 * ((states @ J) * states).sum(-1) - states @ h


class ColourPlan:
    """Dense (J, h) laid out for colour steps on ``device``: the sites
    permuted so that each colour is a contiguous slice.

    ``colors``: :func:`color_groups` output (computed when None), or
    ``sequential=True`` for one site per colour in index order. ``perm[k]``
    is the site at plan position k; ``bounds[c]`` the slice (a, b) of colour
    c; ``J``, ``h``, ``diag`` the permuted float32 tensors.
    """

    def __init__(self, J, h, colors=None, *, sequential: bool = False, device=None):
        with profiling.annotate("dense.plan"):
            self._build(J, h, colors, sequential, device)

    def _build(self, J, h, colors, sequential: bool, device):
        J = np.asarray(J, dtype=np.float32)
        if J.ndim != 2 or J.shape[0] != J.shape[1]:
            raise SamplingError(f"coupling must be square, got shape {J.shape}")
        n = J.shape[0]
        h = np.asarray(h, dtype=np.float32).reshape(-1)
        if sequential:
            perm = np.arange(n)
            sizes = np.ones(n, dtype=np.int64)
        else:
            colors = color_groups(J) if colors is None else np.asarray(colors)
            perm = colors[colors < n].astype(np.int64)
            sizes = (colors < n).sum(axis=1)
        if sorted(perm.tolist()) != list(range(n)):
            raise SamplingError("colors must hold every site exactly once")
        ends = np.cumsum(sizes)
        self.n = n
        self.device = resolve_device(device)
        self.perm = perm
        self.bounds = [(int(e - s), int(e)) for s, e in zip(sizes, ends) if s > 0]
        self.widest = max(b - a for a, b in self.bounds)
        perm_t = torch.from_numpy(perm)
        Jp = torch.from_numpy(J)[perm_t][:, perm_t].contiguous()
        profiling.count("host_syncs", 5)   # the five copies in, from pageable memory
        self.perm_t = perm_t.to(self.device)
        self.inv_t = torch.argsort(perm_t).to(self.device)
        self.J = Jp.to(self.device)
        self.h = torch.from_numpy(h)[perm_t].to(self.device)
        self.diag = torch.diagonal(Jp).contiguous().to(self.device)
        self._graphs = {}       # chains -> [states, u, T, CUDA graph or None]
        self._fused = None

    @property
    def n_colors(self) -> int:
        return len(self.bounds)

    def to_plan(self, states: torch.Tensor) -> torch.Tensor:
        """(..., n) states in site order -> plan order."""
        return states.index_select(-1, self.perm_t.to(states.device))

    def from_plan(self, states: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(..., n) states in plan order -> site order."""
        return torch.index_select(states, -1, self.inv_t.to(states.device), out=out)

    def fused_operands(self) -> tuple:
        """(J, h, diag, ends, widest) as the fused sweep takes them: J with
        its rows padded with zeros to a multiple of 4 columns, and the
        colours' ends as an int32 tensor, made at the first call."""
        if self._fused is None:
            pad = -self.n % 4
            J = torch.nn.functional.pad(self.J, (0, pad)) if pad else self.J
            ends = torch.tensor([b for _, b in self.bounds], dtype=torch.int32)
            profiling.count("host_syncs")   # the ends copied in, from pageable memory
            self._fused = (J, self.h, self.diag, ends.to(self.device), self.widest)
        return self._fused

    def graph_slot(self, chains: int) -> list:
        """The static buffers (states, uniforms, temperatures) of the graphed
        sweep of ``chains`` chains and its graph (None until the first
        sweep captures it), shared by every sweeper of this plan and chain
        count, so a plan captures its sweep once."""
        if chains not in self._graphs:
            states = torch.zeros((chains, self.n), dtype=torch.float32, device=self.device)
            T = torch.ones((chains, 1), dtype=torch.float32, device=self.device)
            self._graphs[chains] = [states, torch.zeros_like(states), T, None]
        return self._graphs[chains]


def colour_step(states: torch.Tensor, J: torch.Tensor, h: torch.Tensor, diag: torch.Tensor,
                u: torch.Tensor, T: torch.Tensor, a: int, b: int):
    """Heat-bath update of the plan slice a:b of every chain, in place.

    ``states`` (chains, n) bits in plan order, ``J``/``h``/``diag`` the
    plan's tensors, ``u`` (chains, n) uniforms in plan order, ``T`` (chains,
    1) temperatures. Sites of the slice must not couple.
    """
    field = torch.addmm(h[a:b], states, J[a:b].t())
    field.addcmul_(diag[a:b], states[:, a:b], value=-1.0)
    p = torch.sigmoid(field.div_(T))
    torch.lt(u[:, a:b], p, out=states[:, a:b])


def colour_sweep(plan: ColourPlan, states: torch.Tensor, u: torch.Tensor, T: torch.Tensor,
                 order: Optional[List[int]] = None):
    """One sweep: every colour once, in ``order`` (default plan order)."""
    for c in (range(plan.n_colors) if order is None else order):
        a, b = plan.bounds[c]
        colour_step(states, plan.J, plan.h, plan.diag, u, T, a, b)


def dense_route(widest: int, chains: int, slots: int) -> str:
    """The card's route for a sweep of ``chains`` chains over a plan whose
    widest colour has ``widest`` sites: ``"fused"`` (one launch of K10) or
    ``"graph"`` (a CUDA graph of colour steps). ``slots``: the K10 blocks,
    a block a chain, that the card runs at once for the plan, 0 where no
    launch fits it (:func:`dense_sweep_kernel.blocks_at_once`).

    K10 pays each site of a colour a block-wide sum, where a colour step
    pays a few launches and one matrix product, so wide colours favour the
    graph; chains beyond the slots run in further waves, each paying every
    site again, where the graph's matrix products grow more slowly. So K10
    takes the plan where the widest colour times the waves is at most
    ``FUSED_WIDEST``.
    """
    if slots < 1:
        return "graph"
    waves = -(-chains // slots)
    return "fused" if widest * waves <= FUSED_WIDEST else "graph"


_SIDE_STREAMS = {}   # device -> the stream that every capture on it warms up on


def _side_stream(device: torch.device):
    """The warm-up stream of captures on ``device``, one a device: cuBLAS
    keeps a workspace (32 MiB on Hopper) for every stream it runs on, so a
    fresh stream a capture would hold one more each time."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device=device)
    return _SIDE_STREAMS[device]


class DenseSweeper:
    """A batch of ``chains`` bit states in the plan's order, swept on the
    plan's device.

    ``seed``: an int or a CPU ``torch.Generator``; the device generator of
    the sweeps' uniforms is seeded from it, and ``random_order`` draws each
    sweep's colour order from it. ``route``: on a CUDA device (and without
    ``random_order``) :func:`dense_route`'s pick, ``"fused"`` (a sweep is one
    launch of K10) or ``"graph"`` (a sweep replays a CUDA graph of the
    colour loop, captured at the plan's first sweep of this many chains;
    the sweepers of one plan and chain count share its buffers, so they
    take turns); elsewhere ``"eager"``, the colour loop run step by step.
    """

    def __init__(self, plan: ColourPlan, chains: int, seed, *, random_order: bool = False):
        self.plan = plan
        self.gen = as_generator(seed)
        dev = plan.device
        self.dev_gen = device_generator(self.gen, dev)
        self.random_order = random_order
        if dev.type != "cuda" or random_order:
            self.route = "eager"
        else:
            self.route = dense_route(plan.widest, chains,
                                     dense_sweep_kernel.blocks_at_once(plan.n, plan.widest, dev))
        if self.route == "graph":
            self._slot = plan.graph_slot(chains)
            self.states, self.u, self.T = self._slot[:3]
        else:
            self._slot = None
            self.states = torch.zeros((chains, plan.n), dtype=torch.float32, device=dev)
            self.u = torch.zeros_like(self.states)
            self.T = torch.ones((chains, 1), dtype=torch.float32, device=dev)

    @property
    def _graph(self):
        return None if self._slot is None else self._slot[3]

    @property
    def chains(self) -> int:
        return self.states.shape[0]

    def load(self, bits: torch.Tensor, *, plan_order: bool = False):
        """Set the states from (chains, n) bits, in site order unless
        ``plan_order``."""
        bits = bits.to(device=self.states.device, dtype=torch.float32)
        if bits.data_ptr() != self.states.data_ptr():
            self.states.copy_(bits if plan_order else self.plan.to_plan(bits))

    def set_temperature(self, T):
        """A Python number for every chain, or (chains,) temperatures."""
        if isinstance(T, (int, float, np.floating, np.integer)):
            self.T.fill_(float(T))
        else:
            self.T.copy_(torch.as_tensor(T, dtype=torch.float32).reshape(-1, 1))

    def _capture(self):
        states, u, T = self.states, self.u, self.T
        # torch.cuda.graph waits for the card once a capture, which the
        # sync warnings that host_syncs matches do not see.
        profiling.count("dense.captures")
        profiling.count("dense.colour_steps", self.plan.n_colors)   # the warm-up sweep
        keep = states.clone()
        # Warm up on a side stream (cuBLAS sets up its handle and workspace
        # outside the capture), then capture the colour loop. Neither draws
        # a uniform, and the states are put back.
        side = _side_stream(states.device)
        side.wait_stream(torch.cuda.current_stream(states.device))
        with torch.cuda.stream(side):
            colour_sweep(self.plan, states, u, T)
        torch.cuda.current_stream(states.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            colour_sweep(self.plan, states, u, T)
        states.copy_(keep)
        return graph

    def run(self, n_sweeps: int = 1) -> torch.Tensor:
        """``n_sweeps`` sweeps, each on fresh uniforms; returns the states
        (the sweeper's own buffer, in plan order)."""
        if n_sweeps and self.route == "graph" and self._slot[3] is None:
            with profiling.annotate("dense.capture"):
                self._slot[3] = self._capture()
        fused = self.route == "fused"
        profiling.count("dense.colour_steps", n_sweeps * self.plan.n_colors)
        if fused:
            self.plan.fused_operands()      # made at the first call, outside the sweeps' span
            profiling.count("dense.fused_sweeps", n_sweeps)
        with profiling.annotate("dense.sweeps", self.u.device):
            for _ in range(n_sweeps):
                torch.rand(self.u.shape, generator=self.dev_gen, device=self.u.device,
                           out=self.u)
                if self.random_order:
                    order = torch.randperm(self.plan.n_colors, generator=self.gen).tolist()
                    colour_sweep(self.plan, self.states, self.u, self.T, order)
                elif fused:
                    dense_sweep_kernel.dense_colour_sweep(self.plan, self.states, self.u, self.T)
                elif self.route == "graph":
                    self._slot[3].replay()
                else:
                    colour_sweep(self.plan, self.states, self.u, self.T)
        return self.states

    def energies(self) -> torch.Tensor:
        """(chains,) float32 energies of the current states."""
        return boltzmann_energy_batch(self.states, self.plan.J, self.plan.h)


def gibbs_sweeps(seed, state, J, h, temperature, n_sweeps: int, random_order: bool = False,
                 device=None) -> torch.Tensor:
    """``n_sweeps`` sequential-scan sweeps of one chain state (n,): sites in
    index order, or in a fresh random order every sweep. Returns (n,)
    float32 bits on ``device`` (default the card)."""
    plan = ColourPlan(J, np.zeros(np.asarray(J).shape[0]) if h is None else h,
                      sequential=True, device=device)
    sweeper = DenseSweeper(plan, 1, seed, random_order=random_order)
    sweeper.load(torch.as_tensor(np.asarray(state, np.float32)).reshape(1, -1))
    sweeper.set_temperature(temperature)
    return sweeper.run(n_sweeps)[0].clone()


def blocked_sweeps(seed, states, J, h, temperature, colors=None, n_sweeps: int = 1,
                   random_order: bool = False, device=None) -> torch.Tensor:
    """``n_sweeps`` coloured block sweeps of a batch of chains (chains, n):
    every colour of ``colors`` (:func:`color_groups`, computed when None)
    once per sweep, all its sites at once. ``temperature``: a number, or
    (chains,) per-chain temperatures. Returns (chains, n) float32 bits on
    ``device`` (default the card)."""
    plan = ColourPlan(J, h, colors, device=device)
    states = torch.atleast_2d(torch.as_tensor(np.asarray(states, np.float32)
                                              if not isinstance(states, torch.Tensor) else states))
    sweeper = DenseSweeper(plan, states.shape[0], seed, random_order=random_order)
    sweeper.load(states)
    sweeper.set_temperature(temperature)
    return plan.from_plan(sweeper.run(n_sweeps))


def iid_bernoulli_sample(seed, h, temperature, chains: int, n_samples: int,
                         device=None) -> torch.Tensor:
    """(chains, n_samples, n) exact draws of a coupling-free model: each bit
    is 1 with probability sigmoid(h_i / T), whatever the rest of the state."""
    device = resolve_device(device)
    h = torch.as_tensor(np.asarray(h, np.float32)).to(device)
    p = torch.sigmoid(h / torch.tensor(float(temperature), dtype=torch.float32, device=device))
    u = torch.rand((chains, n_samples, h.shape[0]), device=device,
                   generator=device_generator(seed, device))
    return (u < p).to(torch.float32)


def dense_gibbs_sample(seed, J, h, x0, *, n_samples: int, temperature: float = 1.0,
                       n_burnin: int = 100, n_sweeps: int = 10, random_order: bool = False,
                       sequential: bool = False, colors=None, device=None,
                       plan: Optional[ColourPlan] = None) -> torch.Tensor:
    """Boltzmann sampling on dense J: (n_chains, n_samples, n) float32 bits
    on ``device`` (default the card).

    ``x0``: (n_chains, n) initial bits. ``n_burnin`` sweeps, then
    ``n_sweeps`` sweeps before each sample. A coupling-free J (one colour)
    takes one exact Bernoulli draw. ``sequential=True`` runs one site per
    colour in index order. ``colors``: a precomputed :func:`color_groups`;
    ``plan``: a prebuilt :class:`ColourPlan` of the same (J, h, order).
    """
    device = resolve_device(device) if plan is None else plan.device
    gen = as_generator(seed)
    x0 = torch.atleast_2d(torch.as_tensor(np.asarray(x0, np.float32) if not
                                          isinstance(x0, torch.Tensor) else x0))
    chains = x0.shape[0]
    if plan is None:
        if colors is None:
            colors = color_groups(np.asarray(J))
        if np.asarray(colors).shape[0] == 1:
            return iid_bernoulli_sample(gen, h, temperature, chains, n_samples, device)
        plan = ColourPlan(J, h, colors, sequential=sequential, device=device)
    elif plan.n_colors == 1:
        return iid_bernoulli_sample(gen, h, temperature, chains, n_samples, device)
    sweeper = DenseSweeper(plan, chains, gen, random_order=random_order)
    sweeper.load(x0)
    sweeper.set_temperature(temperature)
    if n_burnin:
        sweeper.run(n_burnin)
    out = torch.empty((n_samples, chains, plan.n), dtype=torch.float32, device=plan.device)
    for s in range(n_samples):
        plan.from_plan(sweeper.run(n_sweeps), out=out[s])
    return out.transpose(0, 1)


class GibbsSampler:
    """Gibbs sampler for binary bits on ``device`` (default the card).

    ``seed``: an int or a CPU ``torch.Generator``; every call draws its
    randomness from it. ``last_route`` records the route of the last
    :meth:`sample_boltzmann` call: ``"native_cpp"``, ``"iid"`` or
    ``"device"`` (None before the first call).
    """

    def __init__(self, config: Optional[GibbsConfig] = None, seed=None, device=None):
        self.config = config or GibbsConfig()
        self.device = resolve_device(device)
        self._gen = as_generator(seed)
        self.sample_count = 0
        self.last_route: Optional[str] = None

    def _next_seed(self) -> int:
        return int(torch.randint(0, 2**63 - 1, (), generator=self._gen))

    # -- low-level methods ---------------------------------------------------

    def _sigmoid(self, x) -> float:
        return float(torch.sigmoid(torch.tensor(x, dtype=torch.float32)))

    def _compute_local_field(self, i: int, state, coupling, bias=None) -> float:
        """Local field (J state)_i - J_ii state_i + bias_i, in float64."""
        state = np.asarray(state, dtype=np.float64)
        J = np.asarray(coupling, dtype=np.float64)
        b = 0.0 if bias is None else np.asarray(bias, dtype=np.float64)[i]
        return float(J[i] @ state - J[i, i] * state[i] + b)

    def sample_conditional(self, i: int, state, coupling, bias=None) -> int:
        """Sample bit i from its conditional."""
        field = self._compute_local_field(i, state, coupling, bias)
        p = self._sigmoid(field / self.config.temperature)
        return int(float(torch.rand((), generator=self._gen)) < p)

    def gibbs_sweep(self, state, coupling, bias=None, n_sweeps: int = 1) -> np.ndarray:
        """Sequential sweeps over one state vector (random order when the
        config says "random"); returns (n,) float32 bits."""
        out = gibbs_sweeps(self._gen, state, coupling, bias, self.config.temperature,
                           n_sweeps, self.config.update_order == "random", self.device)
        return out.cpu().numpy()

    # -- sampling ------------------------------------------------------------

    def sample_boltzmann(self, coupling, bias=None, n_samples: int = 1000,
                         initial_state=None) -> np.ndarray:
        """Sample the Boltzmann distribution over bits; returns
        (n_samples, n) float32, the chains interleaved round-robin."""
        J = np.asarray(coupling, dtype=np.float32)
        if J.ndim != 2 or J.shape[0] != J.shape[1]:
            raise SamplingError(f"coupling must be square, got shape {J.shape}")
        n = J.shape[0]
        h = np.zeros(n, np.float32) if bias is None else np.asarray(bias, dtype=np.float32)
        if h.shape != (n,):
            raise SamplingError(f"bias shape {h.shape} does not match n={n}")
        if n_samples <= 0:
            raise SamplingError(f"n_samples must be positive, got {n_samples}")
        cfg = self.config
        n_chains = cfg.n_chains
        per_chain = -(-n_samples // n_chains)
        colors = color_groups(J)
        iid = colors.shape[0] == 1
        sequential = cfg.update_order in ("sequential", "random")

        # Tiny sequential jobs run on the host's native sampler: the same
        # chain, without a device round trip per launch.
        flops = (cfg.n_burnin + per_chain * cfg.n_sweeps) * n_chains * n * n
        if not iid and initial_state is None and flops < 1e8 and sequential:
            from tsu_tpu_torch.native import gibbs_dense_native

            out = gibbs_dense_native(J, h, temperature=cfg.temperature, n_chains=n_chains,
                                     n_samples=n_samples, n_burnin=cfg.n_burnin,
                                     n_sweeps=cfg.n_sweeps,
                                     random_order=cfg.update_order == "random",
                                     seed=self._next_seed())
            self.sample_count += n_samples
            self.last_route = "native_cpp"
            return out
        if initial_state is not None:
            x0 = torch.as_tensor(np.asarray(initial_state, np.float32)).reshape(1, n)
            x0 = x0.expand(n_chains, n)
        else:
            x0 = (torch.rand((n_chains, n), generator=self._gen) < 0.5).to(torch.float32)
        samples = dense_gibbs_sample(
            self._gen, J, h, x0, n_samples=per_chain, temperature=cfg.temperature,
            n_burnin=cfg.n_burnin, n_sweeps=cfg.n_sweeps,
            random_order=cfg.update_order == "random", sequential=sequential,
            colors=colors, device=self.device)
        out = samples.transpose(0, 1).reshape(-1, n)
        self.sample_count += n_samples
        self.last_route = "iid" if iid else "device"
        return out[:n_samples].cpu().numpy()

    def compute_energy(self, state, coupling, bias=None) -> float:
        """E(b) = -1/2 b^T J b - h^T b of one state, in float32."""
        state = torch.as_tensor(np.asarray(state, np.float32))
        J = torch.as_tensor(np.asarray(coupling, np.float32))
        h = (torch.zeros(state.shape[-1]) if bias is None
             else torch.as_tensor(np.asarray(bias, np.float32)))
        return float(boltzmann_energy_batch(state, J, h))

    # -- advanced samplers ---------------------------------------------------

    def parallel_tempering(self, coupling, temperatures, bias=None, n_samples: int = 1000,
                           swap_interval: int = 10, keep: str = "cold") -> Tuple[np.ndarray, dict]:
        """Replica exchange; returns (samples, info) with the info dict of
        ``parallel_tempering_dense``: the cold samples (n_samples, n), or with
        ``keep="all"`` every rung's, (n_samples, R, n) uint8."""
        from tsu_tpu_torch.samplers.tempering import parallel_tempering_dense

        J = np.asarray(coupling, dtype=np.float32)
        h = np.zeros(J.shape[0], np.float32) if bias is None else np.asarray(bias, np.float32)
        samples, info = parallel_tempering_dense(
            self._gen, J, h, temperatures=temperatures, n_samples=n_samples,
            swap_interval=swap_interval, n_sweeps=self.config.n_sweeps,
            n_burnin=self.config.n_burnin, keep=keep, device=self.device)
        self.sample_count += n_samples
        return samples.cpu().numpy(), info

    def simulated_annealing(self, coupling, bias=None, T_initial: float = 10.0,
                            T_final: float = 0.1, n_steps: int = 1000,
                            cooling_schedule: str = "exponential") -> Tuple[np.ndarray, float]:
        """Anneal to low-energy states; returns (best_state, best_energy).
        The config is never changed."""
        from tsu_tpu_torch.samplers.annealing import simulated_annealing_dense

        J = np.asarray(coupling, dtype=np.float32)
        h = np.zeros(J.shape[0], np.float32) if bias is None else np.asarray(bias, np.float32)
        best_state, best_energy = simulated_annealing_dense(
            self._next_seed(), J, h, T_initial=T_initial, T_final=T_final, n_steps=n_steps,
            cooling_schedule=cooling_schedule, n_chains=self.config.n_chains,
            device=self.device)
        return np.asarray(best_state), float(best_energy)
