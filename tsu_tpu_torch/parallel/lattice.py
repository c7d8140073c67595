"""Spatially sharded 2-D Ising lattice: checkerboard Gibbs with halo exchange.

Counterpart of ``tsu_tpu/parallel/lattice.py``, with one controller in place
of ``shard_map``. The lattice's compact planes are cut into shards over the
mesh's ``row`` axis, and optionally its ``col`` axis (compact columns); shard
(i, j) lives on mesh device (i, j) for the whole run (the other mesh axes are
the reference's replicated copies and take their index 0). Before each
kernel launch a shard gets its halo: the neighbour shards' edge rows (and
columns), sliced, copied only to another device (on the shard's own device
they are views, read in place), zeroed at an open global edge.
Only the per-sample scalars and the final planes come back.

Kernels, by the shards' tensors' device (a CPU mesh runs their plain
versions):

- row-only sharding, no injected uniforms or 16-bit ones with ``fused``:
  the fused sweep in shard mode (K1), one launch per sweep and shard, with
  two-row black halos;
- ``fused=False``, 24-bit injected uniforms, or any column sharding: the
  exact-sigmoid half-sweep (K3), two launches per sweep and shard, with
  one-row halos and, under column sharding, column halos.

Streams. Every shard keys Philox by its sites' global coordinates under one
base for the run: K1's sweep k by (fold_seed(base), k), K3's half-sweep of
colour c by (fold_seed(base, c), k). A sharded run therefore returns, bit for
bit, the planes the one-shard run of the same kernel returns at the same
seed. (The reference folds the shard index into K3's stream.) Each shard
must hold an even number of rows, so that local row parity is global row
parity; the reference's rows-per-shard % 8 rule is TPU tiling and is gone.
"""

from __future__ import annotations

import torch

from tsu_tpu_torch.ops.checkerboard import (
    neighbor_sum_half_halo,
    neighbor_sum_half_halo2d,
    split_checkerboard,
)
from tsu_tpu_torch.ops.checkerboard_bonds_kernel import bond_key
from tsu_tpu_torch.ops.checkerboard_fused import fused_sweep, sigmoid_table16
from tsu_tpu_torch.ops.checkerboard_kernel import halfsweep
from tsu_tpu_torch.parallel.mesh import Mesh
from tsu_tpu_torch.rng import as_generator
from tsu_tpu_torch.checkpoint import checkpoint_exists, restore_state, save_state


def _spatial_devices(mesh: Mesh, axis_name: str, col_axis) -> list:
    """(n_rows, n_cols) nested list of the devices the shards live on."""
    names = list(mesh.axis_names)
    axes = [names.index(axis_name)] + ([names.index(col_axis)] if col_axis else [])
    rest = [a for a in range(len(names)) if a not in axes]
    devs = mesh.devices.transpose(axes + rest)[(slice(None),) * len(axes) + (0,) * len(rest)]
    return (devs if col_axis else devs[:, None]).tolist()


def _scatter(plane: torch.Tensor, devs) -> list:
    """Cut a (..., R, C2) tensor into the shards of ``devs``, each a
    contiguous tensor on its device."""
    n, m = len(devs), len(devs[0])
    R, C2 = plane.shape[-2:]
    r, c = R // n, C2 // m
    return [[plane[..., i * r:(i + 1) * r, j * c:(j + 1) * c].contiguous().to(devs[i][j])
             for j in range(m)] for i in range(n)]


def _gather(shards) -> torch.Tensor:
    """The global plane of a grid of shards, on the first shard's device."""
    dev = shards[0][0].device
    return torch.cat([torch.cat([s.to(dev) for s in row], dim=-1) for row in shards], dim=-2)


def _halo_exchange(planes, periodic: bool, rows: int = 1):
    """(ups, downs): for each shard the ``rows`` rows above its first row
    and below its last one, (rows, C2), the neighbour shards' along the row
    axis, on its device; zeros at the global top and bottom of an open
    lattice."""
    n = len(planes)
    ups, downs = [], []
    for i, row in enumerate(planes):
        ups.append([planes[(i - 1) % n][j][-rows:].to(p.device) if periodic or i > 0
                    else torch.zeros_like(p[:rows]) for j, p in enumerate(row)])
        downs.append([planes[(i + 1) % n][j][:rows].to(p.device) if periodic or i < n - 1
                      else torch.zeros_like(p[:rows]) for j, p in enumerate(row)])
    return ups, downs


def _halo_exchange2(planes, periodic: bool):
    """Two-row halo exchange of the fused path: (up2, down2) per shard,
    global rows start-2, start-1 and end, end+1."""
    return _halo_exchange(planes, periodic, rows=2)


def _halo_exchange_cols(planes, periodic: bool):
    """Column counterpart of :func:`_halo_exchange` on compact planes:
    (lefts, rights), each (R_local, 1) per shard, the compact columns next
    to the shard's first and last one. Compact-column adjacency does not
    depend on the column offset, so the wrap realises a periodic edge as a
    roll does on one plane; an open edge gets zeros. On the shard's own
    device a column halo is a strided view of the neighbour shard's plane,
    no copy: K3 reads it in place, and no launch of a half-step writes what
    another reads (each writes a new plane). Across devices ``.to`` copies
    it."""
    m = len(planes[0])
    lefts, rights = [], []
    for row in planes:
        lefts.append([row[(j - 1) % m][:, -1:].to(p.device) if periodic or j > 0
                      else torch.zeros_like(p[:, :1]) for j, p in enumerate(row)])
        rights.append([row[(j + 1) % m][:, :1].to(p.device)
                       if periodic or j < m - 1 else torch.zeros_like(p[:, :1])
                       for j, p in enumerate(row)])
    return lefts, rights


def _make_local_halfstep(periodic: bool, J: float, field: float, col_sharded: bool):
    """The sharded half-sweep on K3: ``halfstep(others, update_red, key, T,
    u24=None)`` exchanges the halos of the other colour's shards and returns
    the updated colour's shards. Under column sharding the edges are the
    column halos' (so the kernel masks none); under row sharding the
    horizontal wrap stays in the shard and ``periodic`` masks it."""

    def halfstep(others, update_red: bool, key, T, u24=None):
        ups, downs = _halo_exchange(others, periodic)
        lefts = rights = None
        if col_sharded:
            lefts, rights = _halo_exchange_cols(others, periodic)
        R_l, C_l = others[0][0].shape
        return [[halfsweep(o, ups[i][j], downs[i][j], update_red=update_red, temperature=T,
                           J=J, field=field, periodic=periodic or col_sharded, key=key,
                           row0=i * R_l, col0=j * C_l,
                           left_col=None if lefts is None else lefts[i][j],
                           right_col=None if rights is None else rights[i][j],
                           uniforms=None if u24 is None else u24[i][j])
                 for j, o in enumerate(row)] for i, row in enumerate(others)]

    return halfstep


def _make_local_fused_sweep(periodic: bool, J: float, field: float, T):
    """The sharded full sweep on K1 in shard mode: ``sweep(blacks, base, k,
    u=None, u_halo=None)`` exchanges two-row black halos and launches one
    fused sweep per shard; returns (reds, blacks). Every shard passes the
    same base and its global row offset, so the red rows a shard recomputes
    at its edges are those its neighbours store. ``u``: per shard (2, R_l,
    C2) int32 16-bit uniforms, ``u_halo`` per shard the (u_top, u_bot) red
    uniform rows of global rows start-1 and end, held by the neighbours."""
    table = sigmoid_table16(J, field, float(T))
    tables = {}

    def sweep(blacks, base: int, k: int, u=None, u_halo=None):
        n = len(blacks)
        ups, downs = _halo_exchange2(blacks, periodic)
        reds, news = [], []
        for i in range(n):
            b = blacks[i][0]
            if b.device not in tables:
                tables[b.device] = table.to(b.device)
            R_l = b.shape[0]
            r, nb = fused_sweep(b, tables[b.device], seed=base, sweep=k, periodic=periodic,
                                up2=ups[i][0], down2=downs[i][0],
                                shard_info=(i * R_l, n * R_l, i == 0, i == n - 1),
                                uniforms=None if u is None else u[i][0],
                                uniforms_halo=None if u_halo is None else u_halo[i])
            reds.append([r])
            news.append([nb])
        return reds, news

    return sweep


def _local_observables(reds, blacks, periodic: bool, J: float, field: float,
                       col_sharded: bool):
    """(sum of the spins, energy) of the sharded lattice as float64 scalars
    on the first shard's device. Every bond joins a red site to a black
    one, so the bond sum is each red shard times its black neighbour sum,
    the black halos included: each bond is counted once, by the shard that
    holds its red site."""
    ups, downs = _halo_exchange(blacks, periodic)
    if col_sharded:
        lefts, rights = _halo_exchange_cols(blacks, periodic)
    dev = reds[0][0].device
    bond = spins = torch.zeros((), dtype=torch.float64, device=dev)
    for i, row in enumerate(blacks):
        for j, b in enumerate(row):
            r = reds[i][j]
            if col_sharded:
                nbr = neighbor_sum_half_halo2d(b, ups[i][j], downs[i][j], lefts[i][j],
                                               rights[i][j], True)
            else:
                nbr = neighbor_sum_half_halo(b, ups[i][j], downs[i][j], True, periodic)
            bond = bond + (r * nbr).sum(dtype=torch.float64).to(dev)
            spins = spins + (r.sum(dtype=torch.float64) + b.sum(dtype=torch.float64)).to(dev)
    return spins, -J * bond - field * spins


def _route(mesh, R, C2, axis_name, col_axis, fused, uniforms):
    """Validate the shard shapes and pick the kernel: returns (devices,
    fused)."""
    n = mesh.shape[axis_name]
    if R % n or (R // n) % 2:
        raise ValueError(f"rows per shard must be even: R={R}, shards={n}")
    if col_axis is not None and C2 % mesh.shape[col_axis]:
        raise ValueError(f"compact columns must divide evenly: C/2={C2}, "
                         f"shards={mesh.shape[col_axis]}")
    if fused is None:
        fused = col_axis is None and uniforms is None
    if fused and col_axis is not None:
        raise ValueError("the fused sweep shards rows only")
    return _spatial_devices(mesh, axis_name, col_axis), fused


def _base(seed) -> int:
    """The run's one stream base, drawn from ``seed`` (an int or a CPU
    ``torch.Generator``)."""
    return int(torch.randint(0, 2**31 - 1, (), generator=as_generator(seed)))


def _run_sweeps(red, black, sweep_ids, fused: bool, base: int, T, periodic, J, field,
                col_sharded, uniforms=None):
    """Sweeps ``sweep_ids`` on sharded planes, K1 in shard mode when
    ``fused`` and K3 otherwise. ``uniforms``: for K3 the per-shard
    (n, 2, R_l, C_l) int32; for K1 (those shards, tops, bots), tops[i] and
    bots[i] the (n, C2) red uniforms of the rows above and below row shard
    i."""
    if fused:
        local = _make_local_fused_sweep(periodic, J, field, T)
        for n, k in enumerate(sweep_ids):
            u = u_halo = None
            if uniforms is not None:
                shards, tops, bots = uniforms
                u = [[s[n] for s in row] for row in shards]
                u_halo = [(t[n], b[n]) for t, b in zip(tops, bots)]
            red, black = local(black, base, k, u, u_halo)
        return red, black
    local = _make_local_halfstep(periodic, J, field, col_sharded)
    for n, k in enumerate(sweep_ids):
        u = (None, None)
        if uniforms is not None:
            u = tuple([[s[n, c] for s in row] for row in uniforms] for c in (0, 1))
        red = local(black, True, bond_key(base, 0, k), T, u[0])
        black = local(red, False, bond_key(base, 1, k), T, u[1])
    return red, black


def sharded_checkerboard_sweeps(mesh: Mesh, seed, red: torch.Tensor, black: torch.Tensor,
                                temperature, n_sweeps: int, *, J: float = 1.0,
                                field: float = 0.0, periodic: bool = True,
                                axis_name: str = "row", col_axis: str | None = None,
                                uniforms=None, fused: bool | None = None):
    """n_sweeps full sweeps of compact (R, C/2) planes sharded over
    ``axis_name`` (rows) and optionally ``col_axis`` (compact columns);
    returns the updated global (red, black) on the first shard's device.

    ``seed``: an int or a CPU ``torch.Generator``; the run's stream base is
    drawn from it. ``uniforms``: optional (n_sweeps, 2, R, C2) int32
    replacing the generator, in [0, 2^16) for the fused sweep, [0, 2^24)
    for the half-sweep. ``fused`` (default: row-only sharding and no
    injected uniforms) picks the fused sweep in shard mode, else the
    half-sweep; injected uniforms choose their kernel explicitly, as their
    widths differ.
    """
    R, C2 = black.shape
    devs, fused = _route(mesh, R, C2, axis_name, col_axis, fused, uniforms)
    base = _base(seed)
    reds, blacks = _scatter(red, devs), _scatter(black, devs)
    shards = None
    if uniforms is not None:
        U = torch.as_tensor(uniforms, dtype=torch.int32)
        if U.shape != (n_sweeps, 2, R, C2):
            raise ValueError(f"uniforms must be (n_sweeps, 2, R, C2), got {tuple(U.shape)}")
        shards = _scatter(U, devs)
        if fused:
            n = len(devs)
            R_l = R // n
            U = U.to(devs[0][0])
            tops = [U[:, 0, (i * R_l - 1) % R].contiguous().to(devs[i][0]) for i in range(n)]
            bots = [U[:, 0, ((i + 1) * R_l) % R].contiguous().to(devs[i][0]) for i in range(n)]
            shards = (shards, tops, bots)
    reds, blacks = _run_sweeps(reds, blacks, range(n_sweeps), fused, base, temperature,
                               periodic, J, field, col_axis is not None, shards)
    return _gather(reds), _gather(blacks)


def sharded_lattice_sample(mesh: Mesh, seed, lattice0: torch.Tensor, *, n_samples: int,
                           temperature, J: float = 1.0, field: float = 0.0,
                           n_burnin: int = 100, n_sweeps: int = 1, periodic: bool = True,
                           axis_name: str = "row", col_axis: str | None = None,
                           fused: bool | None = None, dtype=None, checkpoint_path=None,
                           checkpoint_every: int = 0, resume: bool = False) -> dict:
    """Sample observables of a spatially sharded lattice (rows, or rows and
    compact columns when ``col_axis`` is given).

    Returns ``{"magnetization", "energy"}``, (n_samples,) float64 CPU
    tensors (per-spin magnetization and total energy after each block of
    n_sweeps sweeps that follows n_burnin sweeps of burn-in), and
    ``"final_planes"``, the global (red, black) on the first shard's
    device. The planes stay sharded on the mesh for the whole run. Sweep s
    of the run (burn-in first, then the samples' blocks) draws from the
    run's base under the global sweep counter s. ``fused`` as in
    :func:`sharded_checkerboard_sweeps`. ``dtype``: plane storage, default
    bfloat16 on the fused path (±1 spins are exact in it) and float32
    otherwise.

    ``checkpoint_path`` with ``checkpoint_every > 0`` snapshots the run
    after every ``checkpoint_every`` samples: the base, the merged planes,
    the samples done and the observables so far, all in one file written
    under a temporary name and renamed. ``resume=True`` continues from that
    snapshot when it exists (and starts afresh when it does not), so the
    resumed run returns exactly what the uninterrupted one would.
    """
    R, C = lattice0.shape
    devs, fused = _route(mesh, R, C // 2, axis_name, col_axis, fused, None)
    if dtype is None:
        dtype = torch.bfloat16 if fused else torch.float32
    red, black = split_checkerboard(lattice0.to(dtype))
    base = _base(seed)
    reds, blacks = _scatter(red, devs), _scatter(black, devs)
    col_sharded = col_axis is not None
    run = dict(fused=fused, base=base, T=temperature, periodic=periodic, J=J, field=field,
               col_sharded=col_sharded)
    dev = devs[0][0]
    ms = torch.empty(n_samples, dtype=torch.float64, device=dev)
    es = torch.empty(n_samples, dtype=torch.float64, device=dev)
    checkpointing = checkpoint_path is not None and checkpoint_every > 0
    done = 0
    if resume and checkpointing and checkpoint_exists(checkpoint_path):
        st = restore_state(checkpoint_path, {
            "base": 0, "red": red, "black": black, "done": 0, "ms": ms, "es": es})
        run["base"], done = st["base"], st["done"]
        reds, blacks = _scatter(st["red"], devs), _scatter(st["black"], devs)
        ms.copy_(st["ms"])
        es.copy_(st["es"])
    else:
        reds, blacks = _run_sweeps(reds, blacks, range(n_burnin), **run)
    for i in range(done, n_samples):
        start = n_burnin + i * n_sweeps
        reds, blacks = _run_sweeps(reds, blacks, range(start, start + n_sweeps), **run)
        spins, es[i] = _local_observables(reds, blacks, periodic, J, field, col_sharded)
        ms[i] = spins / (R * C)
        if checkpointing and ((i + 1) % checkpoint_every == 0 or i + 1 == n_samples):
            save_state(checkpoint_path, {
                "base": run["base"], "red": _gather(reds), "black": _gather(blacks),
                "done": i + 1, "ms": ms, "es": es})
    return {"magnetization": ms.cpu(), "energy": es.cpu(),
            "final_planes": (_gather(reds), _gather(blacks))}

