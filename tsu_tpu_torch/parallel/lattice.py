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

Across processes (``parallel.multihost_initialize``) each rank builds and
sweeps only the shards the mesh gives it (``Mesh.ranks``). Halos between
shards of one rank stay views or device copies; halos from another rank
arrive through ``parallel.distributed.exchange``, all of one exchange's
messages posted together and tagged by the receiving shard and direction.
Each rank sums its shards' spins and bonds per sample, and the ranks add
them up in float64 once, at the end of the run or at a snapshot; the final
planes and the snapshots are gathered on rank 0.

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
from tsu_tpu_torch.parallel import distributed
from tsu_tpu_torch.parallel.mesh import Mesh
from tsu_tpu_torch.rng import as_generator
from tsu_tpu_torch.checkpoint import checkpoint_exists, restore_state, save_state


class _Grid:
    """The shard grid of one sharded lattice: ``devs`` and ``owners``, (n,
    m) nested lists of each shard's device and rank, and ``rank``, this
    process's. Shard (i, j) is local when this process holds it; in one
    process every shard is. ``home``: the device of the first local shard
    (else the runtime's), where the per-sample sums live."""

    def __init__(self, mesh: Mesh, axis_name: str, col_axis):
        names = list(mesh.axis_names)
        axes = [names.index(axis_name)] + ([names.index(col_axis)] if col_axis else [])
        rest = [a for a in range(len(names)) if a not in axes]
        index = (slice(None),) * len(axes) + (0,) * len(rest)

        def spatial(a):
            a = a.transpose(axes + rest)[index]
            return (a if col_axis else a[:, None]).tolist()

        self.devs, self.owners = spatial(mesh.devices), spatial(mesh.ranks)
        self.n, self.m = len(self.devs), len(self.devs[0])
        self.rank = distributed.rank()
        self.multi = distributed.initialized()
        self.local = [(i, j) for i in range(self.n) for j in range(self.m)
                      if self.owners[i][j] == self.rank]
        rt = distributed.runtime()
        self.home = (self.devs[self.local[0][0]][self.local[0][1]] if self.local
                     else rt.device)

    def mine(self, i: int, j: int) -> bool:
        return self.owners[i][j] == self.rank


def _scatter(plane: torch.Tensor, grid: _Grid) -> list:
    """Cut a (..., R, C2) tensor into the grid's shards, each a contiguous
    tensor on its device; a shard held by another rank is None."""
    R, C2 = plane.shape[-2:]
    r, c = R // grid.n, C2 // grid.m
    return [[plane[..., i * r:(i + 1) * r, j * c:(j + 1) * c].contiguous().to(grid.devs[i][j])
             if grid.mine(i, j) else None for j in range(grid.m)] for i in range(grid.n)]


def _gather(grid: _Grid, *planes) -> tuple:
    """The global plane of each grid of shards in ``planes``, on the first
    shard's device in one process; across processes on rank 0 (None on the
    others), which receives every shard it does not hold."""
    if not grid.multi:
        dev = planes[0][0][0].device
        return tuple(torch.cat([torch.cat([s.to(dev) for s in row], dim=-1) for row in p],
                               dim=-2) for p in planes)
    like = next(p[i][j] for p in planes for i, j in grid.local) if grid.local else None
    sends, recvs = [], []
    for k, p in enumerate(planes):
        for i in range(grid.n):
            for j in range(grid.m):
                tag = (k * grid.n + i) * grid.m + j
                if grid.mine(i, j) and grid.rank != 0:
                    sends.append((p[i][j], 0, tag))
                elif grid.rank == 0 and not grid.mine(i, j):
                    recvs.append((like.shape, like.dtype, grid.home, grid.owners[i][j], tag))
    got = iter(distributed.exchange(sends, recvs))
    if grid.rank != 0:
        return (None,) * len(planes)
    full = [[[p[i][j] if grid.mine(i, j) else next(got) for j in range(grid.m)]
             for i in range(grid.n)] for p in planes]
    return tuple(torch.cat([torch.cat([s.to(grid.home) for s in row], dim=-1) for row in p],
                           dim=-2) for p in full)


def _halos(planes, periodic: bool, grid, axis: int, width: int):
    """The halos of each local shard along ``axis`` (0: the ``width`` rows
    above and below it; 1: the compact column left and right of it), the
    neighbour shards' edges, on its device: a view on the shard's own device,
    a copy on another one, a message from another rank (``grid``; None: one
    process holds every shard), zeros at an open global edge. Returns (before,
    after), None for the shards of other ranks."""
    n, m = len(planes), len(planes[0])
    mine = (lambda i, j: True) if grid is None else grid.mine
    size = (n, m)[axis]
    edges = ((lambda p: p[-width:], lambda p: p[:width]) if axis == 0
             else (lambda p: p[:, -width:], lambda p: p[:, :width]))
    out = {d: [[None] * m for _ in range(n)] for d in (0, 1)}
    wanted = []
    for i in range(n):
        for j in range(m):
            k = (i, j)[axis]
            for d, step, take in ((0, -1, edges[0]), (1, 1, edges[1])):
                src = (((i + step) % n, j), (i, (j + step) % m))[axis]
                if not periodic and k + step in (-1, size):
                    if mine(i, j):
                        out[d][i][j] = torch.zeros_like(take(planes[i][j]))
                elif mine(i, j) and mine(*src):
                    out[d][i][j] = take(planes[src[0]][src[1]]).to(planes[i][j].device)
                else:
                    wanted.append((i, j, 2 * axis + d, d, src, take))
    if grid is not None and grid.multi:
        _trade(grid, planes, out, wanted)
    return out[0], out[1]


def _trade(grid: _Grid, planes, out, wanted):
    """Fill the halos that other ranks hold, in one exchange: ``wanted``
    lists (i, j, direction 0..3 (up, down, left, right), slot, source (si,
    sj), edge slicer) for each halo whose shard or source this rank holds and
    the other it does not. The source's rank sends ``slicer(source plane)``;
    each message is tagged by the receiving shard and the direction."""
    sends, recvs, slots = [], [], []
    for i, j, direction, d, (si, sj), take in wanted:
        tag = (i * grid.m + j) * 4 + direction
        if grid.mine(i, j) and not grid.mine(si, sj):
            like = take(planes[i][j])
            recvs.append((like.shape, like.dtype, like.device, grid.owners[si][sj], tag))
            slots.append((d, i, j))
        elif grid.mine(si, sj) and not grid.mine(i, j):
            sends.append((take(planes[si][sj]), grid.owners[i][j], tag))
    for (d, i, j), t in zip(slots, distributed.exchange(sends, recvs)):
        out[d][i][j] = t


def _halo_exchange(planes, periodic: bool, rows: int = 1, grid: _Grid = None):
    """(ups, downs): for each local shard the ``rows`` rows above its first
    row and below its last one, (rows, C2), the neighbour shards' along the
    row axis, on its device; zeros at the global top and bottom of an open
    lattice (:func:`_halos`)."""
    return _halos(planes, periodic, grid, 0, rows)


def _halo_exchange2(planes, periodic: bool, grid: _Grid = None):
    """Two-row halo exchange of the fused path: (up2, down2) per shard,
    global rows start-2, start-1 and end, end+1."""
    return _halo_exchange(planes, periodic, rows=2, grid=grid)


def _halo_exchange_cols(planes, periodic: bool, grid: _Grid = None):
    """Column counterpart of :func:`_halo_exchange` on compact planes:
    (lefts, rights), each (R_local, 1) per shard, the compact columns next
    to the shard's first and last one. Compact-column adjacency does not
    depend on the column offset, so the wrap realises a periodic edge as a
    roll does on one plane; an open edge gets zeros. On the shard's own
    device a column halo is a strided view of the neighbour shard's plane,
    no copy: K3 reads it in place, and no launch of a half-step writes what
    another reads (each writes a new plane). Across devices ``.to`` copies
    it; from another rank it arrives contiguous."""
    return _halos(planes, periodic, grid, 1, 1)


def _make_local_halfstep(grid: _Grid, periodic: bool, J: float, field: float,
                         col_sharded: bool):
    """The sharded half-sweep on K3: ``halfstep(others, update_red, key, T,
    u24=None)`` exchanges the halos of the other colour's shards and returns
    the updated colour's local shards. Under column sharding the edges are
    the column halos' (so the kernel masks none); under row sharding the
    horizontal wrap stays in the shard and ``periodic`` masks it."""

    def halfstep(others, update_red: bool, key, T, u24=None):
        ups, downs = _halo_exchange(others, periodic, grid=grid)
        lefts = rights = None
        if col_sharded:
            lefts, rights = _halo_exchange_cols(others, periodic, grid)
        out = [[None] * grid.m for _ in range(grid.n)]
        for i, j in grid.local:
            o = others[i][j]
            R_l, C_l = o.shape
            out[i][j] = halfsweep(o, ups[i][j], downs[i][j], update_red=update_red,
                                  temperature=T, J=J, field=field,
                                  periodic=periodic or col_sharded, key=key, row0=i * R_l,
                                  col0=j * C_l,
                                  left_col=None if lefts is None else lefts[i][j],
                                  right_col=None if rights is None else rights[i][j],
                                  uniforms=None if u24 is None else u24[i][j])
        return out

    return halfstep


def _make_local_fused_sweep(grid: _Grid, periodic: bool, J: float, field: float, T):
    """The sharded full sweep on K1 in shard mode: ``sweep(blacks, base, k,
    u=None, u_halo=None)`` exchanges two-row black halos and launches one
    fused sweep per local shard; returns (reds, blacks). Every shard passes
    the same base and its global row offset, so the red rows a shard
    recomputes at its edges are those its neighbours store. ``u``: per shard
    (2, R_l, C2) int32 16-bit uniforms, ``u_halo`` per row shard the (u_top,
    u_bot) red uniform rows of global rows start-1 and end, held by the
    neighbours."""
    table = sigmoid_table16(J, field, float(T))
    tables = {}

    def sweep(blacks, base: int, k: int, u=None, u_halo=None):
        n = grid.n
        ups, downs = _halo_exchange2(blacks, periodic, grid)
        reds = [[None] for _ in range(n)]
        news = [[None] for _ in range(n)]
        for i, _ in grid.local:
            b = blacks[i][0]
            if b.device not in tables:
                tables[b.device] = table.to(b.device)
            R_l = b.shape[0]
            reds[i][0], news[i][0] = fused_sweep(
                b, tables[b.device], seed=base, sweep=k, periodic=periodic, up2=ups[i][0],
                down2=downs[i][0], shard_info=(i * R_l, n * R_l, i == 0, i == n - 1),
                uniforms=None if u is None else u[i][0],
                uniforms_halo=None if u_halo is None else u_halo[i])
        return reds, news

    return sweep


def _local_observables(grid: _Grid, reds, blacks, periodic: bool, col_sharded: bool):
    """(sum of the spins, sum of the bonds) over this process's shards, a
    (2,) float64 tensor on ``grid.home``; both are exact integers, so the
    sums over ranks are exact in any order. Every bond joins a red site to a
    black one, so the bond sum is each red shard times its black neighbour
    sum, the black halos included: each bond is counted once, by the shard
    that holds its red site."""
    ups, downs = _halo_exchange(blacks, periodic, grid=grid)
    if col_sharded:
        lefts, rights = _halo_exchange_cols(blacks, periodic, grid)
    dev = grid.home
    bond = spins = torch.zeros((), dtype=torch.float64, device=dev)
    for i, j in grid.local:
        b, r = blacks[i][j], reds[i][j]
        if col_sharded:
            nbr = neighbor_sum_half_halo2d(b, ups[i][j], downs[i][j], lefts[i][j],
                                           rights[i][j], True)
        else:
            nbr = neighbor_sum_half_halo(b, ups[i][j], downs[i][j], True, periodic)
        bond = bond + (r * nbr).sum(dtype=torch.float64).to(dev)
        spins = spins + (r.sum(dtype=torch.float64) + b.sum(dtype=torch.float64)).to(dev)
    return torch.stack([spins, bond])


def _route(mesh, R, C2, axis_name, col_axis, fused, uniforms):
    """Validate the shard shapes and pick the kernel: returns (grid,
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
    return _Grid(mesh, axis_name, col_axis), fused


def _base(seed) -> int:
    """The run's one stream base, drawn from ``seed`` (an int or a CPU
    ``torch.Generator``)."""
    return int(torch.randint(0, 2**31 - 1, (), generator=as_generator(seed)))


def _run_sweeps(grid, red, black, sweep_ids, fused: bool, base: int, T, periodic, J, field,
                col_sharded, uniforms=None):
    """Sweeps ``sweep_ids`` on sharded planes, K1 in shard mode when
    ``fused`` and K3 otherwise. ``uniforms``: for K3 the per-shard
    (n, 2, R_l, C_l) int32; for K1 (those shards, tops, bots), tops[i] and
    bots[i] the (n, C2) red uniforms of the rows above and below row shard
    i."""
    if fused:
        local = _make_local_fused_sweep(grid, periodic, J, field, T)
        for n, k in enumerate(sweep_ids):
            u = u_halo = None
            if uniforms is not None:
                shards, tops, bots = uniforms
                u = [[None if s is None else s[n] for s in row] for row in shards]
                u_halo = [None if t is None else (t[n], b[n]) for t, b in zip(tops, bots)]
            red, black = local(black, base, k, u, u_halo)
        return red, black
    local = _make_local_halfstep(grid, periodic, J, field, col_sharded)
    for n, k in enumerate(sweep_ids):
        u = (None, None)
        if uniforms is not None:
            u = tuple([[None if s is None else s[n, c] for s in row] for row in uniforms]
                      for c in (0, 1))
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
    Across processes every rank passes the same global planes and keeps
    only its shards; the result is gathered on rank 0, and the other ranks
    return (None, None).

    ``seed``: an int or a CPU ``torch.Generator``; the run's stream base is
    drawn from it. ``uniforms``: optional (n_sweeps, 2, R, C2) int32
    replacing the generator, in [0, 2^16) for the fused sweep, [0, 2^24)
    for the half-sweep. ``fused`` (default: row-only sharding and no
    injected uniforms) picks the fused sweep in shard mode, else the
    half-sweep; injected uniforms choose their kernel explicitly, as their
    widths differ.
    """
    R, C2 = black.shape
    grid, fused = _route(mesh, R, C2, axis_name, col_axis, fused, uniforms)
    base = _base(seed)
    reds, blacks = _scatter(red, grid), _scatter(black, grid)
    shards = None
    if uniforms is not None:
        U = torch.as_tensor(uniforms, dtype=torch.int32)
        if U.shape != (n_sweeps, 2, R, C2):
            raise ValueError(f"uniforms must be (n_sweeps, 2, R, C2), got {tuple(U.shape)}")
        shards = _scatter(U, grid)
        if fused:
            n = grid.n
            R_l = R // n
            rows = {i for i, _ in grid.local}
            tops = [U[:, 0, (i * R_l - 1) % R].contiguous().to(grid.devs[i][0])
                    if i in rows else None for i in range(n)]
            bots = [U[:, 0, ((i + 1) * R_l) % R].contiguous().to(grid.devs[i][0])
                    if i in rows else None for i in range(n)]
            shards = (shards, tops, bots)
    reds, blacks = _run_sweeps(grid, reds, blacks, range(n_sweeps), fused, base, temperature,
                               periodic, J, field, col_axis is not None, shards)
    return _gather(grid, reds, blacks)


def _snapshot(grid: _Grid, path, state: dict, reds, blacks):
    """Write the run's snapshot: ``state`` with the merged planes, one file
    (rank 0 gathers and writes it across processes), then every rank meets,
    so that none reads it before the rename."""
    red, black = _gather(grid, reds, blacks)
    if grid.rank == 0:
        save_state(path, {**state, "red": red, "black": black})
    if grid.multi:
        distributed.barrier()


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
    n_sweeps sweeps that follows n_burnin sweeps of burn-in), equal on
    every rank; ``"final_planes"``, the global (red, black) on the first
    shard's device (across processes gathered on rank 0, None on the
    others); and ``"shards"``, {(i, j): (red, black)} of the shards this
    process holds. The planes stay sharded on the mesh for the whole run;
    across processes each rank sums its shards' spins and bonds per sample
    and the ranks add them up in float64 once, at the end (and at each
    snapshot). Sweep s of the run (burn-in first, then the samples' blocks)
    draws from the run's base under the global sweep counter s. ``fused``
    as in :func:`sharded_checkerboard_sweeps`. ``dtype``: plane storage,
    default bfloat16 on the fused path (±1 spins are exact in it) and
    float32 otherwise.

    ``checkpoint_path`` with ``checkpoint_every > 0`` snapshots the run
    after every ``checkpoint_every`` samples: the base, the merged planes,
    the samples done and the observables so far, all in one file written
    under a temporary name and renamed (by rank 0 across processes, the
    other ranks waiting for it). ``resume=True`` continues from that
    snapshot when it exists (and starts afresh when it does not), so the
    resumed run returns exactly what the uninterrupted one would; the file
    is the same for any number of processes, so a run snapshotted on N
    processes resumes on M.
    """
    R, C = lattice0.shape
    grid, fused = _route(mesh, R, C // 2, axis_name, col_axis, fused, None)
    if dtype is None:
        dtype = torch.bfloat16 if fused else torch.float32
    red, black = split_checkerboard(lattice0.to(dtype))
    base = _base(seed)
    reds, blacks = _scatter(red, grid), _scatter(black, grid)
    col_sharded = col_axis is not None
    run = dict(fused=fused, base=base, T=temperature, periodic=periodic, J=J, field=field,
               col_sharded=col_sharded)
    dev = grid.home
    ms = torch.empty(n_samples, dtype=torch.float64, device=dev)
    es = torch.empty(n_samples, dtype=torch.float64, device=dev)
    sums = torch.zeros((n_samples, 2), dtype=torch.float64, device=dev)   # spins, bonds
    checkpointing = checkpoint_path is not None and checkpoint_every > 0
    done = 0
    if resume and checkpointing and checkpoint_exists(checkpoint_path):
        st = restore_state(checkpoint_path, {
            "base": 0, "red": red, "black": black, "done": 0, "ms": ms, "es": es})
        run["base"], done = st["base"], st["done"]
        reds, blacks = _scatter(st["red"], grid), _scatter(st["black"], grid)
        ms.copy_(st["ms"])
        es.copy_(st["es"])
    else:
        reds, blacks = _run_sweeps(grid, reds, blacks, range(n_burnin), **run)
    finished = done

    def finish(upto: int):
        """The observables of samples finished..upto from the ranks' sums."""
        part = sums[finished:upto]
        if grid.multi and upto > finished:
            part = distributed.all_reduce_sum(part)
        ms[finished:upto] = part[:, 0] / (R * C)
        es[finished:upto] = -J * part[:, 1] - field * part[:, 0]
        return upto

    for i in range(done, n_samples):
        start = n_burnin + i * n_sweeps
        reds, blacks = _run_sweeps(grid, reds, blacks, range(start, start + n_sweeps), **run)
        sums[i] = _local_observables(grid, reds, blacks, periodic, col_sharded)
        if checkpointing and ((i + 1) % checkpoint_every == 0 or i + 1 == n_samples):
            finished = finish(i + 1)
            _snapshot(grid, checkpoint_path, {"base": run["base"], "done": i + 1, "ms": ms,
                                              "es": es}, reds, blacks)
    finish(n_samples)
    final = _gather(grid, reds, blacks)
    return {"magnetization": ms.cpu(), "energy": es.cpu(),
            "final_planes": final if grid.rank == 0 else None,
            "shards": {(i, j): (reds[i][j], blacks[i][j]) for i, j in grid.local}}
