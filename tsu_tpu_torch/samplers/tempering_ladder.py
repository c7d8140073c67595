"""Temperature-ladder engineering for parallel tempering at lattice scale,
Houdayer cluster moves, and the parallel-tempering ground-state search.

Counterpart of ``tsu_tpu/samplers/tempering_ladder.py``. Swap acceptance
between adjacent rungs falls like exp(-dbeta * dE) with dE extensive in the
number of sites, so the rung spacing has to be built for the system:

1. **Variance-matched initialization**: a pilot run measures the energy
   mean U(beta) and variance sigma^2(beta) on a coarse beta grid; with
   locally Gaussian energies the expected acceptance of a pair
   (beta, beta + dbeta) is

       E[min(1, e^D)] = Phi(mu/sig) + exp(mu + sig^2/2) Phi(-mu/sig - sig),
       D ~ N(mu, sig^2),  mu = dbeta (U(beta') - U(beta)),
       sig^2 = dbeta^2 (sigma^2(beta) + sigma^2(beta')),

   and each spacing is found by root-finding it against the target.
2. **Feedback refinement**: short PT runs measure every pair's acceptance
   and split the pairs below the floor; the last round only measures, so
   the diagnostics describe the ladder returned.

:func:`pt_ground_state_search` drives such a ladder: every rung advances
through one batched bond-kernel launch per half-sweep, the best energy per
replica slot is tracked on the device, copies of the ladder exchange
clusters by Houdayer moves, and a batched quench descends every slot's best
state. All host randomness (initial planes, stream ids, swap uniforms,
Houdayer seed sites) is drawn from a CPU ``torch.Generator`` before the
loops, so a seed gives the same search on every device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from scipy.special import erfcinv, log_ndtr, ndtr

from tsu_tpu_torch.ops.checkerboard import wrap_halos
from tsu_tpu_torch.ops.checkerboard_bonds_kernel import bond_sweep_keys
from tsu_tpu_torch.rng import as_generator
from tsu_tpu_torch.samplers.annealing import checkpoint_not_ported
from tsu_tpu_torch.samplers.tempering import _BondPlaneOps, _swap_permutation

GROWTH_CHECK = 16   # Houdayer cluster-growth steps between fixed-point tests


def predict_swap_acceptance(beta1: float, beta2: float,
                            U: Callable[[float], float],
                            var: Callable[[float], float]) -> float:
    """Expected Metropolis swap acceptance for rungs at beta1 < beta2 under
    the Gaussian energy approximation (module docstring, mechanism 1)."""
    db = float(beta2 - beta1)
    if db <= 0.0:
        return 1.0
    mu = db * (U(beta2) - U(beta1))
    sig = db * math.sqrt(max(var(beta1) + var(beta2), 0.0))
    if sig < 1e-12:
        return min(1.0, math.exp(min(mu, 0.0)))
    z = mu / sig
    # The second term in log space: mu + sig^2/2 overflows exp() long before
    # its product with Phi(-z - sig) stops being finite.
    log_term2 = mu + 0.5 * sig * sig + float(log_ndtr(-z - sig))
    return float(min(1.0, ndtr(z) + math.exp(min(log_term2, 50.0))))


def measure_energy_stats(seed, Jh, Jv, betas, *, field: float = 0.0, periodic: bool = True,
                         n_burnin: int = 128, n_measure: int = 128,
                         device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Pilot (mean, variance) of the energy at each inverse temperature.

    One batched run: replica i anneals geometrically from the hottest pilot
    temperature to its own over ``n_burnin`` sweeps (an (n_burnin, B)
    schedule), then ``n_measure`` single sweeps at its own temperature
    accumulate the moments.
    """
    betas = np.asarray(betas, np.float64)
    temps = (1.0 / betas).astype(np.float32)
    B = betas.shape[0]
    ops = _BondPlaneOps(Jh, Jv, field=field, periodic=periodic, device=device)
    gen = as_generator(seed)
    frac = np.arange(1, n_burnin + 1, dtype=np.float64) / n_burnin
    burn_temps = ((float(temps.max()) ** (1.0 - frac[:, None]))
                  * (betas[None, :] ** -frac[:, None])).astype(np.float32)

    reds, blacks = ops.init_planes(gen, B)
    seeds = torch.randint(0, 2**30, (n_burnin + n_measure, B), generator=gen).numpy()
    keys = bond_sweep_keys(seeds, 1)[:, 0].to(ops.device)      # (n, 2, B, 2)
    if n_burnin:
        reds, blacks = ops.sweep_keyed(reds, blacks, keys[:n_burnin], ops.modes(burn_temps))
    modes = ops.modes(temps)
    es = torch.empty((n_measure, B), dtype=torch.float64, device=ops.device)
    for i in range(n_measure):
        reds, blacks = ops.sweep_keyed(reds, blacks, keys[n_burnin + i:n_burnin + i + 1], modes)
        es[i] = ops.energy_planes(reds, blacks)
    es = es.cpu().numpy()
    return es.mean(axis=0), es.var(axis=0)


def _ladder_from_stats(betas_pilot, U_pilot, var_pilot, *,
                       beta_min: float, beta_max: float, target: float,
                       max_rungs: int, dbeta_cap: float,
                       var_floor_frac: float = 1e-3):
    """Hot-to-cold rung placement by root-finding the Gaussian acceptance.

    Returns (betas ascending hot->cold, the (U, V) interpolants, and the
    capped flag). The variance floor keeps a frozen pilot point from
    licensing an absurd spacing; the cap bounds any single step to a
    fraction of the range for the same reason.
    """
    x = np.asarray(betas_pilot, np.float64)
    var_floor = max(1e-12, var_floor_frac * float(np.max(var_pilot)))
    Uv = np.asarray(U_pilot, np.float64)
    Vv = np.maximum(np.asarray(var_pilot, np.float64), var_floor)

    def U(b):
        return float(np.interp(b, x, Uv))

    def V(b):
        return float(np.interp(b, x, Vv))

    ladder = [float(beta_min)]
    capped = False
    while ladder[-1] < beta_max - 1e-12:
        # One slot stays for the forced beta_max endpoint.
        if len(ladder) >= max_rungs - 1:
            capped = True
            break
        b = ladder[-1]
        hi = min(dbeta_cap, beta_max - b)
        if predict_swap_acceptance(b, b + hi, U, V) >= target:
            ladder.append(b + hi)
            continue
        lo = 0.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if predict_swap_acceptance(b, b + mid, U, V) >= target:
                lo = mid
            else:
                hi = mid
        ladder.append(b + max(lo, 1e-9))
    if ladder[-1] < beta_max:
        ladder.append(float(beta_max))
    return np.asarray(ladder, np.float64), (U, V), capped


def _measure_pair_acceptance(generator, ops: _BondPlaneOps, betas_build, *,
                             n_iters, n_burnin, n_sweeps, swap_interval, pad_multiple):
    """Short PT run -> measured acceptance per builder pair (hot->cold) and
    the attempts behind each.

    The trial ladder is padded to a multiple of ``pad_multiple`` replicas
    with copies of the coldest rung, as in the reference; pad pairs have
    dbeta = 0 and are sliced off. Burn-in iterations sweep and swap but do
    not count.
    """
    R_real = len(betas_build)
    R = R_real if pad_multiple <= 1 else -(-R_real // pad_multiple) * pad_multiple
    betas_d = np.concatenate([betas_build[::-1], np.full(R - R_real, betas_build[-1])])
    betas_d = np.sort(betas_d)[::-1].copy()       # coldest first, pads at the cold end
    temps = (1.0 / betas_d).astype(np.float32)
    betas_t = torch.from_numpy(betas_d.astype(np.float32)).to(ops.device)
    total = n_burnin + n_iters

    reds, blacks = ops.init_planes(generator, R)
    seeds = torch.randint(0, 2**30, (total, R), generator=generator).numpy()
    swap_u = torch.rand((total, R), generator=generator).to(ops.device)
    keys = bond_sweep_keys(seeds, n_sweeps).to(ops.device)
    modes = ops.modes(temps)
    acc_p = torch.zeros(R - 1, dtype=torch.int32, device=ops.device)
    att_p = torch.zeros_like(acc_p)
    for t in range(total):
        reds, blacks = ops.sweep_keyed(reds, blacks, keys[t], modes)
        if (t + 1) % swap_interval == 0:
            e = ops.energy_planes(reds, blacks)
            perm, acc, att = _swap_permutation(swap_u[t], e, betas_t, (t // swap_interval) % 2)
            reds, blacks = reds[perm], blacks[perm]
            if t >= n_burnin:
                acc_p += acc
                att_p += att
    pad = R - R_real
    acc_real, att_real = acc_p.cpu().numpy()[pad:], att_p.cpu().numpy()[pad:]
    meas = acc_real / np.maximum(att_real, 1)
    return meas[::-1].copy(), att_real[::-1].copy()


def build_tempering_ladder(seed, Jh, Jv, *, T_min: float, T_max: float,
                           target_acceptance: float = 0.3, accept_floor: float = 0.2,
                           n_pilot: int = 16, pilot_burnin: int = 128,
                           pilot_measure: int = 128, feedback_rounds: int = 3,
                           feedback_iters: int = 96, feedback_burnin: int = 32,
                           n_sweeps: int = 2, swap_interval: int = 1, max_rungs: int = 512,
                           max_insert: int = 3, pad_multiple: int = 32, field: float = 0.0,
                           periodic: bool = True, device=None) -> Tuple[np.ndarray, Dict]:
    """Construct a PT temperature ladder hitting a target swap acceptance.

    Returns (temperatures ascending, ready for ``parallel_tempering_bonds``
    or :func:`pt_ground_state_search`, and a diagnostics dict describing
    that ladder, cold pair first). ``seed``: an int or a CPU
    ``torch.Generator``, from which the pilot and every feedback round draw
    in turn. ``accept_floor`` is the measured pair rate below which feedback
    splits a pair.
    """
    if not (0.0 < T_min < T_max):
        raise ValueError(f"need 0 < T_min < T_max, got {T_min}, {T_max}")
    gen = as_generator(seed)
    beta_min, beta_max = 1.0 / T_max, 1.0 / T_min
    ops = _BondPlaneOps(Jh, Jv, field=field, periodic=periodic, device=device)

    betas_pilot = np.geomspace(beta_min, beta_max, n_pilot)
    U_pilot, var_pilot = measure_energy_stats(
        gen, ops.Jh, ops.Jv, betas_pilot, field=field, periodic=periodic,
        n_burnin=pilot_burnin, n_measure=pilot_measure, device=ops.device)
    betas, (U_itp, V_itp), capped = _ladder_from_stats(
        betas_pilot, U_pilot, var_pilot, beta_min=beta_min, beta_max=beta_max,
        target=target_acceptance, max_rungs=max_rungs,
        dbeta_cap=(beta_max - beta_min) / 8.0)

    measured = attempts = None
    rounds_run = 0
    for r in range(feedback_rounds):
        measured, attempts = _measure_pair_acceptance(
            gen, ops, betas, n_iters=feedback_iters, n_burnin=feedback_burnin,
            n_sweeps=n_sweeps, swap_interval=swap_interval, pad_multiple=pad_multiple)
        rounds_run += 1
        bad = measured < accept_floor
        # The last allowed round measures without splitting.
        if not bad.any() or r == feedback_rounds - 1:
            break
        if len(betas) >= max_rungs:
            capped = True
            break
        # Split each failing pair by the refinement ratio of the local model
        # acceptance ~ erfc(c dbeta); zero-accept pairs clamp at the
        # resolution of the attempt count.
        new = [betas[0]]
        for q in range(len(betas) - 1):
            if bad[q]:
                a_meas = max(float(measured[q]), 0.5 / max(int(attempts[q]), 1))
                ratio = float(erfcinv(min(a_meas, 0.999))
                              / erfcinv(min(max(target_acceptance, 1e-3), 0.999)))
                k_ins = min(max_insert, max(1, math.ceil(ratio) - 1))
                # The rung budget never drops an endpoint.
                k_ins = max(0, min(k_ins, max_rungs - len(new) - (len(betas) - 1 - q)))
                pts = np.linspace(betas[q], betas[q + 1], k_ins + 2)[1:]
            else:
                pts = [betas[q + 1]]
            new.extend(pts)
        betas = np.asarray(new, np.float64)

    temperatures = np.sort(1.0 / betas).astype(np.float32)
    betas_cold_first = np.sort(betas)[::-1].copy()
    pred_final = np.asarray([
        predict_swap_acceptance(b2, b1, U_itp, V_itp)
        for b1, b2 in zip(betas_cold_first[:-1], betas_cold_first[1:])])
    info = {
        "n_rungs": len(temperatures),
        "betas": betas_cold_first,
        "pilot_betas": betas_pilot,
        "pilot_energy_mean": U_pilot,
        "pilot_energy_var": var_pilot,
        "predicted_acceptance": pred_final,
        "measured_pair_acceptance": None if measured is None else measured[::-1].copy(),
        "measured_pair_attempts": None if attempts is None else attempts[::-1].copy(),
        "feedback_rounds_run": rounds_run,
        "capped": capped,
        "target_acceptance": target_acceptance,
        "accept_floor": accept_floor,
    }
    return temperatures, info


def _neighbor_or(mask, update_red: bool, periodic: bool):
    """4-neighbour OR across the checkerboard bipartition: the neighbours of
    one colour's sites are on the other colour's plane. A boolean mask has
    no weights to zero, so an open lattice masks the horizontal wraps."""
    R, C2 = mask.shape[-2:]
    row_is_even = (torch.arange(R, device=mask.device) % 2 == 0)[:, None]
    pick = row_is_even if update_red else ~row_is_even
    up_row, down_row = wrap_halos(mask, periodic)
    up = torch.cat([up_row, mask[..., :-1, :]], dim=-2)
    down = torch.cat([mask[..., 1:, :], down_row], dim=-2)
    left_shift = torch.roll(mask, 1, dims=-1)
    right_shift = torch.roll(mask, -1, dims=-1)
    if not periodic:
        j = torch.arange(C2, device=mask.device)
        # left_shift feeds only picked rows, whose left neighbour wraps at
        # j == 0; right_shift only the others, wrapping at j == C2 - 1.
        left_shift = left_shift & (j != 0)
        right_shift = right_shift & (j != C2 - 1)
    left = torch.where(pick, left_shift, mask)
    right = torch.where(pick, mask, right_shift)
    return up | down | left | right


def _houdayer(u, r1, b1, r2, b2, periodic: bool):
    """Houdayer move of a batch of replica pairs with the seed site of pair
    i chosen by the uniform u[i]: the k-th q = -1 site (red plane first,
    row-major) with k = floor(u[i] * count). The cluster grows until a step
    changes nothing, tested every GROWTH_CHECK steps."""
    qr = (r1.float() * r2.float()) < 0
    qb = (b1.float() * b2.float()) < 0
    B = qr.shape[0]
    flat = torch.cat([qr.reshape(B, -1), qb.reshape(B, -1)], dim=1)
    count = flat.sum(dim=1)
    k = torch.minimum((u.to(torch.float64) * count).long(), (count - 1).clamp(min=0))
    seed = flat & (torch.cumsum(flat, dim=1) == (k + 1)[:, None])
    nred = qr[0].numel()
    m_red, m_black = seed[:, :nred].view_as(qr), seed[:, nred:].view_as(qb)
    while True:
        for _ in range(GROWTH_CHECK):
            prev_red, prev_black = m_red, m_black
            m_red = m_red | (qr & _neighbor_or(m_black, True, periodic))
            m_black = m_black | (qb & _neighbor_or(m_red, False, periodic))
        if torch.equal(m_red, prev_red) and torch.equal(m_black, prev_black):
            break
    return (torch.where(m_red, -r1, r1), torch.where(m_black, -b1, b1),
            torch.where(m_red, -r2, r2), torch.where(m_black, -b2, b2))


def houdayer_move(seed, r1, b1, r2, b2, *, periodic: bool = True):
    """Houdayer isoenergetic cluster move on a batch of replica pairs.

    For each pair (same temperature, same bonds): take the overlap
    q_i = s1_i s2_i, pick a uniform random site with q = -1, grow the
    4-connected q = -1 cluster holding it and flip that cluster in both
    replicas. Each boundary bond's two-replica energy is unchanged, so
    E1 + E2 is conserved exactly and the move needs no acceptance test.
    Pairs that agree everywhere are left as they are. Inputs are the compact
    (B, R, C/2) planes of both replicas; returns the four updated planes.
    ``seed``: an int or a CPU ``torch.Generator``, from which one uniform
    per pair is drawn.
    """
    u = torch.rand(r1.shape[0], generator=as_generator(seed)).to(r1.device)
    return _houdayer(u, r1, b1, r2, b2, periodic)


def pt_ground_state_search(seed, Jh, Jv, *, temperatures, n_iters: int = 2000,
                           n_sweeps: int = 1, swap_interval: int = 1, n_copies: int = 1,
                           houdayer_every: int = 0, houdayer_frac: float = 0.5,
                           field: float = 0.0, periodic: bool = True, quench_sweeps: int = 64,
                           quench_T_final: float = 0.02, chunk_iters=None,
                           checkpoint_path=None, checkpoint_every: int = 1,
                           resume: bool = False, device=None) -> Dict:
    """Parallel-tempering ground-state search over one bond realization on
    ``device`` (default ``torch.get_default_device()``).

    ``n_copies`` ladders run side by side in one kernel batch (B =
    n_copies * n_rungs replicas), each swapping within itself. With two or
    more copies, ``houdayer_every > 0`` applies Houdayer moves every that
    many iterations to the coldest ``houdayer_frac`` of the rungs of each
    copy pair (copies 2k and 2k+1). Every iteration sweeps all replicas
    ``n_sweeps`` times, tracks the best energy per replica slot, swaps, then
    moves clusters; afterwards every slot's best state descends through a
    batched quench to ``quench_T_final`` and the lowest is returned.

    ``seed``: an int or a CPU ``torch.Generator``; the initial planes, the
    stream ids, swap uniforms and Houdayer uniforms of every iteration and
    the quench's stream ids are drawn from it up front. ``chunk_iters``
    has no effect here (the reference's launch granularity; its stream,
    like this one, does not depend on it). ``checkpoint_path`` and
    ``resume`` raise ``NotImplementedError``. Returns the reference's dict.
    """
    if checkpoint_path is not None or resume:
        raise checkpoint_not_ported("pt_ground_state_search")
    del chunk_iters, checkpoint_every
    gen = as_generator(seed)
    temps_np = np.sort(np.asarray(temperatures, np.float32).reshape(-1))
    R, C = len(temps_np), int(n_copies)
    B = C * R
    ops = _BondPlaneOps(Jh, Jv, field=field, periodic=periodic, device=device)
    dev = ops.device
    rows, cols = ops.Jh.shape
    modes = ops.modes(np.tile(temps_np, C))
    betas = (1.0 / torch.from_numpy(temps_np)).to(dev)

    n_pairs = C // 2
    hd_rungs = max(1, int(round(R * houdayer_frac)))
    use_houdayer = houdayer_every > 0 and n_pairs > 0
    n_moves = n_iters // houdayer_every if use_houdayer else 0

    reds, blacks = ops.init_planes(gen, B)
    seeds = torch.randint(0, 2**30, (n_iters, B), generator=gen).numpy()
    swap_u = torch.rand((n_iters, C, R), generator=gen).to(dev)
    hd_u = torch.rand((n_moves, n_pairs * hd_rungs), generator=gen).to(dev)
    keys = bond_sweep_keys(seeds, n_sweeps).to(dev)
    # Slots of rung j of copies 2k (idx1) and 2k+1 (idx2), j < hd_rungs.
    idx1 = (2 * R * torch.arange(n_pairs)[:, None] + torch.arange(hd_rungs)).reshape(-1).to(dev)
    idx2 = idx1 + R
    base = (R * torch.arange(C, device=dev))[:, None]

    best_r, best_b = reds, blacks
    best_e = ops.energy_planes(reds, blacks)
    acc_p = torch.zeros(max(R - 1, 0), dtype=torch.int32, device=dev)
    att_p = torch.zeros_like(acc_p)
    for t in range(n_iters):
        reds, blacks = ops.sweep_keyed(reds, blacks, keys[t], modes)
        e = ops.energy_planes(reds, blacks)
        better = (e < best_e)[:, None, None]
        best_r = torch.where(better, reds, best_r)
        best_b = torch.where(better, blacks, best_b)
        best_e = torch.minimum(e, best_e)
        if (t + 1) % swap_interval == 0:
            perm, acc, att = _swap_permutation(swap_u[t], e.view(C, R), betas,
                                               (t // swap_interval) % 2)
            perm = (perm + base).reshape(-1)
            reds, blacks = reds[perm], blacks[perm]
            acc_p += acc.sum(dim=0, dtype=torch.int32)
            att_p += att * C
        if use_houdayer and (t + 1) % houdayer_every == 0:
            r1, b1, r2, b2 = _houdayer(hd_u[(t + 1) // houdayer_every - 1], reds[idx1],
                                       blacks[idx1], reds[idx2], blacks[idx2], periodic)
            reds = reds.index_put((idx1,), r1).index_put((idx2,), r2)
            blacks = blacks.index_put((idx1,), b1).index_put((idx2,), b2)

    if quench_sweeps > 0:
        # Every slot's best state descends to its local minimum; B restarts
        # for the price of one batched schedule.
        qsched = np.geomspace(float(temps_np[0]), quench_T_final, quench_sweeps).astype(np.float32)
        qmodes = ops.modes(np.repeat(qsched[:, None], B, axis=1))
        qkeys = bond_sweep_keys(torch.randint(0, 2**30, (quench_sweeps, B), generator=gen)
                                .numpy(), 1).to(dev)
        qr, qb = best_r, best_b
        for k in range(quench_sweeps):
            qr, qb = ops.sweep_keyed(qr, qb, qkeys[k], {n: m[k:k + 1] for n, m in qmodes.items()})
            e = ops.energy_planes(qr, qb)
            better = (e < best_e)[:, None, None]
            best_r = torch.where(better, qr, best_r)
            best_b = torch.where(better, qb, best_b)
            best_e = torch.minimum(e, best_e)

    best_e_np = best_e.cpu().numpy()
    acc_np, att_np = acc_p.cpu().numpy(), att_p.cpu().numpy()
    i = int(best_e_np.argmin())
    n_att = int(att_np.sum())
    return {
        "best_state": ops.merge(best_r[i], best_b[i]).cpu().numpy(),
        "best_energy": float(best_e_np[i]),
        "energy_per_site": float(best_e_np[i]) / (rows * cols),
        "pair_acceptance": acc_np / np.maximum(att_np, 1),
        "pair_attempts": att_np,
        "swap_acceptance_rate": float(acc_np.sum()) / n_att if n_att else 0.0,
        "n_rungs": R,
        "n_copies": C,
        "houdayer_every": houdayer_every if use_houdayer else 0,
        "temperatures": temps_np,
        "iters_run": int(n_iters),
        "discrete_table_path": ops.discrete,
    }
