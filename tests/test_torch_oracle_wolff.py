"""The port's copies of the numpy ground truths (``tsu_tpu_torch/oracle.py``:
``wolff_chain`` and ``onsager_magnetization``) against the JAX package's
(``tsu_tpu/oracle/wolff.py``, ``tsu_tpu/oracle/numpy_ref.py``): equal array
for array. Then ``tests/test_wolff.py``'s two checks on the port's copies
and its ``ops/stats``.
"""

import numpy as np
import pytest

from tsu_tpu.oracle import onsager_magnetization as jax_onsager
from tsu_tpu.oracle.wolff import wolff_chain as jax_wolff
from tsu_tpu_torch.oracle import exact_ising_moments, onsager_magnetization, wolff_chain
from tsu_tpu_torch.ops.stats import effective_sample_size


@pytest.mark.parametrize("seed,L,T,n_steps,n_burnin", [
    (0, 4, 2.5, 200, 20), (1, 8, 2.269, 60, 10), (7, 6, 1.5, 40, 5), (3, 10, 3.5, 80, 0),
])
def test_wolff_chain_equals_the_reference(seed, L, T, n_steps, n_burnin):
    ours = wolff_chain(seed, L, T, n_steps, n_burnin=n_burnin)
    ref = jax_wolff(seed, L, T, n_steps, n_burnin=n_burnin)
    assert ours.keys() == ref.keys()
    np.testing.assert_array_equal(ours["m_abs"], ref["m_abs"])
    np.testing.assert_array_equal(ours["final_state"], ref["final_state"])
    assert ours["mean_cluster_size"] == ref["mean_cluster_size"]
    assert ours["sweep_equiv_per_step"] == ref["sweep_equiv_per_step"]


def test_onsager_magnetization_equals_the_reference():
    for T in np.linspace(0.5, 4.0, 20):
        assert onsager_magnetization(float(T)) == jax_onsager(float(T))
    assert onsager_magnetization(2.0, J=1.5) == jax_onsager(2.0, J=1.5)


def _torus_J(L):
    n = L * L
    J = np.zeros((n, n))
    for r in range(L):
        for c in range(L):
            i = r * L + c
            for rr, cc in ((r, (c + 1) % L), ((r + 1) % L, c)):
                j = rr * L + cc
                J[i, j] += 1.0
                J[j, i] += 1.0
    return J


def test_wolff_matches_exact_moments_4x4():
    L, T = 4, 2.5
    out = wolff_chain(0, L, T, n_steps=6000, n_burnin=300)
    ex = exact_ising_moments(_torus_J(L), np.zeros(L * L), temperature=T)
    assert abs(out["m_abs"].mean() - ex["abs_magnetization"]) < 0.03


def test_wolff_cluster_efficiency_at_tc():
    out = wolff_chain(1, 16, 2.269, n_steps=2000, n_burnin=200)
    n = len(out["m_abs"])
    tau_steps = n / (2.0 * effective_sample_size(out["m_abs"]))
    tau_sweq = tau_steps * out["sweep_equiv_per_step"]
    # Wolff is O(1) sweep equivalents at T_c, where heat-bath tau(|M|) at
    # L = 16 is tens of sweeps.
    assert tau_sweq < 8.0
    assert 0.0 < out["sweep_equiv_per_step"] <= 1.0
