// Native host-side graph kernels for the optimization benchmarks.
//
// The TPU does the sampling/annealing; these cover the *host* hot loops that
// pure Python cannot handle at production scale (100k-node graphs —
// BASELINE config 5): greedy local-search MAX-CUT bounds (the honest
// comparison baseline, cf. reference tsu/benchmarks/optimization.py:289-334)
// and coloring-conflict counting. CSR graph representation; exported with C
// linkage for ctypes.
//
// Build: see build.sh (g++ -O3 -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <random>

extern "C" {

// Greedy local-search MAX-CUT. CSR graph: indptr (n+1), indices (nnz),
// weights (nnz), symmetric. Writes the best +-1 assignment into best_spins
// (n) and returns the best cut value over n_restarts.
double greedy_maxcut(
    const int64_t* indptr,
    const int32_t* indices,
    const double* weights,
    int64_t n,
    int32_t n_restarts,
    uint64_t seed,
    int8_t* best_spins) {
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<int> coin(0, 1);

  double best_cut = -1.0;
  int8_t* s = static_cast<int8_t*>(std::malloc(n));
  double* gain = static_cast<double*>(std::malloc(n * sizeof(double)));
  if (!s || !gain) {
    std::free(s);
    std::free(gain);
    return -1.0;
  }

  for (int32_t r = 0; r < n_restarts; ++r) {
    for (int64_t i = 0; i < n; ++i) s[i] = coin(rng) ? 1 : -1;

    // gain[i] = s_i * sum_j w_ij s_j : flip improves the cut iff gain > 0.
    for (int64_t i = 0; i < n; ++i) {
      double f = 0.0;
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k)
        f += weights[k] * s[indices[k]];
      gain[i] = s[i] * f;
    }

    bool improved = true;
    while (improved) {
      improved = false;
      for (int64_t i = 0; i < n; ++i) {
        if (gain[i] > 1e-12) {
          s[i] = -s[i];
          gain[i] = -gain[i];
          // Incremental neighbor-gain update: O(deg) per flip.
          for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
            int64_t j = indices[k];
            gain[j] += 2.0 * weights[k] * s[i] * s[j];
          }
          improved = true;
        }
      }
    }

    double cut = 0.0;
    for (int64_t i = 0; i < n; ++i)
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        int64_t j = indices[k];
        if (j > i) cut += weights[k] * (s[i] != s[j] ? 1.0 : 0.0);
      }
    if (cut > best_cut) {
      best_cut = cut;
      for (int64_t i = 0; i < n; ++i) best_spins[i] = s[i];
    }
  }

  std::free(s);
  std::free(gain);
  return best_cut;
}

// Cut value of a given +-1 assignment on a CSR graph (each undirected edge
// stored twice; counted once via j > i).
double cut_value(
    const int64_t* indptr,
    const int32_t* indices,
    const double* weights,
    int64_t n,
    const int8_t* spins) {
  double cut = 0.0;
  for (int64_t i = 0; i < n; ++i)
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t j = indices[k];
      if (j > i) cut += weights[k] * (spins[i] != spins[j] ? 1.0 : 0.0);
    }
  return cut;
}

// Count same-color edges for a coloring assignment.
int64_t coloring_conflicts(
    const int64_t* indptr,
    const int32_t* indices,
    int64_t n,
    const int32_t* colors) {
  int64_t conflicts = 0;
  for (int64_t i = 0; i < n; ++i)
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t j = indices[k];
      if (j > i && colors[i] == colors[j]) ++conflicts;
    }
  return conflicts;
}


// Simulated annealing on a dense bit-Boltzmann (J, h):
//   E(b) = -1/2 b^T J b - h^T b,  b in {0,1}^n
// Heat-bath site updates in index order (the engine's "sequential" chain,
// cf. reference tsu/gibbs.py:128-162), one sweep per schedule temperature,
// n_chains independent chains; returns the best energy seen and writes the
// matching state. This is the LATENCY path: small problems (n <= a few
// hundred) where a single accelerator dispatch costs more than the whole
// anneal — the TPU path (tsu_tpu/samplers/annealing.py) owns everything big.
double sa_dense(
    const float* J,          // (n, n) row-major, symmetric
    const float* h,          // (n,)
    int32_t n,
    const float* schedule,   // (n_steps,) temperatures
    int32_t n_steps,
    int32_t n_chains,
    uint64_t seed,
    float* best_state) {     // out: (n,)
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  std::uniform_int_distribution<int> coin(0, 1);

  double best_e = 1e300;
  float* b = static_cast<float*>(std::malloc(n * sizeof(float)));
  double* f = static_cast<double*>(std::malloc(n * sizeof(double)));
  if (!b || !f) {
    std::free(b);
    std::free(f);
    return 1e300;
  }

  for (int32_t c = 0; c < n_chains; ++c) {
    // Random init + full local fields f[i] = sum_j J[i][j] b[j] + h[i].
    for (int32_t i = 0; i < n; ++i) b[i] = static_cast<float>(coin(rng));
    double e = 0.0;
    for (int32_t i = 0; i < n; ++i) {
      double fi = h[i];
      const float* Ji = J + static_cast<int64_t>(i) * n;
      for (int32_t j = 0; j < n; ++j) fi += Ji[j] * b[j];
      f[i] = fi;
      e += -0.5 * (fi - h[i]) * b[i] - h[i] * b[i];
    }

    for (int32_t t = 0; t < n_steps; ++t) {
      const double T = schedule[t];
      for (int32_t i = 0; i < n; ++i) {
        const float Jii = J[static_cast<int64_t>(i) * n + i];
        const double g = f[i] - Jii * b[i];  // field excluding self-coupling
        double x = g / T;
        if (x > 30.0) x = 30.0;
        if (x < -30.0) x = -30.0;
        const double p = 1.0 / (1.0 + std::exp(-x));
        const float newb = unif(rng) < p ? 1.0f : 0.0f;
        const float delta = newb - b[i];
        if (delta != 0.0f) {
          // dE = -delta * g - 0.5 * Jii * (newb^2 - old^2); bits: x^2 = x.
          e += -delta * g - 0.5 * Jii * delta;
          const int64_t in = static_cast<int64_t>(i) * n;
          for (int32_t j = 0; j < n; ++j) f[j] += J[static_cast<int64_t>(j) * n + i] * delta;
          (void)in;
          b[i] = newb;
        }
        if (e < best_e) {
          best_e = e;
          for (int32_t j = 0; j < n; ++j) best_state[j] = b[j];
          best_state[i] = b[i];
        }
      }
    }
  }

  std::free(b);
  std::free(f);
  return best_e;
}


// Heat-bath Gibbs sampling on a dense bit-Boltzmann (J, h) — the LATENCY
// path for tiny models (cf. sa_dense above). Site-ordered sweeps
// (order_mode 0, the engine's "sequential" chain, reference
// tsu/gibbs.py:128-162) or a fresh random site permutation per sweep
// (order_mode 1, reference "random"). n_chains independent chains,
// round-robin interleaved into the output so consecutive returned samples
// come from different chains (matching the compiled engine's layout).
// Writes n_samples rows of n floats into out; returns 0 on success.
int32_t gibbs_dense(
    const float* J,        // (n, n) row-major
    const float* h,        // (n,)
    int32_t n,
    double temperature,
    int32_t n_chains,
    int32_t n_samples,     // total across chains
    int32_t n_burnin,      // sweeps per chain before the first sample
    int32_t n_sweeps,      // thinning sweeps between samples
    int32_t order_mode,    // 0 sequential, 1 random permutation per sweep
    uint64_t seed,
    float* out) {          // (n_samples, n)
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  std::uniform_int_distribution<int> coin(0, 1);
  if (n_chains < 1) n_chains = 1;
  const int32_t per_chain = (n_samples + n_chains - 1) / n_chains;

  float* b = static_cast<float*>(std::malloc(
      static_cast<int64_t>(n_chains) * n * sizeof(float)));
  double* f = static_cast<double*>(std::malloc(
      static_cast<int64_t>(n_chains) * n * sizeof(double)));
  int32_t* order = static_cast<int32_t*>(std::malloc(n * sizeof(int32_t)));
  if (!b || !f || !order) {
    std::free(b);
    std::free(f);
    std::free(order);
    return -1;
  }
  for (int32_t i = 0; i < n; ++i) order[i] = i;

  // Init all chains + local fields.
  for (int32_t c = 0; c < n_chains; ++c) {
    float* bc = b + static_cast<int64_t>(c) * n;
    double* fc = f + static_cast<int64_t>(c) * n;
    for (int32_t i = 0; i < n; ++i) bc[i] = static_cast<float>(coin(rng));
    for (int32_t i = 0; i < n; ++i) {
      double fi = h[i];
      const float* Ji = J + static_cast<int64_t>(i) * n;
      for (int32_t j = 0; j < n; ++j) fi += Ji[j] * bc[j];
      fc[i] = fi;
    }
  }

  auto sweep_chain = [&](float* bc, double* fc) {
    if (order_mode == 1) {
      for (int32_t i = n - 1; i > 0; --i) {
        std::uniform_int_distribution<int32_t> pick(0, i);
        const int32_t j = pick(rng);
        const int32_t t = order[i];
        order[i] = order[j];
        order[j] = t;
      }
    }
    for (int32_t k = 0; k < n; ++k) {
      const int32_t i = order[k];
      const float Jii = J[static_cast<int64_t>(i) * n + i];
      double x = (fc[i] - Jii * bc[i]) / temperature;
      if (x > 30.0) x = 30.0;
      if (x < -30.0) x = -30.0;
      const double p = 1.0 / (1.0 + std::exp(-x));
      const float newb = unif(rng) < p ? 1.0f : 0.0f;
      const float delta = newb - bc[i];
      if (delta != 0.0f) {
        for (int32_t j = 0; j < n; ++j)
          fc[j] += J[static_cast<int64_t>(j) * n + i] * delta;
        bc[i] = newb;
      }
    }
  };

  for (int32_t c = 0; c < n_chains; ++c)
    for (int32_t t = 0; t < n_burnin; ++t)
      sweep_chain(b + static_cast<int64_t>(c) * n,
                  f + static_cast<int64_t>(c) * n);

  for (int32_t s = 0; s < per_chain; ++s) {
    for (int32_t c = 0; c < n_chains; ++c) {
      float* bc = b + static_cast<int64_t>(c) * n;
      for (int32_t t = 0; t < n_sweeps; ++t)
        sweep_chain(bc, f + static_cast<int64_t>(c) * n);
      const int64_t row = static_cast<int64_t>(s) * n_chains + c;
      if (row < n_samples)
        for (int32_t i = 0; i < n; ++i) out[row * n + i] = bc[i];
    }
  }

  std::free(b);
  std::free(f);
  std::free(order);
  return 0;
}

}  // extern "C"
