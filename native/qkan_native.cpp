// Native runtime components for qkan_implementation.
//
// C++ counterpart of the reference's native dependencies: a dense-QUBO
// simulated annealer with the same algorithm and energy convention as the
// on-device JAX annealer (anneal/sa.py) -- the role dwave-neal's C++
// sampler plays for the reference (DegreeOptimizer.py:236-237) -- plus a
// brute-force exact solver for small problems (test oracle) and a batch
// energy evaluator.
//
// Build:  g++ -O3 -march=native -shared -fPIC -o libqkan_native.so qkan_native.cpp
// ABI: plain C functions over double arrays; loaded via ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// xorshift128+ PRNG: fast, reproducible across platforms.
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    // splitmix64 seeding
    uint64_t z = seed + 0x9E3779B97F4A7C15ULL;
    auto next = [&z]() {
      z += 0x9E3779B97F4A7C15ULL;
      uint64_t r = z;
      r = (r ^ (r >> 30)) * 0xBF58476D1CE4E5B9ULL;
      r = (r ^ (r >> 27)) * 0x94D049BB133111EBULL;
      return r ^ (r >> 31);
    };
    s0 = next();
    s1 = next();
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  double uniform() {  // [0, 1)
    return (next() >> 11) * (1.0 / 9007199254740992.0);
  }
};

double energy(int n, const double* h, const double* J, const double* s) {
  double e = 0.0;
  for (int i = 0; i < n; ++i) {
    if (s[i] == 0.0) continue;
    e += h[i];
    const double* Ji = J + (size_t)i * n;
    for (int j = i + 1; j < n; ++j) e += Ji[j] * s[j];
  }
  return e;
}

}  // namespace

extern "C" {

// Batched simulated annealing over E(s) = h.s + 1/2 s^T J s (J symmetric,
// zero diagonal).  Writes samples [num_reads, n] (0/1 doubles) and energies
// [num_reads] (offset NOT included; caller adds it).
void qkan_anneal(int n, int num_reads, int num_sweeps, const double* h,
                 const double* J, double beta0, double beta1, uint64_t seed,
                 double* out_samples, double* out_energies) {
  std::vector<double> betas(num_sweeps);
  if (num_sweeps == 1) {
    // np.geomspace(b0, b1, 1) == [b0]: the JAX annealer this mirrors runs
    // its single sweep HOT, not quenched
    betas[0] = beta0;
  } else {
    double ratio = std::pow(beta1 / beta0, 1.0 / (num_sweeps - 1));
    double b = beta0;
    for (int t = 0; t < num_sweeps; ++t, b *= ratio) betas[t] = b;
  }

  std::vector<double> f(n);
  for (int r = 0; r < num_reads; ++r) {
    Rng rng(seed * 0x100000001B3ULL + (uint64_t)r);
    double* s = out_samples + (size_t)r * n;
    for (int i = 0; i < n; ++i) s[i] = rng.next() & 1 ? 1.0 : 0.0;
    // local fields f_i = h_i + sum_j J_ij s_j
    for (int i = 0; i < n; ++i) {
      double acc = h[i];
      const double* Ji = J + (size_t)i * n;
      for (int j = 0; j < n; ++j) acc += Ji[j] * s[j];
      f[i] = acc;
    }
    for (int t = 0; t < num_sweeps; ++t) {
      double beta = betas[t];
      for (int i = 0; i < n; ++i) {
        double de = (1.0 - 2.0 * s[i]) * f[i];
        bool accept = de <= 0.0 || rng.uniform() < std::exp(-beta * de);
        if (accept) {
          double delta = 1.0 - 2.0 * s[i];
          s[i] += delta;
          const double* Ji = J + (size_t)i * n;
          for (int j = 0; j < n; ++j) f[j] += delta * Ji[j];
        }
      }
    }
    out_energies[r] = energy(n, h, J, s);
  }
}

// Exact brute-force minimum for n <= 30 (test oracle).  Returns best energy
// and writes the argmin bits into out_sample.
double qkan_brute_force(int n, const double* h, const double* J,
                        double* out_sample) {
  double best = 1e300;
  uint64_t best_bits = 0;
  std::vector<double> s(n);
  for (uint64_t bits = 0; bits < (1ULL << n); ++bits) {
    for (int i = 0; i < n; ++i) s[i] = (bits >> i) & 1 ? 1.0 : 0.0;
    double e = energy(n, h, J, s.data());
    if (e < best) {
      best = e;
      best_bits = bits;
    }
  }
  for (int i = 0; i < n; ++i) out_sample[i] = (best_bits >> i) & 1 ? 1.0 : 0.0;
  return best;
}

// Batch energy evaluation: energies[r] = E(samples[r]).
void qkan_energies(int n, int num_samples, const double* h, const double* J,
                   const double* samples, double* out_energies) {
  for (int r = 0; r < num_samples; ++r)
    out_energies[r] = energy(n, h, J, samples + (size_t)r * n);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Dense statevector engine: the Aer-class CPU baseline.
//
// The reference's only quantum runtime is Qiskit Aer's C++ gate loop
// (MulStep.py:120-122); Aer is not installable in this environment, so this
// engine provides the denominator for the "statevector gate-ops/sec vs Aer
// CPU" north-star ratio (BASELINE.md row 5).  Same structure as Aer's
// qubitvector: complex amplitudes over 2^q, one cache-friendly strided loop
// per gate, specialized per opcode.  Little-endian qubit convention (qubit t
// has bit weight 2^t) matching sim/circuit.py; for multi-qubit gates
// qubits[0] is the MSB of the gate-matrix index.
//
// Amplitudes are stored as separate re/im planes: real-only gates (H, X,
// Ry, CX, CZ, CRY, SWAP, UCRY -- everything FABLE emits) then run the same
// real 2x2 kernel on each plane.

#include <complex>

namespace sv {

inline void apply_1q_real(double* re, double* im, size_t dim, int t,
                          double m00, double m01, double m10, double m11) {
  const size_t step = 1ULL << t;
  for (size_t base = 0; base < dim; base += 2 * step) {
    for (size_t i = base; i < base + step; ++i) {
      const size_t j = i + step;
      const double r0 = re[i], i0 = im[i], r1 = re[j], i1 = im[j];
      re[i] = m00 * r0 + m01 * r1;
      im[i] = m00 * i0 + m01 * i1;
      re[j] = m10 * r0 + m11 * r1;
      im[j] = m10 * i0 + m11 * i1;
    }
  }
}

}  // namespace sv

extern "C" {

// Gate stream ABI (flattened, ctypes-friendly):
//   ops[g]               opcode: 0=h 1=x 2=z 3=ry 4=rz 5=cx 6=cz 7=swap
//                                8=cry 9=ucry 10=diag
//   qubits[qoff[g]..qoff[g+1])   gate qubit list (ucry: target, then
//                                controls MSB-first; diag: qubits MSB-first)
//   params_re/params_im[poff[g]..poff[g+1])  angles / phases
// State: re/im planes of length 2^num_qubits, updated in place.
// Returns 0 on success, -1 on an unknown opcode.
int qkan_sv_run(int num_qubits, int num_gates, const int* ops,
                const long long* qoff, const int* qubits,
                const long long* poff, const double* params_re,
                const double* params_im, double* re, double* im) {
  const size_t dim = 1ULL << num_qubits;
  const double inv_sqrt2 = 0.7071067811865475244;
  std::vector<double> cos_tab, sin_tab;
  for (int g = 0; g < num_gates; ++g) {
    const int* q = qubits + qoff[g];
    const int nq = (int)(qoff[g + 1] - qoff[g]);
    const double* pr = params_re + poff[g];
    const double* pi = params_im ? params_im + poff[g] : nullptr;
    const long long np = poff[g + 1] - poff[g];
    switch (ops[g]) {
      case 0:  // h
        sv::apply_1q_real(re, im, dim, q[0], inv_sqrt2, inv_sqrt2, inv_sqrt2,
                          -inv_sqrt2);
        break;
      case 1:  // x
        sv::apply_1q_real(re, im, dim, q[0], 0.0, 1.0, 1.0, 0.0);
        break;
      case 2: {  // z
        const size_t step = 1ULL << q[0];
        for (size_t base = step; base < dim; base += 2 * step)
          for (size_t i = base; i < base + step; ++i) {
            re[i] = -re[i];
            im[i] = -im[i];
          }
        break;
      }
      case 3: {  // ry
        const double c = std::cos(pr[0] / 2), s = std::sin(pr[0] / 2);
        sv::apply_1q_real(re, im, dim, q[0], c, -s, s, c);
        break;
      }
      case 4: {  // rz: diag(e^{-i a/2}, e^{i a/2})
        const double c = std::cos(pr[0] / 2), s = std::sin(pr[0] / 2);
        const size_t step = 1ULL << q[0];
        for (size_t base = 0; base < dim; base += 2 * step)
          for (size_t i = base; i < base + step; ++i) {
            const size_t j = i + step;
            double r = re[i], m = im[i];
            re[i] = c * r + s * m;   // * e^{-ia/2}
            im[i] = c * m - s * r;
            r = re[j]; m = im[j];
            re[j] = c * r - s * m;   // * e^{+ia/2}
            im[j] = c * m + s * r;
          }
        break;
      }
      case 5: {  // cx(control, target): swap amplitudes where control set
        const size_t cbit = 1ULL << q[0], step = 1ULL << q[1];
        for (size_t base = 0; base < dim; base += 2 * step)
          for (size_t i = base; i < base + step; ++i) {
            if (!(i & cbit)) continue;
            const size_t j = i + step;
            std::swap(re[i], re[j]);
            std::swap(im[i], im[j]);
          }
        break;
      }
      case 6: {  // cz
        const size_t m = (1ULL << q[0]) | (1ULL << q[1]);
        for (size_t i = 0; i < dim; ++i)
          if ((i & m) == m) {
            re[i] = -re[i];
            im[i] = -im[i];
          }
        break;
      }
      case 7: {  // swap(a, b)
        const size_t ab = (1ULL << q[0]) | (1ULL << q[1]);
        const size_t abit = 1ULL << q[0], bbit = 1ULL << q[1];
        for (size_t i = 0; i < dim; ++i)
          if ((i & abit) && !(i & bbit)) {
            const size_t j = i ^ ab;
            std::swap(re[i], re[j]);
            std::swap(im[i], im[j]);
          }
        break;
      }
      case 8: {  // cry(control, target)
        const double c = std::cos(pr[0] / 2), s = std::sin(pr[0] / 2);
        const size_t cbit = 1ULL << q[0], step = 1ULL << q[1];
        for (size_t base = 0; base < dim; base += 2 * step)
          for (size_t i = base; i < base + step; ++i) {
            if (!(i & cbit)) continue;
            const size_t j = i + step;
            const double r0 = re[i], i0 = im[i], r1 = re[j], i1 = im[j];
            re[i] = c * r0 - s * r1;
            im[i] = c * i0 - s * i1;
            re[j] = s * r0 + c * r1;
            im[j] = s * i0 + c * i1;
          }
        break;
      }
      case 9: {  // ucry(target; controls MSB-first), 2^k angles
        const int t = q[0];
        const int k = nq - 1;
        cos_tab.resize((size_t)np);
        sin_tab.resize((size_t)np);
        for (long long a = 0; a < np; ++a) {
          cos_tab[a] = std::cos(pr[a] / 2);
          sin_tab[a] = std::sin(pr[a] / 2);
        }
        const size_t step = 1ULL << t;
        // FABLE layout fast path (target = MSB, controls = all remaining
        // qubits descending): the angle index IS the pair index, no
        // per-pair bit gathering.  Keeps the baseline honest -- an
        // optimized Aer-class loop would specialize this too.
        bool contiguous = (t == num_qubits - 1) && (k == num_qubits - 1);
        for (int b = 0; contiguous && b < k; ++b)
          if (q[1 + b] != k - 1 - b) contiguous = false;
        if (contiguous) {
          for (size_t i = 0; i < step; ++i) {
            const double c = cos_tab[i], s = sin_tab[i];
            const size_t j = i + step;
            const double r0 = re[i], i0 = im[i], r1 = re[j], i1 = im[j];
            re[i] = c * r0 - s * r1;
            im[i] = c * i0 - s * i1;
            re[j] = s * r0 + c * r1;
            im[j] = s * i0 + c * i1;
          }
          break;
        }
        for (size_t base = 0; base < dim; base += 2 * step)
          for (size_t i = base; i < base + step; ++i) {
            size_t idx = 0;
            for (int b = 0; b < k; ++b)
              idx = (idx << 1) | ((i >> q[1 + b]) & 1ULL);
            const double c = cos_tab[idx], s = sin_tab[idx];
            const size_t j = i + step;
            const double r0 = re[i], i0 = im[i], r1 = re[j], i1 = im[j];
            re[i] = c * r0 - s * r1;
            im[i] = c * i0 - s * i1;
            re[j] = s * r0 + c * r1;
            im[j] = s * i0 + c * i1;
          }
        break;
      }
      case 10: {  // diag over qubits (MSB-first), 2^k complex phases
        const int k = nq;
        for (size_t i = 0; i < dim; ++i) {
          size_t idx = 0;
          for (int b = 0; b < k; ++b)
            idx = (idx << 1) | ((i >> q[b]) & 1ULL);
          const double dr = pr[idx], di = pi ? pi[idx] : 0.0;
          const double r = re[i], m = im[i];
          re[i] = dr * r - di * m;
          im[i] = dr * m + di * r;
        }
        break;
      }
      default:
        return -1;
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Circuit optimizer: the gate-graph scheduling pass of the runtime.
//
// Consumes a flat gate encoding (opcode, q0, q1, param) and applies
// peephole passes with commutation-aware lookback (gates on disjoint qubits
// commute):
//   * cancel self-inverse pairs (H-H, X-X, Z-Z, CX-CX, CZ-CZ, SWAP-SWAP)
//   * merge consecutive Ry/Rz rotations on the same qubit (sum angles,
//     dropping merged rotations with |angle| < eps)
// Writes a keep-mask and updated params; the Python side rebuilds the gate
// list.  Opcodes: 0=h 1=x 2=z 3=ry 4=rz 5=cx 6=cz 7=swap 8=other(barrier
// to all passes -- ucry/diag/unitary are treated as opaque).

namespace {

inline bool shares_qubit(int a0, int a1, int b0, int b1) {
  if (a0 == b0 || a0 == b1) return true;
  if (a1 >= 0 && (a1 == b0 || a1 == b1)) return true;
  return false;
}

}  // namespace

extern "C" {

// Returns the number of kept gates.  keep[g] in {0,1}; params may be
// updated in place (merged rotation angles).
int qkan_optimize_circuit(int num_gates, const int* ops, const int* q0,
                          const int* q1, double* params, double eps,
                          uint8_t* keep) {
  for (int g = 0; g < num_gates; ++g) keep[g] = 1;

  auto is_self_inverse = [](int op) {
    return op <= 2 || (op >= 5 && op <= 7);
  };
  auto same_qubits = [&](int a, int b) {
    if (q0[a] != q0[b]) {
      // swap/cz are symmetric in their qubits
      bool sym = (ops[a] == 6 || ops[a] == 7);
      if (!(sym && q0[a] == q1[b] && q1[a] == q0[b])) return false;
      return true;
    }
    return q1[a] == q1[b];
  };

  bool changed = true;
  while (changed) {
    changed = false;
    for (int g = 0; g < num_gates; ++g) {
      if (!keep[g]) continue;
      if (ops[g] == 8) continue;  // opaque
      // look forward past commuting gates for a partner
      for (int h = g + 1; h < num_gates; ++h) {
        if (!keep[h]) continue;
        if (ops[h] == 8) {
          // opaque gate: assume it touches everything; stop the scan
          break;
        }
        bool touches = shares_qubit(q0[g], q1[g], q0[h], q1[h]);
        if (!touches) continue;  // commutes (disjoint qubits): scan past
        // first gate sharing a qubit: only a mergeable/cancelable partner
        // with the SAME op + qubits helps; otherwise blocked.
        if (ops[h] == ops[g] && same_qubits(g, h)) {
          if (is_self_inverse(ops[g])) {
            keep[g] = keep[h] = 0;
            changed = true;
          } else if (ops[g] == 3 || ops[g] == 4) {  // ry/rz merge
            params[h] += params[g];
            keep[g] = 0;
            if (std::fabs(params[h]) < eps) keep[h] = 0;
            changed = true;
          }
        }
        break;  // blocked (or handled); stop scanning for g
      }
    }
  }
  int kept = 0;
  for (int g = 0; g < num_gates; ++g) kept += keep[g];
  return kept;
}

// Circuit depth over the kept gates (1-2 qubit gates; op 8 uses both slots
// when q1 >= 0).
int qkan_circuit_depth(int num_gates, const int* q0, const int* q1,
                       const uint8_t* keep, int num_qubits) {
  std::vector<int> level(num_qubits, 0);
  int depth = 0;
  for (int g = 0; g < num_gates; ++g) {
    if (!keep[g]) continue;
    int d = level[q0[g]];
    if (q1[g] >= 0 && level[q1[g]] > d) d = level[q1[g]];
    d += 1;
    level[q0[g]] = d;
    if (q1[g] >= 0) level[q1[g]] = d;
    if (d > depth) depth = d;
  }
  return depth;
}

}  // extern "C"
