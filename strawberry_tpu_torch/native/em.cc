// Batched latent-class-model EM — C++ fast path for the host-routed
// per-locus solves (oracle: quant/em.py, ref: EmSolver src/estimate.cpp:
// 366-488). Same recurrence and quirks as the oracle:
//   * per-iteration column renormalization with the newF==0 no-op (an
//     all-zero column keeps its previous newF values)
//   * on convergence (||theta'-theta|| < 1e-2) the PREVIOUS theta is kept
//   * a zero E-step denominator aborts the run; the caller's contract
//     (batched_em) then uses theta0, which we fill directly
// Sums run in ascending-index order (the convergence norm uses numpy's
// 8-accumulator pairwise algorithm to track the oracle's float path as
// closely as possible); remaining ulp-level differences vs numpy's BLAS
// gemv are absorbed by the %.6f output formatting, as with the device EM.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

using std::size_t;

namespace {
typedef int64_t i64;

const int MAX_ITER = 1000;
const double THETA_CHANGE_LIMIT = 1e-2;

// numpy pairwise_sum (numpy/core/src/umath/loops_utils.h.src semantics)
static double np_pairwise_sum(const double* a, i64 n) {
  if (n < 8) {
    double res = 0.0;
    for (i64 i = 0; i < n; ++i) res += a[i];
    return res;
  }
  if (n <= 128) {
    double r[8];
    for (int k = 0; k < 8; ++k) r[k] = a[k];
    i64 i = 8;
    for (; i + 8 <= n; i += 8)
      for (int k = 0; k < 8; ++k) r[k] += a[i + k];
    double res = ((r[0] + r[1]) + (r[2] + r[3])) +
                 ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res += a[i];
    return res;
  }
  i64 n2 = n / 2;
  n2 -= n2 % 8;
  return np_pairwise_sum(a, n2) + np_pairwise_sum(a + n2, n - n2);
}

static void em_one(i64 nrow, i64 ncol, const double* u, const double* F0,
                   double theta0, double* theta_out) {
  std::vector<double> F(F0, F0 + nrow * ncol);
  std::vector<double> newF(nrow * ncol, 0.0);
  std::vector<double> theta(ncol, theta0), next_theta(ncol), denom(nrow),
      diff(ncol);
  for (int it = 0; it < MAX_ITER; ++it) {
    for (i64 i = 0; i < nrow; ++i) {
      double s = 0.0;
      for (i64 j = 0; j < ncol; ++j) s += F[i * ncol + j] * theta[j];
      denom[i] = s;
    }
    for (i64 i = 0; i < nrow; ++i)
      if (denom[i] == 0.0) {
        for (i64 j = 0; j < ncol; ++j) theta_out[j] = theta0;
        return;  // run failure: caller semantics = theta0
      }
    // next_theta_j = sum_i ((u_i * F_ij) * theta_j) / denom_i
    for (i64 j = 0; j < ncol; ++j) {
      double s = 0.0;
      for (i64 i = 0; i < nrow; ++i)
        s += ((u[i] * F[i * ncol + j]) * theta[j]) / denom[i];
      next_theta[j] = s;
    }
    // column renormalize into newF; zero columns keep previous newF
    for (i64 j = 0; j < ncol; ++j) {
      double cs = 0.0;
      for (i64 i = 0; i < nrow; ++i) cs += F[i * ncol + j];
      if (cs != 0.0)
        for (i64 i = 0; i < nrow; ++i)
          newF[i * ncol + j] = F[i * ncol + j] / cs;
    }
    F = newF;
    for (i64 j = 0; j < ncol; ++j) {
      double d = next_theta[j] - theta[j];
      diff[j] = d * d;
    }
    if (std::sqrt(np_pairwise_sum(diff.data(), ncol)) <
        THETA_CHANGE_LIMIT)
      break;  // previous theta is the answer
    theta = next_theta;
  }
  for (i64 j = 0; j < ncol; ++j) theta_out[j] = theta[j];
}

}  // namespace

extern "C" {

// Batched EM over pre-filtered problems.
//   u_off:  (n+1) row offsets into u_flat
//   F_off:  (n+1) element offsets into F_flat (row-major nrow x ncol)
//   ncol:   (n,) isoform counts
//   theta0: (n,) initial theta scalar (total_count / niso)
//   theta_out: flat, ncol[k] entries per problem at th_off[k]
void strawb_em_batch(i64 n, const i64* u_off, const i64* F_off,
                     const i64* ncol, const double* theta0,
                     const double* u_flat, const double* F_flat,
                     const i64* th_off, double* theta_out, i64 n_threads) {
  auto work = [&](i64 k0, i64 k1) {
    for (i64 k = k0; k < k1; ++k) {
      i64 nrow = u_off[k + 1] - u_off[k];
      em_one(nrow, ncol[k], u_flat + u_off[k], F_flat + F_off[k],
             theta0[k], theta_out + th_off[k]);
    }
  };
  if (n_threads <= 1 || n < 4) {
    work(0, n);
    return;
  }
  std::vector<std::thread> ts;
  i64 per = (n + n_threads - 1) / n_threads;
  for (i64 t = 0; t < n_threads; ++t) {
    i64 a = t * per, b = a + per < n ? a + per : n;
    if (a >= b) break;
    ts.emplace_back(work, a, b);
  }
  for (auto& th : ts) th.join();
}

// Raw-slice variant for the fully-vectorized pass-2 finalize: takes the
// quant-prep partition slices directly (un-truncated counts + flat
// alpha) and performs the Python-side per-locus preamble here — count
// truncation (np.trunc), total = numpy-pairwise sum of the truncated
// counts, the >1e-5 any-weight row filter, theta0 = total/niso, and the
// init-failure rule (no surviving rows -> status 0, EmSolver::init
// returning false, estimate.cpp:374-391).
//   bin_off:   (n+1) row offsets into counts_flat
//   alpha_off: (n+1) element offsets into alpha_flat (row-major nb x nc)
//   th_off:    (n+1) offsets into theta_out
void strawb_em_batch_raw(i64 n, const i64* bin_off, const i64* niso,
                         const double* counts_flat,
                         const double* alpha_flat, const i64* alpha_off,
                         const i64* th_off, double* theta_out,
                         uint8_t* status, i64 n_threads) {
  auto work = [&](i64 k0, i64 k1) {
    std::vector<double> tc, u, F;
    for (i64 k = k0; k < k1; ++k) {
      i64 nb = bin_off[k + 1] - bin_off[k];
      i64 nc = niso[k];
      const double* cnt = counts_flat + bin_off[k];
      const double* al = alpha_flat + alpha_off[k];
      tc.resize(nb);
      for (i64 i = 0; i < nb; ++i) tc[i] = std::trunc(cnt[i]);
      double total = np_pairwise_sum(tc.data(), nb);
      u.clear();
      F.clear();
      for (i64 i = 0; i < nb; ++i) {
        bool keep = false;
        for (i64 j = 0; j < nc; ++j)
          if (al[i * nc + j] > 1e-5) {
            keep = true;
            break;
          }
        if (!keep) continue;
        u.push_back(tc[i]);
        F.insert(F.end(), al + i * nc, al + (i + 1) * nc);
      }
      if (u.empty()) {
        status[k] = 0;
        for (i64 j = 0; j < nc; ++j) theta_out[th_off[k] + j] = 0.0;
        continue;
      }
      status[k] = 1;
      em_one((i64)u.size(), nc, u.data(), F.data(), total / (double)nc,
             theta_out + th_off[k]);
    }
  };
  if (n_threads <= 1 || n < 4) {
    work(0, n);
    return;
  }
  std::vector<std::thread> ts;
  i64 per = (n + n_threads - 1) / n_threads;
  for (i64 t = 0; t < n_threads; ++t) {
    i64 a = t * per, b = a + per < n ? a + per : n;
    if (a >= b) break;
    ts.emplace_back(work, a, b);
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"
