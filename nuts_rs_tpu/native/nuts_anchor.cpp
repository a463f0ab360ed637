// Native single-core NUTS throughput anchor.
//
// The reference (pymc-devs/nuts-rs) publishes no benchmark numbers and no
// Rust toolchain exists in this image, so `cargo bench` cannot produce the
// CPU figures its criterion harness (`benches/sample.rs:190-198`,
// sample_1000_10 / sample_1000_1000) defines.  This file is the stand-in
// anchor: an independent, optimized C++ implementation of the same
// algorithm — recursive-doubling NUTS with multinomial (progressive)
// sampling, diagonal mass-matrix adaptation (fg/bg Welford, draw/grad
// variance rule), and Nesterov dual averaging — run single-core on THIS
// container's CPU at the reference bench configurations.  bench.py divides
// the device engine's throughput by this measurement (`vs_baseline`), so the
// ratio compares two native implementations of the same algorithm on the
// hardware actually present, instead of the engine against itself.
//
// This is an original implementation written from the algorithm (Hoffman &
// Gelman 2014; structure documented in SURVEY.md §2.6-2.7).  It is NOT a
// translation of the reference's Rust: plain arrays instead of state pools,
// a self-contained recursion carrying (left, right, sample) triples, and a
// simplified-but-equivalent Stan-style window schedule.
//
// Build+run (see bench.py, which does this automatically):
//   g++ -O3 -march=native -std=c++17 nuts_anchor.cpp -o nuts_anchor
//   ./nuts_anchor <dim> <num_tune> <num_draws> <maxdepth> [seed]
// Prints one JSON line: {"grad_evals": N, "seconds": s, "grad_evals_per_sec":
// r, "mean_abs_err": e}.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <vector>

namespace {

// xoshiro256++ (public-domain algorithm) — fast counter-style PRNG.
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    uint64_t x = seed + 0x9E3779B97F4A7C15ull;
    for (int i = 0; i < 4; i++) {
      x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ull;
      x ^= x >> 27; x *= 0x94D049BB133111EBull;
      x ^= x >> 31;
      s[i] = x + 0x9E3779B97F4A7C15ull * (i + 1);
    }
  }
  static uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }
  uint64_t next() {
    uint64_t r = rotl(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3]; s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return r;
  }
  double uniform() { return (next() >> 11) * 0x1.0p-53; }
  double normal() {  // Box-Muller (cached pair)
    if (have_) { have_ = false; return cache_; }
    double u1 = uniform(), u2 = uniform();
    if (u1 < 1e-300) u1 = 1e-300;
    double r = std::sqrt(-2.0 * std::log(u1)), a = 6.283185307179586 * u2;
    cache_ = r * std::sin(a); have_ = true;
    return r * std::cos(a);
  }
  bool have_ = false;
  double cache_ = 0.0;
};

struct Model {
  int dim;
  double mu;
  // Logistic-regression data (empty => iid normal model).
  int n_data = 0;
  std::vector<double> X;  // [n_data, dim] row-major
  std::vector<double> y;  // [n_data]
  mutable std::vector<double> logits;

  // normal: logp = -0.5 sum (q-mu)^2 ; grad = mu - q  (the reference's
  // NormalLogp fixture / sample_1000_* bench model)
  // logreg: logp = sum y (Xq) - log1p(exp(Xq)) - 0.5|q|^2 ;
  //         grad = X^T (y - sigmoid(Xq)) - q   (bench.py GLM config)
  double logp_grad(const double* q, double* grad) const {
    if (n_data == 0) {
      double acc = 0.0;
      for (int i = 0; i < dim; i++) {
        double d = q[i] - mu;
        acc += d * d;
        grad[i] = -d;
      }
      return -0.5 * acc;
    }
    double lp = 0.0;
    for (int i = 0; i < dim; i++) {
      lp -= 0.5 * q[i] * q[i];
      grad[i] = -q[i];
    }
    for (int r = 0; r < n_data; r++) {
      const double* xr = &X[(size_t)r * dim];
      double t = 0.0;
      for (int i = 0; i < dim; i++) t += xr[i] * q[i];
      double m = t > 0 ? t : 0.0;  // stable log1p(exp(t))
      lp += y[r] * t - (m + std::log(std::exp(-m) + std::exp(t - m)));
      double resid = y[r] - 1.0 / (1.0 + std::exp(-t));
      for (int i = 0; i < dim; i++) grad[i] += resid * xr[i];
    }
    return lp;
  }

  void make_logreg(int n, uint64_t seed) {
    n_data = n;
    X.resize((size_t)n * dim);
    y.resize(n);
    Rng r(seed);
    std::vector<double> beta(dim);
    for (int i = 0; i < dim; i++) beta[i] = 0.5 * r.normal();
    for (int row = 0; row < n; row++) {
      double t = 0.0;
      for (int i = 0; i < dim; i++) {
        X[(size_t)row * dim + i] = r.normal();
        t += X[(size_t)row * dim + i] * beta[i];
      }
      y[row] = r.uniform() < 1.0 / (1.0 + std::exp(-t)) ? 1.0 : 0.0;
    }
  }
};

// Phase-space point in the whitened (z) space.
struct Pt {
  std::vector<double> z, v, zg;  // position, velocity, gradient (z-space)
  double logp = 0.0, energy = 0.0;
  int idx = 0;  // signed index in trajectory
  explicit Pt(int d) : z(d), v(d), zg(d) {}
};

struct Sampler {
  Model model;
  int dim, maxdepth;
  Rng rng;
  // diagonal transform: q = z*stds + mean
  std::vector<double> stds, mean;
  double logdet = 0.0;  // sum log(1/stds)
  // Welford fg/bg estimators over draws and grads (q-space)
  struct Est { std::vector<double> dm, dv, gm, gv; double n = 0; };
  Est fg, bg;
  // dual averaging
  double da_mu = 0, da_log_step = 0, da_log_step_bar = 0, da_hbar = 0;
  double da_count = 1;
  double step_size = 0.1;
  long grad_evals = 0;
  std::vector<double> qbuf, gbuf;

  Sampler(Model m, int md, uint64_t seed)
      : model(m), dim(m.dim), maxdepth(md), rng(seed),
        stds(m.dim, 1.0), mean(m.dim, 0.0),
        qbuf(m.dim), gbuf(m.dim) {
    fg = bg = Est{std::vector<double>(dim, 0.0), std::vector<double>(dim, 0.0),
                  std::vector<double>(dim, 0.0), std::vector<double>(dim, 0.0)};
  }

  void eval_z(Pt& p) {  // fill logp, zg from p.z
    for (int i = 0; i < dim; i++) qbuf[i] = p.z[i] * stds[i] + mean[i];
    p.logp = model.logp_grad(qbuf.data(), gbuf.data());
    for (int i = 0; i < dim; i++) p.zg[i] = gbuf[i] * stds[i];
    grad_evals++;
  }

  double energy(const Pt& p) const {
    double ke = 0.0;
    for (int i = 0; i < dim; i++) ke += p.v[i] * p.v[i];
    return 0.5 * ke - (p.logp + logdet);
  }

  // One leapfrog from `from` in direction dir; returns false on divergence.
  bool leapfrog(const Pt& from, int dir, double e0, Pt& out) {
    double eps = dir * step_size;
    for (int i = 0; i < dim; i++) {
      out.v[i] = from.v[i] + 0.5 * eps * from.zg[i];
      out.z[i] = from.z[i] + eps * out.v[i];
    }
    eval_z(out);
    for (int i = 0; i < dim; i++) out.v[i] += 0.5 * eps * out.zg[i];
    out.idx = from.idx + dir;
    out.energy = energy(out);
    double err = out.energy - e0;
    return std::isfinite(err) && err <= 1000.0;
  }

  static bool turning(const Pt& lo, const Pt& hi) {
    double t1 = 0, t2 = 0;
    for (size_t i = 0; i < lo.z.size(); i++) {
      double dz = hi.z[i] - lo.z[i];
      t1 += dz * lo.v[i];
      t2 += dz * hi.v[i];
    }
    return t1 < 0 || t2 < 0;
  }

  // Build a subtree of `depth` doublings from `from` in direction dir.
  // On success fills `far` (outer end) and `sample`+`logw`; returns:
  // 0 ok, 1 turning, 2 divergence.
  int subtree(const Pt& from, int dir, int depth, double e0,
              Pt& far, Pt& sample, double& logw) {
    if (depth == 0) {
      if (!leapfrog(from, dir, e0, far)) return 2;
      sample = far;
      logw = -(far.energy - e0);
      return 0;
    }
    Pt mid(dim), s2(dim);
    double w1, w2;
    int r = subtree(from, dir, depth - 1, e0, mid, sample, w1);
    if (r) return r;
    r = subtree(mid, dir, depth - 1, e0, far, s2, w2);
    if (r) return r;
    // progressive multinomial between the two halves
    logw = w1 > w2 ? w1 + std::log1p(std::exp(w2 - w1))
                   : w2 + std::log1p(std::exp(w1 - w2));
    if (std::log(rng.uniform()) < w2 - logw) sample = s2;
    const Pt& lo = dir > 0 ? from : far;
    const Pt& hi = dir > 0 ? far : from;
    if (turning(lo, hi)) return 1;
    // sub-interfaces (3-way check, nuts.rs:148-161 semantics)
    if (depth >= 1) {
      const Pt& a = dir > 0 ? mid : far;
      const Pt& b = dir > 0 ? far : mid;
      if (turning(a, b)) return 1;
      const Pt& c = dir > 0 ? from : mid;
      const Pt& d2 = dir > 0 ? mid : from;
      if (turning(c, d2)) return 1;
    }
    return 0;
  }

  struct DrawInfo { double accept = 0; long steps = 0; bool div = false; };

  // One NUTS draw from q (q-space, updated in place).
  DrawInfo draw(std::vector<double>& q) {
    Pt minus(dim), plus(dim), cur(dim), sample(dim);
    for (int i = 0; i < dim; i++)
      cur.z[i] = (q[i] - mean[i]) / stds[i];
    eval_z(cur);
    for (int i = 0; i < dim; i++) cur.v[i] = rng.normal();
    cur.idx = 0;
    cur.energy = energy(cur);
    double e0 = cur.energy;
    minus = plus = sample = cur;
    double logw_main = 0.0;
    long steps0 = grad_evals;
    DrawInfo info;
    double sum_acc = 0; long n_acc = 0;
    for (int depth = 0; depth < maxdepth; depth++) {
      int dir = rng.uniform() < 0.5 ? -1 : 1;
      Pt& from = dir > 0 ? plus : minus;
      Pt far(dim), s2(dim);
      double logw_sub;
      int r = subtree(from, dir, depth, e0, far, s2, logw_sub);
      if (r == 2) { info.div = true; break; }
      if (r == 0) {
        // biased progressive: accept new subtree with min(1, w_sub/w_main)
        if (std::log(rng.uniform()) < logw_sub - logw_main) sample = s2;
        double m = std::max(logw_main, logw_sub);
        logw_main = m + std::log(std::exp(logw_main - m)
                                 + std::exp(logw_sub - m));
        (dir > 0 ? plus : minus) = far;
        if (turning(minus, plus)) break;
      } else {
        break;  // inner turning: discard subtree, stop
      }
      sum_acc += std::min(1.0, std::exp(-(s2.energy - e0)));
      n_acc++;
    }
    info.steps = grad_evals - steps0 - 1;  // exclude the init eval
    info.accept = n_acc ? sum_acc / n_acc
                        : (info.div ? 0.0 : 1.0);
    for (int i = 0; i < dim; i++) q[i] = sample.z[i] * stds[i] + mean[i];
    // keep last grads for the estimator (q-space)
    for (int i = 0; i < dim; i++) gbuf[i] = sample.zg[i] / stds[i];
    return info;
  }

  void est_add(Est& e, const std::vector<double>& q,
               const std::vector<double>& g) {
    e.n += 1;
    for (int i = 0; i < dim; i++) {
      double d = q[i] - e.dm[i];
      e.dm[i] += d / e.n;
      e.dv[i] += d * (q[i] - e.dm[i]);
      double dg = g[i] - e.gm[i];
      e.gm[i] += dg / e.n;
      e.gv[i] += dg * (g[i] - e.gm[i]);
    }
  }

  void mass_update() {
    if (fg.n < 3) return;
    logdet = 0.0;
    for (int i = 0; i < dim; i++) {
      double vd = fg.dv[i] / fg.n, vg = fg.gv[i] / fg.n;
      double s2 = (vd > 0 && vg > 0) ? std::sqrt(vd / vg) : stds[i] * stds[i];
      stds[i] = std::sqrt(s2);
      mean[i] = fg.dm[i] + s2 * fg.gm[i];
      logdet -= std::log(stds[i]);
    }
  }

  void da_init() {
    da_mu = std::log(10.0 * step_size);
    da_log_step = std::log(step_size);
    da_log_step_bar = 0.0;
    da_hbar = 0.0;
    da_count = 1;
  }

  void da_advance(double accept) {
    const double t0 = 10.0, gamma = 0.05, k = 0.75, target = 0.8;
    double w = 1.0 / (da_count + t0);
    da_hbar = (1 - w) * da_hbar + w * (target - accept);
    da_log_step = da_mu - da_hbar * std::sqrt(da_count) / gamma;
    double mk = std::pow(da_count, -k);
    da_log_step_bar = mk * da_log_step + (1 - mk) * da_log_step_bar;
    da_count += 1;
    step_size = std::exp(da_log_step);
  }
};

}  // namespace

int main(int argc, char** argv) {
  int dim = argc > 1 ? std::atoi(argv[1]) : 10;
  int num_tune = argc > 2 ? std::atoi(argv[2]) : 1000;
  int num_draws = argc > 3 ? std::atoi(argv[3]) : 1000;
  int maxdepth = argc > 4 ? std::atoi(argv[4]) : 10;
  uint64_t seed = argc > 5 ? std::strtoull(argv[5], nullptr, 10) : 42;
  int logreg_n = argc > 6 ? std::atoi(argv[6]) : 0;  // >0: logistic, N rows

  Model model{dim, 3.0};
  if (logreg_n > 0) {
    model.mu = 0.0;
    model.make_logreg(logreg_n, 1234);
  }
  Sampler s(model, maxdepth, seed);
  std::vector<double> q(dim);
  for (int i = 0; i < dim; i++) q[i] = s.rng.normal();
  s.da_init();

  // Stan-style windows: first 15% step-size only, growing mass windows
  // (25 * 2^k), final 10% step-size only.
  int init_win = std::max(1, (int)(0.15 * num_tune));
  int term_win = std::max(1, (int)(0.10 * num_tune));
  int win_end = init_win + 25, win_size = 25;

  auto t_start = std::chrono::steady_clock::now();
  double post_sum = 0.0;
  long post_n = 0;

  for (int it = 0; it < num_tune + num_draws; it++) {
    auto info = s.draw(q);
    if (it < num_tune) {
      s.da_advance(info.accept);
      bool in_mass = it >= init_win && it < num_tune - term_win;
      if (in_mass && !info.div) {
        s.est_add(s.fg, q, s.gbuf);
        s.est_add(s.bg, q, s.gbuf);
        if (it + 1 >= win_end) {  // close window: adopt bg, restart
          s.mass_update();
          s.fg = s.bg;
          s.bg = Sampler::Est{
              std::vector<double>(dim, 0.0), std::vector<double>(dim, 0.0),
              std::vector<double>(dim, 0.0), std::vector<double>(dim, 0.0)};
          win_size *= 2;
          win_end = std::min(it + 1 + win_size, num_tune - term_win);
          s.da_init();  // re-init DA around the new geometry
        }
      }
      if (it == num_tune - 1) s.step_size = std::exp(s.da_log_step_bar);
    } else {
      for (int i = 0; i < dim; i++) post_sum += q[i];
      post_n += dim;
    }
  }
  auto t_end = std::chrono::steady_clock::now();
  double secs = std::chrono::duration<double>(t_end - t_start).count();
  double rate = s.grad_evals / secs;
  double err = logreg_n > 0 ? 0.0 : std::fabs(post_sum / post_n - model.mu);
  std::printf(
      "{\"grad_evals\": %ld, \"seconds\": %.4f, "
      "\"grad_evals_per_sec\": %.1f, \"mean_abs_err\": %.4f}\n",
      s.grad_evals, secs, rate, err);
  return err < 0.25 ? 0 : 1;
}
