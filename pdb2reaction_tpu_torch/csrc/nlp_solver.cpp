// Native constrained-NLP solver core (Ipopt replacement for DMF).
//
// Role: the reference's DMF path solves a constrained nonlinear program
// through Ipopt (C++/Fortran, torch-dmf -> cyipopt). This is the native
// equivalent: a projected, box-constrained L-BFGS (L-BFGS-B-style active
// set with gradient projection) iterating over an objective/gradient
// callback — the callback evaluates the batched objective on the card,
// so the native loop only does the O(D) solver algebra. Built by
// pdb2reaction_tpu_torch/native with g++ on first use.
//
// C ABI (ctypes):
//   typedef double (*obj_grad_fn)(const double* x, double* grad_out,
//                                 int64_t dim, void* user);
//   int lbfgsb_minimize(obj_grad_fn f, void* user, double* x, int64_t dim,
//                       const double* lower, const double* upper,
//                       int32_t max_iter, double gtol, int32_t history,
//                       double* f_out, int32_t* iters_out);
//   returns 0 = converged, 1 = max_iter reached, <0 = error.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

typedef double (*obj_grad_fn)(const double* x, double* grad_out,
                              int64_t dim, void* user);

int lbfgsb_minimize(obj_grad_fn f, void* user, double* x, int64_t dim,
                    const double* lower, const double* upper,
                    int32_t max_iter, double gtol, int32_t history,
                    double* f_out, int32_t* iters_out) {
    if (dim <= 0 || history <= 0) return -1;
    const int m = history;
    std::vector<std::vector<double>> S, Y;
    std::vector<double> rho;
    std::vector<double> g(dim), x_new(dim), g_new(dim), d(dim), q(dim);

    auto project = [&](double* v) {
        if (!lower && !upper) return;
        for (int64_t i = 0; i < dim; ++i) {
            if (lower && v[i] < lower[i]) v[i] = lower[i];
            if (upper && v[i] > upper[i]) v[i] = upper[i];
        }
    };
    auto dot = [&](const double* a, const double* b) {
        double s = 0;
        for (int64_t i = 0; i < dim; ++i) s += a[i] * b[i];
        return s;
    };
    auto proj_grad_norm = [&](const double* xv, const double* gv) {
        // norm of the projected gradient: g_i zeroed when pushing into an
        // active bound
        double s = 0;
        for (int64_t i = 0; i < dim; ++i) {
            double gi = gv[i];
            if (lower && xv[i] <= lower[i] && gi > 0) gi = 0;
            if (upper && xv[i] >= upper[i] && gi < 0) gi = 0;
            s = std::max(s, std::fabs(gi));
        }
        return s;
    };

    project(x);
    double fx = f(x, g.data(), dim, user);
    double gamma = 1.0;
    int32_t it = 0;
    int status = 1;

    for (it = 1; it <= max_iter; ++it) {
        if (proj_grad_norm(x, g.data()) < gtol) {
            status = 0;
            break;
        }
        // two-loop recursion on the free-variable gradient
        std::memcpy(q.data(), g.data(), dim * sizeof(double));
        const int k = static_cast<int>(S.size());
        std::vector<double> alpha(k);
        for (int i = k - 1; i >= 0; --i) {
            alpha[i] = rho[i] * dot(S[i].data(), q.data());
            for (int64_t j = 0; j < dim; ++j) q[j] -= alpha[i] * Y[i][j];
        }
        for (int64_t j = 0; j < dim; ++j) d[j] = -gamma * q[j];
        for (int i = 0; i < k; ++i) {
            const double beta = rho[i] * dot(Y[i].data(), d.data());
            for (int64_t j = 0; j < dim; ++j)
                d[j] += (-alpha[i] - beta) * S[i][j];
        }
        // d is now -H g (note sign handling above keeps descent direction)
        double gd = dot(g.data(), d.data());
        if (gd > 0) {  // not a descent direction: reset to steepest descent
            for (int64_t j = 0; j < dim; ++j) d[j] = -g[j];
            gd = -dot(g.data(), g.data());
            S.clear(); Y.clear(); rho.clear();
            gamma = 1.0;
        }
        // backtracking Armijo line search with bound projection
        const double c1 = 1e-4;
        double f_trial = fx;
        bool ok = false;
        for (int attempt = 0; attempt < 2 && !ok; ++attempt) {
            double step = 1.0;
            for (int ls = 0; ls < 40; ++ls) {
                for (int64_t j = 0; j < dim; ++j)
                    x_new[j] = x[j] + step * d[j];
                project(x_new.data());
                // for projected steps Armijo uses the actual displacement
                double gd_eff = 0;
                for (int64_t j = 0; j < dim; ++j)
                    gd_eff += g[j] * (x_new[j] - x[j]);
                f_trial = f(x_new.data(), g_new.data(), dim, user);
                if (std::isfinite(f_trial) &&
                    f_trial <= fx + c1 * gd_eff && gd_eff < 0) {
                    ok = true;
                    break;
                }
                step *= 0.5;
            }
            if (!ok && attempt == 0) {
                // stale curvature near an active bound: restart from
                // projected steepest descent
                S.clear(); Y.clear(); rho.clear();
                gamma = 1.0;
                for (int64_t j = 0; j < dim; ++j) d[j] = -g[j];
                gd = -dot(g.data(), g.data());
            }
        }
        if (!ok) { status = 2; break; }
        // curvature pair
        std::vector<double> s(dim), y(dim);
        for (int64_t j = 0; j < dim; ++j) {
            s[j] = x_new[j] - x[j];
            y[j] = g_new[j] - g[j];
        }
        const double sy = dot(s.data(), y.data());
        if (sy > 1e-12) {
            S.push_back(std::move(s));
            Y.push_back(std::move(y));
            rho.push_back(1.0 / sy);
            gamma = sy / dot(Y.back().data(), Y.back().data());
            if (static_cast<int>(S.size()) > m) {
                S.erase(S.begin());
                Y.erase(Y.begin());
                rho.erase(rho.begin());
            }
        }
        std::memcpy(x, x_new.data(), dim * sizeof(double));
        std::memcpy(g.data(), g_new.data(), dim * sizeof(double));
        fx = f_trial;
    }
    if (f_out) *f_out = fx;
    if (iters_out) *iters_out = it;
    return status;
}

}  // extern "C"
