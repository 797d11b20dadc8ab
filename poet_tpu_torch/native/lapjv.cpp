// Jonker-Volgenant linear assignment (shortest augmenting paths with
// potentials): the host's exact O(n^3) solver for square cost matrices, in
// float64.
//
// The port's copy of `poet_tpu/native/lapjv.cpp` (the port imports nothing
// of the JAX package, so it carries its own source). The matcher keeps its
// float32 solver (`ops/hungarian.py`), whose ties break as JAX's in-jit
// solver's do; this one is the independent oracle beside it and the solver
// for host tooling. Built with g++ into the gitignored build directory at
// first use (`native/__init__.py:lapjv`) and called through ctypes.

#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// cost: row-major n x n. col_of_row: output, size n.
// Returns the optimal total cost.
double lapjv(const double* cost, int32_t n, int32_t* col_of_row) {
    const double INF = std::numeric_limits<double>::infinity();
    // 1-indexed potentials / assignment (index 0 is the virtual column).
    std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
    std::vector<int32_t> p(n + 1, 0), way(n + 1, 0);

    for (int32_t i = 1; i <= n; ++i) {
        p[0] = i;
        int32_t j0 = 0;
        std::vector<double> minv(n + 1, INF);
        std::vector<bool> used(n + 1, false);
        do {
            used[j0] = true;
            int32_t i0 = p[j0], j1 = 0;
            double delta = INF;
            const double* row = cost + (int64_t)(i0 - 1) * n;
            for (int32_t j = 1; j <= n; ++j) {
                if (used[j]) continue;
                double cur = row[j - 1] - u[i0] - v[j];
                if (cur < minv[j]) {
                    minv[j] = cur;
                    way[j] = j0;
                }
                if (minv[j] < delta) {
                    delta = minv[j];
                    j1 = j;
                }
            }
            for (int32_t j = 0; j <= n; ++j) {
                if (used[j]) {
                    u[p[j]] += delta;
                    v[j] -= delta;
                } else {
                    minv[j] -= delta;
                }
            }
            j0 = j1;
        } while (p[j0] != 0);
        // augment along the alternating path
        do {
            int32_t j1 = way[j0];
            p[j0] = p[j1];
            j0 = j1;
        } while (j0);
    }

    double total = 0.0;
    for (int32_t j = 1; j <= n; ++j) {
        if (p[j] > 0) {
            col_of_row[p[j] - 1] = j - 1;
            total += cost[(int64_t)(p[j] - 1) * n + (j - 1)];
        }
    }
    return total;
}

// Batched variant: costs (b, n, n) row-major; out (b, n).
void lapjv_batch(const double* costs, int32_t b, int32_t n, int32_t* out) {
    for (int32_t k = 0; k < b; ++k) {
        lapjv(costs + (int64_t)k * n * n, n, out + (int64_t)k * n);
    }
}

}  // extern "C"
