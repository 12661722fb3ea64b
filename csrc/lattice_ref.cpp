// Golden-model permutohedral lattice filter (CPU, C++).
//
// An independent implementation of the same mathematics as the JAX/XLA
// pipeline (simplex_gp_tpu/ops/lattice.py), used as the cross-backend
// differential-test oracle -- the role the reference's CPU extension plays
// against its CUDA backend (reference experiments/cuda_test.py).  The
// structure is deliberately different from both the JAX path (no sort-based
// dedup) and the reference C++ (no open-addressing table or replay buffer):
// a std::unordered_map from packed lattice keys to value accumulators, and
// explicit neighbor-key lookups during the blur.
//
// C ABI for ctypes:
//   lattice_filter_ref(src[n*c], ref[n*d], coeffs[2r+1], n, d, c, order,
//                      blur_variance, out[n*c]) -> 0 on success.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct KeyHash {
    size_t operator()(const std::string& s) const noexcept {
        return std::hash<std::string>()(s);
    }
};

using Table = std::unordered_map<std::string, std::vector<float>, KeyHash>;

std::string pack_key(const std::vector<int32_t>& k) {
    return std::string(reinterpret_cast<const char*>(k.data()),
                       k.size() * sizeof(int32_t));
}

}  // namespace

extern "C" int lattice_filter_ref(const float* src, const float* ref,
                                  const float* coeffs, int n, int d, int c,
                                  int order, float blur_variance, float* out) {
    const int dp1 = d + 1;

    // Elevation scale factors: 1/sqrt((i+1)(i+2)) * (d+1)*sqrt(var + 1/6)
    // (the variance-calibrated lattice spacing; math per the Adams et al.
    // permutohedral construction, reference permutohedral.h:371-391).
    std::vector<double> scale(d);
    const double cal = (d + 1) * std::sqrt(blur_variance + 1.0 / 6.0);
    for (int i = 0; i < d; ++i)
        scale[i] = cal / std::sqrt(double(i + 1) * double(i + 2));

    // Canonical simplex table.
    std::vector<int32_t> canonical((dp1) * (dp1));
    for (int i = 0; i <= d; ++i) {
        for (int j = 0; j <= d - i; ++j) canonical[i * dp1 + j] = i;
        for (int j = d - i + 1; j <= d; ++j) canonical[i * dp1 + j] = i - dp1;
    }

    // Per-point geometry: keys (n, d+1, d) and barycentric weights (n, d+1).
    std::vector<int32_t> keys(size_t(n) * dp1 * d);
    std::vector<float> weights(size_t(n) * dp1);

    std::vector<double> elevated(dp1), rem0(dp1), bary(d + 2);
    std::vector<int32_t> greedy(dp1), rank(dp1);

    for (int p = 0; p < n; ++p) {
        const float* x = ref + size_t(p) * d;
        // Elevate onto the hyperplane sum(z)=0 via the E-matrix recurrence.
        elevated[d] = -d * x[d - 1] * scale[d - 1];
        for (int i = d - 1; i > 0; --i)
            elevated[i] = elevated[i + 1] - i * x[i - 1] * scale[i - 1] +
                          (i + 2) * x[i] * scale[i];
        elevated[0] = elevated[1] + 2 * x[0] * scale[0];

        // Nearest remainder-0 point.
        int sum = 0;
        for (int i = 0; i <= d; ++i) {
            double v = elevated[i] / dp1;
            double up = std::ceil(v) * dp1, down = std::floor(v) * dp1;
            greedy[i] = int32_t(up - elevated[i] < elevated[i] - down ? up : down);
            sum += greedy[i] / dp1;
        }

        // Rank differential (ties by index).
        for (int i = 0; i <= d; ++i) rank[i] = 0;
        for (int i = 0; i < d; ++i)
            for (int j = i + 1; j <= d; ++j) {
                if (elevated[i] - greedy[i] < elevated[j] - greedy[j]) rank[i]++;
                else rank[j]++;
            }

        // Hyperplane repair.
        for (int i = 0; i <= d; ++i) {
            int r2 = rank[i] + sum;
            if (r2 > d) { greedy[i] -= dp1; rank[i] = r2 - dp1; }
            else if (r2 < 0) { greedy[i] += dp1; rank[i] = r2 + dp1; }
            else rank[i] = r2;
        }

        // Barycentric coordinates.
        for (int i = 0; i <= d + 1; ++i) bary[i] = 0.0;
        for (int i = 0; i <= d; ++i) {
            double t = (elevated[i] - greedy[i]) / dp1;
            bary[d - rank[i]] += t;
            bary[d + 1 - rank[i]] -= t;
        }
        bary[0] += 1.0 + bary[d + 1];

        for (int rem = 0; rem <= d; ++rem) {
            weights[size_t(p) * dp1 + rem] = float(bary[rem]);
            int32_t* kp = keys.data() + (size_t(p) * dp1 + rem) * d;
            for (int i = 0; i < d; ++i)
                kp[i] = greedy[i] + canonical[rem * dp1 + rank[i]];
        }
    }

    // Splat.
    Table table;
    table.reserve(size_t(n) * dp1);
    std::vector<int32_t> kv(d);
    for (int p = 0; p < n; ++p)
        for (int rem = 0; rem <= d; ++rem) {
            const int32_t* kp = keys.data() + (size_t(p) * dp1 + rem) * d;
            kv.assign(kp, kp + d);
            auto& val = table[pack_key(kv)];
            if (val.empty()) val.assign(c, 0.0f);
            const float w = weights[size_t(p) * dp1 + rem];
            for (int ch = 0; ch < c; ++ch)
                val[ch] += w * src[size_t(p) * c + ch];
        }

    // Blur along each of the d+1 lattice axes (sequential passes over a
    // double-buffered table; missing neighbors read as zero).
    const int ntaps = 2 * order + 1;
    for (int ax = 0; ax <= d; ++ax) {
        Table next;
        next.reserve(table.size());
        std::vector<int32_t> nk(d);
        for (auto& [key, val] : table) {
            const int32_t* kp = reinterpret_cast<const int32_t*>(key.data());
            std::vector<float> acc(c, 0.0f);
            for (int t = -order; t <= order; ++t) {
                const float w = coeffs[t + order];
                if (t == 0) {
                    for (int ch = 0; ch < c; ++ch) acc[ch] += w * val[ch];
                    continue;
                }
                for (int i = 0; i < d; ++i) nk[i] = kp[i] - t;
                if (ax < d) nk[ax] = kp[ax] + t * d;
                auto it = table.find(pack_key(nk));
                if (it != table.end())
                    for (int ch = 0; ch < c; ++ch) acc[ch] += w * it->second[ch];
            }
            next[key] = std::move(acc);
        }
        table = std::move(next);
    }

    // Slice with the magic normalization 1/(1 + 2^-d).
    const float norm = 1.0f / (1.0f + std::pow(2.0f, -float(d)));
    std::memset(out, 0, size_t(n) * c * sizeof(float));
    for (int p = 0; p < n; ++p)
        for (int rem = 0; rem <= d; ++rem) {
            const int32_t* kp = keys.data() + (size_t(p) * dp1 + rem) * d;
            kv.assign(kp, kp + d);
            auto it = table.find(pack_key(kv));
            if (it == table.end()) continue;
            const float w = weights[size_t(p) * dp1 + rem] * norm;
            for (int ch = 0; ch < c; ++ch)
                out[size_t(p) * c + ch] += w * it->second[ch];
        }
    return 0;
}
