// Copy of native/wtt_native.cpp (the JAX package's host C++ core), built
// by whisper_timestamped_tpu_torch/native.py into build/ at first use.
//
// Native host components for whisper_timestamped_tpu.
//
// The reference relies on native dependency code for these host-side hot
// paths: tiktoken's Rust BPE (via openai-whisper) and dtw-python's Cython DP
// core (survey §2.b). This library provides TPU-framework equivalents with a
// plain C ABI consumed through ctypes (no pybind11 in the image):
//
//   * rank-based byte-pair encoding (greedy lowest-rank merge, identical
//     semantics to the pure-Python BytePairEncoder),
//   * the DTW cost DP + backtrace (symmetric1 and the no-vertical custom
//     step pattern, dtw-python tie-break order: diagonal, left, up).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 wtt_native.cpp -o libwtt_native.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// BPE
// ---------------------------------------------------------------------------

struct BpeHandle {
    std::unordered_map<std::string, int32_t> ranks;
};

// blob layout: repeated records of [u32 len][len bytes][i32 rank]
void* wtt_bpe_new(const uint8_t* blob, uint64_t blob_len) {
    auto* h = new BpeHandle();
    uint64_t off = 0;
    while (off + 8 <= blob_len) {
        uint32_t len;
        std::memcpy(&len, blob + off, 4);
        off += 4;
        if (off + len + 4 > blob_len) break;
        std::string key(reinterpret_cast<const char*>(blob + off), len);
        off += len;
        int32_t rank;
        std::memcpy(&rank, blob + off, 4);
        off += 4;
        h->ranks.emplace(std::move(key), rank);
    }
    return h;
}

void wtt_bpe_free(void* handle) { delete static_cast<BpeHandle*>(handle); }

// Encode one pre-split piece (UTF-8 bytes). Returns number of ids written,
// or -1 if a byte is missing from the vocabulary, or -2 if out_cap too small.
int32_t wtt_bpe_encode_piece(void* handle, const uint8_t* piece, uint32_t n,
                             int32_t* out, uint32_t out_cap) {
    auto* h = static_cast<BpeHandle*>(handle);
    if (n == 0) return 0;
    {
        std::string whole(reinterpret_cast<const char*>(piece), n);
        auto it = h->ranks.find(whole);
        if (it != h->ranks.end()) {
            if (out_cap < 1) return -2;
            out[0] = it->second;
            return 1;
        }
    }
    // parts as (start, len) into piece
    std::vector<std::pair<uint32_t, uint32_t>> parts;
    parts.reserve(n);
    for (uint32_t i = 0; i < n; ++i) parts.emplace_back(i, 1);

    const int32_t NORANK = std::numeric_limits<int32_t>::max();
    auto pair_rank = [&](size_t i) -> int32_t {
        const auto& a = parts[i];
        const auto& b = parts[i + 1];
        std::string key(reinterpret_cast<const char*>(piece) + a.first,
                        a.second + b.second);
        auto it = h->ranks.find(key);
        return it == h->ranks.end() ? NORANK : it->second;
    };

    while (parts.size() > 1) {
        int32_t best = NORANK;
        size_t best_i = SIZE_MAX;
        for (size_t i = 0; i + 1 < parts.size(); ++i) {
            int32_t r = pair_rank(i);
            if (r < best) { best = r; best_i = i; }
        }
        if (best == NORANK) break;
        parts[best_i].second += parts[best_i + 1].second;
        parts.erase(parts.begin() + best_i + 1);
    }

    if (out_cap < parts.size()) return -2;
    for (size_t i = 0; i < parts.size(); ++i) {
        std::string key(reinterpret_cast<const char*>(piece) + parts[i].first,
                        parts[i].second);
        auto it = h->ranks.find(key);
        if (it == h->ranks.end()) return -1;
        out[i] = it->second;
    }
    return static_cast<int32_t>(parts.size());
}

// ---------------------------------------------------------------------------
// DTW
// ---------------------------------------------------------------------------

// Fills path_i/path_j (cap >= n+m) with the alignment path; returns its
// length. Tie-break order matches dtw-python: diagonal, left, up.
int32_t wtt_dtw_path(const double* x, int32_t n, int32_t m, int32_t allow_vertical,
                     int32_t* path_i, int32_t* path_j, int32_t cap) {
    const double INF = std::numeric_limits<double>::infinity();
    std::vector<double> prev(m), cur(m);
    std::vector<int8_t> steps(static_cast<size_t>(n) * m, 0);
    enum { DIAG = 0, LEFT = 1, UP = 2 };

    prev[0] = x[0];
    for (int32_t j = 1; j < m; ++j) {
        prev[j] = prev[j - 1] + x[j];
        steps[j] = LEFT;
    }
    for (int32_t i = 1; i < n; ++i) {
        const double* xr = x + static_cast<size_t>(i) * m;
        cur[0] = allow_vertical ? prev[0] + xr[0] : INF;
        steps[static_cast<size_t>(i) * m] = UP;
        for (int32_t j = 1; j < m; ++j) {
            double best = prev[j - 1];
            int8_t code = DIAG;
            if (cur[j - 1] < best) { best = cur[j - 1]; code = LEFT; }
            if (allow_vertical && prev[j] < best) { best = prev[j]; code = UP; }
            cur[j] = xr[j] + best;
            steps[static_cast<size_t>(i) * m + j] = code;
        }
        std::swap(prev, cur);
    }

    // backtrace
    std::vector<std::pair<int32_t, int32_t>> rev;
    rev.reserve(n + m);
    int32_t i = n - 1, j = m - 1;
    rev.emplace_back(i, j);
    while (i > 0 || j > 0) {
        if (i == 0) {
            --j;
        } else if (j == 0) {
            --i;
        } else {
            switch (steps[static_cast<size_t>(i) * m + j]) {
                case DIAG: --i; --j; break;
                case LEFT: --j; break;
                default: --i; break;
            }
        }
        rev.emplace_back(i, j);
    }
    int32_t len = static_cast<int32_t>(rev.size());
    if (len > cap) return -1;
    for (int32_t k = 0; k < len; ++k) {
        path_i[k] = rev[len - 1 - k].first;
        path_j[k] = rev[len - 1 - k].second;
    }
    return len;
}

}  // extern "C"
