// Levenshtein aligner with operation counts: the native scoring core.
//
// The counterpart of the reference's external SCTK/sclite (asr.sh:1694,
// stage-13 scoring): corpus WER/CER takes millions of DP cells over long
// references, a host-CPU path.  Bound to Python with ctypes
// (llm_guided_asr_tpu_torch/utils/metrics.py); built at first use with
// g++ -O3 into build/host/.
//
// edit_distance_i64(ref, n, hyp, m, out[4]) -> out = {sub, del, ins, cor}

#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

void edit_distance_i64(const int64_t* ref, int64_t n, const int64_t* hyp,
                       int64_t m, int64_t* out) {
    // Full DP matrix (needed for the backtrace); row-major (n+1) x (m+1).
    std::vector<int32_t> d((n + 1) * (m + 1));
    auto at = [m](int64_t i, int64_t j) { return i * (m + 1) + j; };
    for (int64_t i = 0; i <= n; ++i) d[at(i, 0)] = static_cast<int32_t>(i);
    for (int64_t j = 0; j <= m; ++j) d[at(0, j)] = static_cast<int32_t>(j);
    for (int64_t i = 1; i <= n; ++i) {
        const int64_t r = ref[i - 1];
        for (int64_t j = 1; j <= m; ++j) {
            int32_t sub = d[at(i - 1, j - 1)] + (r != hyp[j - 1] ? 1 : 0);
            int32_t del = d[at(i - 1, j)] + 1;
            int32_t ins = d[at(i, j - 1)] + 1;
            d[at(i, j)] = std::min(sub, std::min(del, ins));
        }
    }
    // Backtrace, preferring diagonal moves (matches the python reference).
    int64_t i = n, j = m;
    int64_t n_sub = 0, n_del = 0, n_ins = 0, n_cor = 0;
    while (i > 0 || j > 0) {
        if (i > 0 && j > 0 &&
            d[at(i, j)] == d[at(i - 1, j - 1)] + (ref[i - 1] != hyp[j - 1] ? 1 : 0)) {
            if (ref[i - 1] == hyp[j - 1]) ++n_cor; else ++n_sub;
            --i; --j;
        } else if (i > 0 && d[at(i, j)] == d[at(i - 1, j)] + 1) {
            ++n_del; --i;
        } else {
            ++n_ins; --j;
        }
    }
    out[0] = n_sub; out[1] = n_del; out[2] = n_ins; out[3] = n_cor;
}

}  // extern "C"
