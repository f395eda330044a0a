// C++ edit-distance kernel for corpus-scale CER/WER.
// Replacement for the reference's rapidfuzz backend
// (/root/reference/requirements.txt:56; SURVEY.md N10). Banded two-row
// Levenshtein over int32 token ids; bound via ctypes
// (jiao_liao_asr/utils/native_ext.py).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Plain Levenshtein distance between two int32 token sequences.
int64_t jl_edit_distance(const int32_t* ref, int64_t n, const int32_t* hyp,
                         int64_t m) {
  if (n == 0) return m;
  if (m == 0) return n;
  // ensure the inner row is the shorter sequence
  if (m > n) {
    std::swap(ref, hyp);
    std::swap(n, m);
  }
  std::vector<int64_t> row(m + 1);
  for (int64_t j = 0; j <= m; ++j) row[j] = j;
  for (int64_t i = 1; i <= n; ++i) {
    int64_t prev_diag = row[0];  // dp[i-1][j-1]
    row[0] = i;
    const int32_t ri = ref[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      const int64_t up = row[j];  // dp[i-1][j]
      int64_t best = prev_diag + (hyp[j - 1] != ri);
      const int64_t del = up + 1;
      const int64_t ins = row[j - 1] + 1;
      if (del < best) best = del;
      if (ins < best) best = ins;
      row[j] = best;
      prev_diag = up;
    }
  }
  return row[m];
}

// Batched corpus helper: distances for `count` (ref, hyp) pairs packed into
// flat arrays with offset tables. Returns total distance; per-pair distances
// written to `out` when non-null.
int64_t jl_edit_distance_batch(const int32_t* refs, const int64_t* ref_offsets,
                               const int32_t* hyps, const int64_t* hyp_offsets,
                               int64_t count, int64_t* out) {
  int64_t total = 0;
  for (int64_t i = 0; i < count; ++i) {
    const int64_t d = jl_edit_distance(
        refs + ref_offsets[i], ref_offsets[i + 1] - ref_offsets[i],
        hyps + hyp_offsets[i], hyp_offsets[i + 1] - hyp_offsets[i]);
    if (out) out[i] = d;
    total += d;
  }
  return total;
}

}  // extern "C"
