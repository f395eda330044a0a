// C++ BPE merge-loop runtime: the hot path of byte-level BPE encoding.
// Replacement for the reference's Rust `tokenizers` runtime
// (/root/reference/requirements.txt:74; SURVEY.md N8/N9). Python owns file
// parsing and pretokenization; this kernel applies lowest-rank-first pair
// merges over vocab ids. Merge rules arrive as packed (left<<32|right) keys
// in rank order plus the merged token's vocab id.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

struct Bpe {
  // (left<<32|right) -> {rank, merged_id}
  std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> rules;
};

inline uint64_t key(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

}  // namespace

extern "C" {

void* jl_bpe_new(int64_t n_merges, const int64_t* pair_keys,
                 const int32_t* merged_ids) {
  auto* bpe = new Bpe();
  bpe->rules.reserve(static_cast<size_t>(n_merges) * 2);
  for (int64_t r = 0; r < n_merges; ++r) {
    bpe->rules.emplace(static_cast<uint64_t>(pair_keys[r]),
                       std::make_pair(static_cast<int32_t>(r), merged_ids[r]));
  }
  return bpe;
}

void jl_bpe_free(void* handle) { delete static_cast<Bpe*>(handle); }

// Merge `n` symbol ids in place-ish; writes result to `out` (cap >= n).
// Returns the merged length.
int64_t jl_bpe_encode(void* handle, const int32_t* syms, int64_t n,
                      int32_t* out) {
  const auto& rules = static_cast<Bpe*>(handle)->rules;
  std::vector<int32_t> cur(syms, syms + n);
  while (cur.size() >= 2) {
    int32_t best_rank = INT32_MAX;
    int32_t best_id = -1;
    size_t best_pos = 0;
    for (size_t i = 0; i + 1 < cur.size(); ++i) {
      auto it = rules.find(key(cur[i], cur[i + 1]));
      if (it != rules.end() && it->second.first < best_rank) {
        best_rank = it->second.first;
        best_id = it->second.second;
        best_pos = i;
      }
    }
    if (best_id < 0) break;
    const int32_t a = cur[best_pos], b = cur[best_pos + 1];
    std::vector<int32_t> next;
    next.reserve(cur.size());
    for (size_t i = 0; i < cur.size();) {
      if (i + 1 < cur.size() && cur[i] == a && cur[i + 1] == b) {
        next.push_back(best_id);
        i += 2;
      } else {
        next.push_back(cur[i]);
        ++i;
      }
    }
    cur.swap(next);
  }
  for (size_t i = 0; i < cur.size(); ++i) out[i] = cur[i];
  return static_cast<int64_t>(cur.size());
}

}  // extern "C"
