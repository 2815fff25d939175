// Batched monotonic alignment search (width-1 Viterbi) on CPU.
//
// Native counterpart of the reference's numba-JIT mas_width1
// (alignment.py:31-59): same DP recurrence and tie-break (prefer j-1 when
// log_p[i-1][j-1] >= log_p[i-1][j]) and the trailing opt[0][0]=1 write.
// The port's own copy of the JAX package's cpp/mas.cc: the host twin of
// the card's kernel (csrc/mas_width1.cu, radmmm_torch/ops/alignment.py);
// items run in parallel across a thread pool. An item with no text or no
// frames gets no path (all zero), as the kernel gives it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

void mas_one(const float* attn, int T_mel, int T_text, int stride_mel,
             float* out) {
  if (T_mel <= 0 || T_text <= 0) return;
  const float kNegInf = -std::numeric_limits<float>::infinity();
  std::vector<float> log_p(static_cast<size_t>(T_mel) * T_text);
  std::vector<int32_t> prev(static_cast<size_t>(T_mel) * T_text, 0);

  for (int j = 0; j < T_text; ++j) {
    float a = std::log(std::max(attn[j], 1e-45f));
    log_p[j] = (j == 0) ? a : kNegInf;
  }
  for (int i = 1; i < T_mel; ++i) {
    const float* row = attn + static_cast<size_t>(i) * stride_mel;
    float* lp = log_p.data() + static_cast<size_t>(i) * T_text;
    const float* lp_prev = log_p.data() + static_cast<size_t>(i - 1) * T_text;
    int32_t* pv = prev.data() + static_cast<size_t>(i) * T_text;
    for (int j = 0; j < T_text; ++j) {
      float best = lp_prev[j];
      int32_t best_j = j;
      if (j > 0 && lp_prev[j - 1] >= lp_prev[j]) {
        best = lp_prev[j - 1];
        best_j = j - 1;
      }
      lp[j] = std::log(std::max(row[j], 1e-45f)) + best;
      pv[j] = best_j;
    }
  }
  int curr = T_text - 1;
  for (int i = T_mel - 1; i >= 0; --i) {
    out[static_cast<size_t>(i) * stride_mel + curr] = 1.0f;
    curr = prev[static_cast<size_t>(i) * T_text + curr];
  }
  out[curr] = 1.0f;  // reference's trailing opt[0, curr] write
}

}  // namespace

extern "C" {

// attn, out: (B, T_mel_max, T_text_max) row-major float32. out must be
// zero-initialized. Lens clip each item's valid region.
void mas_batch(const float* attn, float* out, int B, int T_mel_max,
               int T_text_max, const int32_t* mel_lens,
               const int32_t* text_lens, int n_threads) {
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min(n_threads, B);
  std::vector<std::thread> threads;
  auto work = [&](int start, int step) {
    for (int b = start; b < B; b += step) {
      const size_t base =
          static_cast<size_t>(b) * T_mel_max * T_text_max;
      mas_one(attn + base, mel_lens[b], text_lens[b], T_text_max,
              out + base);
    }
  };
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(work, t, n_threads);
  work(0, n_threads);
  for (auto& th : threads) th.join();
}

}  // extern "C"
