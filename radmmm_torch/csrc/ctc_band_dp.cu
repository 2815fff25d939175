// The CTC alpha and beta band DPs of the attention CTC loss, for Hopper
// (sm_90a), f32. Two kernels in one file.
//
// Replace the TPU kernels radmmm_tpu/losses/ctc_pallas.py::_alpha_kernel
// (ctc_alpha_pallas) and ::_beta_kernel (ctc_beta_pallas). With S = 2*T_text
// + 1 states per item (even s: blank, odd s: text token (s+1)/2, every label
// distinct) and per-state emissions emit (B, T_mel, S):
//
//   alpha(0, s) = emit(0, s) for s in {0, 1} (and s <= 2*text_len), else NEG
//   alpha(t, s) = lse3(alpha[s], alpha[s-1], alpha[s-2] + skip(s)) + emit(t, s)
//                 for s <= 2*text_len, else NEG; rows t >= mel_len frozen
//   beta(t) = terminal for t >= mel_len - 1 (0 at s in {2*text_len,
//             2*text_len - 1}, else NEG), otherwise
//   beta(t, s) = lse3(q[s], q[s+1], q[s+2] + skip(s)), q = beta(t+1) + emit(t+1)
//
// skip(s) is 0 for odd (label) s and NEG for even s; lse3 is max + log of
// the three exps; NEG = -1e30 is finite, so 0 * NEG = 0 and no NaN appears.
// These are the JAX scan's formulas term for term (losses/ctc.py:98-126 and
// :189-213), so the kernels equal the port's plain twins up to the card's
// expf/logf.
//
// What bounds it: the serial chain of T_mel - 1 dependent rows, not bytes
// or FLOPs. At the flagship step (B = 8, T_mel = 512, S = 193) a DP reads
// 3.2 MB and writes 3.2 MB (about 2 us at 3.35 TB/s) and does about 4
// transcendental functions per state and row; each row depends on the whole
// row before it.
//
// Design: one block per batch item, one thread per state (up to 4 states a
// thread for long texts), the band double-buffered in shared memory. A loop
// over mel rows with one __syncthreads() a row replaces the Pallas kernels'
// sequential grid; each thread loads the next row's emissions before the
// barrier so the load is off the chain. Each block writes its own rows of
// the (T_mel, B, S) output.
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxPerThread = 4;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__device__ __forceinline__ float skip(int s) { return (s & 1) ? 0.f : kNeg; }

__global__ void ctc_alpha_kernel(const float* __restrict__ emit,
                                 const int* __restrict__ text_lens,
                                 const int* __restrict__ mel_lens,
                                 float* __restrict__ alphas, int B, int T,
                                 int S) {
  extern __shared__ float band[];            // 2 x S
  const int b = blockIdx.x;
  const int top = 2 * text_lens[b];          // last valid state
  const int ml = mel_lens[b];
  const float* e = emit + (size_t)b * T * S;
  float* cur = band;
  float* nxt = band + S;

  float em[kMaxPerThread];
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int s = threadIdx.x + k * blockDim.x;
    if (s >= S) break;
    const float a = (s <= 1 && s <= top) ? e[s] : kNeg;
    cur[s] = a;
    alphas[(size_t)b * S + s] = a;
    if (T > 1) em[k] = e[(size_t)S + s];
  }
  __syncthreads();

  for (int t = 1; t < T; ++t) {
    if (t >= ml) {                            // frozen rows, uniform branch
      for (int k = 0; k < kMaxPerThread; ++k) {
        const int s = threadIdx.x + k * blockDim.x;
        if (s >= S) break;
        alphas[((size_t)t * B + b) * S + s] = cur[s];
      }
      continue;
    }
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int s = threadIdx.x + k * blockDim.x;
      if (s >= S) break;
      const float p1 = s >= 1 ? cur[s - 1] : kNeg;
      const float p2 = (s >= 2 ? cur[s - 2] : kNeg) + skip(s);
      const float a = s <= top ? lse3(cur[s], p1, p2) + em[k] : kNeg;
      nxt[s] = a;
      alphas[((size_t)t * B + b) * S + s] = a;
      if (t + 1 < T) em[k] = e[(size_t)(t + 1) * S + s];
    }
    __syncthreads();
    float* tmp = cur; cur = nxt; nxt = tmp;
  }
}

__global__ void ctc_beta_kernel(const float* __restrict__ emit,
                                const int* __restrict__ text_lens,
                                const int* __restrict__ mel_lens,
                                float* __restrict__ betas, int B, int T,
                                int S) {
  extern __shared__ float band[];            // 2 x S: q of the row after
  const int b = blockIdx.x;
  const int tl2 = 2 * text_lens[b];
  const int ml = mel_lens[b];
  const float* e = emit + (size_t)b * T * S;
  float* cur = band;
  float* nxt = band + S;

  float term[kMaxPerThread], em[kMaxPerThread];
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int s = threadIdx.x + k * blockDim.x;
    if (s >= S) break;
    term[k] = (s == tl2 || s == tl2 - 1) ? 0.f : kNeg;
    betas[((size_t)(T - 1) * B + b) * S + s] = term[k];
    cur[s] = term[k] + e[(size_t)(T - 1) * S + s];
    if (T > 1) em[k] = e[(size_t)(T - 2) * S + s];
  }
  __syncthreads();

  for (int t = T - 2; t >= 0; --t) {
    const bool terminal = t >= ml - 1;        // uniform across the block
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int s = threadIdx.x + k * blockDim.x;
      if (s >= S) break;
      float beta = term[k];
      if (!terminal) {
        const float n1 = s + 1 < S ? cur[s + 1] : kNeg;
        const float n2 = (s + 2 < S ? cur[s + 2] : kNeg) + skip(s);
        beta = lse3(cur[s], n1, n2);
      }
      betas[((size_t)t * B + b) * S + s] = beta;
      nxt[s] = beta + em[k];
      if (t > 0) em[k] = e[(size_t)(t - 1) * S + s];
    }
    __syncthreads();
    float* tmp = cur; cur = nxt; nxt = tmp;
  }
}

int launch(bool alpha, const float* emit, const int* text_lens,
           const int* mel_lens, float* out, int B, int T, int S,
           void* stream) {
  int threads = (S + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  if (S > threads * kMaxPerThread) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)S * sizeof(float);
  auto* kernel = alpha ? ctc_alpha_kernel : ctc_beta_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(emit, text_lens,
                                                     mel_lens, out, B, T, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// emit (B, T, S) f32; text_lens, mel_lens (B,) int32; out (T, B, S) f32.
// Return cudaGetLastError() after the launch (0 on success).
int ctc_alpha_launch(const float* emit, const int* text_lens,
                     const int* mel_lens, float* alphas, int B, int T, int S,
                     void* stream) {
  return launch(true, emit, text_lens, mel_lens, alphas, B, T, S, stream);
}

int ctc_beta_launch(const float* emit, const int* text_lens,
                    const int* mel_lens, float* betas, int B, int T, int S,
                    void* stream) {
  return launch(false, emit, text_lens, mel_lens, betas, B, T, S, stream);
}

const char* radmmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
