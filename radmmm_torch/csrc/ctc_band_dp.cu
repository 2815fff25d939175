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
// row before it, so a row's cost is its latency: the lse3 chain, the
// barrier, and whatever wait for its emissions is left on the chain.
//
// Design: one block per batch item, a thread per state (or per few states:
// up to 4 for long texts), the band double-buffered in shared memory. A
// loop over mel rows with one __syncthreads() a row replaces the Pallas
// kernels' sequential grid. Each block writes its own rows of the
// (T_mel, B, S) output.
// - alpha: the emissions arrive through a shared-memory ring of R rows
//   (16; 8 where 18 rows of S floats would not fit a block), kept R - 1
//   rows ahead of the DP by 4-byte cp.async copies, one commit group a
//   row, so a row never waits for device memory. A row is S floats (772
//   bytes at S = 193, not a multiple of 16), which no TMA tensor map can
//   describe, and the bulk copy's 16-byte alignment would hold only for
//   every fourth row; a thread copies exactly the states it computes, so
//   its own wait_group, not a barrier, tells it that its row has landed.
//   A thread takes one state (up to 1,024 states), so a row's barrier
//   spans ceil(S / 32) warps; two states a thread over half as many warps
//   was slower on an H100 at the flagship shape (PERF.md).
// - beta: each thread loads the next row's emissions into a register
//   before the barrier, one row ahead.
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxPerThread = 4;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__device__ __forceinline__ float skip(int s) { return (s & 1) ? 0.f : kNeg; }

// 4-byte asynchronous copies into shared memory, in per-thread groups
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// R: rows of the emission ring, R - 1 of them in flight ahead of the DP.
// P: states a thread, s = threadIdx.x + k * blockDim.x for k < P; their P
// chains are independent, so the loads of a row come before its stores.
template <int R, int P>
__global__ void ctc_alpha_kernel(const float* __restrict__ emit,
                                 const int* __restrict__ text_lens,
                                 const int* __restrict__ mel_lens,
                                 float* __restrict__ alphas, int B, int T,
                                 int S) {
  extern __shared__ float smem[];            // 2 x S band, R x S ring
  const int b = blockIdx.x;
  const int top = 2 * text_lens[b];          // last valid state
  const int live = min(mel_lens[b], T);      // rows 1 .. live-1 are computed
  const float* e = emit + (size_t)b * T * S;
  float* cur = smem;
  float* nxt = smem + S;
  float* ring = smem + 2 * S;
  int st[P];
#pragma unroll
  for (int k = 0; k < P; ++k) st[k] = threadIdx.x + k * blockDim.x;

  // row r's emissions of this thread's states into slot r % R; a thread
  // reads only what it copied, so its own wait_group orders the two. Rows
  // the DP never reads are not fetched, and their group stays empty.
  auto fetch = [&](int r) {
    if (r < live) {
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (st[k] < S)
          cp_async4(ring + (size_t)(r % R) * S + st[k],
                    e + (size_t)r * S + st[k]);
    }
    cp_async_commit();
  };
  // row r's emissions from the ring into registers, once its group landed
  // (R - 1 groups are committed past row r - 1 whenever this runs)
  float em[P];
  auto take = [&](int r) {
    cp_async_wait<R - 2>();
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (st[k] < S) em[k] = ring[(size_t)(r % R) * S + st[k]];
  };
  for (int r = 1; r < R; ++r) fetch(r);

#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int s = st[k];
    if (s >= S) continue;
    const float a = (s <= 1 && s <= top) ? e[s] : kNeg;
    cur[s] = a;
    alphas[(size_t)b * S + s] = a;
  }
  if (live > 1) take(1);
  __syncthreads();

  int t = 1;
  for (; t < live; ++t) {
    float a[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int s = st[k];
      if (s >= S) continue;
      const float p1 = s >= 1 ? cur[s - 1] : kNeg;
      const float p2 = (s >= 2 ? cur[s - 2] : kNeg) + skip(s);
      a[k] = s <= top ? lse3(cur[s], p1, p2) + em[k] : kNeg;
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (st[k] >= S) continue;
      nxt[st[k]] = a[k];
      alphas[((size_t)t * B + b) * S + st[k]] = a[k];
    }
    fetch(t + R - 1);                        // into the slot row t-1 left
    if (t + 1 < live) take(t + 1);           // the next row's, off the chain
    __syncthreads();
    float* tmp = cur; cur = nxt; nxt = tmp;
  }
  for (; t < T; ++t) {                       // frozen rows past mel_len
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (st[k] < S) alphas[((size_t)t * B + b) * S + st[k]] = cur[st[k]];
  }
  cp_async_wait<0>();
}

using AlphaKernel = void (*)(const float*, const int*, const int*, float*,
                             int, int, int);

template <int R>
AlphaKernel alpha_kernel(int P) {
  switch (P) {
    case 1: return ctc_alpha_kernel<R, 1>;
    case 2: return ctc_alpha_kernel<R, 2>;
    case 3: return ctc_alpha_kernel<R, 3>;
    default: return ctc_alpha_kernel<R, kMaxPerThread>;
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

// threads of a block: one a state, a multiple of 32, at most 1024
int block_threads(int S) {
  const int threads = (S + 31) / 32 * 32;
  return threads > 1024 ? 1024 : threads;
}

}  // namespace

extern "C" {

// emit (B, T, S) f32; text_lens, mel_lens (B,) int32; out (T, B, S) f32.
// Return cudaGetLastError() after the launch (0 on success).
int ctc_alpha_launch(const float* emit, const int* text_lens,
                     const int* mel_lens, float* alphas, int B, int T, int S,
                     void* stream) {
  const int threads = block_threads(S);
  if (S > threads * kMaxPerThread) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
      != cudaSuccess) return (int)e;
  // a ring of 16 rows where it fits a block (S up to 3,228), else of 8
  const bool deep = (size_t)(2 + 16) * S * sizeof(float) <= (size_t)optin;
  const int P = (S + threads - 1) / threads;
  const AlphaKernel kernel =
      deep ? alpha_kernel<16>(P) : alpha_kernel<8>(P);
  const size_t smem = (size_t)(2 + (deep ? 16 : 8)) * S * sizeof(float);
  if ((e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(emit, text_lens,
                                                     mel_lens, alphas, B, T,
                                                     S);
  return (int)cudaGetLastError();
}

int ctc_beta_launch(const float* emit, const int* text_lens,
                    const int* mel_lens, float* betas, int B, int T, int S,
                    void* stream) {
  const int threads = block_threads(S);
  if (S > threads * kMaxPerThread) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)S * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ctc_beta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ctc_beta_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      emit, text_lens, mel_lens, betas, B, T, S);
  return (int)cudaGetLastError();
}

const char* radmmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
