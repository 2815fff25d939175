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
// hand-off between the threads of a row, and whatever wait for its
// emissions is left on the chain.
//
// Design: one block per batch item; a loop over mel rows inside the block
// replaces the Pallas kernels' sequential grid. Each block writes its own
// rows of the (T_mel, B, S) output.
// - alpha: a thread per state (or per few states: up to 4 for long
//   texts), the band double-buffered in shared memory, one
//   __syncthreads() a row. The emissions arrive through a shared-memory
//   ring of R rows (16; 8 where 18 rows of S floats would not fit a
//   block), kept R - 1 rows ahead of the DP by 4-byte cp.async copies, one
//   commit group a row, so a row never waits for device memory. A row is S floats (772
//   bytes at S = 193, not a multiple of 16), which no TMA tensor map can
//   describe, and the bulk copy's 16-byte alignment would hold only for
//   every fourth row; a thread copies exactly the states it computes, so
//   its own wait_group, not a barrier, tells it that its row has landed.
//   A thread takes one state (up to 1,024 states), so a row's barrier
//   spans ceil(S / 32) warps; two states a thread over half as many warps
//   was slower on an H100 at the flagship shape (PERF.md).
// - beta: a warp wavefront with no block barrier in the row loop. Warp w
//   owns the states [32 C w, 32 C (w + 1)); lane l holds C of them,
//   s = 32 (C w + k) + l for k < C (32 apart, so a warp's ring reads and
//   its copies are unit-stride), and the row q = beta + emit in registers.
//   The neighbours s + 1 and s + 2 come from two lane rotations
//   (__shfl_sync); lanes 30 and 31 take the top ones from the warp above,
//   which publishes q at its first two states each row into a small edge
//   ring: one 64-bit shared store of (value, row), spun on by the reader
//   until the row matches, so no fence either way. The reader publishes
//   the rows it consumed, so the ring is never overrun. The top warp runs
//   ahead and each warp below trails it by about a row. Emissions arrive
//   through a cp.async ring like alpha's, walked backwards, 24 rows deep
//   in copy groups of 8: one commit and one wait a group, since a warp
//   issues in order and a row's bookkeeping lands on its chain. The wait
//   for an edge is the whole warp's, so the warp never diverges. Rows
//   t >= mel_len - 1 are the terminal band, stored without a DP row; the
//   DP starts at mel_len - 2 from terminal + emit(mel_len - 1).
//   C (states a lane) is 1 where S allows (2 and 4 were slower at S = 193
//   on an H100, PERF.md), else the least of 2 and 4 that keeps the block
//   within 1,024 threads.
#include <cuda_runtime.h>

#include "wavefront.cuh"

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

// G rows a copy group, NG groups in the emission ring (R = G NG rows); C
// states a lane (see the file's head). Warp w's states are
// s = 32 (C w + k) + l; states past S hold q = NEG. Step j = 1 .. n_dp
// computes row t = n_dp - j from q_{j-1} (row t + 1's beta + emit) and
// leaves q_j; q_0 = terminal + emit(mel_len - 1).
template <int G, int NG, int C>
__global__ void __launch_bounds__(1024)
    ctc_beta_kernel(const float* __restrict__ emit,
                    const int* __restrict__ text_lens,
                    const int* __restrict__ mel_lens,
                    float* __restrict__ betas, int B, int T, int S) {
  using namespace wavefront;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = blockDim.x >> 5;
  // edge ring: per warp kEdgeRows slots of q at its first two states
  unsigned long long* edge = reinterpret_cast<unsigned long long*>(smem_raw);
  int* consumed = reinterpret_cast<int*>(edge + W * kEdgeRows * 2);
  float* ring = reinterpret_cast<float*>(consumed + W);   // G NG x S
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tl2 = 2 * text_lens[b];
  const int ml = min(mel_lens[b], T);
  const int n_dp = max(ml - 1, 0);         // rows n_dp .. T-1 are terminal
  const int s0 = 32 * C * warp + lane;     // state of k = 0

  bool ok[C];
  float term[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int s = s0 + 32 * k;
    ok[k] = s < S;
    term[k] = (s == tl2 || s == tl2 - 1) ? 0.f : kNeg;
  }

  if (n_dp > 0) {
    edge_clear(edge, W * kEdgeRows * 2, threadIdx.x, blockDim.x);
    if (lane == 0) consumed[warp] = 0;
    __syncthreads();                       // once, before the row loop

    // group n: ring rows r = nG .. nG + G - 1 (emission rows n_dp - r) in
    // slot n % NG
    const float* src = emit + (size_t)b * T * S + s0;
    float* lring = ring + s0;
    const unsigned lring_s = smem_u32(lring);
    auto fetch = [&](int n) {
      const unsigned dst = lring_s + 4u * (unsigned)((n % NG) * G * S);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int r = n * G + u;
        if (r <= n_dp) {
#pragma unroll
          for (int k = 0; k < C; ++k)
            if (ok[k])
              copy4(dst + 4u * (unsigned)(u * S + 32 * k),
                    src + (size_t)(n_dp - r) * S + 32 * k);
        }
      }
      commit_copies();
    };
    // Warp w's edge ring: slot j % kEdgeRows holds q_j at its first two
    // states, 8 bytes each. The slot read (rd, row j - 1 of the warp
    // above) and the slot written (wr, row j here) are kept running, not
    // recomputed: a warp issues in order, so a row's address arithmetic
    // lands on its chain.
    const unsigned mine = smem_u32(edge + (size_t)warp * kEdgeRows * 2);
    const unsigned mine_end = mine + 16u * kEdgeRows;
    const unsigned above = mine_end, above_end = above + 16u * kEdgeRows;
    const unsigned below_read = smem_u32(consumed + warp - (warp > 0));
    const unsigned my_read = smem_u32(consumed + warp);
    unsigned rd = above, wr = mine + 8u * (lane & 1);
    int seen = 0;
    float q[C];
    auto publish = [&](int j) {            // q_j, for the warp below
      if (warp > 0) {
        edge_reserve(below_read, j, seen);
        if (lane < 2) edge_store(wr, j, q[0]);
      }
      wr = wr + 16u >= mine_end ? wr + 16u - 16u * kEdgeRows : wr + 16u;
    };

    for (int n = 0; n < NG - 1; ++n) fetch(n);
    wait_copies<NG - 2>();                 // group 0 has landed
#pragma unroll
    for (int k = 0; k < C; ++k) q[k] = ok[k] ? term[k] + lring[32 * k] : kNeg;
    publish(0);
    float* out = betas + ((size_t)(n_dp - 1) * B + b) * S + s0;  // row n_dp-1
    const long long row_step = -(long long)B * S;

    for (int n = 0; n * G <= n_dp; ++n) {
      wait_copies<NG - 2>();               // group n has landed
      fetch(n + NG - 1);                   // into the slot n - 1 left
      const float* rows = lring + (size_t)(n % NG) * G * S;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int j = n * G + u;
        if (u == 0 && n == 0) continue;    // q_0, above
        if (j > n_dp) break;
        float em[C], r1[C], r2[C];
#pragma unroll
        for (int k = 0; k < C; ++k) {
          em[k] = ok[k] ? rows[u * S + 32 * k] : 0.f;
          r1[k] = __shfl_sync(0xffffffffu, q[k], (lane + 1) & 31);
          r2[k] = __shfl_sync(0xffffffffu, q[k], (lane + 2) & 31);
        }
        // the top lanes' neighbours past the warp: q_{j-1} of the warp
        // above; the whole warp waits, so it never diverges
        float e0 = kNeg, e1 = kNeg;
        if (warp + 1 < W) {
          edge_wait2(rd, j - 1, e0, e1);
          // the rows read, every 8th: the producer needs them only once
          // its ring is nearly round
          if (lane == 31 && (j & 7) == 0) progress_store(my_read, j);
        }
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const float n1 = lane < 31 ? r1[k] : (k + 1 < C ? r1[k + 1] : e0);
          const float n2 =
              lane < 30 ? r2[k]
                        : (k + 1 < C ? r2[k + 1] : (lane == 30 ? e0 : e1));
          const float beta = lse3(q[k], n1, n2 + skip(s0 + 32 * k));
          if (ok[k]) out[32 * k] = beta;
          q[k] = ok[k] ? beta + em[k] : kNeg;
        }
        out += row_step;
        rd = rd + 16u == above_end ? above : rd + 16u;
        publish(j);
      }
    }
    wait_copies<0>();
  }
  for (int t = n_dp; t < T; ++t) {         // the terminal band
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (ok[k]) betas[((size_t)t * B + b) * S + s0 + 32 * k] = term[k];
  }
}

using BetaKernel = void (*)(const float*, const int*, const int*, float*,
                            int, int, int);

// the kernel for a ring of G NG rows and C states a lane
template <int G, int NG>
BetaKernel beta_kernel(int C) {
  switch (C) {
    case 1: return ctc_beta_kernel<G, NG, 1>;
    case 2: return ctc_beta_kernel<G, NG, 2>;
    default: return ctc_beta_kernel<G, NG, 4>;
  }
}

// beta's states a lane: 1 (the fastest at S = 193 in PERF.md's H100
// sweep), else the least of 2 and 4 that keeps ceil(S / (32 C)) warps
// within 32
int beta_per_lane(int S) {
  int c = 1;
  while (c < 4 && S > 1024 * c) c *= 2;
  return c;
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

// The launch's plan for S states: warps of the block and states a lane.
void ctc_beta_plan(int S, int* warps, int* per_lane) {
  *per_lane = beta_per_lane(S);
  *warps = (S + 32 * *per_lane - 1) / (32 * *per_lane);
}

int ctc_beta_launch(const float* emit, const int* text_lens,
                    const int* mel_lens, float* betas, int B, int T, int S,
                    void* stream) {
  if (S < 1 || S > 32 * 32 * kMaxPerThread) return (int)cudaErrorInvalidValue;
  int warps, C;
  ctc_beta_plan(S, &warps, &C);
  int dev = 0, optin = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
      != cudaSuccess) return (int)e;
  // the edge rings and progress words, then the emission ring: 24 rows in
  // 3 copy groups of 8 where they fit a block, else 8 rows in 2 groups
  const size_t edges = (size_t)warps * (wavefront::kEdgeRows * 2 * 8 + 4);
  const bool deep = edges + (size_t)24 * S * sizeof(float) <= (size_t)optin;
  const BetaKernel kernel =
      deep ? beta_kernel<8, 3>(C) : beta_kernel<4, 2>(C);
  const size_t smem = edges + (size_t)(deep ? 24 : 8) * S * sizeof(float);
  if ((e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  kernel<<<B, warps * 32, smem, (cudaStream_t)stream>>>(
      emit, text_lens, mel_lens, betas, B, T, S);
  return (int)cudaGetLastError();
}

const char* radmmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
