// Width-1 monotonic alignment search (MAS) for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel radmmm_tpu/ops/alignment.py::_mas_kernel
// (reached through _mas_width1_pallas). Per batch item, over the log
// attention la (T_mel, T_text) (text-masked to NEG = -1e30, row 0 limited to
// token 0, both done by the wrapper as by the Pallas wrapper):
//
//   lp(0) = la(0); for rows i = 1 .. mel_len - 1:
//     diag(i, j) = lp(i-1, j-1) >= lp(i-1, j)     (ties go to the diagonal;
//                                                   lp(i-1, -1) = NEG)
//     lp(i, j) = la(i, j) + (diag ? lp(i-1, j-1) : lp(i-1, j))
//   backtrack from token text_len - 1 at row mel_len - 1: out(i, cur) = 1,
//   cur -= diag(i, cur); row 0 takes cur and token 0 (the reference's
//   trailing opt[0, 0] = 1). Rows past mel_len are zero; an item with
//   text_len = 0 or mel_len = 0 is all zero.
//
// Every value is one f32 add of the same operands as the JAX scan and the
// port's plain twin, and every choice a comparison, so the kernel equals
// them bit for bit.
//
// What bounds it: the serial chain of T_mel - 1 dependent rows and then
// the serial backtrack, not bytes (at the flagship step 1.6 MB in and
// 1.6 MB out, under 1 us at 3.35 TB/s) or FLOPs (one add and one compare
// per cell). A row is a compare and an add, so what a row costs is the
// hand-off of lp between the threads that hold it, and the wait for its
// input if that is left on the chain.
//
// Design: one block per item, a warp wavefront with no block barrier in
// the row loop.
// - Warp w owns the columns [32 C w, 32 C (w + 1)); lane l holds C of
//   them, j = 32 (C w + k) + l for k < C, and their lp in registers. C is
//   ceil(T_text / 32) up to 4, so T_text <= 128 (96 at the flagship) is
//   one warp; longer texts take ceil(T_text / 128) warps of 4.
// - The left neighbour j - 1 comes from one lane rotation per k
//   (__shfl_sync); lane 0 takes column 32 C w - 1 from the warp before,
//   which stores lp at its last column each row, with the row's index, as
//   one 64-bit shared word into a small edge ring (wavefront.cuh). Warp 0
//   leads and each warp after it trails by about a row.
// - The choice bits of a row are one ballot per k: word C w + k covers the
//   columns 32 (C w + k) .. + 31, so the words of a row are the
//   ceil(T_text / 32) words of the columns in order (512 x 3 words = 6 KB
//   at the flagship shape), the layout mas_width1_smem has always counted.
// - The rows of la arrive through a ring of 48 rows (16 where that does
//   not fit) filled by 4-byte cp.async copies in groups of 8 rows, 40
//   rows ahead: a row is 4 T_text bytes, not a multiple of 16 in general,
//   so no TMA tensor map or bulk copy describes it; a lane copies exactly
//   the columns it computes, so its own wait_group orders the ring with no
//   barrier. One commit and one wait a group, not a row: a warp issues in
//   order, so what a row spends on bookkeeping it spends on the chain.
//   For the same reason the wait for an edge is the whole warp's (no
//   divergence) and the row's other work is predicated, not branched.
//   Where not even the 16-row ring fits beside the bits (T_mel x T_text
//   near the limit of mas_width1_smem), the kernel has no ring and loads
//   each row from device memory one row ahead into registers; the space
//   of the 2 rows the limit counts then holds the edge rings.
// - The output's zero fill runs on up to 3 more warps while the DP runs
//   (on the DP warps first where 32 DP warps leave no room).
// - After one __syncthreads(), one thread walks the bits back. The words
//   it needs for row i are loaded kBack rows ahead into registers (the two
//   words around the column where the path stood kBack rows before, since
//   cur falls by at most one a row), so a step is a select, a shift, an
//   and and a subtract, never a dependent shared-memory load.
#include <cuda_runtime.h>

#include <stdint.h>

#include "wavefront.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxPerThread = 4;
constexpr int kFillWarps = 3;
constexpr int kBack = 8;          // backtrack rows prefetched, <= 32

__host__ __device__ inline int dp_warps(int Tt, int C) {
  return (Tt + 32 * C - 1) / (32 * C);
}

__host__ __device__ inline int per_lane(int Tt) {
  const int c = (Tt + 31) / 32;
  return c < kMaxPerThread ? (c < 1 ? 1 : c) : kMaxPerThread;
}

// bytes of the edge rings and progress words (none for one warp)
__host__ __device__ inline size_t edge_bytes(int W) {
  return W > 1 ? ((size_t)W * (wavefront::kEdgeRows * 8 + 4) + 7) / 8 * 8
               : 0;
}

// shared memory: edge rings, progress words, bits (T_mel x words), la ring
// of R rows (none for R = 0)
size_t smem_bytes(int Tm, int Tt, int R) {
  const int nw = (Tt + 31) / 32;
  return edge_bytes(dp_warps(Tt, per_lane(Tt))) +
         ((size_t)Tm * nw + (size_t)R * Tt) * sizeof(float);
}

__device__ void zero_fill(float* o, size_t n, int tid, int nthreads) {
  size_t head = ((16 - ((uintptr_t)o & 15)) & 15) / sizeof(float);
  if (head > n) head = n;
  for (size_t i = tid; i < head; i += nthreads) o[i] = 0.f;
  float4* o4 = reinterpret_cast<float4*>(o + head);
  const size_t n4 = (n - head) / 4;
  for (size_t i = tid; i < n4; i += nthreads)
    o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (size_t i = head + 4 * n4 + tid; i < n; i += nthreads) o[i] = 0.f;
}

// G rows a copy group, NG groups in the ring (R = G NG rows; NG = 0: no
// ring, rows loaded one ahead into registers); C columns a lane; MULTI:
// more than one DP warp (T_text > 128), so the edge hand-off.
template <int G, int NG, int C, bool MULTI>
__global__ void __launch_bounds__(1024)
    mas_width1_kernel(const float* __restrict__ log_attn,
                      const int* __restrict__ text_lens,
                      const int* __restrict__ mel_lens,
                      float* __restrict__ out, int Tm, int Tt) {
  using namespace wavefront;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = MULTI ? dp_warps(Tt, C) : 1;
  const int nw = (Tt + 31) / 32;
  unsigned long long* edge = reinterpret_cast<unsigned long long*>(smem_raw);
  int* consumed = reinterpret_cast<int*>(edge + W * kEdgeRows);
  unsigned int* bits =
      reinterpret_cast<unsigned int*>(smem_raw + edge_bytes(W));
  float* ring = reinterpret_cast<float*>(bits + (size_t)Tm * nw);  // R x Tt

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tl = text_lens[b], ml = min(mel_lens[b], Tm);
  const bool live = tl > 0 && ml > 0;          // uniform: else nothing to mark
  const float* la = log_attn + (size_t)b * Tm * Tt;
  float* o = out + (size_t)b * Tm * Tt;

  const int n_fill = (int)(blockDim.x >> 5) - W;
  if (n_fill == 0 || warp >= W) {
    if (n_fill == 0) zero_fill(o, (size_t)Tm * Tt, threadIdx.x, blockDim.x);
    else zero_fill(o, (size_t)Tm * Tt, threadIdx.x - 32 * W, 32 * n_fill);
  }

  if (warp < W && live) {
    if (MULTI) {                               // the DP warps only
      edge_clear(edge + warp * kEdgeRows, kEdgeRows, lane, 32);
      if (lane == 0) consumed[warp] = 0;
      asm volatile("bar.sync 1, %0;\n" ::"r"(32 * W) : "memory");
    }
    const int col0 = 32 * C * warp + lane;     // column of k = 0
    bool ok[C], keep[C];
    float v[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      ok[k] = col0 + 32 * k < Tt;
      keep[k] = lane == 0 && 32 * (C * warp + k) < Tt;  // stores word k
      v[k] = ok[k] ? la[col0 + 32 * k] : kNeg;
    }
    // Columns past T_text are neither loaded nor read (em 0); what they
    // compute only reaches columns to their right and bits the backtrack
    // never reads.
    const float* src = la + col0;
    // lp(i) at the last column of warp w in slot i % kEdgeRows of its ring
    const unsigned mine = smem_u32(edge + warp * kEdgeRows);
    const unsigned before = mine - 8u * kEdgeRows;
    const unsigned after_read = smem_u32(consumed + warp + (warp + 1 < W));
    const unsigned my_read = smem_u32(consumed + warp);
    int seen = 0;
    auto publish = [&](int i) {
      if (MULTI && warp + 1 < W) {
        edge_reserve(after_read, i, seen);
        if (lane == 31)
          edge_store(mine + 8u * (unsigned)(i % kEdgeRows), i, v[C - 1]);
      }
    };

    unsigned int* brow = bits + nw + C * warp; // bits of row i, running
    const int from = (lane + 31) & 31;
    auto row = [&](int i, const float (&em)[C]) {  // lp(i) from lp(i - 1)
      float rot[C];
#pragma unroll
      for (int k = 0; k < C; ++k)
        rot[k] = __shfl_sync(0xffffffffu, v[k], from);
      float edge_left = kNeg;                  // lp(i-1, -1) for warp 0
      if (MULTI && warp > 0) {                 // the whole warp waits
        edge_left =
            edge_wait(before + 8u * (unsigned)((i - 1) % kEdgeRows), i - 1);
        if (lane == 0) progress_store(my_read, i);
      }
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const float left =
            lane > 0 ? rot[k] : (k > 0 ? rot[k - 1] : edge_left);
        const bool diag = left >= v[k];
        v[k] = em[k] + (diag ? left : v[k]);
        const unsigned int word = __ballot_sync(0xffffffffu, diag);
        if (keep[k]) brow[k] = word;
      }
      brow += nw;
      publish(i);
    };

    publish(0);
    if constexpr (NG > 0) {
      // group n: rows 1 + nG .. nG + G in ring rows (n % NG) G + u
      float* lring = ring + col0;
      const unsigned lring_s = smem_u32(lring);
      auto fetch = [&](int n) {
        const int i0 = 1 + n * G;
        const unsigned dst = lring_s + 4u * (unsigned)((n % NG) * G * Tt);
#pragma unroll
        for (int u = 0; u < G; ++u)
          if (i0 + u < ml) {
#pragma unroll
            for (int k = 0; k < C; ++k)
              if (ok[k])
                copy4(dst + 4u * (unsigned)(u * Tt + 32 * k),
                      src + (size_t)(i0 + u) * Tt + 32 * k);
          }
        commit_copies();
      };
      for (int n = 0; n < NG - 1; ++n) fetch(n);
      for (int n = 0; 1 + n * G < ml; ++n) {
        wait_copies<NG - 2>();                 // group n has landed
        fetch(n + NG - 1);                     // into the slot n - 1 left
        const float* rows = lring + (size_t)(n % NG) * G * Tt;
#pragma unroll
        for (int u = 0; u < G; ++u) {
          const int i = 1 + n * G + u;
          if (i >= ml) break;
          float em[C];
#pragma unroll
          for (int k = 0; k < C; ++k)
            em[k] = ok[k] ? rows[u * Tt + 32 * k] : 0.f;
          row(i, em);
        }
      }
      wait_copies<0>();
    } else {
      float next[C];                           // row i + 1, loaded ahead
#pragma unroll
      for (int k = 0; k < C; ++k)
        next[k] = ok[k] && 1 < ml ? src[(size_t)Tt + 32 * k] : 0.f;
      for (int i = 1; i < ml; ++i) {
        float em[C];
#pragma unroll
        for (int k = 0; k < C; ++k) {
          em[k] = next[k];
          next[k] = ok[k] && i + 1 < ml ? src[(size_t)(i + 1) * Tt + 32 * k]
                                        : 0.f;
        }
        row(i, em);
      }
    }
  }
  __syncthreads();                             // the bits, and the zero fill

  if (threadIdx.x == 0 && live) {
    // slot d holds the words of a row around base[d]: hi covers columns
    // base .. base + 31, lo the 32 before. The row's cur lies within kBack
    // of the cur known when the slot was loaded, so in lo or hi.
    unsigned int lo[kBack], hi[kBack];
    int base[kBack];
    auto load = [&](int d, int r, int c) {     // r < 1: never read
      const unsigned int* w = bits + (size_t)max(r, 0) * nw + (c >> 5);
      base[d] = c & ~31;
      hi[d] = w[0];
      lo[d] = c >= 32 ? w[-1] : 0u;
    };
    int c = tl - 1;
    int r = ml - 1;
    float* orow = o + (size_t)r * Tt;
#pragma unroll
    for (int d = 0; d < kBack; ++d) load(d, r - d, c);
    while (r >= 1) {
#pragma unroll
      for (int d = 0; d < kBack; ++d) {
        if (r < 1) break;
        orow[c] = 1.f;
        const unsigned int w = c >= base[d] ? hi[d] : lo[d];
        const int next = c - (int)(__funnelshift_r(w, w, c) & 1u);
        load(d, r - kBack, c);
        c = next;
        --r;
        orow -= Tt;
      }
    }
    o[c] = 1.f;
    o[0] = 1.f;
  }
}

using MasKernel = void (*)(const float*, const int*, const int*, float*, int,
                           int);

// the kernel for a ring of G NG rows and the columns a lane of the plan
template <int G, int NG>
MasKernel mas_kernel(int C, int W) {
  if (W > 1) return mas_width1_kernel<G, NG, kMaxPerThread, true>;
  switch (C) {
    case 1: return mas_width1_kernel<G, NG, 1, false>;
    case 2: return mas_width1_kernel<G, NG, 2, false>;
    case 3: return mas_width1_kernel<G, NG, 3, false>;
    default: return mas_width1_kernel<G, NG, kMaxPerThread, false>;
  }
}

}  // namespace

extern "C" {

// The shared memory a (T_mel, T_text) launch is allowed, in bytes: 4 (2
// T_text + T_mel ceil(T_text / 32)), the choice bits and two rows. A
// launch takes a la ring of 48 or 16 rows beside the bits where it fits,
// else none, and then the edge rings of T_text > 128 (260 bytes a DP
// warp) fit in the two rows' space.
size_t mas_width1_smem(int Tm, int Tt) {
  return ((size_t)2 * Tt + (size_t)Tm * ((Tt + 31) / 32)) * sizeof(float);
}

// The launch's plan for T_text columns: DP warps, columns a lane, and the
// warps that zero the output beside them.
void mas_width1_plan(int Tt, int* warps, int* cols_per_lane,
                     int* fill_warps) {
  *cols_per_lane = per_lane(Tt);
  *warps = dp_warps(Tt, *cols_per_lane);
  *fill_warps = 32 - *warps < kFillWarps ? 32 - *warps : kFillWarps;
}

// log_attn (B, T_mel, T_text) f32; text_lens, mel_lens (B,) int32;
// out (B, T_mel, T_text) f32. Returns cudaGetLastError() after the launch
// (0 on success).
int mas_width1_launch(const float* log_attn, const int* text_lens,
                      const int* mel_lens, float* out, int B, int Tm, int Tt,
                      void* stream) {
  if (Tt < 1 || Tt > 32 * 32 * kMaxPerThread) return (int)cudaErrorInvalidValue;
  int W, C, F;
  mas_width1_plan(Tt, &W, &C, &F);
  int dev = 0, optin = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
      != cudaSuccess) return (int)e;
  // a ring of 48 rows in 6 copy groups of 8 where it fits, else of 16 in
  // 2, else none
  int R = 48;
  while (R > 0 && smem_bytes(Tm, Tt, R) > (size_t)optin) R = R > 16 ? 16 : 0;
  const size_t smem = smem_bytes(Tm, Tt, R);
  const MasKernel kernel = R == 48   ? mas_kernel<8, 6>(C, W)
                           : R == 16 ? mas_kernel<8, 2>(C, W)
                                     : mas_kernel<1, 0>(C, W);
  if ((e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  kernel<<<B, 32 * (W + F), smem, (cudaStream_t)stream>>>(
      log_attn, text_lens, mel_lens, out, Tm, Tt);
  return (int)cudaGetLastError();
}

const char* radmmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
