// The WN stack's f32 convolutions for Hopper (sm_90a): one implicit GEMM on
// the CUDA cores (FFMA, f32 sums), channels-last, forward, dgrad and wgrad.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA
// (radmmm_tpu/ops/conv.py conv1d_same). It was added because cuDNN's f32
// convolutions of ops/coupling.py WN took about two thirds of a training
// step on the card at about half of the FFMA peak, and transposed the
// port's (B, T, C) tensors to NCHW and back around every call.
//
// Contract (the plain twins are ops/wn_conv.py conv_reference and
// wgrad_reference). x is (N, Cin) row-major with N = B T (rows b T + t),
// w is (K, Cin, Cout), the tap offsets are off_k = (k - (K - 1) / 2) d:
//
//   raw[n, o] = sum_k sum_c w[k, c, o] x[n + off_k, c]
//
// with x zero where t + off_k lies outside [0, T) and, when `premask`, where
// mask[n + off_k] is 0 (the partial-padding premask x * mask, with no pass
// over x). The epilogue is MaskedConv1d.forward's arithmetic in its order:
//   pp:   upd = sum_k m[n + off_k] (0 outside the item; m = mask or 1),
//         ratio = K / (upd + 1e-6), clip = min(max(upd, 0), 1),
//         out = raw (ratio clip) + bias clip
//   else: out = raw + bias
//   then out = out mask[n] where a mask is given.
// dgrad is the same kernel on draw = dout (ratio clip mask) with the taps
// reversed and w[k] transposed (the wrapper's (K, Cout, Cin) copy), and the
// premask as its output mask. wgrad:
//
//   dw[k, o, c] = sum_n draw[n - off_k, o] x[n, c]
//
// over the rows n whose n - off_k lies in the same item, x zero where
// mask[n] is 0 when `premask`.
//
// What bounds it: operations. For in_i at B 8 x T 256 (N 2,048, 1,024 ->
// 1,024 channels, K 5) one direction is 21.5 GFLOP on about 36 MB, 0.32 ms
// at the FFMA peak of 67 TFLOP/s against 0.011 ms at 3.35 TB/s.
//
// Design (SIMT, since the cells' precision is f32 and TF32 is closed):
// - Tiles of 128 x 128 outputs, 256 threads (one block an SM: 167
//   registers a thread), each thread an 8 x 8 accumulator whose shared-
//   memory reads are float4s: a quarter-warp reads one broadcast address or
//   eight consecutive float4s, so no bank conflicts.
// - The reduction runs in stages of 32: a tap and 32 input channels
//   (forward, dgrad) or 32 rows (wgrad). A ring of 3 shared-memory stages
//   is filled by cp.async, 16 bytes a copy (the wrapper pads a channel
//   count to a multiple of 4), two stages in flight while one is computed.
//   A row outside its item, past N, or masked is copied with a source size
//   of 0, which fills zeros: tiles straddle items freely.
// - The activation tile of the forward and dgrad is row-major in its
//   channels, as x lies in memory, at a row stride of 36 floats; a thread
//   reads it as float4s along the reduction (the next four depths' while
//   it uses these) and the weights as float4s along Cout.
// - Grids smaller than the card split the reduction (`splits` > 1, the
//   wrapper's plan): each split writes its partial tile, and a second
//   kernel sums the splits in a fixed order (then the epilogue). No
//   atomics: two runs give the same bits.
// - Measured (PERF.md section 6, K7): 64% (forward, dgrad) and 69%
//   (wgrad) of the FFMA peak at the flagship's in_i. Tried and slower: 8 x
//   16 accumulators in 128-thread blocks, two an SM (59-61%); 16-deep
//   stages (55-60%); 64-deep stages; 4 stages; lanes 8 x 4; the forward's
//   activations copied 4 bytes at a time into a transposed tile, so that
//   it reads them as the wgrad does (61%).
// - Launched on the caller's stream, no allocation, no host wait, so the
//   training and serving CUDA graphs capture it.
#include <cuda_runtime.h>

#include <atomic>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // output rows (forward) or Cout (wgrad)
constexpr int kBN = 128;          // output channels
constexpr int kTM = 8;            // rows a thread
constexpr int kTN = 8;            // columns a thread
constexpr int kThreads = kBM * kBN / (kTM * kTN);
// a warp's lanes: kLaneRows along the rows, the rest along the columns
constexpr int kLaneRows = 4;
constexpr int kLaneCols = 32 / kLaneRows;
constexpr int kWarpRows = kLaneRows * kTM;       // a warp's tile
constexpr int kWarpCols = kLaneCols * kTN;
constexpr int kColStep = kLaneCols * 4;          // a thread's column halves
constexpr int kBK = 32;           // reduction depth of a stage (the
                                  // wrapper's STAGE)
constexpr int kStages = 3;
constexpr int kALd = kBK + 4;     // row stride of a row-major A tile
// a stage's copies, 16 bytes each: a row-major A tile in passes of kARows
// rows of kBK / 4 chunks; a (kBK x 128) tile in passes of kBRows rows of
// 32 chunks
constexpr int kARows = kThreads / (kBK / 4);
constexpr int kAPasses = kBM / kARows;
constexpr int kBRows = kThreads / 32;
constexpr int kBPasses = kBK / kBRows;
// wgrad: the rows of a split, described once in shared memory
constexpr int kMaxSplitRows = 2048;

constexpr int kConvSmem = kStages * (kBM * kALd + kBK * kBN) * 4;
constexpr int kWgradSmem =
    kStages * (kBK * kBM + kBK * kBN) * 4 + kMaxSplitRows * 4;

struct ConvArgs {
  const float* x;       // (N, Cin)
  const float* w;       // (K, Cin, Cout)
  const float* bias;    // (Cout,) or null
  const float* mask;    // (N,) or null
  float* out;           // (N, Cout), or (splits, N, Cout) partials
  float* rs;            // (N, 2) row scales for the backward, or null
  int N, T, Cin, Cout, K, dil;
  int premask, pp;
  int cblocks;          // ceil(Cin / kBK)
  int iters;            // K * cblocks
  int per_split;        // stages of one split
};

struct WgradArgs {
  const float* dy;      // draw (N, Cout)
  const float* x;       // (N, Cin)
  const float* mask;    // (N,) or null: x rows that load as zeros
  float* out;           // (K, Cout, Cin), or (splits, K, Cout, Cin) partials
  int N, T, Cin, Cout, K, dil;
  int split_rows;       // rows of one split, a multiple of kBK
  int splits;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from base + off, or zeros (base is then not read) when !ok
__device__ __forceinline__ void copy16(unsigned dst, const float* base,
                                       long long off, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(ok ? base + off : base), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// kTM x kTN outputs a thread. Warps tile the block in kWarpRows x
// kWarpCols; a warp's lanes are kLaneRows (rows) x kLaneCols (columns).
// Columns: c0 + {0..3} + kColStep {0, 1}. Rows where A is read along the
// reduction (forward, dgrad): wr + lr + kLaneRows i, so an instruction's
// rows are consecutive and their float4s fall in distinct banks (rows 4
// apart would share banks at any row stride that is a multiple of 4
// floats). Rows where A is read along its rows (wgrad): r0 + {0..3} +
// 4 kLaneRows {0, 1}, as float4s.
struct Frag {
  int wr, lr, c0;
  __device__ __forceinline__ Frag(int tid) {
    const int warp = tid >> 5, lane = tid & 31;
    constexpr int warps_down = kBM / kWarpRows;
    wr = (warp % warps_down) * kWarpRows;
    lr = lane / kLaneCols;
    c0 = (warp / warps_down) * kWarpCols + (lane % kLaneCols) * 4;
  }
  __device__ __forceinline__ int row(int i) const {
    return wr + lr + kLaneRows * i;
  }
  __device__ __forceinline__ int r0() const { return wr + 4 * lr; }
  __device__ __forceinline__ int wrow(int i) const {
    return r0() + (i & 3) + 4 * kLaneRows * (i >> 2);
  }
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void load_b(float (&b)[kTN], const float* p) {
#pragma unroll
  for (int j = 0; j < kTN / 4; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(p + kColStep * j);
    b[4 * j] = v.x;
    b[4 * j + 1] = v.y;
    b[4 * j + 2] = v.z;
    b[4 * j + 3] = v.w;
  }
}

// one stage: A row-major (kBM rows x kALd), B (kBK x kBN)
__device__ __forceinline__ void mma_rowmajor_a(float (&acc)[kTM][kTN],
                                               const float* As,
                                               const float* Bs,
                                               const Frag& f) {
  // the next four depths' A fragments load while these are used
  float4 a[kTM], an[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
    a[i] = *reinterpret_cast<const float4*>(As + f.row(i) * kALd);
#pragma unroll
  for (int k4 = 0; k4 < kBK; k4 += 4) {
    if (k4 + 4 < kBK) {
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        an[i] =
            *reinterpret_cast<const float4*>(As + f.row(i) * kALd + k4 + 4);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[kTN];
      load_b(b, Bs + (k4 + kk) * kBN + f.c0);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float av = comp(a[i], kk);
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) a[i] = an[i];
  }
}

// one stage: A (kBK x kBM), B (kBK x kBN), both along the reduction
__device__ __forceinline__ void mma_colmajor_a(float (&acc)[kTM][kTN],
                                               const float* As,
                                               const float* Bs,
                                               const Frag& f) {
  const float* ap = As + f.r0();
  const float* bp = Bs + f.c0;
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(ap + k * kBM);
    const float4 a1 =
        *reinterpret_cast<const float4*>(ap + k * kBM + 4 * kLaneRows);
    const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float b[kTN];
    load_b(b, bp + k * kBN);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The epilogue's factors of row n: out = raw * scale + bias * bscale, then
// times m. Written in MaskedConv1d.forward's order, without contraction.
struct RowEpi {
  float scale, bscale, m;
};

__device__ __forceinline__ RowEpi row_epilogue(const ConvArgs& a, int n) {
  RowEpi r;
  r.m = a.mask ? a.mask[n] : 1.f;
  r.scale = 1.f;
  r.bscale = 1.f;
  if (a.pp) {
    const int t = n % a.T, half = (a.K - 1) / 2;
    float upd = 0.f;
    for (int k = 0; k < a.K; ++k) {
      const int tt = t + (k - half) * a.dil;
      if (tt >= 0 && tt < a.T)
        upd = __fadd_rn(upd, a.mask ? a.mask[n + (k - half) * a.dil] : 1.f);
    }
    const float ratio = __fdiv_rn((float)a.K, __fadd_rn(upd, 1e-6f));
    const float clip = fminf(fmaxf(upd, 0.f), 1.f);
    r.scale = __fmul_rn(ratio, clip);
    r.bscale = clip;
  }
  return r;
}

__device__ __forceinline__ float apply_epilogue(const ConvArgs& a,
                                                const RowEpi& r, float raw,
                                                int o) {
  float v = raw;
  if (a.pp) {
    v = __fmul_rn(v, r.scale);
    if (a.bias) v = __fadd_rn(v, __fmul_rn(a.bias[o], r.bscale));
  } else if (a.bias) {
    v = __fadd_rn(v, a.bias[o]);
  }
  return a.mask ? __fmul_rn(v, r.m) : v;
}

// the backward's row factors: draw = dout * rs[n, 0], dbias = sum dout *
// rs[n, 1]
__device__ __forceinline__ void store_row_scales(const ConvArgs& a,
                                                 const RowEpi& r, int n) {
  a.rs[2 * n] = a.pp ? __fmul_rn(r.scale, r.m) : r.m;
  a.rs[2 * n + 1] = a.pp ? __fmul_rn(r.bscale, r.m) : r.m;
}

// Forward and dgrad. Grid (Cout tiles, N tiles, splits).
__global__ void __launch_bounds__(kThreads, 1)
    wn_conv_kernel(const ConvArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                   // kStages x kBM x kALd
  float* Bs = smem + kStages * kBM * kALd;            // kStages x kBK x kBN
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int it0 = blockIdx.z * a.per_split;
  const int it1 = min(a.iters, it0 + a.per_split);
  const int half = (a.K - 1) / 2;

  // this thread's copies: A rows ar + kARows j at column aq of a stage; B
  // rows br + kBRows j at column bq
  const int ar = tid / (kBK / 4), aq = (tid % (kBK / 4)) * 4;
  const int br = tid >> 5, bq = (tid & 31) * 4;
  // bit k: the A row reads a real x row at tap k
  unsigned ok_tap[kAPasses];
#pragma unroll
  for (int j = 0; j < kAPasses; ++j) {
    ok_tap[j] = 0u;
    const int n = m0 + ar + kARows * j;
    if (n >= a.N) continue;
    const int t = n % a.T;
    for (int k = 0; k < a.K; ++k) {
      const int off = (k - half) * a.dil;
      const bool ok = t + off >= 0 && t + off < a.T &&
                      !(a.premask && a.mask && a.mask[n + off] == 0.f);
      ok_tap[j] |= (ok ? 1u : 0u) << k;
    }
  }
  const unsigned as0 = smem_u32(As) + (ar * kALd + aq) * 4;
  const unsigned bs0 = smem_u32(Bs) + (br * kBN + bq) * 4;
  // offsets of this thread's first A and B rows, and the stage to load
  // next (tap ld_k, channels from ld_c0); stages load in order
  const long long xa = (long long)(m0 + ar) * a.Cin + aq;
  const long long wb = (long long)br * a.Cout + n0 + bq;
  const bool col_ok = n0 + bq < a.Cout;
  int ld_k = it0 / a.cblocks, ld_c0 = (it0 - ld_k * a.cblocks) * kBK;

  auto load_next = [&](int slot) {
    const long long xoff = xa + (long long)(ld_k - half) * a.dil * a.Cin
                           + ld_c0;
    const long long woff = wb + ((long long)ld_k * a.Cin + ld_c0) * a.Cout;
    const unsigned as = as0 + slot * (kBM * kALd * 4);
    const unsigned bs = bs0 + slot * (kBK * kBN * 4);
    const bool ch_ok = ld_c0 + aq < a.Cin;
#pragma unroll
    for (int j = 0; j < kAPasses; ++j)
      copy16(as + j * (kARows * kALd * 4), a.x,
             xoff + (long long)j * kARows * a.Cin,
             ch_ok && ((ok_tap[j] >> ld_k) & 1u));
#pragma unroll
    for (int j = 0; j < kBPasses; ++j)
      copy16(bs + j * (kBRows * kBN * 4), a.w,
             woff + (long long)j * kBRows * a.Cout,
             col_ok && ld_c0 + br + kBRows * j < a.Cin);
    ld_c0 += kBK;
    if (ld_c0 >= a.Cin) {
      ld_c0 = 0;
      ++ld_k;
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (it0 + s < it1) load_next(s);
    commit_copies();
  }
  const Frag f(tid);
  for (int it = it0; it < it1; ++it) {
    wait_copies<kStages - 2>();
    __syncthreads();
    const int next = it + kStages - 1;
    if (next < it1) load_next((next - it0) % kStages);
    commit_copies();
    const int slot = (it - it0) % kStages;
    mma_rowmajor_a(acc, As + slot * kBM * kALd, Bs + slot * kBK * kBN, f);
  }
  wait_copies<0>();

  const bool split = gridDim.z > 1;
  float* out = split ? a.out + (long long)blockIdx.z * a.N * a.Cout : a.out;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int n = m0 + f.row(i);
    if (n >= a.N) continue;
    RowEpi r = {1.f, 1.f, 1.f};
    if (!split) {
      r = row_epilogue(a, n);
      if (a.rs && blockIdx.x == 0 && f.c0 == 0) store_row_scales(a, r, n);
    }
    float* orow = out + (long long)n * a.Cout;
#pragma unroll
    for (int h = 0; h < kTN / 4; ++h) {
      const int o = n0 + f.c0 + kColStep * h;
      if (o >= a.Cout) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = split ? acc[i][4 * h + e]
                     : apply_epilogue(a, r, acc[i][4 * h + e], o + e);
      *reinterpret_cast<float4*>(orow + o) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The splits' sum in split order, then the epilogue; four outputs a
// thread.
__global__ void wn_conv_reduce_kernel(const ConvArgs a, const float* part,
                                      int splits) {
  const long long total = (long long)a.N * a.Cout;
  const long long i =
      4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= total) return;
  const int n = (int)(i / a.Cout), o = (int)(i - (long long)n * a.Cout);
  float4 v = *reinterpret_cast<const float4*>(part + i);
  for (int s = 1; s < splits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(part + s * total + i);
    v.x = __fadd_rn(v.x, p.x);
    v.y = __fadd_rn(v.y, p.y);
    v.z = __fadd_rn(v.z, p.z);
    v.w = __fadd_rn(v.w, p.w);
  }
  const RowEpi r = row_epilogue(a, n);
  if (a.rs && o == 0) store_row_scales(a, r, n);
  *reinterpret_cast<float4*>(a.out + i) = make_float4(
      apply_epilogue(a, r, v.x, o), apply_epilogue(a, r, v.y, o + 1),
      apply_epilogue(a, r, v.z, o + 2), apply_epilogue(a, r, v.w, o + 3));
}

// wgrad. Grid (Cin tiles, Cout tiles, K x splits); z = tap * splits + split.
__global__ void __launch_bounds__(kThreads, 1)
    wn_wgrad_kernel(const WgradArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                   // kStages x kBK x kBM
  float* Bs = smem + kStages * kBK * kBM;             // kStages x kBK x kBN
  // per row of the split: its t, or -1 past N; bit 30 set where x loads
  int* rows = reinterpret_cast<int*>(Bs + kStages * kBK * kBN);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;                    // Cin
  const int m0 = blockIdx.y * kBM;                    // Cout
  const int k = blockIdx.z / a.splits, sp = blockIdx.z - k * a.splits;
  const int off = (k - (a.K - 1) / 2) * a.dil;
  const int r0 = sp * a.split_rows;
  const int nrows = min(a.split_rows, a.N - r0);
  for (int i = tid; i < a.split_rows; i += kThreads) {
    const int n = r0 + i;
    int d = -1;
    if (i < nrows) {
      d = n % a.T;
      if (!(a.mask && a.mask[n] == 0.f)) d |= 1 << 30;
    }
    rows[i] = d;
  }
  __syncthreads();

  // this thread's copies: rows r + kBRows j of a stage, column q, of both
  const int r = tid >> 5, q = (tid & 31) * 4;
  const unsigned as0 = smem_u32(As) + (r * kBM + q) * 4;
  const unsigned bs0 = smem_u32(Bs) + (r * kBN + q) * 4;
  const bool dy_col = m0 + q < a.Cout, x_col = n0 + q < a.Cin;
  // draw[n - off] pairs with x[n] inside one item
  const long long dy0 = (long long)(r0 + r - off) * a.Cout + m0 + q;
  const long long x0 = (long long)(r0 + r) * a.Cin + n0 + q;
  const int iters = (nrows + kBK - 1) / kBK;

  auto load_stage = [&](int slot, int it) {
    const unsigned as = as0 + slot * (kBK * kBM * 4);
    const unsigned bs = bs0 + slot * (kBK * kBN * 4);
#pragma unroll
    for (int j = 0; j < kBPasses; ++j) {
      const int i = it * kBK + r + kBRows * j;
      const int d = rows[i];
      const int t = (d & 0x3fffffff) - off;
      copy16(as + j * (kBRows * kBM * 4), a.dy,
             dy0 + (long long)(i - r) * a.Cout,
             dy_col && d >= 0 && t >= 0 && t < a.T);
      copy16(bs + j * (kBRows * kBN * 4), a.x,
             x0 + (long long)(i - r) * a.Cin,
             x_col && d >= 0 && (d & (1 << 30)));
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < iters) load_stage(s, s);
    commit_copies();
  }
  const Frag f(tid);
  for (int it = 0; it < iters; ++it) {
    wait_copies<kStages - 2>();
    __syncthreads();
    const int next = it + kStages - 1;
    if (next < iters) load_stage(next % kStages, next);
    commit_copies();
    const int slot = it % kStages;
    mma_colmajor_a(acc, As + slot * kBK * kBM, Bs + slot * kBK * kBN, f);
  }
  wait_copies<0>();

  const long long plane = (long long)a.Cout * a.Cin;
  float* out = a.out + ((long long)sp * a.K + k) * plane;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int o = m0 + f.wrow(i);
    if (o >= a.Cout) continue;
    float* orow = out + (long long)o * a.Cin;
#pragma unroll
    for (int h = 0; h < kTN / 4; ++h) {
      const int c = n0 + f.c0 + kColStep * h;
      if (c < a.Cin)
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

// the splits' sum in split order, four values a thread
__global__ void wn_sum_splits_kernel(const float* part, float* out,
                                     long long total, int splits) {
  const long long i =
      4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= total) return;
  float4 v = *reinterpret_cast<const float4*>(part + i);
  for (int s = 1; s < splits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(part + s * total + i);
    v.x = __fadd_rn(v.x, p.x);
    v.y = __fadd_rn(v.y, p.y);
    v.z = __fadd_rn(v.z, p.z);
    v.w = __fadd_rn(v.w, p.w);
  }
  *reinterpret_cast<float4*>(out + i) = v;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

constexpr int kMaxDevices = 64;
// the kernels' dynamic shared memory limits, raised once on each device (a
// concurrent first call sets the same values)
std::atomic<bool> g_smem_set[kMaxDevices];

cudaError_t raise_smem_limits() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && g_smem_set[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  e = cudaFuncSetAttribute(wn_conv_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kConvSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wn_wgrad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWgradSmem);
  if (e == cudaSuccess && dev < kMaxDevices)
    g_smem_set[dev].store(true, std::memory_order_release);
  return e;
}

unsigned blocks_for(long long total) {
  return (unsigned)((total / 4 + 255) / 256);
}

}  // namespace

extern "C" {

// Forward or dgrad: x (N, Cin), w (K, Cin, Cout), bias (Cout,) or null,
// mask (N,) or null, out (N, Cout), rs (N, 2) or null, part (splits, N,
// Cout) scratch when splits > 1 (else null). Cin and Cout multiples of 4;
// x, w, out and part 16-byte aligned. Returns cudaGetLastError() after the
// launches (0 on success).
int wn_conv_launch(const float* x, const float* w, const float* bias,
                   const float* mask, float* out, float* rs, float* part,
                   int B, int T, int Cin, int Cout, int K, int dilation,
                   int premask, int pp, int splits, void* stream) {
  const long long N = (long long)B * T;
  if (B <= 0 || T <= 0 || Cin <= 0 || Cout <= 0 || K <= 0 || K > 31 ||
      K % 2 == 0 || dilation <= 0 || splits <= 0 || splits > 65535 ||
      N > 0x3fffffff || Cin % 4 || Cout % 4 || !aligned16(x) ||
      !aligned16(w) || !aligned16(out) ||
      (splits > 1 && (part == nullptr || !aligned16(part))))
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.x = x; a.w = w; a.bias = bias; a.mask = mask;
  a.out = splits > 1 ? part : out;
  a.rs = rs;
  a.N = (int)N; a.T = T; a.Cin = Cin; a.Cout = Cout; a.K = K;
  a.dil = dilation; a.premask = premask; a.pp = pp;
  a.cblocks = (Cin + kBK - 1) / kBK;
  a.iters = K * a.cblocks;
  a.per_split = (a.iters + splits - 1) / splits;
  const dim3 grid((Cout + kBN - 1) / kBN, (a.N + kBM - 1) / kBM, splits);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if ((e = raise_smem_limits()) != cudaSuccess) return (int)e;
  wn_conv_kernel<<<grid, kThreads, kConvSmem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess || splits == 1) return (int)e;
  a.out = out;
  wn_conv_reduce_kernel<<<blocks_for(N * Cout), 256, 0, s>>>(a, part,
                                                             splits);
  return (int)cudaGetLastError();
}

// wgrad: dy (N, Cout), x (N, Cin), mask (N,) or null -> out (K, Cout,
// Cin); part (splits, K, Cout, Cin) scratch when splits > 1. split_rows a
// multiple of the stage depth, at most 2,048, with splits * split_rows >= N
// > (splits - 1) * split_rows. The same widths and alignment as above.
int wn_wgrad_launch(const float* dy, const float* x, const float* mask,
                    float* out, float* part, int B, int T, int Cin, int Cout,
                    int K, int dilation, int splits, int split_rows,
                    void* stream) {
  const long long N = (long long)B * T;
  if (B <= 0 || T <= 0 || Cin <= 0 || Cout <= 0 || K <= 0 || K > 31 ||
      K % 2 == 0 || dilation <= 0 || splits <= 0 || N > 0x3fffffff ||
      split_rows <= 0 || split_rows % kBK || split_rows > kMaxSplitRows ||
      (long long)splits * split_rows < N ||
      (long long)(splits - 1) * split_rows >= N ||
      (long long)K * splits > 65535 || Cin % 4 || Cout % 4 ||
      !aligned16(dy) || !aligned16(x) || !aligned16(out) ||
      (splits > 1 && (part == nullptr || !aligned16(part))))
    return (int)cudaErrorInvalidValue;
  WgradArgs a;
  a.dy = dy; a.x = x; a.mask = mask;
  a.out = splits > 1 ? part : out;
  a.N = (int)N; a.T = T; a.Cin = Cin; a.Cout = Cout; a.K = K;
  a.dil = dilation; a.split_rows = split_rows; a.splits = splits;
  const dim3 grid((Cin + kBN - 1) / kBN, (Cout + kBM - 1) / kBM, K * splits);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if ((e = raise_smem_limits()) != cudaSuccess) return (int)e;
  wn_wgrad_kernel<<<grid, kThreads, kWgradSmem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess || splits == 1) return (int)e;
  const long long total = (long long)K * Cout * Cin;
  wn_sum_splits_kernel<<<blocks_for(total), 256, 0, s>>>(part, out, total,
                                                         splits);
  return (int)cudaGetLastError();
}

const char* radmmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
