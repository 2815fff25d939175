// Fused dilated conv1d + bias + softplus for Hopper (sm_90a), bf16 inputs,
// f32 accumulation and output.
//
// Replaces the TPU kernel scripts/bench_wn_kernel.py::pallas_conv_softplus
// (its body `kernel`), the WN `in_i` layer of the fused-WN experiment:
//
//   out[b, t, o] = softplus(bias[o] + sum_i sum_c x[b, t + (i - K/2) d, c]
//                                                  * w[i, c, o])
//
// with x (B, T, Cin) bf16 zero outside [0, T), w (K, Cin, Cout) bf16 in
// the script's WIO layout, bias (Cout,) f32, out (B, T, Cout) f32 and
// softplus in the stable form of jax.nn.softplus: max(v, 0) +
// log1p(exp(-|v|)).
//
// What bounds it: operations. At the script's shape (B 32, T 256, C 1024,
// K 5) it does 2 K Cin Cout B T = 85.9 GFLOP on 60.8 MB (x and w read
// once, out written once): 0.087 ms at the bf16 dense tensor-core peak
// (989 TFLOP/s) against 0.018 ms at 3.35 TB/s.
//
// Design: an implicit GEMM, M = B T rows (b, t), N = Cout, reduced over K
// taps x Cin, as a warp-specialised persistent kernel:
// - Tiles of 128 rows x 256 channels; the rows of a tile lie in one batch
//   item. One block per SM walks the tiles (tile += gridDim.x).
// - A producer warp keeps a ring of 4 stages in flight. A stage is the
//   tap's x tile (128 rows x 64 channels, 16 KB) and the tap's w tile (64
//   input x 256 output channels, 32 KB), copied by TMA
//   (cp.async.bulk.tensor) into 128-byte-swizzled shared memory,
//   completing on the stage's `full` mbarrier. x is a 3-D tensor map over
//   (Cin, T, B): tap i of a tile starting at t0 is the box at t = t0 +
//   (i - K/2) d, and TMA zero-fills every row outside [0, T) (a negative t,
//   the ragged last tile, T below the halo) and every channel past Cin. No
//   padded copy of x exists. w is read in its own layout, a tensor map over
//   (Cout, Cin, K) in four boxes of 64 output channels: wgmma takes it as
//   an MN-major operand (its transpose bit), so the wrapper writes no
//   transposed copy.
// - Two consumer warpgroups each issue wgmma.mma_async m64n256k16 (bf16 in,
//   f32 accumulators in registers, 128 a thread) on their 64 rows of the
//   stage, keep one wgmma group in flight, and release a stage on its
//   `empty` mbarrier once the group that read it has completed.
//   setmaxnreg gives the consumers 232 registers and the producer 40.
// - Epilogue in registers (wgmma's accumulator layout is fixed: thread l of
//   warp w holds rows 16w + l/4 (+8), columns 8j + 2(l%4) (+1)): bias,
//   softplus and float2 stores with the ragged T and Cout edges masked.
//   While it runs the producer already fills the ring for the next tile.
// Each staged byte feeds 87 FLOP (a 128 x 128 tile would feed 64); x (16.8
// MB at the script's shape) stays in L2 across the five taps.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                      // output rows per tile
constexpr int kBN = 256;                      // output channels per tile
constexpr int kBK = 64;                       // input channels per stage
constexpr int kStages = 4;
constexpr int kConsumers = 2;                 // warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kABytes = kBM * kBK * 2;        // 16 KB
constexpr int kBBytes = kBN * kBK * 2;        // 32 KB
constexpr int kBoxBytes = 64 * kBK * 2;       // one 64-channel box of w
constexpr int kStageBytes = kABytes + kBBytes;
// the ring, its 2 x kStages mbarriers, and slack to align the base to the
// 1024 bytes of the 128-byte swizzle pattern
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a tile stored in 128-byte rows (64
// bf16) with the 128-byte swizzle: `lead` and `stride` are the byte
// offsets between the swizzle atoms (8 rows x 128 bytes) along the two
// dimensions, as wgmma reads them for the tile's major order
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lead,
                                              uint32_t stride) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;   // start address
  d |= (uint64_t)(lead >> 4) << 16;
  d |= (uint64_t)(stride >> 4) << 32;
  d |= (uint64_t)1 << 62;                      // 128-byte swizzle
  return d;
}

#define D8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 256 per warpgroup, f32) = A (64 x 16, K-major) B (16 x 256,
// MN-major: the transpose bit set) + scale_d d
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db,
                                                 uint32_t scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117,"
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56),
        D8(64), D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef D8

__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

struct Shape {
  int B, T, Cin, Cout, K, dilation;
  int m_per_b;      // 128-row tiles per batch item
  int n_tiles_n;    // 256-channel tiles
  int n_tiles;
};

__global__ void __launch_bounds__(kThreads, 1)
conv_softplus_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const float* __restrict__ bias, float* __restrict__ out,
                     const Shape s) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);                    // the producer's expect_tx
      mbar_init(&empty[i], 4 * kConsumers);      // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_chunks = (s.Cin + kBK - 1) / kBK;
  const int n_k = s.K * n_chunks;               // stages per tile
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < s.n_tiles; tile += gridDim.x) {
        const int mt = tile / s.n_tiles_n;
        const int n0 = (tile % s.n_tiles_n) * kBN;
        const int b = mt / s.m_per_b;
        const int t0 = (mt % s.m_per_b) * kBM;
        for (int tap = 0; tap < s.K; ++tap) {
          const int ts = t0 + (tap - s.K / 2) * s.dilation;
          for (int c = 0; c < s.Cin; c += kBK, ++it) {
            const int st = it % kStages;
            mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
            uint8_t* a = smem + st * kStageBytes;
            mbar_expect_tx(&full[st], kStageBytes);
            tma_load_3d(a, &tm_x, &full[st], c, ts, b);
            for (int q = 0; q < kBN / 64; ++q)
              tma_load_3d(a + kABytes + q * kBoxBytes, &tm_w, &full[st],
                          n0 + 64 * q, c, tap);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;                      // this warpgroup's 64 rows
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    int it = 0;
    for (int tile = blockIdx.x; tile < s.n_tiles; tile += gridDim.x) {
      const int mt = tile / s.n_tiles_n;
      const int n0 = (tile % s.n_tiles_n) * kBN;
      const int b = mt / s.m_per_b;
      const int t0 = (mt % s.m_per_b) * kBM;
      int prev = -1;
      for (int k = 0; k < n_k; ++k, ++it) {
        const int st = it % kStages;
        mbar_wait(&full[st], (it / kStages) & 1);
        const uint8_t* a = smem + st * kStageBytes + cw * 64 * 128;
        const uint8_t* bt = smem + st * kStageBytes + kABytes;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_m64n256k16(d, smem_desc(a + kk * 32, 16, 1024),
                           smem_desc(bt + kk * 2048, kBoxBytes, 1024),
                           (k > 0 || kk > 0) ? 1u : 0u);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the group before this one has read its stage: release it
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = st;
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

      // epilogue: rows t0 + 64 cw + 16 warp + lane/4 (+8), columns
      // n0 + 8 j + 2 (lane % 4) (+1) for register 4 j (+1; +2, +3 the row
      // 8 below)
      const int t_lo = t0 + cw * 64 + warp * 16 + lane / 4;
      const int t_hi = t_lo + 8;
      float* row_lo = out + ((size_t)b * s.T + t_lo) * s.Cout;
      float* row_hi = row_lo + (size_t)8 * s.Cout;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane % 4);
        if (n < s.Cout) {               // n even and Cout % 8 == 0: n + 1 too
          const float b0 = bias[n], b1 = bias[n + 1];
          if (t_lo < s.T)
            *reinterpret_cast<float2*>(row_lo + n) = make_float2(
                softplus(d[4 * j] + b0), softplus(d[4 * j + 1] + b1));
          if (t_hi < s.T)
            *reinterpret_cast<float2*>(row_hi + n) = make_float2(
                softplus(d[4 * j + 2] + b0), softplus(d[4 * j + 3] + b1));
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: fetched through the
// runtime, so the library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 3-D bf16 tensor map over (inner, mid, outer), innermost first, with a
// (64, box_mid, 1) box (64 bf16: one 128-byte swizzle row) and the
// 128-byte swizzle; out-of-bounds reads are 0
bool make_map(CUtensorMap* m, const void* base, uint64_t inner, uint64_t mid,
              uint64_t outer, uint32_t box_mid) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[3] = {inner, mid, outer};
  const cuuint64_t strides[2] = {inner * 2, inner * mid * 2};   // bytes
  const cuuint32_t box[3] = {64, box_mid, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// x (B, T, Cin) bf16, w (K, Cin, Cout) bf16, bias (Cout,) f32 -> out
// (B, T, Cout) f32. Cin and Cout multiples of 8, x and w 16-byte aligned,
// out 8-byte aligned (checked by the wrapper; refused here too). Returns
// cudaGetLastError() after the launch (0 on success).
int conv_softplus_launch(const void* x, const void* w, const float* bias,
                         float* out, int B, int T, int Cin, int Cout, int K,
                         int dilation, void* stream) {
  if (B <= 0 || T <= 0 || Cin <= 0 || Cout <= 0 || K <= 0 || Cin % 8 ||
      Cout % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w;
  if (!make_map(&tm_x, x, Cin, T, B, kBM) ||
      !make_map(&tm_w, w, Cout, Cin, K, kBK))
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.B = B; s.T = T; s.Cin = Cin; s.Cout = Cout; s.K = K;
  s.dilation = dilation;
  s.m_per_b = (T + kBM - 1) / kBM;
  s.n_tiles_n = (Cout + kBN - 1) / kBN;
  const long long n_tiles = (long long)B * s.m_per_b * s.n_tiles_n;
  if (n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  s.n_tiles = (int)n_tiles;
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess)
    return (int)e;
  if ((e = cudaFuncSetAttribute(conv_softplus_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemBytes)) != cudaSuccess)
    return (int)e;
  const int grid = s.n_tiles < sms ? s.n_tiles : sms;
  conv_softplus_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      tm_x, tm_w, bias, out, s);
  return (int)cudaGetLastError();
}

const char* radmmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
