// pYIN's HMM Viterbi for Hopper (sm_90a), f32: the forward max-plus over
// every frame and the backtrack in one launch, a cluster of CTAs per batch
// item.
//
// Replaces no Pallas kernel: the JAX package runs this DP as a lax.scan
// (radmmm_tpu/data/pitch.py:233-263) that XLA compiles. The port's plain
// twin, radmmm_torch/data/pitch.py viterbi_reference, loops over frames in
// torch, about 8 small kernels a frame.
//
// Per item, over the states (v, k), v 0 voiced or 1 unvoiced, k < K a
// pitch bin, with log_P (K, K), log_V (2, 2) and log_obs (F, 2, K):
//
//   score_0(v, k) = s0(v, k)           (the wrapper's, as the twin makes it)
//   for t = 1 .. F - 1:
//     m(v, k')  = max_k  score(v, k) + log_P(k, k')      kp(v, k') its k
//     n(v', k') = max_v  m(v, k') + log_V(v, v')         vp(v', k') its v
//     n(v', k') = n(v', k') + log_obs(t, v', k')
//     score(v', k') = n(v', k') - max over all 2 K of n
//   the last frame's best state is the first argmax of score over v K + k,
//   and state(t) = pred_t(state(t + 1)), pred_t(v', k') = (vp, kp(vp, k')).
//
// Every value is one f32 add or subtract of the same operands as the
// twin's, and every choice a strict comparison in ascending index (torch's
// max and argmax return the first index of a tie), so the paths are bit for
// bit the twin's on any inputs without NaN. The maxima that only
// renormalise (fmaxf, the warps' integer max) may differ from torch's in
// the sign of a zero, which no comparison sees. The library is built
// without fast math; nothing here multiplies, so nothing contracts into an
// FMA.
//
// What bounds it: the chain of F - 1 dependent frames. A frame is 2 K^2
// add-max pairs (65,522 at K 181), a merge, a max over all 2 K and an
// exchange; across the batch that is 268 M pairs at B 8 and F 512, about
// 8 us at 67 TFLOP/s, and log_obs is 5.9 MB, about 2 us at 3.35 TB/s.
// Each frame waits on the one before, so what a frame costs is latency:
// one SM took about 3.2 us a frame (5,000 cycles of max-plus, 1,400 of
// merge, block max and barriers), 8 SMs over distributed shared memory
// take well under half that.
//
// Design (kThreads a CTA, a cluster of C CTAs an item, C 8 at K 181):
// - CTA r owns the output columns [r cw, (r + 1) cw), cw = ceil(K / C),
//   and keeps their log_P columns (K x cw) in shared memory for the whole
//   launch. Every CTA keeps the whole score, one float2 (v 0, v 1) a bin,
//   so a warp reads a bin's two scores as one broadcast.
// - Frame t, phase 1: thread tid takes column tid % cw and the k range
//   tid / cw of ceil(K / (kThreads / cw)) bins (5 ranges of 37 at K 181),
//   and keeps the first max of both v over it. Ranges past the first
//   leave theirs in shared memory as one float4 (m0, k0, m1, k1).
// - Phase 2, the first range's threads: merge the ranges in k order
//   (strict >), the voicing max (strict >: v 0 on a tie), + log_obs(t),
//   whose values they loaded before phase 1; write pred_t as v K + k in 16
//   bits to a scratch of (F - 1, 2 K) in device memory (724 bytes a frame,
//   in L2); push the pair to every CTA of the cluster (st.async into its
//   receive buffer, counted on its transaction mbarrier), and each warp's
//   max (one integer max over the warp) the same way.
// - Each CTA waits on its own mbarrier for the frame's 8 K bytes of pairs
//   and C warp maxima, takes the max over the maxima and writes the next
//   score. No barrier spans the cluster inside the loop: the buffers and
//   mbarriers alternate by frame parity, and a CTA can send frame t + 2's
//   values only after every CTA has sent it frame t + 1's, which each does
//   only after reading frame t's, so a buffer is never overwritten while
//   read.
// - After the last frame, one cluster barrier makes every CTA's pred rows
//   visible to CTA 0, and the others exit. CTA 0 takes the first argmax
//   over 2 K, copies pred back into the shared memory log_P held (at least
//   kStageRows frames at a time) and one thread walks it back there,
//   writing both paths.
#include <cuda_runtime.h>

#include <atomic>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kStageRows = 128;
constexpr size_t kSmemMax = 227 * 1024;   // sm_90's opt-in maximum a CTA
constexpr int kMaxDevices = 64;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// the cluster size, the columns a CTA, the k ranges a column and bins a
// range, the warps that own columns in a CTA
struct Plan {
  int C, cw, ranges, chunk, ow;
};

// the largest cluster up to kMaxCluster whose every CTA owns a column
__host__ __device__ inline Plan plan_for(int K) {
  Plan p;
  p.C = kMaxCluster < K ? kMaxCluster : K;
  while (p.C > 1 && (p.C - 1) * ((K + p.C - 1) / p.C) >= K) --p.C;
  p.cw = (K + p.C - 1) / p.C;
  const int most = kThreads / p.cw;
  p.chunk = (K + most - 1) / most;
  p.ranges = (K + p.chunk - 1) / p.chunk;
  p.ow = (p.cw + 31) / 32;
  return p;
}

// byte offsets in shared memory: log_P's columns (K x cw f32), which the
// backtrack reuses (at least kStageRows rows of 2 K uint16), at 0; then
// the score (K float2), the receive buffers (2 parities of K float2 and of
// C ow f32), the ranges' maxima past the first ((ranges - 1) cw float4)
// and the two mbarriers
struct Layout {
  size_t score, recv, maxes, part, bars, total;
};

__host__ __device__ inline Layout layout_for(int K) {
  const Plan p = plan_for(K);
  size_t head = static_cast<size_t>(K) * p.cw * sizeof(float);
  const size_t stage = static_cast<size_t>(kStageRows) * 2 * K * sizeof(uint16_t);
  if (stage > head) head = stage;
  Layout l;
  l.score = align16(head);
  l.recv = l.score + static_cast<size_t>(K) * sizeof(float2);
  l.maxes = l.recv + 2 * static_cast<size_t>(K) * sizeof(float2);
  l.part = align16(l.maxes + 2 * static_cast<size_t>(p.C) * p.ow * sizeof(float));
  l.bars = l.part + static_cast<size_t>(p.ranges - 1) * p.cw * sizeof(float4);
  l.total = l.bars + 2 * sizeof(uint64_t);
  return l;
}

__device__ inline int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// every thread of the cluster arrives and waits; what each wrote before
// is visible to all after
__device__ inline void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address of the same shared-memory offset in CTA `rank` of the cluster
__device__ inline uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// stores into another CTA's shared memory, counted on its mbarrier
__device__ inline void push2(uint32_t addr, float a, float b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32"
      " [%0], {%1, %2}, [%3];"
      :: "r"(addr), "r"(__float_as_uint(a)), "r"(__float_as_uint(b)),
         "r"(bar) : "memory");
}

__device__ inline void push1(uint32_t addr, float a, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
      " [%0], %1, [%2];"
      :: "r"(addr), "r"(__float_as_uint(a)), "r"(bar) : "memory");
}

// one arrival that expects `bytes` more of transactions
__device__ inline void arm(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ inline void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"
        " p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// the max over the warp, exact: a float's bits as an int in the float
// order (the low 31 bits of a negative flipped)
__device__ inline float warp_max(float x) {
  int key = __float_as_int(x);
  key ^= (key >> 31) & 0x7fffffff;
  key = __reduce_max_sync(0xffffffffu, key);
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}

__global__ void __launch_bounds__(kThreads, 1)
pyin_viterbi_kernel(const float* __restrict__ score0,   // (B, 2, K)
                    const float* __restrict__ log_obs,  // (B, F, 2, K)
                    const float* __restrict__ log_P,    // (K, K)
                    const float* __restrict__ log_V,    // (2, 2)
                    uint16_t* __restrict__ pred,        // (B, F - 1, 2 K)
                    int64_t* __restrict__ v_path,       // (B, F)
                    int64_t* __restrict__ k_path,       // (B, F)
                    int F, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan plan = plan_for(K);
  const Layout L = layout_for(K);
  const int C = plan.C, cw = plan.cw, ow = plan.ow;
  const int r = cluster_rank();
  const int b = blockIdx.x / C;
  float* sP = reinterpret_cast<float*>(smem);
  float2* sScore = reinterpret_cast<float2*>(smem + L.score);
  float2* sRecv = reinterpret_cast<float2*>(smem + L.recv);
  float* sMax = reinterpret_cast<float*>(smem + L.maxes);
  float4* sPart = reinterpret_cast<float4*>(smem + L.part);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K2 = 2 * K;
  const int c_lo = r * cw;
  const int cn = min(K, c_lo + cw) - c_lo;      // columns of this CTA
  const float* obs = log_obs + static_cast<size_t>(b) * F * K2;
  uint16_t* pred_b = pred + static_cast<size_t>(b) * (F - 1) * K2;

  for (int i = tid; i < K * cn; i += kThreads) {
    const int k = i / cn, j = i - k * cn;
    sP[k * cw + j] = log_P[static_cast<size_t>(k) * K + c_lo + j];
  }
  const float* s0 = score0 + static_cast<size_t>(b) * K2;
  for (int k = tid; k < K; k += kThreads)
    sScore[k] = make_float2(s0[k], s0[K + k]);
  // maxima of warps that own no column stay -inf
  for (int i = tid; i < 2 * C * ow; i += kThreads) sMax[i] = -INFINITY;
  // the bytes a CTA receives a frame: every column's pair and every
  // CTA's owner warps' maxima
  uint32_t bytes = 8u * K;
  for (int j = 0; j < C; ++j)
    bytes += 4u * ((min(K, (j + 1) * cw) - j * cw + 31) / 32);
  const uint32_t bar0 = static_cast<uint32_t>(smem_addr(smem + L.bars));
  if (tid == 0) {
    for (int p = 0; p < 2; ++p)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(bar0 + 8 * p) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    arm(bar0, bytes);
    arm(bar0 + 8, bytes);
  }
  const int col = tid % cn, range = tid / cn;
  const bool owner = tid < cn;                  // phase 2
  const bool sweeps = range < plan.ranges;      // phase 1
  const int k_lo = range * plan.chunk;
  const int k_hi = min(K, k_lo + plan.chunk);
  const int owner_warps = (cn + 31) / 32;
  // log_V(v, v'): cvv' into v' from v
  const float lv00 = log_V[0], lv01 = log_V[1];
  const float lv10 = log_V[2], lv11 = log_V[3];
  uint32_t recv_of[kMaxCluster], bar_of[kMaxCluster];
#pragma unroll
  for (int j = 0; j < kMaxCluster; ++j) {
    recv_of[j] = map_rank(smem_addr(sRecv), j < C ? j : 0);
    bar_of[j] = map_rank(bar0, j < C ? j : 0);
  }
  // lane j < C sends its warp's max to CTA j
  const uint32_t max_to = map_rank(smem_addr(sMax), lane < C ? lane : 0);
  const uint32_t max_bar = map_rank(bar0, lane < C ? lane : 0);
  cluster_sync();

  for (int t = 1; t < F; ++t) {
    const int par = t & 1;
    float o0 = 0.f, o1 = 0.f;
    if (owner) {                  // used after phase 1: its latency hides
      o0 = obs[static_cast<size_t>(t) * K2 + c_lo + col];
      o1 = obs[static_cast<size_t>(t) * K2 + K + c_lo + col];
    }
    float m0 = -INFINITY, m1 = -INFINITY;
    int i0 = k_lo, i1 = k_lo;
    if (sweeps) {
      const float* Pc = sP + col;
#pragma unroll 4
      for (int k = k_lo; k < k_hi; ++k) {
        const float2 s = sScore[k];
        const float p = Pc[k * cw];
        const float a0 = s.x + p, a1 = s.y + p;
        if (a0 > m0) { m0 = a0; i0 = k; }
        if (a1 > m1) { m1 = a1; i1 = k; }
      }
      if (range > 0)
        sPart[(range - 1) * cw + col] = make_float4(
            m0, __int_as_float(i0), m1, __int_as_float(i1));
    }
    __syncthreads();

    if (warp < owner_warps) {
      float most = -INFINITY;
      if (owner) {
#pragma unroll 4
        for (int q = 1; q < plan.ranges; ++q) {
          const float4 x = sPart[(q - 1) * cw + col];
          if (x.x > m0) { m0 = x.x; i0 = __float_as_int(x.y); }
          if (x.z > m1) { m1 = x.z; i1 = __float_as_int(x.w); }
        }
        const float c00 = m0 + lv00, c10 = m1 + lv10;   // into v' 0
        const float c01 = m0 + lv01, c11 = m1 + lv11;   // into v' 1
        const bool from1_0 = c10 > c00, from1_1 = c11 > c01;
        const float n0 = (from1_0 ? c10 : c00) + o0;
        const float n1 = (from1_1 ? c11 : c01) + o1;
        const uint32_t at = 8u * (par * K + c_lo + col);
#pragma unroll
        for (int j = 0; j < kMaxCluster; ++j)
          if (j < C) push2(recv_of[j] + at, n0, n1, bar_of[j] + 8 * par);
        uint16_t* row = pred_b + static_cast<size_t>(t - 1) * K2;
        row[c_lo + col] = static_cast<uint16_t>(from1_0 ? K + i1 : i0);
        row[K + c_lo + col] = static_cast<uint16_t>(from1_1 ? K + i1 : i0);
        most = fmaxf(n0, n1);
      }
      most = warp_max(most);
      if (lane < C)
        push1(max_to + 4u * (par * C * ow + r * ow + warp), most,
              max_bar + 8 * par);
    }
    wait_parity(bar0 + 8 * par, ((t - 1) >> 1) & 1);
    if (tid == 0 && t + 2 < F) arm(bar0 + 8 * par, bytes);

    const float* mx = sMax + par * C * ow;
    float M = mx[0];
    for (int i = 1; i < C * ow; ++i) M = fmaxf(M, mx[i]);
    for (int k = tid; k < K; k += kThreads) {
      const float2 n = sRecv[par * K + k];
      sScore[k] = make_float2(n.x - M, n.y - M);
    }
    __syncthreads();
  }
  cluster_sync();           // every CTA's pred rows are visible to CTA 0
  if (r != 0) return;

  // the first argmax over v K + k: lane l scans l, l + 32, ... in order,
  // then the lanes' winners merge, the lower index on a tie
  int s = 0;
  if (warp == 0) {
    float best = -INFINITY;
    int at = 0x7fffffff;
    for (int i = lane; i < K2; i += 32) {
      const float2 sc = sScore[i < K ? i : i - K];
      const float x = i < K ? sc.x : sc.y;
      if (at == 0x7fffffff || x > best) { best = x; at = i; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oa = __shfl_xor_sync(0xffffffffu, at, o);
      if (ob > best || (ob == best && oa < at)) { best = ob; at = oa; }
    }
    s = at;
  }
  if (tid == 0) {
    const int v = s >= K;
    v_path[static_cast<size_t>(b) * F + F - 1] = v;
    k_path[static_cast<size_t>(b) * F + F - 1] = s - v * K;
  }

  // the walk back, `rows` frames of pred at a time (a row of 2 K uint16 is
  // K 32-bit words; each row starts 4-byte aligned), read past L1: other
  // CTAs wrote them
  uint16_t* stage = reinterpret_cast<uint16_t*>(smem);
  const int rows = static_cast<int>(L.score / (K2 * sizeof(uint16_t)));
  for (int hi = F - 1; hi > 0; hi -= rows) {
    const int lo = hi > rows ? hi - rows : 0;
    const unsigned int* src = reinterpret_cast<const unsigned int*>(
        pred_b + static_cast<size_t>(lo) * K2);
    unsigned int* dst = reinterpret_cast<unsigned int*>(stage);
    for (int i = tid, n = (hi - lo) * K; i < n; i += kThreads)
      dst[i] = __ldcg(src + i);
    __syncthreads();
    if (tid == 0) {
      for (int t = hi - 1; t >= lo; --t) {
        s = stage[(t - lo) * K2 + s];
        const int v = s >= K;
        v_path[static_cast<size_t>(b) * F + t] = v;
        k_path[static_cast<size_t>(b) * F + t] = s - v * K;
      }
    }
    __syncthreads();
  }
}

// the largest K whose layout, and every smaller K's, fits kSmemMax
int max_bins() {
  int K = 0;
  while (K < kThreads * kMaxCluster && layout_for(K + 1).total <= kSmemMax)
    ++K;
  return K;
}

// the kernel's dynamic shared memory limit, raised to kSmemMax once on
// each device (a concurrent first call sets the same value)
std::atomic<bool> g_smem_set[kMaxDevices];

cudaError_t raise_smem_limit() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && g_smem_set[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  e = cudaFuncSetAttribute(pyin_viterbi_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemMax));
  if (e == cudaSuccess && dev < kMaxDevices)
    g_smem_set[dev].store(true, std::memory_order_release);
  return e;
}

}  // namespace

extern "C" {

// The most pitch bins a launch takes: more do not fit a CTA's shared
// memory.
int pyin_viterbi_max_bins() {
  static const int most = max_bins();
  return most;
}

// The cluster size of a launch over K pitch bins.
int pyin_viterbi_cluster(int K) { return plan_for(K).C; }

// score0 (B, 2, K), log_obs (B, F, 2, K), log_P (K, K), log_V (2, 2) f32;
// pred (B, F - 1, 2 K) 16-bit scratch; v_path, k_path (B, F) int64.
// Returns cudaGetLastError() after the launch (0 on success).
int pyin_viterbi_launch(const float* score0, const float* log_obs,
                        const float* log_P, const float* log_V, void* pred,
                        int64_t* v_path, int64_t* k_path, int B, int F,
                        int K, void* stream) {
  if (B < 1 || F < 1 || K < 1 || K > pyin_viterbi_max_bins())
    return (int)cudaErrorInvalidValue;
  cudaError_t e = raise_smem_limit();
  if (e != cudaSuccess) return (int)e;
  const int C = plan_for(K).C;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = layout_for(K).total;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, pyin_viterbi_kernel, score0, log_obs, log_P,
                         log_V, static_cast<uint16_t*>(pred), v_path, k_path,
                         F, K);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* radmmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
