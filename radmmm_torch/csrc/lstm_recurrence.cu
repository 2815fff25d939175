// Masked multi-lane LSTM recurrence for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel radmmm_tpu/ops/lstm_pallas.py::_lstm_kernel
// (reached through lstm_recurrence_pallas). Per lane l and step t, with the
// input projection x_proj precomputed outside (one large matmul):
//
//   gates = x_proj[l,t] + h @ Wh[l]; i,f,g,o = split(gates)   (torch order)
//   c' = f*c + i*g;  h' = o*tanh(c')
//   (h,c) <- (h',c') where mask[t] > 0, else kept;  out[l,t] = h' * mask[t]
//
// A lane with its reverse bit set walks t = T-1 .. 0, which is the JAX
// package's flip-then-scan. A BiLSTM is one launch with L = 2 lanes, the
// three ganged frame predictors one launch with L = 6.
//
// For training the launch also writes what the backward kernel
// (lstm_recurrence_bwd.cu) needs: the gate activations (i, f, g, o after
// their sigmoid/tanh) and the carried c and h after every step. Serving
// passes null pointers and writes nothing extra.
//
// What bounds it: latency, not bytes or FLOPs. A lane is a chain of T
// dependent steps, each a (B,H)x(H,4H) product whose input is the whole h
// of the step before; at B = 1..8 that is a few hundred kFLOP a step, far
// below what the card's FLOP rate or memory bandwidth would need a step to
// last. What a step costs is the product spread over as many SMs as the
// lane can use, the exchange of the new h between them, and the barrier
// that orders the steps. Wh does not fit one SM (1.08 MB at H = 260, 4.46
// MB at H = 528, in f32).
//
// Design: an all-gather of h per step, with no barrier wider than a lane.
// Each CTA owns one lane's hb hidden units with all four of their gate
// columns. It keeps Wh[:, those 4 hb columns] in shared memory for the
// whole run and its cells' c in registers (one cell (b, unit) a thread).
// Per step it multiplies the lane's h, held unit-major in its own shared
// memory, by its columns (f32 FMAs on the CUDA cores, a thread two columns
// by up to 8 batch rows over one of ks chunks of the H reduction; the
// chunks meet in shared memory), updates its cells, writes out (and the
// saved states) and hands its units' new h to every CTA of the lane. The
// next step's x_proj and mask are loaded during the exchange and the
// barrier, off the chain. Lanes are independent: a BiLSTM's directions
// and the six frame-DAP lanes never wait for each other. Two routes,
// picked by the wrapper's plan (ops/lstm_kernel.forward_plan):
// - cluster: a lane is one thread-block cluster of up to 16 CTAs (Hopper's
//   non-portable size; 8 where only portable clusters are resident), for
//   every lane whose Wh slices fit the cluster's shared memory: H <= 260
//   in the model. A CTA writes its units' h, 16 bytes at a time, into
//   every peer's shared memory (distributed shared memory), double-buffered
//   by step parity, and barrier.cluster arrive.release / wait.acquire
//   orders the steps. A CTA writes into a buffer for step s+2 only after
//   every CTA has passed the barrier of step s+1, which each reaches after
//   its product of step s; the last step sends nothing, so no CTA exits
//   while a peer may still write to it. A lane that finds no free SMs
//   waits for a cluster to finish and still gives the same answer.
// - grid: a cooperative launch for lanes whose Wh is too large for a
//   cluster (H = 528). h goes through an L2 double buffer (2, L, H, Bp),
//   written with __stcg and read with __ldcg, and each lane's CTAs meet at
//   a barrier of their own: a release atomicAdd on the lane's counter and
//   an acquire spin until it reaches step x CTAs (lstm_sync.cuh). The
//   launch is cooperative, so every CTA is resident and the spin cannot
//   deadlock.
// No tensor cores: they would take f32 operands as TF32, and the plain twin
// is f32. The bf16 variant (the JAX package's conv_precision "bf16"), whose
// products run on them, is lstm_recurrence_bf16.cu.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lstm_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline size_t up4(size_t n) { return (n + 3) / 4 * 4; }

// batch rows as the product tiles them: 4 up to B = 4, else a multiple of 8
__host__ __device__ inline int pad_rows(int B) {
  return B <= 4 ? 4 : (B + 7) / 8 * 8;
}

// shared memory of one CTA, in floats, each part on a 16-byte boundary;
// ops/lstm_kernel.py::_fwd_smem mirrors the byte count
struct Layout {
  int Bp;      // batch rows padded
  int nc;      // this CTA's gate columns: 4 hb
  int kc;      // reduction rows per chunk
  int hp;      // rows of the Wh slice: ks * kc >= H, zero past H
  int hr;      // rows (units) of an h buffer: max(hp, n_cta * hb)
  size_t w_off, h_off, part_off, bytes;
};

__host__ __device__ inline Layout make_layout(int B, int H, int hb, int ks,
                                              int n_cta, bool cluster) {
  Layout s;
  s.Bp = pad_rows(B);
  s.nc = 4 * hb;
  s.kc = (H + ks - 1) / ks;
  s.hp = s.kc * ks;
  s.hr = s.hp > n_cta * hb ? s.hp : n_cta * hb;
  const size_t w_elems = (size_t)s.hp * s.nc;
  s.w_off = 0;                                          // hp x nc    Wh
  s.h_off = up4(s.w_off + w_elems);
                                                        // (2|1) x hr x Bp
  s.part_off = up4(s.h_off + (size_t)(cluster ? 2 : 1) * s.hr * s.Bp);
  s.bytes = (s.part_off + (size_t)ks * s.Bp * s.nc) * sizeof(float);
  return s;                                             // ks x Bp x nc
}

struct Params {
  const float* xp;     // (L, T, B, 4H)
  const float* mask;   // (T, B), or (L, T, B) with mask_lane_stride = T*B
  const float* wh;     // (L, H, 4H)
  float* out;          // (L, T, B, H)
  float* act;          // (L, T, B, 4H) gate activations, or null
  float* cs;           // (L, T, B, H) carried c after each step, or null
  float* hs;           // (L, T, B, H) carried h after each step, or null
  float* hbuf;         // grid: (2, L, H, Bp) zeroed; cluster: null
  unsigned* arrived;   // grid: (L,) zeroed counters; cluster: null
  int L, T, B, H, hb, ks, n_cta;
  long long mask_lane_stride;
  unsigned long long reverse_bits;
};

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

// kRows: batch rows a thread accumulates at once (4 for B <= 4, else 8)
template <bool kCluster, int kRows>
__global__ void __launch_bounds__(kThreads, 1)
lstm_recurrence_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, B = p.B, T = p.T, G = 4 * H, hb = p.hb, ks = p.ks;
  const int n_cta = p.n_cta, tid = threadIdx.x;
  const Layout s = make_layout(B, H, hb, ks, n_cta, kCluster);
  const int Bp = s.Bp, nc = s.nc;
  const int lane = blockIdx.x / n_cta;
  const int rank = blockIdx.x % n_cta;    // the cluster rank on that route
  const int j0 = rank * hb;
  const bool rev = (p.reverse_bits >> lane) & 1ULL;
  const size_t hsize = (size_t)s.hr * Bp;

  float* w_s = smem + s.w_off;
  float* h_s = smem + s.h_off;     // h_s[unit * Bp + b]
  float* part_s = smem + s.part_off;

  // this CTA's Wh columns: local column c = gate * hb + j holds global
  // column gate * H + j0 + j; rows past H and units past H are zero
  const float* wh = p.wh + (size_t)lane * H * G;
  for (int i = tid; i < s.hp * nc; i += kThreads) {
    const int k = i / nc, c = i % nc, u = j0 + c % hb;
    w_s[i] = (k < H && u < H) ? wh[(size_t)k * G + (c / hb) * H + u] : 0.f;
  }
  // h before the first step, and the padding (rows past B, units past H)
  // that feeds only sums never stored, stays zero
  for (size_t i = tid; i < (kCluster ? 2 : 1) * hsize; i += kThreads)
    h_s[i] = 0.f;

  const float* xp = p.xp + (size_t)lane * T * B * G;
  const float* mk = p.mask + (size_t)lane * p.mask_lane_stride;
  float* out = p.out + (size_t)lane * T * B * H;

  // one cell (b, unit) per thread: the plan keeps B * hb <= kThreads
  const int cb = tid / hb, cj = tid % hb, cu = j0 + cj;
  const bool owns_cell = tid < B * hb && cu < H;
  // the product: two columns c0, c0 + 1 over reduction chunk `chunk`; the
  // plan keeps 2 hb ks <= kThreads
  const int pairs = nc / 2;
  const bool in_product = tid < pairs * ks;
  const int c0 = 2 * (tid % pairs), chunk = tid / pairs;

  // a cell's x_proj and mask at a step
  struct In { float x[4], m; };
  auto load_in = [&](int step) {
    In v = {{0.f, 0.f, 0.f, 0.f}, 0.f};
    if (owns_cell) {
      const int t = rev ? T - 1 - step : step;
      const float* xr = xp + ((size_t)t * B + cb) * G + cu;
#pragma unroll
      for (int g = 0; g < 4; ++g) v.x[g] = xr[g * H];
      v.m = mk[(size_t)t * B + cb];
    }
    return v;
  };

  // every CTA of the cluster runs before any writes another's memory
  if constexpr (kCluster) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  float c_cell = 0.f;
  In cur = load_in(0);
  for (int step = 0; step < T; ++step) {
    const int t = rev ? T - 1 - step : step;
    const int par = step & 1;
    // h after step - 1: this step's buffer (the cluster's double buffer, or
    // the grid's one copy of the L2 buffer)
    const float* h_cur = h_s + (kCluster ? par * hsize : 0);
    float* h_nxt = h_s + (kCluster ? (par ^ 1) * hsize : 0);
    if (step > 0) {
      if constexpr (kCluster) {
        cluster_wait();
      } else {
        lane_wait(p.arrived + lane, (unsigned)step * n_cta);
        const float4* src = reinterpret_cast<const float4*>(
            p.hbuf + ((size_t)par * p.L + lane) * H * Bp);
        float4* dst = reinterpret_cast<float4*>(h_s);
        for (int i = tid; i < H * Bp / 4; i += kThreads) dst[i] = __ldcg(src + i);
        __syncthreads();
      }
    }

    if (in_product) {
      const int k_lo = chunk * s.kc;
      for (int b0 = 0; b0 < B; b0 += kRows) {
        float acc[2][kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q) acc[0][q] = acc[1][q] = 0.f;
        const float* hk = h_cur + (size_t)k_lo * Bp + b0;
        const float* wk = w_s + (size_t)k_lo * nc + c0;
#pragma unroll 4
        for (int k = 0; k < s.kc; ++k) {
          const float2 w = *reinterpret_cast<const float2*>(
              wk + (size_t)k * nc);
          float hv[kRows];
#pragma unroll
          for (int q4 = 0; q4 < kRows / 4; ++q4) {
            const float4 v = *reinterpret_cast<const float4*>(
                hk + (size_t)k * Bp + 4 * q4);
            hv[4 * q4] = v.x; hv[4 * q4 + 1] = v.y;
            hv[4 * q4 + 2] = v.z; hv[4 * q4 + 3] = v.w;
          }
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            acc[0][q] = fmaf(hv[q], w.x, acc[0][q]);
            acc[1][q] = fmaf(hv[q], w.y, acc[1][q]);
          }
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (b0 + q < B)
            *reinterpret_cast<float2*>(
                part_s + ((size_t)chunk * Bp + b0 + q) * nc + c0) =
                make_float2(acc[0][q], acc[1][q]);
      }
    }
    __syncthreads();

    if (owns_cell) {
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float acc = 0.f;
        for (int q = 0; q < ks; ++q)
          acc += part_s[((size_t)q * Bp + cb) * nc + g * hb + cj];
        gate[g] = cur.x[g] + acc;
      }
      const float ai = sigmoidf_(gate[0]), af = sigmoidf_(gate[1]);
      const float ag = tanhf(gate[2]), ao = sigmoidf_(gate[3]);
      const float c_new = af * c_cell + ai * ag;
      const float h_new = ao * tanhf(c_new);
      const bool keep = cur.m > 0.f;
      const float h_keep = keep ? h_new : h_cur[(size_t)cu * Bp + cb];
      c_cell = keep ? c_new : c_cell;
      out[((size_t)t * B + cb) * H + cu] = h_new * cur.m;
      if (p.act) {
        const size_t cell = ((size_t)lane * T + t) * B + cb;
        float* a = p.act + cell * G + cu;
        a[0] = ai; a[H] = af; a[2 * H] = ag; a[3 * H] = ao;
        p.cs[cell * H + cu] = c_cell;
        p.hs[cell * H + cu] = h_keep;
      }
      if (step + 1 < T) {
        if constexpr (kCluster)
          h_nxt[(size_t)cu * Bp + cb] = h_keep;
        else
          __stcg(p.hbuf + (((size_t)(par ^ 1) * p.L + lane) * H + cu) * Bp
                     + cb, h_keep);
      }
    }
    if (step + 1 == T) break;
    // the next step's inputs, in flight through the exchange and the
    // barrier
    cur = load_in(step + 1);
    __syncthreads();
    if constexpr (kCluster) {
      // my units' rows of h_nxt (hb x Bp floats from unit j0) to the same
      // place in every peer, 16 bytes a store
      const int n4 = hb * Bp / 4;
      float* mine = h_nxt + (size_t)j0 * Bp;
      const float4* src = reinterpret_cast<const float4*>(mine);
      for (int i = tid; i < (n_cta - 1) * n4; i += kThreads) {
        const int peer = (rank + 1 + i / n4) % n_cta;
        float4* dst = reinterpret_cast<float4*>(
            cg::this_cluster().map_shared_rank(mine, peer));
        dst[i % n4] = src[i % n4];
      }
      cluster_arrive();
    } else {
      lane_arrive(p.arrived + lane);
    }
  }
}

using Kernel = void (*)(const Params);

Kernel kernel_for(bool cluster, int B) {
  if (cluster)
    return B <= 4 ? lstm_recurrence_kernel<true, 4>
                  : lstm_recurrence_kernel<true, 8>;
  return B <= 4 ? lstm_recurrence_kernel<false, 4>
                : lstm_recurrence_kernel<false, 8>;
}

}  // namespace

extern "C" {

// The current device's limits for the plan (lstm_sync.cuh), with the
// registers of the grid-route kernel. Returns a CUDA error code.
int lstm_recurrence_limits(int* sms, int* smem_block, int* smem_sm,
                           int* regs_grid) {
  return lstm_card_limits(kernel_for(false, 8), sms, smem_block, smem_sm,
                          regs_grid);
}

// Clusters of n_cta CTAs of the cluster-route kernel for (B, H, hb, ks)
// that the current device holds at once, in *n_clusters (0: none fits).
// Returns 0.
int lstm_recurrence_clusters(int B, int H, int hb, int ks, int n_cta,
                             int* n_clusters) {
  const Layout s = make_layout(B, H, hb, ks, n_cta, true);
  return lstm_active_clusters(kernel_for(true, B), n_cta, kThreads, s.bytes,
                              n_clusters);
}

// Launches the recurrence on `stream` by the route of the wrapper's plan:
// `cluster` non-zero for one cluster of n_cta CTAs per lane, else the
// cooperative grid with the zeroed `hbuf` and `arrived`. act, cs and hs are
// null when serving, all three set when training. Returns
// cudaGetLastError() after the launch (0 on success).
int lstm_recurrence_launch(const float* xp, const float* mask, const float* wh,
                           float* out, float* act, float* cs, float* hs,
                           float* hbuf, unsigned* arrived, int L, int T,
                           int B, int H, long long mask_lane_stride,
                           unsigned long long reverse_bits, int cluster,
                           int n_cta, int hb, int ks, void* stream) {
  if (B * hb > kThreads || 2 * hb * ks > kThreads || n_cta * hb < H ||
      ks < 1 || L < 1 || L > 64)
    return (int)cudaErrorInvalidValue;
  const Layout s = make_layout(B, H, hb, ks, n_cta, cluster != 0);
  Params p;
  p.xp = xp; p.mask = mask; p.wh = wh; p.out = out;
  p.act = act; p.cs = cs; p.hs = hs; p.hbuf = hbuf; p.arrived = arrived;
  p.L = L; p.T = T; p.B = B; p.H = H; p.hb = hb; p.ks = ks; p.n_cta = n_cta;
  p.mask_lane_stride = mask_lane_stride;
  p.reverse_bits = reverse_bits;
  return lstm_launch(kernel_for(cluster != 0, B), p, cluster != 0, n_cta,
                     L * n_cta, kThreads, s.bytes, (cudaStream_t)stream);
}

const char* radmmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
