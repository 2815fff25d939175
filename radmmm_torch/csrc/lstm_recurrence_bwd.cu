// Backward of the masked multi-lane LSTM recurrence, for Hopper (sm_90a),
// f32.
//
// The TPU kernel radmmm_tpu/ops/lstm_pallas.py::_lstm_kernel has no
// backward: the JAX package trains its LSTMs by differentiating lax.scan.
// This kernel is the backward of lstm_recurrence.cu, the port's K4. It
// walks each lane in the opposite order to its forward and, from the
// forward's saved gate activations (i, f, g, o) and carried cell states,
// computes the gradient of the gate pre-activations:
//
//   dh = dh_pass + dgates(t_next) @ Wh^T      (h after step t feeds t_next)
//   valid frame (mask > 0):
//     dh' = dh + dout(t) * mask(t);  tc = tanh(c(t))
//     dc' = dc_pass + dh' * o * (1 - tc^2)
//     dgates(t) = [dc' g i(1-i), dc' c(t_prev) f(1-f), dc' i (1-g^2),
//                  dh' tc o(1-o)]
//     dh_pass = 0;  dc_pass = dc' * f
//   masked frame: dgates(t) = 0, dh_pass = dh, dc_pass unchanged
//
// dgates is the gradient of x_proj. The wrapper forms dWh = sum_t
// h(t_prev)^T dgates(t) with one batched matmul outside the kernel.
//
// What bounds it: a chain of T dependent steps, each a (B,4H)x(4H,H)
// product whose input is the whole dgates of the step before, so latency is
// the limit (the exchange between the CTAs of a lane and the barrier that
// orders the steps), not FLOPs or bytes.
//
// Design: a reduce-scatter per step in place of an all-gather. Each CTA
// owns one lane's hb hidden units with all four of their gate columns (the
// forward's slice), so the dgates it computes for them stay local. It keeps
// Wh[:, its 4 hb columns] in shared memory for the whole run, multiplies
// its own dgates by it into a partial dh of all H units for all B rows
// (f32 FMAs on the CUDA cores, a thread two units by 8 rows; the 4 hb
// reduction split into ks chunks that meet in shared memory), and sends
// each CTA of its lane the partials of that CTA's units: B x H floats out
// per step, a quarter of the B x 4H an all-gather of dgates would read in,
// as 16-byte stores of four batch rows of one unit. A CTA sums what it received for its units,
// updates its cells and writes their dgates; the next step's saved forward
// values are loaded while the product and the exchange run, off the chain.
// Lanes are independent: nothing spans two lanes. The per-step product sets
// the pace, so a lane takes as many CTAs as its route allows.
// Two routes, picked by the wrapper's plan:
// - cluster: a lane is one thread-block cluster of up to 16 CTAs (Hopper's
//   non-portable size; 8 where only portable clusters are resident), for
//   every lane whose Wh slices fit the cluster's shared memory: H <= 260
//   in the model. Partials go straight into the owner's shared memory
//   (distributed shared memory), double-buffered by step parity, and
//   barrier.cluster arrive.release / wait.acquire orders the steps.
// - grid: a cooperative launch for lanes whose Wh is too large for a
//   cluster (H = 528, 4.46 MB). Partials go through L2 (a buffer of
//   (L, 2, CTAs, H, B) floats, read with __ldcg and summed by all threads),
//   and each lane's CTAs meet at a barrier of their own: a release
//   atomicAdd on the lane's counter and an acquire spin until it reaches
//   step x CTAs. The launch is cooperative, so every CTA is resident and the
//   spin cannot deadlock.
// The bf16 variant, the backward of the forward's bf16 product on the
// tensor cores, is in lstm_recurrence_bf16.cu.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lstm_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 384;
constexpr int kTileB = 8;    // batch rows a thread accumulates at once

__host__ __device__ inline size_t up4(size_t n) { return (n + 3) / 4 * 4; }

// shared memory of one CTA, in floats, each part on a 16-byte boundary;
// ops/lstm_kernel.py::_bwd_smem mirrors the byte count
struct Layout {
  int Bp;      // B rounded up to 4, for float4 reads of dgates
  int nc;      // this CTA's gate columns: 4 hb
  int kc;      // columns per chunk of the partial product
  int gp;      // nc padded to ks * kc
  size_t w_off, dg_off, part_off, rx_off, bytes;
};

__host__ __device__ inline Layout make_layout(int B, int H, int hb, int ks,
                                              int n_cta, bool cluster) {
  Layout s;
  s.Bp = (B + 3) / 4 * 4;
  s.nc = 4 * hb;
  s.kc = (s.nc + ks - 1) / ks;
  s.gp = s.kc * ks;
  const size_t w_elems = (size_t)s.gp * H;
  s.w_off = 0;                                          // gp x H    Wh^T
  s.dg_off = up4(s.w_off + w_elems);
                                                        // gp x Bp   dgates
  s.part_off = up4(s.dg_off + (size_t)s.gp * s.Bp);     // ks x H x Bp
  s.rx_off = up4(s.part_off + (ks > 1 ? (size_t)ks * H * s.Bp : 0));
  // cluster: 2 x n_cta x hb x Bp partials received; grid: the gather's
  // sums
  const size_t rx =
      cluster ? (size_t)2 * n_cta * hb * s.Bp : (size_t)kThreads;
  s.bytes = (s.rx_off + rx) * sizeof(float);
  return s;
}

struct Params {
  const float* dout;   // (L, T, B, H)
  const float* act;    // (L, T, B, 4H) i, f, g, o activations
  const float* cs;     // (L, T, B, H) carried c after each step
  const float* mask;   // (T, B), or (L, T, B) with mask_lane_stride = T*B
  const float* wh;     // (L, H, 4H)
  float* dxp;          // (L, T, B, 4H) out: dgates
  float* part;         // grid: (L, 2, n_cta, H, Bp) partials; else null
  unsigned* arrived;   // grid: (L,) zeroed counters; cluster: null
  int L, T, B, H, hb, ks, n_cta;
  long long mask_lane_stride;
  unsigned long long reverse_bits;
};

template <bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
lstm_recurrence_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, B = p.B, T = p.T, G = 4 * H, hb = p.hb, ks = p.ks;
  const int n_cta = p.n_cta, tid = threadIdx.x;
  const Layout s = make_layout(B, H, hb, ks, n_cta, kCluster);
  const int lane = blockIdx.x / n_cta;
  const int rank = blockIdx.x % n_cta;    // the cluster rank on that route
  const int j0 = rank * hb;
  const bool rev = (p.reverse_bits >> lane) & 1ULL;

  float* w_s = smem + s.w_off;
  float* dg_s = smem + s.dg_off;
  float* part_s = smem + s.part_off;
  float* rx_s = smem + s.rx_off;

  // this CTA's Wh columns, transposed: w_s[k * H + j] = Wh[j, gate * H +
  // j0 + u] for the local column k = gate * hb + u; zero past 4 hb and for
  // units past H. k runs fastest, so Wh is read in runs of hb floats.
  const float* wh = p.wh + (size_t)lane * H * G;
  for (int i = tid; i < s.gp * H; i += kThreads) {
    const int j = i / s.gp, k = i % s.gp, u = j0 + k % hb;
    w_s[(size_t)k * H + j] =
        (k < s.nc && u < H) ? wh[(size_t)j * G + (k / hb) * H + u] : 0.f;
  }
  for (int i = tid; i < s.gp * s.Bp; i += kThreads) dg_s[i] = 0.f;

  const float* dout = p.dout + (size_t)lane * T * B * H;
  const float* act = p.act + (size_t)lane * T * B * G;
  const float* cs = p.cs + (size_t)lane * T * B * H;
  const float* mk = p.mask + (size_t)lane * p.mask_lane_stride;
  float* dxp = p.dxp + (size_t)lane * T * B * G;

  // one cell (b, unit) per thread: the plan keeps B * hb <= kThreads
  const int cb = tid / hb, cj = tid % hb, cu = j0 + cj;
  const bool owns_cell = tid < B * hb && cu < H;
  float dh_pass = 0.f, dc_pass = 0.f;

  // the saved forward values a cell needs at a step: its gates, c after
  // and before the step, dout and the mask
  struct Saved { float a[4], c_new, c_prev, d_out, m; };
  auto load_saved = [&](int step) {
    Saved v = {{0.f, 0.f, 0.f, 0.f}, 0.f, 0.f, 0.f, 0.f};
    if (owns_cell) {
      const int t = rev ? step : T - 1 - step;
      const size_t cell = (size_t)t * B + cb;
      v.m = mk[cell];
      if (v.m > 0.f) {
#pragma unroll
        for (int g = 0; g < 4; ++g) v.a[g] = act[cell * G + g * H + cu];
        v.c_new = cs[cell * H + cu];
        if (rev ? t != T - 1 : t != 0)
          v.c_prev = cs[((size_t)(rev ? t + 1 : t - 1) * B + cb) * H + cu];
        v.d_out = dout[cell * H + cu];
      }
    }
    return v;
  };

  // hands the partial dh of unit j, rows b .. b+3, to the unit's CTA
  auto send4 = [&](int par, int j, int b, float4 v) {
    if constexpr (kCluster) {
      float* dst = cg::this_cluster().map_shared_rank(rx_s, j / hb);
      *reinterpret_cast<float4*>(
          dst + (((size_t)par * n_cta + rank) * hb + j % hb) * s.Bp + b) = v;
    } else {
      __stcg(reinterpret_cast<float4*>(
                 p.part + ((((size_t)lane * 2 + par) * n_cta + rank) * H + j)
                              * s.Bp + b), v);
    }
  };

  // every CTA of the cluster runs before any writes another's memory
  if constexpr (kCluster) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  Saved cur = load_saved(0);
  for (int step = 0; step < T; ++step) {
    // the forward's step T-1-step
    const int t = rev ? step : T - 1 - step;

    // dgates(t_next) @ Wh^T for my units: the partials the lane's CTAs
    // sent one step ago (none at the first step)
    float rec = 0.f;
    if (step > 0) {
      const int par = (step - 1) & 1;
      if constexpr (kCluster) {
        cluster_wait();
        if (owns_cell) {
          const float* r = rx_s + ((size_t)par * n_cta * hb + cj) * s.Bp + cb;
          for (int src = 0; src < n_cta; ++src)
            rec += r[(size_t)src * hb * s.Bp];
        }
      } else {
        lane_wait(p.arrived + lane, (unsigned)step * n_cta);
        // all threads gather: group g sums sources g, g + ngrp, ... of the
        // element e = (unit, row)
        const int E = B * hb, ngrp = kThreads / E;
        const int e = tid % E, grp = tid / E;
        if (grp < ngrp) {
          const int u = j0 + e / B, b = e % B;
          float acc = 0.f;
          if (u < H) {
            const float* src =
                p.part + (((size_t)lane * 2 + par) * n_cta * H + u) * s.Bp + b;
            for (int q = grp; q < n_cta; q += ngrp)
              acc += __ldcg(src + (size_t)q * H * s.Bp);
          }
          rx_s[grp * E + e] = acc;
        }
        __syncthreads();
        if (owns_cell)
          for (int g = 0; g < ngrp; ++g) rec += rx_s[g * E + cj * B + cb];
      }
    }

    if (owns_cell) {
      const float dh = dh_pass + rec;
      float dg[4] = {0.f, 0.f, 0.f, 0.f};
      if (cur.m > 0.f) {
        const float ai = cur.a[0], af = cur.a[1], ag = cur.a[2];
        const float ao = cur.a[3];
        const float dhn = dh + cur.d_out * cur.m;
        const float tc = tanhf(cur.c_new);
        const float dcn = dc_pass + dhn * ao * (1.f - tc * tc);
        dg[0] = dcn * ag * ai * (1.f - ai);
        dg[1] = dcn * cur.c_prev * af * (1.f - af);
        dg[2] = dcn * ai * (1.f - ag * ag);
        dg[3] = dhn * tc * ao * (1.f - ao);
        dh_pass = 0.f;
        dc_pass = dcn * af;
      } else {
        dh_pass = dh;
      }
      float* o = dxp + ((size_t)t * B + cb) * G + cu;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        o[g * H] = dg[g];
        dg_s[(size_t)(g * hb + cj) * s.Bp + cb] = dg[g];
      }
    }
    if (step + 1 == T) break;
    // the next step's saved values, in flight through this step's product
    // and exchange
    cur = load_saved(step + 1);
    __syncthreads();

    // partial dh of every unit of the lane from my columns, then out. A
    // thread takes units j and j + Hh for 8 batch rows at a time. Reads
    // past Bp rows (or past unit H - 1 when H is odd) stay inside shared
    // memory and feed only sums that are never stored.
    const int par = step & 1;
    const int Hh = (H + 1) / 2;
    for (int item = tid; item < Hh * ks; item += kThreads) {
      const int j = item % Hh, chunk = item / Hh, j2 = j + Hh;
      const int k_lo = chunk * s.kc;
      for (int b0 = 0; b0 < B; b0 += kTileB) {
        float acc[2][kTileB];
#pragma unroll
        for (int q = 0; q < kTileB; ++q) acc[0][q] = acc[1][q] = 0.f;
#pragma unroll 4
        for (int k = k_lo; k < k_lo + s.kc; ++k) {
          const float w[2] = {w_s[(size_t)k * H + j],
                              w_s[(size_t)k * H + j2]};
          const float4* d =
              reinterpret_cast<const float4*>(dg_s + (size_t)k * s.Bp + b0);
          const float4 d0 = d[0], d1 = d[1];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            acc[c][0] = fmaf(d0.x, w[c], acc[c][0]);
            acc[c][1] = fmaf(d0.y, w[c], acc[c][1]);
            acc[c][2] = fmaf(d0.z, w[c], acc[c][2]);
            acc[c][3] = fmaf(d0.w, w[c], acc[c][3]);
            acc[c][4] = fmaf(d1.x, w[c], acc[c][4]);
            acc[c][5] = fmaf(d1.y, w[c], acc[c][5]);
            acc[c][6] = fmaf(d1.z, w[c], acc[c][6]);
            acc[c][7] = fmaf(d1.w, w[c], acc[c][7]);
          }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int u = c ? j2 : j;
          if (u >= H) continue;
#pragma unroll
          for (int q4 = 0; q4 < kTileB / 4; ++q4) {
            if (b0 + 4 * q4 >= B) continue;
            const float4 v =
                make_float4(acc[c][4 * q4], acc[c][4 * q4 + 1],
                            acc[c][4 * q4 + 2], acc[c][4 * q4 + 3]);
            if (ks == 1)
              send4(par, u, b0 + 4 * q4, v);
            else
              *reinterpret_cast<float4*>(
                  part_s + ((size_t)chunk * H + u) * s.Bp + b0 + 4 * q4) = v;
          }
        }
      }
    }
    if (ks > 1) {
      __syncthreads();
      const int Q = s.Bp / 4;
      for (int e = tid; e < H * Q; e += kThreads) {
        const float4* src =
            reinterpret_cast<const float4*>(part_s) + e;   // (j, b/4)
        float4 v = src[0];
        for (int c = 1; c < ks; ++c) {
          const float4 w = src[(size_t)c * H * Q];
          v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
        }
        send4(par, e / Q, 4 * (e % Q), v);
      }
    }
    if constexpr (kCluster) {
      cluster_arrive();
    } else {
      __syncthreads();
      lane_arrive(p.arrived + lane);
    }
  }
}

}  // namespace

extern "C" {

using Kernel = void (*)(const Params);

Kernel kernel_for(bool cluster) {
  return cluster ? lstm_recurrence_bwd_kernel<true>
                 : lstm_recurrence_bwd_kernel<false>;
}

// The current device's limits for the plan (lstm_sync.cuh), with the
// registers of the grid-route kernel. Returns a CUDA error code.
int lstm_recurrence_bwd_limits(int* sms, int* smem_block, int* smem_sm,
                               int* regs_grid) {
  return lstm_card_limits(kernel_for(false), sms, smem_block, smem_sm,
                          regs_grid);
}

// Clusters of n_cta CTAs of the cluster-route kernel for (B, H, hb, ks)
// that the current device holds at once, in *n_clusters (0: none fits).
// Returns 0.
int lstm_recurrence_bwd_clusters(int B, int H, int hb, int ks, int n_cta,
                                 int* n_clusters) {
  const Layout s = make_layout(B, H, hb, ks, n_cta, true);
  return lstm_active_clusters(kernel_for(true), n_cta, kThreads, s.bytes,
                              n_clusters);
}

// Launches the backward on `stream` by the route of the wrapper's plan:
// `cluster` non-zero for one cluster of n_cta CTAs per lane, else the
// cooperative grid with `part` and the zeroed `arrived`. Returns
// cudaGetLastError() after the launch (0 on success).
int lstm_recurrence_bwd_launch(const float* dout, const float* act,
                               const float* cs, const float* mask,
                               const float* wh, float* dxp, float* part,
                               unsigned* arrived, int L, int T, int B, int H,
                               long long mask_lane_stride,
                               unsigned long long reverse_bits, int cluster,
                               int n_cta, int hb, int ks, void* stream) {
  if (B * hb > kThreads || n_cta * hb < H || ks < 1 || L < 1 || L > 64)
    return (int)cudaErrorInvalidValue;
  const Layout s = make_layout(B, H, hb, ks, n_cta, cluster != 0);
  Params p;
  p.dout = dout; p.act = act; p.cs = cs; p.mask = mask; p.wh = wh;
  p.dxp = dxp; p.part = part; p.arrived = arrived;
  p.L = L; p.T = T; p.B = B; p.H = H; p.hb = hb; p.ks = ks; p.n_cta = n_cta;
  p.mask_lane_stride = mask_lane_stride;
  p.reverse_bits = reverse_bits;
  return lstm_launch(kernel_for(cluster != 0), p, cluster != 0, n_cta,
                     L * n_cta, kThreads, s.bytes, (cudaStream_t)stream);
}

const char* radmmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
