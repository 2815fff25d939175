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
// What bounds it: as in the forward, a chain of T dependent steps, each a
// (B,4H)x(4H,H) product whose input is the whole dgates of the step before,
// so latency is the limit (the spread of dgates to every block and the
// barrier), not FLOPs or bytes; each step moves 4x the forward's h through
// L2 (B*4H floats instead of B*H).
//
// Design: the forward's layout. The grid is L * ceil(H / hb) blocks; each
// block owns one lane and hb hidden units, keeps the Wh rows of those units
// (hb x 4H) in shared memory for the whole run, and carries their dh/dc in
// registers. At each step it reads the previous step's dgates of its lane
// (B x 4H) with __ldcg from the output tensor itself (each step writes its
// own row of dx_proj, so no extra buffer is needed), reduces them against
// its Wh rows (threads split the 4H reduction, partial sums meet in shared
// memory), updates its cells, writes their four dgates and meets every
// other block at a grid-wide barrier (cooperative launch).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTileB = 8;

struct Layout {
  int ks;      // threads sharing one unit's 4H reduction
  int kc;      // reduction chunk per thread, a multiple of 4
  int gp;      // padded 4H: ks * kc
  size_t w_off, dg_off, part_off, bytes;
};

__host__ __device__ inline Layout make_layout(int H, int B, int hb) {
  Layout s;
  s.ks = kThreads / hb;
  const int G = 4 * H;
  int kc = (G + s.ks - 1) / s.ks;
  s.kc = (kc + 3) / 4 * 4;
  s.gp = s.kc * s.ks;
  s.w_off = 0;                                         // gp x hb   Wh rows
  s.dg_off = s.w_off + (size_t)s.gp * hb;              // B x gp    dgates
  s.part_off = s.dg_off + (size_t)B * s.gp;            // ks x B x hb
  s.bytes = (s.part_off + (size_t)s.ks * B * hb) * sizeof(float);
  return s;
}

struct Params {
  const float* dout;   // (L, T, B, H)
  const float* act;    // (L, T, B, 4H) i, f, g, o activations
  const float* cs;     // (L, T, B, H) carried c after each step
  const float* mask;   // (T, B), or (L, T, B) with mask_lane_stride = T*B
  const float* wh;     // (L, H, 4H)
  float* dxp;          // (L, T, B, 4H) out: dgates
  int L, T, B, H, hb, blocks_per_lane;
  long long mask_lane_stride;
  unsigned long long reverse_bits;
};

__global__ void __launch_bounds__(kThreads)
lstm_recurrence_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();

  const int H = p.H, B = p.B, T = p.T, G = 4 * H, hb = p.hb;
  const Layout s = make_layout(H, B, hb);
  const int lane = blockIdx.x / p.blocks_per_lane;
  const int j0 = (blockIdx.x % p.blocks_per_lane) * hb;
  const bool rev = (p.reverse_bits >> lane) & 1ULL;

  float* w_s = smem + s.w_off;
  float* dg_s = smem + s.dg_off;
  float* part_s = smem + s.part_off;

  // Wh rows of this block's units: w_s[k * hb + c] = Wh[j0 + c, k]
  const float* wh = p.wh + (size_t)lane * H * G;
  for (int i = threadIdx.x; i < s.gp * hb; i += kThreads) {
    const int k = i / hb, u = j0 + i % hb;
    w_s[i] = (k < G && u < H) ? wh[(size_t)u * G + k] : 0.f;
  }

  const float* dout = p.dout + (size_t)lane * T * B * H;
  const float* act = p.act + (size_t)lane * T * B * G;
  const float* cs = p.cs + (size_t)lane * T * B * H;
  const float* mk = p.mask + (size_t)lane * p.mask_lane_stride;
  float* dxp = p.dxp + (size_t)lane * T * B * G;

  const int col = threadIdx.x % hb;     // unit this thread reduces for
  const int ks_me = threadIdx.x / hb;   // and its chunk of the 4H reduction
  const int k_lo = ks_me * s.kc;
  const int cb = threadIdx.x / hb, cj = threadIdx.x % hb, cu = j0 + cj;
  const bool owns_cell = threadIdx.x < B * hb && cu < H;
  float dh_pass = 0.f, dc_pass = 0.f;

  for (int step = 0; step < T; ++step) {
    // the forward's step T-1-step; its neighbours in the forward's order
    const int t = rev ? step : T - 1 - step;
    const int t_next = rev ? t - 1 : t + 1;   // processed one step ago
    const int t_prev = rev ? t + 1 : t - 1;   // c before this step
    const bool first = rev ? t == T - 1 : t == 0;

    // this step's saved forward values, off the dgates dependency chain
    float a[4] = {0.f, 0.f, 0.f, 0.f}, c_new = 0.f, c_prev = 0.f;
    float d_out = 0.f, m = 0.f;
    if (owns_cell) {
      const size_t cell = (size_t)t * B + cb;
      m = mk[cell];
      if (m > 0.f) {
#pragma unroll
        for (int g = 0; g < 4; ++g) a[g] = act[cell * G + g * H + cu];
        c_new = cs[cell * H + cu];
        if (!first) c_prev = cs[((size_t)t_prev * B + cb) * H + cu];
        d_out = dout[cell * H + cu];
      }
    }

    // dgates of the step processed before (zero at the first); written by
    // other SMs, so read past the incoherent L1
    for (int i = threadIdx.x; i < B * s.gp; i += kThreads) {
      const int b = i / s.gp, k = i % s.gp;
      dg_s[i] = (step > 0 && k < G)
                    ? __ldcg(dxp + ((size_t)t_next * B + b) * G + k) : 0.f;
    }
    __syncthreads();

    for (int b0 = 0; b0 < B; b0 += kTileB) {
      float acc[kTileB];
#pragma unroll
      for (int q = 0; q < kTileB; ++q) acc[q] = 0.f;
      for (int k = k_lo; k < k_lo + s.kc; k += 4) {
        const float w0 = w_s[(k + 0) * hb + col];
        const float w1 = w_s[(k + 1) * hb + col];
        const float w2 = w_s[(k + 2) * hb + col];
        const float w3 = w_s[(k + 3) * hb + col];
#pragma unroll
        for (int q = 0; q < kTileB; ++q) {
          if (b0 + q < B) {
            const float4 d = *reinterpret_cast<const float4*>(
                dg_s + (size_t)(b0 + q) * s.gp + k);
            acc[q] = fmaf(d.x, w0, acc[q]);
            acc[q] = fmaf(d.y, w1, acc[q]);
            acc[q] = fmaf(d.z, w2, acc[q]);
            acc[q] = fmaf(d.w, w3, acc[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kTileB; ++q)
        if (b0 + q < B)
          part_s[((size_t)ks_me * B + b0 + q) * hb + col] = acc[q];
    }
    __syncthreads();

    if (owns_cell) {
      float rec = 0.f;
      for (int q = 0; q < s.ks; ++q)
        rec += part_s[((size_t)q * B + cb) * hb + cj];
      const float dh = dh_pass + rec;
      float dg[4] = {0.f, 0.f, 0.f, 0.f};
      if (m > 0.f) {
        const float ai = a[0], af = a[1], ag = a[2], ao = a[3];
        const float dhn = dh + d_out * m;
        const float tc = tanhf(c_new);
        const float dcn = dc_pass + dhn * ao * (1.f - tc * tc);
        dg[0] = dcn * ag * ai * (1.f - ai);
        dg[1] = dcn * c_prev * af * (1.f - af);
        dg[2] = dcn * ai * (1.f - ag * ag);
        dg[3] = dhn * tc * ao * (1.f - ao);
        dh_pass = 0.f;
        dc_pass = dcn * af;
      } else {
        dh_pass = dh;
      }
      float* o = dxp + ((size_t)t * B + cb) * G + cu;
#pragma unroll
      for (int g = 0; g < 4; ++g) o[g * H] = dg[g];
    }
    grid.sync();   // orders this step's dgates before the next step's reads
  }
}

}  // namespace

extern "C" {

// Co-resident blocks of the kernel on the current device for slice width
// hb, in *capacity. Returns a CUDA error code (non-zero when the slice's
// shared memory does not fit a block).
int lstm_recurrence_bwd_capacity(int B, int H, int hb, int* capacity) {
  const Layout s = make_layout(H, B, hb);
  cudaError_t e = cudaFuncSetAttribute(
      lstm_recurrence_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s.bytes);
  if (e != cudaSuccess) { cudaGetLastError(); return (int)e; }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lstm_recurrence_bwd_kernel, kThreads, s.bytes))
      != cudaSuccess)
    return (int)e;
  *capacity = per_sm * sms;
  return 0;
}

// Launches the backward on `stream`. Returns cudaGetLastError() after the
// launch (0 on success).
int lstm_recurrence_bwd_launch(const float* dout, const float* act,
                               const float* cs, const float* mask,
                               const float* wh, float* dxp, int L, int T,
                               int B, int H, long long mask_lane_stride,
                               unsigned long long reverse_bits, int hb,
                               void* stream) {
  const Layout s = make_layout(H, B, hb);
  Params p;
  p.dout = dout; p.act = act; p.cs = cs; p.mask = mask; p.wh = wh;
  p.dxp = dxp;
  p.L = L; p.T = T; p.B = B; p.H = H; p.hb = hb;
  p.blocks_per_lane = (H + hb - 1) / hb;
  p.mask_lane_stride = mask_lane_stride;
  p.reverse_bits = reverse_bits;
  cudaError_t e = cudaFuncSetAttribute(
      lstm_recurrence_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s.bytes);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)lstm_recurrence_bwd_kernel,
                                  dim3(L * p.blocks_per_lane), dim3(kThreads),
                                  args, s.bytes, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* radmmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
