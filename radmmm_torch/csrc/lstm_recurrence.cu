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
// What bounds it: a chain of T dependent steps, each a (B,H)x(H,4H) product
// whose input is the whole h of the step before. At serving batch sizes
// (B = 1..8) the product is a few hundred kFLOP, so neither the card's
// FLOP rate nor its memory bandwidth is the limit: latency is, the per-step
// cost of spreading h to every block that needs it and of the barrier that
// orders the steps. Wh does not fit one SM (1.08 MB at H = 260, 4.46 MB at
// H = 528, in f32).
//
// Design: the grid is L * ceil(H / hb) blocks. Each block owns one lane and
// a slice of hb hidden units with all four of their gate columns; it keeps
// that Wh slice in shared memory for the whole run and the slice's cell
// state in shared memory. At every step a block reads the previous h of
// its lane (B*H floats) from a global double buffer that stays in L2,
// computes its 4*hb gate columns for all B rows with f32 FMAs on the CUDA
// cores (threads split the H reduction into ks chunks, partial sums meet in
// shared memory), updates its units, writes their h into the other half of
// the buffer and meets every other block at a grid-wide barrier
// (cooperative launch, cg::this_grid().sync()). The launch is cooperative,
// so it fails rather than deadlocks when the grid cannot be co-resident;
// the wrapper picks hb so that it is. No tensor cores: the product is too
// thin at these batch sizes to feed them.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTileB = 8;   // batch rows a thread accumulates at once

struct Layout {
  int nc;      // gate columns per block: 4 * hb
  int ks;      // threads sharing one column's H reduction
  int kc;      // reduction chunk per thread, a multiple of 4
  int hp;      // padded H: ks * kc
  size_t w_off, h_off, part_off, c_off, bytes;
};

__host__ __device__ inline Layout make_layout(int H, int B, int hb) {
  Layout s;
  s.nc = 4 * hb;
  s.ks = kThreads / s.nc;
  int kc = (H + s.ks - 1) / s.ks;
  s.kc = (kc + 3) / 4 * 4;
  s.hp = s.kc * s.ks;
  s.w_off = 0;                                         // hp x nc   Wh slice
  s.h_off = s.w_off + (size_t)s.hp * s.nc;             // B x hp    h of t-1
  s.part_off = s.h_off + (size_t)B * s.hp;             // ks x B x nc
  s.c_off = s.part_off + (size_t)s.ks * B * s.nc;      // B x hb    cell
  s.bytes = (s.c_off + (size_t)B * hb) * sizeof(float);
  return s;
}

struct Params {
  const float* xp;     // (L, T, B, 4H)
  const float* mask;   // (T, B), or (L, T, B) with mask_lane_stride = T*B
  const float* wh;     // (L, H, 4H)
  float* out;          // (L, T, B, H)
  float* hbuf;         // (2, L, B, H) scratch
  float* act;          // (L, T, B, 4H) gate activations, or null
  float* cs;           // (L, T, B, H) carried c after each step, or null
  float* hs;           // (L, T, B, H) carried h after each step, or null
  int L, T, B, H, hb, blocks_per_lane;
  long long mask_lane_stride;
  unsigned long long reverse_bits;
};

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kThreads)
lstm_recurrence_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();

  const int H = p.H, B = p.B, T = p.T, G = 4 * H, hb = p.hb;
  const Layout s = make_layout(H, B, hb);
  const int nc = s.nc;
  const int lane = blockIdx.x / p.blocks_per_lane;
  const int j0 = (blockIdx.x % p.blocks_per_lane) * hb;
  const bool rev = (p.reverse_bits >> lane) & 1ULL;

  float* w_s = smem + s.w_off;
  float* h_s = smem + s.h_off;
  float* part_s = smem + s.part_off;
  float* c_s = smem + s.c_off;

  // this block's Wh columns: local column c = gate * hb + j holds global
  // column gate * H + j0 + j; rows past H and units past H are zero
  const float* wh = p.wh + (size_t)lane * H * G;
  for (int i = threadIdx.x; i < s.hp * nc; i += kThreads) {
    const int k = i / nc, c = i % nc, u = j0 + c % hb;
    w_s[i] = (k < H && u < H) ? wh[(size_t)k * G + (c / hb) * H + u] : 0.f;
  }
  for (int i = threadIdx.x; i < B * hb; i += kThreads) c_s[i] = 0.f;

  const float* xp = p.xp + (size_t)lane * T * B * G;
  const float* mk = p.mask + (size_t)lane * p.mask_lane_stride;
  float* out = p.out + (size_t)lane * T * B * H;

  const int col = threadIdx.x % nc;     // gate column this thread reduces
  const int ks_me = threadIdx.x / nc;   // and its chunk of the H reduction
  const int k_lo = ks_me * s.kc;
  // one cell (b, j) per thread: the wrapper guarantees B * hb <= kThreads
  const int cb = threadIdx.x / hb, cj = threadIdx.x % hb, cu = j0 + cj;
  const bool owns_cell = threadIdx.x < B * hb && cu < H;

  for (int step = 0; step < T; ++step) {
    const int t = rev ? T - 1 - step : step;
    const float* hin = p.hbuf + ((size_t)(step & 1) * p.L + lane) * B * H;
    float* hout = p.hbuf + ((size_t)((step + 1) & 1) * p.L + lane) * B * H;

    // issue this step's x_proj and mask reads early; they are not on the
    // h dependency chain
    float xg[4] = {0.f, 0.f, 0.f, 0.f};
    float m = 0.f;
    if (owns_cell) {
      const float* xr = xp + ((size_t)t * B + cb) * G + cu;
#pragma unroll
      for (int g = 0; g < 4; ++g) xg[g] = xr[g * H];
      m = mk[(size_t)t * B + cb];
    }

    // h of step t-1 (zero at the first step); __ldcg skips the incoherent
    // L1, the buffer was written by other SMs
    for (int i = threadIdx.x; i < B * s.hp; i += kThreads) {
      const int b = i / s.hp, k = i % s.hp;
      h_s[i] = (step > 0 && k < H) ? __ldcg(hin + (size_t)b * H + k) : 0.f;
    }
    __syncthreads();

    for (int b0 = 0; b0 < B; b0 += kTileB) {
      float acc[kTileB];
#pragma unroll
      for (int q = 0; q < kTileB; ++q) acc[q] = 0.f;
      for (int k = k_lo; k < k_lo + s.kc; k += 4) {
        const float w0 = w_s[(k + 0) * nc + col];
        const float w1 = w_s[(k + 1) * nc + col];
        const float w2 = w_s[(k + 2) * nc + col];
        const float w3 = w_s[(k + 3) * nc + col];
#pragma unroll
        for (int q = 0; q < kTileB; ++q) {
          if (b0 + q < B) {
            const float4 hv = *reinterpret_cast<const float4*>(
                h_s + (size_t)(b0 + q) * s.hp + k);
            acc[q] = fmaf(hv.x, w0, acc[q]);
            acc[q] = fmaf(hv.y, w1, acc[q]);
            acc[q] = fmaf(hv.z, w2, acc[q]);
            acc[q] = fmaf(hv.w, w3, acc[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kTileB; ++q)
        if (b0 + q < B)
          part_s[((size_t)ks_me * B + b0 + q) * nc + col] = acc[q];
    }
    __syncthreads();

    if (owns_cell) {
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float acc = 0.f;
        for (int q = 0; q < s.ks; ++q)
          acc += part_s[((size_t)q * B + cb) * nc + g * hb + cj];
        gate[g] = xg[g] + acc;
      }
      const float c_old = c_s[threadIdx.x];
      const float ai = sigmoidf_(gate[0]), af = sigmoidf_(gate[1]);
      const float ag = tanhf(gate[2]), ao = sigmoidf_(gate[3]);
      const float c_new = af * c_old + ai * ag;
      const float h_new = ao * tanhf(c_new);
      const bool keep = m > 0.f;
      const float c_keep = keep ? c_new : c_old;
      const float h_keep = keep ? h_new : h_s[(size_t)cb * s.hp + cu];
      c_s[threadIdx.x] = c_keep;
      hout[(size_t)cb * H + cu] = h_keep;
      const size_t cell = ((size_t)lane * T + t) * B + cb;
      out[((size_t)t * B + cb) * H + cu] = h_new * m;
      if (p.act) {
        float* a = p.act + cell * G + cu;
        a[0] = ai; a[H] = af; a[2 * H] = ag; a[3 * H] = ao;
        p.cs[cell * H + cu] = c_keep;
        p.hs[cell * H + cu] = h_keep;
      }
    }
    grid.sync();   // orders this step's h writes before the next step's reads
  }
}

}  // namespace

extern "C" {

// Co-resident blocks of the kernel on the current device for slice width
// hb, in *capacity. Returns a CUDA error code (non-zero when the slice's
// shared memory does not fit a block).
int lstm_recurrence_capacity(int B, int H, int hb, int* capacity) {
  const Layout s = make_layout(H, B, hb);
  cudaError_t e = cudaFuncSetAttribute(
      lstm_recurrence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s.bytes);
  if (e != cudaSuccess) { cudaGetLastError(); return (int)e; }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lstm_recurrence_kernel, kThreads, s.bytes)) != cudaSuccess)
    return (int)e;
  *capacity = per_sm * sms;
  return 0;
}

// Launches the recurrence on `stream`. Returns cudaGetLastError() after the
// launch (0 on success).
// act, cs and hs are null when serving, all three set when training.
int lstm_recurrence_launch(const float* xp, const float* mask, const float* wh,
                           float* out, float* hbuf, float* act, float* cs,
                           float* hs, int L, int T, int B, int H,
                           long long mask_lane_stride,
                           unsigned long long reverse_bits, int hb,
                           void* stream) {
  const Layout s = make_layout(H, B, hb);
  Params p;
  p.xp = xp; p.mask = mask; p.wh = wh; p.out = out; p.hbuf = hbuf;
  p.act = act; p.cs = cs; p.hs = hs;
  p.L = L; p.T = T; p.B = B; p.H = H; p.hb = hb;
  p.blocks_per_lane = (H + hb - 1) / hb;
  p.mask_lane_stride = mask_lane_stride;
  p.reverse_bits = reverse_bits;
  cudaError_t e = cudaFuncSetAttribute(
      lstm_recurrence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s.bytes);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)lstm_recurrence_kernel,
                                  dim3(L * p.blocks_per_lane), dim3(kThreads),
                                  args, s.bytes, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* radmmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
