// The masked multi-lane LSTM recurrence and its backward in bf16, for
// Hopper (sm_90a): the per-step products on the tensor cores.
//
// Replaces the TPU kernel radmmm_tpu/ops/lstm_pallas.py::_lstm_kernel at
// Precision.DEFAULT (the JAX package's conv_precision "bf16"), whose
// recurrent dot jnp.dot(h, wh) takes bf16 operands with f32 sums on the
// matrix unit, and the backward of that dot, which JAX differentiates
// through lax.scan at the same precision. It computes what the f32 kernels
// (lstm_recurrence.cu, lstm_recurrence_bwd.cu) compute, with both operands
// of h @ Wh (forward) and dgates @ Wh^T (backward) rounded to bf16 (ties to
// even) and f32 sums: see those files for the recurrences, the routes
// (a thread-block cluster per lane, or the cooperative grid with a barrier
// per lane) and the exchanges. The gates, c, the carried h and every
// output stay f32. The plain twins are ops/lstm_kernel.py's
// lstm_recurrence_reference and lstm_recurrence_backward_reference with
// bf16.
//
// What bounds it: latency, as the f32 kernels. A lane is a chain of T
// dependent steps; a step is a thin product (B <= 8 rows), the exchange of
// its result between the lane's CTAs and the barrier that orders the steps.
// The design takes the product off the chain's CUDA cores:
//
// - mma.sync m16n8k16 (bf16 in, f32 sums). Forward, per CTA and step:
//   gates^T (nc x Bp) = Wh_slice^T (nc x H) . h^T (H x Bp), M the CTA's
//   nc = 4 hb gate columns, N = 8 batch rows (B < 8 pads to 8, B > 8 takes
//   more N tiles), K = H. Backward: dh^T (H x Bp) = Wh_slice (H x nc) .
//   dgates^T (nc x Bp), M = H, K = nc. Rows past H, past nc and past the
//   CTA's units are zero.
// - The A operand (the CTA's Wh slice) is constant for the whole run: each
//   warp builds its A fragments once, before the time loop, rounded to
//   bf16, the first kRegSlots of a thread in registers (4 x 32 bits each),
//   the rest in shared memory in fragment order, 16 bytes a lane, read back
//   conflict-free. kRegSlots is 2 by measurement (an H100, the model's
//   shapes): 24 slots, enough for every fragment of a warp at H <= 260,
//   took 168 registers a thread with spills and cost 0.3-0.6 us a step
//   more than 8 (120 registers); 4 (101) and 2 were faster still, and the
//   fragments read from shared memory cost no time that showed.
// - The B operand is bf16 in shared memory, K-major rows of 8 (16 bytes),
//   read with ldmatrix.trans. Forward: the CTA that owns a unit rounds its
//   new h once, as it writes it for the exchange, so the exchange moves
//   half the f32 kernel's bytes (the cluster's DSMEM stores, the grid's L2
//   buffer); the owner keeps its cell's f32 h in a register for the masked
//   frames, out and the saved hs. Backward: the CTA rounds its dgates once
//   as it stores them for the product.
// - The 12 warps split the product as wm x wk (M x K); the forward's wk
//   partial tiles meet in shared memory, the backward takes wk = 1 and each
//   warp sends its dh partials, as float4 rows (a shuffle pairs two lanes'
//   halves), to their owners.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
// A fragments a thread keeps in registers (4 registers each), and M tiles a
// warp takes at once (its accumulators): ops/lstm_kernel.py mirrors both
constexpr int kRegSlots = 2;
constexpr int kMaxM = 3;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// How the warps tile one CTA's product of M x K tiles of 16 x 16: wm x wk
// warps, warp (gm, gk) the M tiles gm + i wm (max_m at a time, in npass
// passes) and the K tiles gk + i wk (kpw at most); `slots` A fragments a
// warp keeps in shared memory. ops/lstm_kernel.py::_bf16_tiling mirrors it.
struct Tiling {
  int M, K, wk, wm, kpw, max_m, npass, slots;
};

__host__ __device__ inline Tiling make_tiling(int M, int K, int wk) {
  Tiling t;
  t.M = M; t.K = K; t.wk = wk; t.wm = kWarps / wk;
  const int mpw = cdiv(M, t.wm);
  t.kpw = cdiv(K, wk);
  t.max_m = imin(mpw, kMaxM);
  t.npass = cdiv(mpw, t.max_m);
  t.slots = (t.npass * t.kpw - imin(t.kpw, kRegSlots / t.max_m)) * t.max_m;
  return t;
}

// shared memory of one forward CTA, in bytes, each part on a 16-byte
// boundary; ops/lstm_kernel.py::_fwd_smem_bf16 mirrors the count
struct FwdLayout {
  Tiling t;
  int NT;              // N tiles: batch rows in eights
  int hr;              // rows (units) of an h buffer: max(16 K, n_cta hb)
  size_t h_off, part_off, bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int B, int H, int hb, int ks,
                                                int n_cta, bool cluster) {
  FwdLayout s;
  s.t = make_tiling(cdiv(4 * hb, 16), cdiv(H, 16), ks);
  s.NT = cdiv(B, 8);
  s.hr = imax(16 * s.t.K, n_cta * hb);
  // kWarps x slots x 32 lanes x 16 B   A fragments past the registers
  s.h_off = (size_t)kWarps * s.t.slots * 512;
  // (2|1) x NT x hr x 8 bf16            h, the cluster's double buffer
  s.part_off = s.h_off + (size_t)(cluster ? 2 : 1) * s.NT * s.hr * 16;
  // wk x NT x 8 x (16 M + 4) f32       the warps' partial gate tiles
  s.bytes = s.part_off + (size_t)ks * s.NT * 8 * (s.t.M * 16 + 4) * 4;
  return s;
}

// shared memory of one backward CTA, in bytes; ops/lstm_kernel.py::
// _bwd_smem_bf16 mirrors the count
struct BwdLayout {
  Tiling t;
  int NT;
  size_t dg_off, rx_off, bytes;
};

__host__ __device__ inline BwdLayout bwd_layout(int B, int H, int hb,
                                                int n_cta, bool cluster) {
  BwdLayout s;
  s.t = make_tiling(cdiv(H, 16), cdiv(4 * hb, 16), 1);
  s.NT = cdiv(B, 8);
  s.dg_off = (size_t)kWarps * s.t.slots * 512;        // A fragments
  s.rx_off = s.dg_off + (size_t)s.NT * s.t.K * 16 * 16;   // NT x 16 K x 8
                                                          // bf16 dgates
  // cluster: 2 x n_cta x hb x 8 NT f32 partials received; grid: the
  // gather's sums
  s.bytes = s.rx_off + 4 * (cluster ? (size_t)2 * n_cta * hb * s.NT * 8
                                    : (size_t)kThreads);
  return s;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the B fragment of k16 x n8 from 16 K-major rows of 8 bf16 at `rows`
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[2],
                                       const __nv_bfloat16* rows, int wl) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(rows + (wl & 15) * 8);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b[0]), "r"(b[1]));
}

// One warp's share of a CTA's product: its A fragments (the first
// kRegSlots in registers, the rest in shared memory) and the tiles they
// cover.
template <int kM>
struct WarpTiles {
  static constexpr int kRegK = kRegSlots / kM;
  uint4 reg[kRegK > 0 ? kRegK : 1][kM];   // [kRegK][kM]
  int gm, gk, nk;      // first M tile, first K tile, K tiles of the warp
  uint4* slot;         // its fragments in shared memory, at lane 0

  __device__ int m_tile(const Tiling& t, int pass, int im) const {
    return gm + (pass * kM + im) * t.wm;
  }
  __device__ int k_tile(const Tiling& t, int ik) const {
    return gk + ik * t.wk;
  }
  // the shared-memory slot of (pass, ik, im), where it is not a register
  __device__ int slot_of(const Tiling& t, int pass, int ik, int im) const {
    const int first = imax(t.kpw - kRegK, 0);
    return (pass == 0 ? ik - kRegK : first + (pass - 1) * t.kpw + ik) * kM
           + im;
  }

  // Each fragment of the warp from a_at(row, col), rounded to bf16, in the
  // m16n8k16 A layout: a thread holds rows g, g + 8 and columns 2t, 2t + 1,
  // 2t + 8, 2t + 9 of its tile (g = lane / 4, t = lane % 4).
  template <typename At>
  __device__ void load(const Tiling& t, int warp, int wl, uint4* frag_s,
                       At a_at) {
    gm = warp % t.wm;
    gk = warp / t.wm;
    nk = gk < t.K ? cdiv(t.K - gk, t.wk) : 0;
    slot = frag_s + (size_t)warp * t.slots * 32;
    auto frag = [&](int mt, int kt) {
      const int r = mt * 16 + (wl >> 2), c = kt * 16 + 2 * (wl & 3);
      return make_uint4(pack_bf16(a_at(r, c), a_at(r, c + 1)),
                        pack_bf16(a_at(r + 8, c), a_at(r + 8, c + 1)),
                        pack_bf16(a_at(r, c + 8), a_at(r, c + 9)),
                        pack_bf16(a_at(r + 8, c + 8), a_at(r + 8, c + 9)));
    };
#pragma unroll
    for (int ik = 0; ik < kRegK; ++ik)
#pragma unroll
      for (int im = 0; im < kM; ++im) {
        const int mt = m_tile(t, 0, im);
        reg[ik][im] = ik < nk && mt < t.M ? frag(mt, k_tile(t, ik))
                                          : make_uint4(0, 0, 0, 0);
      }
    for (int pass = 0; pass < t.npass; ++pass)
      for (int ik = pass == 0 ? kRegK : 0; ik < nk; ++ik)
        for (int im = 0; im < kM; ++im) {
          const int mt = m_tile(t, pass, im);
          if (mt < t.M)
            slot[slot_of(t, pass, ik, im) * 32 + wl] = frag(mt, k_tile(t, ik));
        }
  }

  // The warp's product with the B operand at `rows` (K-major rows of 8
  // bf16): store(mt, d) for each of its M tiles, d the m16n8 f32 tile (rows
  // g, g + 8, columns 2t, 2t + 1). Warps without K tiles store zeros.
  template <typename Store>
  __device__ void product(const Tiling& t, const __nv_bfloat16* rows, int wl,
                          Store store) const {
    for (int pass = 0; pass < t.npass; ++pass) {
      float acc[kM][4];
#pragma unroll
      for (int im = 0; im < kM; ++im)
        acc[im][0] = acc[im][1] = acc[im][2] = acc[im][3] = 0.f;
      bool ok[kM];
#pragma unroll
      for (int im = 0; im < kM; ++im) ok[im] = m_tile(t, pass, im) < t.M;
      if (pass == 0) {
#pragma unroll
        for (int ik = 0; ik < kRegK; ++ik) {
          if (ik < nk) {
            uint32_t b[2];
            ldsm_b(b, rows + (size_t)k_tile(t, ik) * 16 * 8, wl);
#pragma unroll
            for (int im = 0; im < kM; ++im)
              if (ok[im]) mma_bf16(acc[im], reg[ik][im], b);
          }
        }
      }
      for (int ik = pass == 0 ? kRegK : 0; ik < nk; ++ik) {
        uint32_t b[2];
        ldsm_b(b, rows + (size_t)k_tile(t, ik) * 16 * 8, wl);
#pragma unroll
        for (int im = 0; im < kM; ++im)
          if (ok[im])
            mma_bf16(acc[im], slot[slot_of(t, pass, ik, im) * 32 + wl], b);
      }
#pragma unroll
      for (int im = 0; im < kM; ++im)
        if (ok[im]) store(m_tile(t, pass, im), acc[im]);
    }
  }
};

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

struct FwdParams {
  const float* xp;     // (L, T, B, 4H)
  const float* mask;   // (T, B), or (L, T, B) with mask_lane_stride = T*B
  const float* wh;     // (L, H, 4H)
  float* out;          // (L, T, B, H)
  float* act;          // (L, T, B, 4H) gate activations, or null
  float* cs;           // (L, T, B, H) carried c after each step, or null
  float* hs;           // (L, T, B, H) carried h after each step, or null
  __nv_bfloat16* hbuf; // grid: (2, L, NT, H, 8) zeroed; cluster: null
  unsigned* arrived;   // grid: (L,) zeroed counters; cluster: null
  int L, T, B, H, hb, ks, n_cta;
  long long mask_lane_stride;
  unsigned long long reverse_bits;
};

template <bool kCluster, int kM>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bf16_fwd_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, B = p.B, T = p.T, G = 4 * H, hb = p.hb, nc = 4 * hb;
  const int n_cta = p.n_cta, tid = threadIdx.x, wl = tid & 31;
  const FwdLayout s = fwd_layout(B, H, hb, p.ks, n_cta, kCluster);
  const Tiling& tl = s.t;
  // a partial tile's rows: one a batch row, its columns the gate columns,
  // 4 past them so that the m16n8 stores meet no bank twice
  const int NT = s.NT, hr = s.hr, Mr = 16 * tl.M + 4;
  const int lane = blockIdx.x / n_cta;
  const int rank = blockIdx.x % n_cta;    // the cluster rank on that route
  const int j0 = rank * hb;
  const bool rev = (p.reverse_bits >> lane) & 1ULL;
  const size_t hsize = (size_t)NT * hr * 8;

  uint4* frag_s = reinterpret_cast<uint4*>(smem);
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem + s.h_off);
  float* part_s = reinterpret_cast<float*>(smem + s.part_off);

  // A = this CTA's Wh columns, transposed: row c = gate * hb + j holds
  // global column gate * H + j0 + j, column k unit k of h
  const float* wh = p.wh + (size_t)lane * H * G;
  WarpTiles<kM> w;
  w.load(tl, tid >> 5, wl, frag_s, [&](int c, int k) {
    const int u = j0 + c % hb;
    return (c < nc && k < H && u < H) ? wh[(size_t)k * G + (c / hb) * H + u]
                                      : 0.f;
  });
  // h before the first step, and the padding (rows past B, units past H)
  // that feeds only sums never stored or products with zero Wh, stays zero
  uint4* h4 = reinterpret_cast<uint4*>(h_s);
  for (size_t i = tid; i < (kCluster ? 2 : 1) * hsize / 8; i += kThreads)
    h4[i] = make_uint4(0, 0, 0, 0);

  const float* xp = p.xp + (size_t)lane * T * B * G;
  const float* mk = p.mask + (size_t)lane * p.mask_lane_stride;
  float* out = p.out + (size_t)lane * T * B * H;

  // one cell (b, unit) per thread: the plan keeps B * hb <= kThreads
  const int cb = tid / hb, cj = tid % hb, cu = j0 + cj;
  const int cn = cb >> 3, cr = cb & 7;     // its N tile and row in it
  const bool owns_cell = tid < B * hb && cu < H;

  // the exchange (cluster route): my units' rows of an h buffer (hb rows of
  // 16 bytes a N tile, from unit j0) to the same place in every peer, one
  // row a store. A thread's first kSends stores are the same every step:
  // their rows (in uint4 of buffer 0) and peer addresses are worked out
  // here, off the chain.
  constexpr int kSends = 2;
  const int n_rows = NT * hb, n_send = kCluster ? (n_cta - 1) * n_rows : 0;
  auto send_row = [&](int i) {   // (peer, row) of store i
    return make_int2((rank + 1 + i / n_rows) % n_cta,
                     (i % n_rows) / hb * hr + j0 + i % n_rows % hb);
  };
  int send_row_of[kSends];
  uint4* send_to[kSends];
#pragma unroll
  for (int q = 0; q < kSends; ++q) {
    const int i = tid + q * kThreads;
    const int2 pr = send_row(i < n_send ? i : 0);
    send_row_of[q] = pr.y;
    send_to[q] = kCluster && i < n_send
                     ? cg::this_cluster().map_shared_rank(h4 + pr.y, pr.x)
                     : nullptr;
  }

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

  float c_cell = 0.f, h_cell = 0.f;
  In cur = load_in(0);
  for (int step = 0; step < T; ++step) {
    const int t = rev ? T - 1 - step : step;
    const int par = step & 1;
    // h after step - 1 in bf16: this step's buffer (the cluster's double
    // buffer, or the grid's one copy of the L2 buffer)
    const __nv_bfloat16* h_cur = h_s + (kCluster ? par * hsize : 0);
    __nv_bfloat16* h_nxt = h_s + (kCluster ? (par ^ 1) * hsize : 0);
    if (step > 0) {
      if constexpr (kCluster) {
        cluster_wait();
      } else {
        lane_wait(p.arrived + lane, (unsigned)step * n_cta);
        const uint4* src = reinterpret_cast<const uint4*>(
            p.hbuf + ((size_t)par * p.L + lane) * NT * H * 8);
        for (int i = tid; i < NT * H; i += kThreads)
          h4[(size_t)(i / H) * hr + i % H] = __ldcg(src + i);
        __syncthreads();
      }
    }

    // gates^T = Wh_slice^T h^T on the tensor cores, a partial tile per K
    // split of the warps, stored batch row by batch row
    for (int nt = 0; nt < NT; ++nt)
      w.product(tl, h_cur + (size_t)nt * hr * 8, wl,
                [&](int mt, const float (&d)[4]) {
                  float* o = part_s + (((size_t)w.gk * NT + nt) * 8
                                       + 2 * (wl & 3)) * Mr
                             + mt * 16 + (wl >> 2);
                  o[0] = d[0]; o[Mr] = d[1]; o[8] = d[2]; o[Mr + 8] = d[3];
                });
    __syncthreads();

    if (owns_cell) {
      // the wk partials of the cell's four gates, each summed in K order;
      // the four gates' loads go out together
      float gate[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int q = 0; q < tl.wk; ++q) {
        const float* pq =
            part_s + (((size_t)q * NT + cn) * 8 + cr) * Mr + cj;
#pragma unroll
        for (int g = 0; g < 4; ++g) gate[g] += pq[g * hb];
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) gate[g] += cur.x[g];
      const float ai = sigmoidf_(gate[0]), af = sigmoidf_(gate[1]);
      const float ag = tanhf(gate[2]), ao = sigmoidf_(gate[3]);
      const float c_new = af * c_cell + ai * ag;
      const float h_new = ao * tanhf(c_new);
      const bool keep = cur.m > 0.f;
      h_cell = keep ? h_new : h_cell;
      c_cell = keep ? c_new : c_cell;
      out[((size_t)t * B + cb) * H + cu] = h_new * cur.m;
      if (p.act) {
        const size_t cell = ((size_t)lane * T + t) * B + cb;
        float* a = p.act + cell * G + cu;
        a[0] = ai; a[H] = af; a[2 * H] = ag; a[3 * H] = ao;
        p.cs[cell * H + cu] = c_cell;
        p.hs[cell * H + cu] = h_cell;
      }
      if (step + 1 < T) {
        // the one rounding of this h for the products that read it
        const __nv_bfloat16 hv = __float2bfloat16_rn(h_cell);
        if constexpr (kCluster)
          h_nxt[((size_t)cn * hr + cu) * 8 + cr] = hv;
        else
          __stcg(reinterpret_cast<unsigned short*>(p.hbuf)
                     + ((((size_t)(par ^ 1) * p.L + lane) * NT + cn) * H
                        + cu) * 8 + cr,
                 __bfloat16_as_ushort(hv));
      }
    }
    if (step + 1 == T) break;
    // the next step's inputs, in flight through the exchange and the
    // barrier
    cur = load_in(step + 1);
    __syncthreads();
    if constexpr (kCluster) {
      const size_t buf = (size_t)(par ^ 1) * NT * hr;   // h_nxt, in uint4
#pragma unroll
      for (int q = 0; q < kSends; ++q)
        if (send_to[q]) send_to[q][buf] = h4[buf + send_row_of[q]];
      for (int i = tid + kSends * kThreads; i < n_send; i += kThreads) {
        const int2 pr = send_row(i);
        uint4* src = h4 + buf + pr.y;
        *cg::this_cluster().map_shared_rank(src, pr.x) = *src;
      }
      cluster_arrive();
    } else {
      lane_arrive(p.arrived + lane);
    }
  }
}

struct BwdParams {
  const float* dout;   // (L, T, B, H)
  const float* act;    // (L, T, B, 4H) i, f, g, o activations
  const float* cs;     // (L, T, B, H) carried c after each step
  const float* mask;   // (T, B), or (L, T, B) with mask_lane_stride = T*B
  const float* wh;     // (L, H, 4H)
  float* dxp;          // (L, T, B, 4H) out: dgates
  float* part;         // grid: (L, 2, n_cta, H, 8 NT) partials; else null
  unsigned* arrived;   // grid: (L,) zeroed counters; cluster: null
  int L, T, B, H, hb, n_cta;
  long long mask_lane_stride;
  unsigned long long reverse_bits;
};

template <bool kCluster, int kM>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bf16_bwd_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, B = p.B, T = p.T, G = 4 * H, hb = p.hb, nc = 4 * hb;
  const int n_cta = p.n_cta, tid = threadIdx.x, wl = tid & 31;
  const BwdLayout s = bwd_layout(B, H, hb, n_cta, kCluster);
  const Tiling& tl = s.t;
  const int NT = s.NT, Bp = 8 * NT, Kr = 16 * tl.K;
  const int lane = blockIdx.x / n_cta;
  const int rank = blockIdx.x % n_cta;    // the cluster rank on that route
  const int j0 = rank * hb;
  const bool rev = (p.reverse_bits >> lane) & 1ULL;

  uint4* frag_s = reinterpret_cast<uint4*>(smem);
  __nv_bfloat16* dg_s = reinterpret_cast<__nv_bfloat16*>(smem + s.dg_off);
  float* rx_s = reinterpret_cast<float*>(smem + s.rx_off);

  // A = this CTA's Wh columns: row j unit j of dh, column c = gate * hb +
  // u holds global column gate * H + j0 + u
  const float* wh = p.wh + (size_t)lane * H * G;
  WarpTiles<kM> w;
  w.load(tl, tid >> 5, wl, frag_s, [&](int j, int c) {
    const int u = j0 + c % hb;
    return (j < H && c < nc && u < H) ? wh[(size_t)j * G + (c / hb) * H + u]
                                      : 0.f;
  });
  uint4* dg4 = reinterpret_cast<uint4*>(dg_s);
  for (int i = tid; i < NT * Kr; i += kThreads)
    dg4[i] = make_uint4(0, 0, 0, 0);

  const float* dout = p.dout + (size_t)lane * T * B * H;
  const float* act = p.act + (size_t)lane * T * B * G;
  const float* cs = p.cs + (size_t)lane * T * B * H;
  const float* mk = p.mask + (size_t)lane * p.mask_lane_stride;
  float* dxp = p.dxp + (size_t)lane * T * B * G;

  // one cell (b, unit) per thread: the plan keeps B * hb <= kThreads
  const int cb = tid / hb, cj = tid % hb, cu = j0 + cj;
  const int cn = cb >> 3, cr = cb & 7;
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
          dst + (((size_t)par * n_cta + rank) * hb + j % hb) * Bp + b) = v;
    } else {
      __stcg(reinterpret_cast<float4*>(
                 p.part + ((((size_t)lane * 2 + par) * n_cta + rank) * H + j)
                              * Bp + b), v);
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
          const float* r = rx_s + ((size_t)par * n_cta * hb + cj) * Bp + cb;
#pragma unroll 8
          for (int src = 0; src < n_cta; ++src)
            rec += r[(size_t)src * hb * Bp];
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
                p.part + (((size_t)lane * 2 + par) * n_cta * H + u) * Bp + b;
            for (int q = grp; q < n_cta; q += ngrp)
              acc += __ldcg(src + (size_t)q * H * Bp);
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
        // the one rounding of these dgates for the product
        dg_s[((size_t)cn * Kr + g * hb + cj) * 8 + cr] =
            __float2bfloat16_rn(dg[g]);
      }
    }
    if (step + 1 == T) break;
    // the next step's saved values, in flight through this step's product
    // and exchange
    cur = load_saved(step + 1);
    __syncthreads();

    // dh^T = Wh_slice dgates^T for every unit of the lane from my columns,
    // on the tensor cores, straight to the units' CTAs: a lane pairs its
    // two columns of a tile row with its neighbour's into a float4 of four
    // batch rows (even lanes row g, odd lanes row g + 8)
    const int par = step & 1;
    for (int nt = 0; nt < NT; ++nt)
      w.product(tl, dg_s + (size_t)nt * Kr * 8, wl,
                [&](int mt, const float (&d)[4]) {
                  const bool odd = wl & 1;
                  const float r0 = __shfl_xor_sync(0xffffffffu,
                                                   odd ? d[0] : d[2], 1);
                  const float r1 = __shfl_xor_sync(0xffffffffu,
                                                   odd ? d[1] : d[3], 1);
                  const int j = mt * 16 + (wl >> 2) + (odd ? 8 : 0);
                  const int b = nt * 8 + 2 * (wl & 3) - (odd ? 2 : 0);
                  if (j < H)
                    send4(par, j, b, odd ? make_float4(r0, r1, d[2], d[3])
                                         : make_float4(d[0], d[1], r0, r1));
                });
    if constexpr (kCluster) {
      cluster_arrive();
    } else {
      __syncthreads();
      lane_arrive(p.arrived + lane);
    }
  }
}

using FwdKernel = void (*)(const FwdParams);
using BwdKernel = void (*)(const BwdParams);

template <bool kCluster>
FwdKernel fwd_kernel(int max_m) {
  return max_m == 1 ? lstm_bf16_fwd_kernel<kCluster, 1>
         : max_m == 2 ? lstm_bf16_fwd_kernel<kCluster, 2>
                      : lstm_bf16_fwd_kernel<kCluster, 3>;
}

FwdKernel fwd_kernel_for(bool cluster, int max_m) {
  return cluster ? fwd_kernel<true>(max_m) : fwd_kernel<false>(max_m);
}

template <bool kCluster>
BwdKernel bwd_kernel(int max_m) {
  return max_m == 1 ? lstm_bf16_bwd_kernel<kCluster, 1>
         : max_m == 2 ? lstm_bf16_bwd_kernel<kCluster, 2>
                      : lstm_bf16_bwd_kernel<kCluster, 3>;
}

BwdKernel bwd_kernel_for(bool cluster, int max_m) {
  return cluster ? bwd_kernel<true>(max_m) : bwd_kernel<false>(max_m);
}

}  // namespace

extern "C" {

// The current device's limits for the plan (lstm_sync.cuh), with the
// registers of the forward's or the backward's grid-route kernel with
// three M tiles a warp (its most). Returns a CUDA error code.
int lstm_bf16_fwd_limits(int* sms, int* smem_block, int* smem_sm,
                         int* regs_grid) {
  return lstm_card_limits(fwd_kernel_for(false, kMaxM), sms, smem_block,
                          smem_sm, regs_grid);
}

int lstm_bf16_bwd_limits(int* sms, int* smem_block, int* smem_sm,
                         int* regs_grid) {
  return lstm_card_limits(bwd_kernel_for(false, kMaxM), sms, smem_block,
                          smem_sm, regs_grid);
}

// Clusters of n_cta CTAs of the cluster-route kernel for (B, H, hb, ks)
// that the current device holds at once, in *n_clusters (0: none fits).
// Returns 0.
int lstm_bf16_fwd_clusters(int B, int H, int hb, int ks, int n_cta,
                           int* n_clusters) {
  const FwdLayout s = fwd_layout(B, H, hb, ks, n_cta, true);
  return lstm_active_clusters(fwd_kernel_for(true, s.t.max_m), n_cta,
                              kThreads, s.bytes, n_clusters);
}

int lstm_bf16_bwd_clusters(int B, int H, int hb, int ks, int n_cta,
                           int* n_clusters) {
  const BwdLayout s = bwd_layout(B, H, hb, n_cta, true);
  return lstm_active_clusters(bwd_kernel_for(true, s.t.max_m), n_cta,
                              kThreads, s.bytes, n_clusters);
}

// Launches the bf16 forward on `stream` by the route of the wrapper's plan:
// `cluster` non-zero for one cluster of n_cta CTAs per lane, else the
// cooperative grid with the zeroed bf16 `hbuf` and `arrived`; ks warps
// split the reduction (a divisor of 12). act, cs and hs are null when
// serving, all three set when training. Returns cudaGetLastError() after
// the launch (0 on success).
int lstm_bf16_fwd_launch(const float* xp, const float* mask, const float* wh,
                         float* out, float* act, float* cs, float* hs,
                         void* hbuf, unsigned* arrived, int L, int T, int B,
                         int H, long long mask_lane_stride,
                         unsigned long long reverse_bits, int cluster,
                         int n_cta, int hb, int ks, void* stream) {
  if (B * hb > kThreads || n_cta * hb < H || ks < 1 || kWarps % ks ||
      L < 1 || L > 64)
    return (int)cudaErrorInvalidValue;
  const FwdLayout s = fwd_layout(B, H, hb, ks, n_cta, cluster != 0);
  FwdParams p;
  p.xp = xp; p.mask = mask; p.wh = wh; p.out = out;
  p.act = act; p.cs = cs; p.hs = hs;
  p.hbuf = static_cast<__nv_bfloat16*>(hbuf); p.arrived = arrived;
  p.L = L; p.T = T; p.B = B; p.H = H; p.hb = hb; p.ks = ks; p.n_cta = n_cta;
  p.mask_lane_stride = mask_lane_stride;
  p.reverse_bits = reverse_bits;
  return lstm_launch(fwd_kernel_for(cluster != 0, s.t.max_m), p,
                     cluster != 0, n_cta, L * n_cta, kThreads, s.bytes,
                     (cudaStream_t)stream);
}

// Launches the bf16 backward on `stream` by the route of the wrapper's
// plan: `cluster` non-zero for one cluster of n_cta CTAs per lane, else the
// cooperative grid with `part` and the zeroed `arrived`; ks must be 1 (the
// warps split the units, not the reduction). Returns cudaGetLastError()
// after the launch (0 on success).
int lstm_bf16_bwd_launch(const float* dout, const float* act,
                         const float* cs, const float* mask, const float* wh,
                         float* dxp, float* part, unsigned* arrived, int L,
                         int T, int B, int H, long long mask_lane_stride,
                         unsigned long long reverse_bits, int cluster,
                         int n_cta, int hb, int ks, void* stream) {
  if (B * hb > kThreads || n_cta * hb < H || ks != 1 || L < 1 || L > 64)
    return (int)cudaErrorInvalidValue;
  const BwdLayout s = bwd_layout(B, H, hb, n_cta, cluster != 0);
  BwdParams p;
  p.dout = dout; p.act = act; p.cs = cs; p.mask = mask; p.wh = wh;
  p.dxp = dxp; p.part = part; p.arrived = arrived;
  p.L = L; p.T = T; p.B = B; p.H = H; p.hb = hb; p.n_cta = n_cta;
  p.mask_lane_stride = mask_lane_stride;
  p.reverse_bits = reverse_bits;
  return lstm_launch(bwd_kernel_for(cluster != 0, s.t.max_m), p,
                     cluster != 0, n_cta, L * n_cta, kThreads, s.bytes,
                     (cudaStream_t)stream);
}

const char* radmmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
