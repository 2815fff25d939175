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
// per cell).
//
// Design: one block per item, one thread per text column (up to 4 a thread
// for long texts). The previous row of lp is double-buffered in shared
// memory; the choice bits of every row stay in shared memory, packed 32 to
// a word by a warp ballot (512 x 96 bits = 6 KB at the flagship shape).
// After the forward DP one thread walks the bits back and writes the ones;
// the block first zeroes its item's output.
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxPerThread = 4;

__global__ void mas_width1_kernel(const float* __restrict__ log_attn,
                                  const int* __restrict__ text_lens,
                                  const int* __restrict__ mel_lens,
                                  float* __restrict__ out, int Tm, int Tt) {
  extern __shared__ unsigned int smem_u[];
  const int b = blockIdx.x;
  const int tl = text_lens[b], ml = min(mel_lens[b], Tm);
  const int nwords = (Tt + 31) / 32;
  float* cur = reinterpret_cast<float*>(smem_u);
  float* nxt = cur + Tt;
  unsigned int* bits = smem_u + 2 * Tt;       // Tm x nwords

  const float* la = log_attn + (size_t)b * Tm * Tt;
  float* o = out + (size_t)b * Tm * Tt;
  for (size_t i = threadIdx.x; i < (size_t)Tm * Tt; i += blockDim.x)
    o[i] = 0.f;
  if (tl <= 0 || ml <= 0) return;             // uniform: nothing to mark

  for (int k = 0; k < kMaxPerThread; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < Tt) cur[j] = la[j];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int i = 1; i < ml; ++i) {
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int j0 = k * blockDim.x;
      if (j0 >= Tt) break;                     // uniform
      const int j = j0 + threadIdx.x;
      bool diag = false;
      if (j < Tt) {
        const float here = cur[j];
        const float left = j > 0 ? cur[j - 1] : kNeg;
        diag = left >= here;
        nxt[j] = la[(size_t)i * Tt + j] + (diag ? left : here);
      }
      const unsigned int word = __ballot_sync(0xffffffffu, diag);
      if (lane == 0 && j0 + (threadIdx.x & ~31) < Tt)
        bits[(size_t)i * nwords + (j0 + (threadIdx.x & ~31)) / 32] = word;
    }
    __syncthreads();
    float* tmp = cur; cur = nxt; nxt = tmp;
  }

  if (threadIdx.x == 0) {
    int c = tl - 1;
    for (int i = ml - 1; i >= 1; --i) {
      o[(size_t)i * Tt + c] = 1.f;
      c -= (bits[(size_t)i * nwords + c / 32] >> (c % 32)) & 1u;
    }
    o[c] = 1.f;
    o[0] = 1.f;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for (T_mel, T_text), in *bytes.
size_t mas_width1_smem(int Tm, int Tt) {
  return (2 * (size_t)Tt + (size_t)Tm * ((Tt + 31) / 32)) * sizeof(float);
}

// log_attn (B, T_mel, T_text) f32; text_lens, mel_lens (B,) int32;
// out (B, T_mel, T_text) f32. Returns cudaGetLastError() after the launch
// (0 on success).
int mas_width1_launch(const float* log_attn, const int* text_lens,
                      const int* mel_lens, float* out, int B, int Tm, int Tt,
                      void* stream) {
  int threads = (Tt + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  if (Tt > threads * kMaxPerThread) return (int)cudaErrorInvalidValue;
  const size_t smem = mas_width1_smem(Tm, Tt);
  cudaError_t e = cudaFuncSetAttribute(
      mas_width1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  mas_width1_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      log_attn, text_lens, mel_lens, out, Tm, Tt);
  return (int)cudaGetLastError();
}

const char* radmmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
