// Fused 2x transposed-conv classifier + per-parity first-max class argmax
// (Hopper). ENet's MC vote tail.
//
// Replaces the TPU kernel
//   deep_active_semantic_segmentation_tpu/ops/pallas/tconv_votes_fused.py
//   ::tconv2x_argmax_parity_major (pallas_call at :125, body _kernel at :55).
//
// What it computes: stage-5 features x (B, Cin, h, w), NCHW contiguous,
// f32 or bf16, and the f32 weight W (Cin, Cout, 3, 3) of a bias-free torch
// ConvTranspose2d(3, stride 2, padding 1, output_padding 1), to int32
// votes (B, 4, h, w), parity-major (parity p = 2*(y%2) + x%2 of the output
// pixel (y, x) = (2i + p/2, 2j + p%2)). Output parity p of input pixel
// (i, j) sums the taps in kTaps[p] (input offset (di, dj), weight tap
// (ky, kx)); a tap past the bottom or right edge reads zero and is
// skipped. The logits accumulate in f32, tap by tap and within a tap
// input channel by input channel, are rounded to the input dtype (round
// to nearest even: a no-op for f32, the unfused bf16 module's output
// rounding for bf16, as the Pallas body does at :83), and the first
// maximum over classes wins (strict '>'), as jnp.argmax and torch.argmax
// break ties.
//
// FMA contraction: every product and sum goes through __fmul_rn /
// __fadd_rn, which nvcc never contracts into an FMA. Each logit is thus
// rounded exactly as the plain PyTorch version in ops/tconv_votes.py
// rounds it (one rounding per multiply and per add, the same order), and
// the votes equal the plain version's bit for bit.
//
// What bounds it on an H100: operations. At the main-path shape
// (B=8, Cin=16, h=w=256 -> 512x512, Cout=19) it reads 33.6 MB and writes
// 8.4 MB (12.5 us at 3.35 TB/s), and does 9 non-zero taps x 16 x 19 x 2
// FLOP per input pixel x 524,288 pixels = 2.87 GFLOP (42.8 us at the
// 67 TFLOP/s f32 rate outside the tensor cores). (Arithmetic from the
// shapes, not a measurement.) Without FMA a multiply and an add are two
// instructions, so this design's own ceiling is half that rate.
//
// What the design does about it: the TPU kernel fed a parity tap table
// to the MXU, with a shifted-identity matmul for the column taps and
// 32-row tiles with a one-tile halo; none of that carries over. Here one
// thread owns one (input pixel, parity): blockIdx.y is the parity, so a
// warp runs one tap list without divergence. Cout f32 accumulators sit in
// registers (unrolled up to the compile-time bound CMAX); the parity's
// taps of the weight (<= 4 x Cin x Cout floats) are staged in shared
// memory as [tap][ci][co], read by every thread of a warp at the same
// address (a broadcast); the <= 4 x Cin input values come through L1/L2
// with neighbouring threads on neighbouring columns. The (B, Cout, 2h, 2w)
// logits, 159 MB in f32, never exist. Simple and right first: a
// tensor-core GEMM over the parity tap table (wgmma, TF32 or bf16) is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCin = 32;
constexpr int kMaxCout = 32;

// kTaps[p][t] = {di, dj, ky, kx}; kNumTaps[p] taps for parity p. The same
// table and order as TAPS in ops/tconv_votes.py.
__constant__ int8_t kTaps[4][4][4] = {
    {{0, 0, 1, 1}, {0, 0, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}},
    {{0, 0, 1, 2}, {0, 1, 1, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}},
    {{0, 0, 2, 1}, {1, 0, 0, 1}, {0, 0, 0, 0}, {0, 0, 0, 0}},
    {{0, 0, 2, 2}, {0, 1, 2, 0}, {1, 0, 0, 2}, {1, 1, 0, 0}},
};
__constant__ int kNumTaps[4] = {1, 2, 2, 4};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The f32 logit rounded to the input dtype, back in f32 (exact).
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int CMAX>
__global__ void __launch_bounds__(kThreads)
    tconv2x_argmax_parity_major_kernel(const T* __restrict__ x,
                                       const float* __restrict__ weight,
                                       int32_t* __restrict__ out, int Cin,
                                       int h, int w, int Cout) {
  extern __shared__ float w_s[];  // [tap][ci][co] for this parity's taps
  const int p = blockIdx.y;
  const int b = blockIdx.z;
  const int ntaps = kNumTaps[p];

  // stage the parity's taps of W (Cin, Cout, 3, 3) as [t][ci][co]
  const int per_tap = Cin * Cout;
  for (int k = threadIdx.x; k < ntaps * per_tap; k += blockDim.x) {
    const int t = k / per_tap, r = k % per_tap;  // r = ci * Cout + co
    const int ky = kTaps[p][t][2], kx = kTaps[p][t][3];
    w_s[k] = weight[(int64_t)r * 9 + ky * 3 + kx];
  }
  __syncthreads();

  const int64_t plane = (int64_t)h * w;
  const int64_t pix = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= plane) return;
  const int i = (int)(pix / w), j = (int)(pix % w);
  const T* xb = x + (int64_t)b * Cin * plane;

  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.0f;

  for (int t = 0; t < ntaps; ++t) {
    const int ii = i + kTaps[p][t][0], jj = j + kTaps[p][t][1];
    if (ii >= h || jj >= w) continue;  // the transposed conv's zero edge
    const T* xp = xb + (int64_t)ii * w + jj;
    const float* wt = w_s + t * per_tap;
    for (int ci = 0; ci < Cin; ++ci, xp += plane, wt += Cout) {
      const float xv = load_f32(xp);
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < Cout) acc[c] = __fadd_rn(acc[c], __fmul_rn(xv, wt[c]));
      }
    }
  }

  float best = 0.0f;
  int32_t arg = 0;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < Cout) {
      const float v = round_to(acc[c], x);
      if (c == 0 || v > best) {
        best = v;
        arg = c;
      }
    }
  }
  out[((int64_t)b * 4 + p) * plane + pix] = arg;
}

template <typename T, int CMAX>
int launch_cmax(const void* x, const void* weight, void* out, int B, int Cin,
                int h, int w, int Cout, cudaStream_t stream) {
  const int64_t plane = (int64_t)h * w;
  const dim3 grid((unsigned)((plane + kThreads - 1) / kThreads), 4,
                  (unsigned)B);
  const size_t smem = (size_t)4 * Cin * Cout * sizeof(float);
  tconv2x_argmax_parity_major_kernel<T, CMAX><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)weight, (int32_t*)out, Cin, h, w, Cout);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* weight, void* out, int B, int Cin, int h,
           int w, int Cout, void* stream_ptr) {
  if (Cin < 1 || Cin > kMaxCin || Cout < 1 || Cout > kMaxCout || B < 1 ||
      B > 65535 || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (Cout <= 8) return launch_cmax<T, 8>(x, weight, out, B, Cin, h, w, Cout, stream);
  if (Cout <= 16) return launch_cmax<T, 16>(x, weight, out, B, Cin, h, w, Cout, stream);
  if (Cout <= 24) return launch_cmax<T, 24>(x, weight, out, B, Cin, h, w, Cout, stream);
  return launch_cmax<T, 32>(x, weight, out, B, Cin, h, w, Cout, stream);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the launch's
// cudaGetLastError() (0 on success); the caller raises on anything else.
extern "C" int tconv2x_argmax_parity_major_f32(const void* x, const void* weight,
                                               void* out, int B, int Cin, int h,
                                               int w, int Cout, void* stream) {
  return launch<float>(x, weight, out, B, Cin, h, w, Cout, stream);
}

extern "C" int tconv2x_argmax_parity_major_bf16(const void* x,
                                                const void* weight, void* out,
                                                int B, int Cin, int h, int w,
                                                int Cout, void* stream) {
  return launch<__nv_bfloat16>(x, weight, out, B, Cin, h, w, Cout, stream);
}
