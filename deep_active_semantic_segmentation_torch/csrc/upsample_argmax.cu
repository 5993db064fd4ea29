// Fused 4x align-corners bilinear upsample + first-max class argmax (Hopper).
//
// Replaces the TPU kernel
//   deep_active_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py
//   ::upsample4_argmax (pallas_call at :73, body _kernel at :36).
//
// What it computes: decoder-resolution logits x (B, C, h, w), NCHW
// contiguous, f32 or bf16, to int32 votes (B, H, W) with H = 4(h-1)+1,
// W = 4(w-1)+1. Output pixel (y, x) sits at source row y/4 and column x/4
// (align_corners with an exact 4x ratio). Rows are lerped first with
// weights 1-fy/4 and fy/4, then columns with 1-fx/4 and fx/4, the same
// association as the Pallas body (:45-52); the math is f32. The argmax
// keeps a running max with strict '>', so the first maximum wins, as
// jnp.argmax and torch.argmax do.
//
// FMA contraction: every product and sum of the lerps goes through the
// round-to-nearest intrinsics __fmul_rn / __fadd_rn, which nvcc never
// contracts into an FMA, whatever -fmad says. Each lerp is therefore
// rounded exactly as the plain PyTorch version in ops/upsample_argmax.py
// rounds it (one rounding per multiply and per add), and the votes equal
// the plain version's bit for bit.
//
// What bounds it on an H100: bytes. At the main-path shape
// (B=5, C=19, h=w=129 -> 513x513) it must read 5*19*129*129*4 B = 6.3 MB
// and write 5*513*513*4 B = 5.3 MB: 11.6 MB, about 3.5 us at 3.35 TB/s.
// It does 19 * 9 flops per output pixel (~0.23 GFLOP), far below the
// card's f32 rate. (Arithmetic from the shapes, not a measurement.)
//
// Design: one thread per source cell (j, i) produces the 4x4 output patch
// of rows 4j..4j+3 and columns 4i..4i+3 (clipped at H and W), so it loads
// 4 values per class where a thread per output pixel loaded 4 for one
// pixel: 16x fewer loads. It keeps 16 running (max, arg) pairs in
// registers. A block of 4 warps owns 4 source rows x 32 source columns of
// one image; it stages them, plus one halo row and column (clamped at the
// last row and column, as the plain version's min(o/4 + 1, n - 1)), for a
// chunk of up to 32 classes in shared memory, with a warp's lanes on
// consecutive columns. Output rows are 4(w-1)+1 int32 wide, so a row does
// not start 16-byte aligned: each warp writes its 4 x 128 patch rows to
// shared memory (16 bytes a lane) and stores them back a lane per column,
// 128 contiguous bytes per instruction. The (B, C, 513, 513) logits,
// 100 MB per MC step in f32, never exist. What is left bounds this
// design by instruction issue, not bytes: per class a thread issues about
// 124 instructions (24 lerps of three unfused operations, 16
// compare-and-selects of three, 4 shared loads), ~8 us of issue over the
// card at the main-path shape; PERF.md has the measurements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = kWarps;          // source rows per block, one per warp
constexpr int kTileCols = 32;              // source columns per block, one per lane
constexpr int kRowStride = kTileCols + 1;  // + the right halo column
constexpr int kClassStride = (kTileRows + 1) * kRowStride;
constexpr int kClassChunk = 32;            // classes staged per round

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// a * (1 - f/4) + b * (f/4), rounded after each operation (no FMA).
__device__ __forceinline__ float lerp4(float a, float b, float w0, float w1) {
  return __fadd_rn(__fmul_rn(a, w0), __fmul_rn(b, w1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample4_argmax_kernel(const T* __restrict__ x, int32_t* __restrict__ out,
                            int C, int h, int w, int tiles_h, int tiles_w) {
  __shared__ float xs[kClassChunk * kClassStride];            // [c][row][col]
  __shared__ int4 patch[kWarps][4][kTileCols];                // [fy][i][fx]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tj = (int)(blockIdx.x % tiles_w);
  const int ti = (int)(blockIdx.x / tiles_w % tiles_h);
  const int b = (int)(blockIdx.x / tiles_w / tiles_h);
  const int j0 = ti * kTileRows, i0 = tj * kTileCols;
  const int j = j0 + warp;  // this thread's source cell (j, i)
  const int H = 4 * (h - 1) + 1, W = 4 * (w - 1) + 1;
  const int64_t plane = (int64_t)h * w;
  const T* xb = x + (int64_t)b * C * plane;

  float best[16];
  int32_t arg[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    best[k] = 0.0f;
    arg[k] = 0;
  }

  for (int c0 = 0; c0 < C; c0 += kClassChunk) {
    const int nc = min(kClassChunk, C - c0);
    if (c0 > 0) __syncthreads();  // the previous chunk's reads are done
    // stage rows min(j0 + r, h - 1), columns min(i0 + col, w - 1)
#pragma unroll 4
    for (int rr = warp; rr < nc * (kTileRows + 1); rr += kWarps) {
      const int c = rr / (kTileRows + 1), r = rr % (kTileRows + 1);
      const T* src = xb + (int64_t)(c0 + c) * plane +
                     (int64_t)min(j0 + r, h - 1) * w;
      float* dst = xs + c * kClassStride + r * kRowStride;
      dst[lane] = load_f32(src + min(i0 + lane, w - 1));
      if (lane == 0) dst[kTileCols] = load_f32(src + min(i0 + kTileCols, w - 1));
    }
    __syncthreads();

    for (int c = 0; c < nc; ++c) {
      const float* s = xs + c * kClassStride + warp * kRowStride + lane;
      const float x00 = s[0], x01 = s[1];
      const float x10 = s[kRowStride], x11 = s[kRowStride + 1];
      const int cls = c0 + c;
#pragma unroll
      for (int fy = 0; fy < 4; ++fy) {
        // 1 - f/4 and f/4 are exact in f32 for f in 0..3
        const float wy1 = 0.25f * fy, wy0 = 1.0f - wy1;
        const float r0 = lerp4(x00, x10, wy0, wy1);
        const float r1 = lerp4(x01, x11, wy0, wy1);
#pragma unroll
        for (int fx = 0; fx < 4; ++fx) {
          const float wx1 = 0.25f * fx, wx0 = 1.0f - wx1;
          const float v = lerp4(r0, r1, wx0, wx1);
          const int k = fy * 4 + fx;
          if (cls == 0 || v > best[k]) {
            best[k] = v;
            arg[k] = cls;
          }
        }
      }
    }
  }

  // the warp's 4 output rows, 128 columns each, through shared memory
#pragma unroll
  for (int fy = 0; fy < 4; ++fy)
    patch[warp][fy][lane] = make_int4(arg[fy * 4], arg[fy * 4 + 1],
                                      arg[fy * 4 + 2], arg[fy * 4 + 3]);
  __syncwarp();
  const int32_t* rows = reinterpret_cast<const int32_t*>(patch[warp]);
#pragma unroll
  for (int fy = 0; fy < 4; ++fy) {
    const int y = 4 * j + fy;
    if (y >= H) continue;  // past the last row (and rows j >= h)
    int32_t* dst = out + ((int64_t)b * H + y) * W + 4 * i0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int xo = lane + 32 * k;
      if (4 * i0 + xo < W) dst[xo] = rows[fy * 4 * kTileCols + xo];
    }
  }
}

template <typename T>
int launch(const void* x, void* out, int B, int C, int h, int w,
           void* stream) {
  if (B < 1 || C < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const int tiles_h = (h + kTileRows - 1) / kTileRows;
  const int tiles_w = (w + kTileCols - 1) / kTileCols;
  const int64_t blocks = (int64_t)B * tiles_h * tiles_w;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  upsample4_argmax_kernel<T><<<(unsigned)blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const T*)x, (int32_t*)out, C, h, w, tiles_h, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the launch's
// cudaGetLastError() (0 on success); the caller raises on anything else.
extern "C" int upsample4_argmax_f32(const void* x, void* out, int B, int C,
                                    int h, int w, void* stream) {
  return launch<float>(x, out, B, C, h, w, stream);
}

extern "C" int upsample4_argmax_bf16(const void* x, void* out, int B, int C,
                                     int h, int w, void* stream) {
  return launch<__nv_bfloat16>(x, out, B, C, h, w, stream);
}
