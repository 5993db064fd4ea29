// Fused 2x transposed-conv classifier + per-parity first-max class argmax
// (Hopper, tensor cores). ENet's MC vote tail.
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
// (i, j) sums the taps of its parity (input offset (di, dj), weight tap
// (ky, kx); the table of ops/tconv_votes.py::TAPS); a tap past the bottom
// or right edge reads zero. Each logit is rounded to the input dtype
// (round to nearest even: a no-op for f32, the unfused bf16 module's
// output rounding for bf16, as the Pallas body does at :83), and the first
// maximum over classes wins, as jnp.argmax and torch.argmax break ties.
//
// The logits of parity p are one GEMM, logits_p = X_p . W_p: X_p is
// (pixels x ntaps(p)*Cin) from the 1/2/2/4 shifted copies of the
// features, W_p is (ntaps(p)*Cin x Cout), Cout padded to a multiple of 8.
//
// Precision: three TF32 passes. Each f32 operand v is split into
// hi = tf32(v) (cvt.rna: nearest, ties away from zero) and lo = v - hi
// (exact in f32; the tensor core reads its top 10 mantissa bits, a
// truncation of ~2^-22 of v), and hi.hi + hi.lo + lo.hi accumulate in f32
// on the tensor cores: about f32-level error (lo.lo, ~2^-22 of each
// product, is dropped). A bf16 feature is exact in TF32 (lo = 0), so bf16
// input takes two passes. One pass would leave ~1e-3 rms logit error at
// unit-scale inputs, which flips votes whose top-2 gap exceeds 1e-3
// (tests/test_torch_tconv_votes.py emulates both on the CPU). The votes
// meet that bar against the plain version; they are not bit-equal to it,
// since the summation order and rounding differ.
//
// What bounds it on an H100: bytes, for the work itself. At the main-path
// shape (B=8, Cin=16, h=w=256 -> 512x512, Cout=19) it reads 33.6 MB and
// writes 8.4 MB (12.5 us at 3.35 TB/s); the 2.87 GFLOP of real products
// take 5.8 us at the 495 TFLOP/s TF32 tensor-core rate. This design does
// three passes over Cout padded to 24, 10.9 GFLOP, 22 us at that peak: its
// own ceiling. (Arithmetic from the shapes, not a measurement; PERF.md
// has the times and what holds the kernel above them.)
//
// Design:
// - Persistent blocks of one warpgroup (4 warps): each stages the weight
//   once, split into hi and lo, as the 18 K-major B matrices (9 parity
//   taps x hi/lo, per 8-channel chunk; (Cout padded to 8s) x 8 TF32) that
//   wgmma reads from shared memory, then walks over tiles of 4 input rows
//   x 16 columns of one image: 64 pixels, the m64 of a wgmma.
// - A tile's features, plus one halo row and column, for all channels,
//   are staged in shared memory as f32, [ci][row][col], the channel stride
//   = 8 mod 32 words, so the A-fragment loads (8 columns x 4 channels per
//   instruction) hit 32 distinct banks. Taps past the edge are staged as
//   zeros: the transposed conv's zero edge costs nothing. Any h and w are
//   taken: staging is by 4-byte loads, so no row stride need be aligned.
// - Warp w owns tile row w, its 16 rows of the wgmma. For each 8-channel
//   chunk it loads and splits the A fragments of the four input offsets
//   (di, dj) into registers, then issues wgmma.m64nNk8 TF32 (A from
//   registers, B from shared memory) for every (parity, tap) pair: offset
//   00 feeds all four parities, 01 parities 1 and 3, 10 parities 2 and 3,
//   11 parity 3; three passes each (two for bf16).
// - Epilogue in registers: each lane holds 2 classes per 8-class tile of
//   two pixels; it rounds, takes its first max per parity, and the quad
//   merges transposed with shuffles (the lower class wins a tie), so lane
//   t ends with parity t and writes it: a warp stores 32-byte runs of each
//   parity plane.
// - Several blocks per SM overlap one block's staging and epilogue with
//   another's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;                  // one warpgroup
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = kWarps;          // input rows per tile, one per warp
constexpr int kTileCols = 16;              // input columns per tile: a warp's 16 wgmma rows
constexpr int kRowStride = kTileCols + 1;  // + the right halo column
constexpr int kChanElems = (kTileRows + 1) * kRowStride;
constexpr int kChanStride = 104;           // >= kChanElems, == 8 mod 32
constexpr int kPerLane = (kChanElems + 31) / 32;  // staged values per lane and channel
constexpr int kMaxCin = 32;
constexpr int kMaxCout = 32;
constexpr int kPairs = 9;                  // (parity, tap) pairs over the four parities
constexpr int kMaxDevices = 64;            // devices whose launch geometry is kept

static_assert(kChanElems <= kChanStride, "tile fits its channel");
static_assert(kChanStride % 32 == 8, "conflict-free A-fragment loads");

// Pair q, ordered by input offset: offset 00 feeds q 0-3 (parities 0-3),
// 01 feeds q 4-5 (parities 1, 3), 10 feeds q 6-7 (parities 2, 3), 11
// feeds q 8 (parity 3). kPairTap[q] = {ky, kx}: the same taps as
// ops/tconv_votes.py::TAPS.
__constant__ int8_t kPairTap[kPairs][2] = {
    {1, 1}, {1, 2}, {2, 1}, {2, 2},  // offset (0, 0)
    {1, 0}, {2, 0},                  // offset (0, 1)
    {0, 1}, {0, 2},                  // offset (1, 0)
    {0, 0},                          // offset (1, 1)
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The f32 logit rounded to the input dtype, back in f32 (exact).
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v = hi + lo: hi rounded to TF32, lo the exact f32 remainder.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// The shared-memory descriptor of a K-major B matrix (N rows of 8 TF32
// k-values) stored as 8-row x 16-byte core matrices without swizzle: core
// matrix (n/8, k/4) at (n/8) * 256 + (k/4) * 128 bytes, so the leading
// (k) byte offset is 128 and the stride (n) byte offset 256.
__device__ __forceinline__ uint64_t b_desc(const void* smem) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((addr >> 4) & 0x3fff) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d += a . B over the warpgroup's 64 pixel rows: wgmma m64n(8*NT)k8 TF32
// with f32 accumulation, A from registers (warp w's 16 rows in the
// m16n8k8 fragment layout), B from shared memory.
template <int NT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NT][4], const uint32_t (&a)[4],
                                           uint64_t bd) {
  float* r = &d[0][0];
  if constexpr (NT == 1) {
    asm volatile("wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, 1, 1, 1;\n"
                 : "+f"(r[0]), "+f"(r[1]), "+f"(r[2]), "+f"(r[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd));
  } else if constexpr (NT == 2) {
    asm volatile("wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1;\n"
                 : "+f"(r[0]), "+f"(r[1]), "+f"(r[2]), "+f"(r[3]), "+f"(r[4]),
                   "+f"(r[5]), "+f"(r[6]), "+f"(r[7])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd));
  } else if constexpr (NT == 3) {
    asm volatile("wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
                 "{%12, %13, %14, %15}, %16, 1, 1, 1;\n"
                 : "+f"(r[0]), "+f"(r[1]), "+f"(r[2]), "+f"(r[3]), "+f"(r[4]),
                   "+f"(r[5]), "+f"(r[6]), "+f"(r[7]), "+f"(r[8]), "+f"(r[9]),
                   "+f"(r[10]), "+f"(r[11])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd));
  } else {
    asm volatile("wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
                 "{%16, %17, %18, %19}, %20, 1, 1, 1;\n"
                 : "+f"(r[0]), "+f"(r[1]), "+f"(r[2]), "+f"(r[3]), "+f"(r[4]),
                   "+f"(r[5]), "+f"(r[6]), "+f"(r[7]), "+f"(r[8]), "+f"(r[9]),
                   "+f"(r[10]), "+f"(r[11]), "+f"(r[12]), "+f"(r[13]), "+f"(r[14]),
                   "+f"(r[15])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd));
  }
}

// Pin a register that an asynchronous wgmma reads or writes: the compiler
// may neither move its other uses across this point nor reuse it before.
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// (best, arg) <- the first maximum of itself and (ov, oa): the larger
// value, the lower class on a tie.
__device__ __forceinline__ void merge(float& best, int& arg, float ov, int oa) {
  if (ov > best || (ov == best && oa < arg)) {
    best = ov;
    arg = oa;
  }
}

// Stage one tile [ci][row][col]: rows i0..i0+kTileRows, columns
// j0..j0+kTileCols, zero past the edge and past Cin. Warp w takes
// channels w, w + kWarps, ...
template <typename T>
__device__ __forceinline__ void stage_tile(float* xs, const T* xb, int Cin, int KC, int h,
                                           int w, int i0, int j0, int warp, int lane) {
  const int64_t plane = (int64_t)h * w;
  for (int ci = warp; ci < KC * 8; ci += kWarps) {
    float v[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int e = lane + 32 * k;
      const int r = e / kRowStride, col = e % kRowStride;
      const bool ok = e < kChanElems && ci < Cin && i0 + r < h && j0 + col < w;
      v[k] = ok ? load_f32(xb + ci * plane + (int64_t)(i0 + r) * w + j0 + col) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int e = lane + 32 * k;
      if (e < kChanElems) xs[ci * kChanStride + e] = v[k];
    }
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
    tconv2x_argmax_parity_major_kernel(const T* __restrict__ x,
                                       const float* __restrict__ weight,
                                       int32_t* __restrict__ out, int Cin,
                                       int h, int w, int Cout, int tiles_h,
                                       int tiles_w, int64_t tiles) {
  constexpr bool kSplitA = sizeof(T) == 4;  // bf16 features are exact in TF32
  constexpr int kMatrix = NT * 256;         // bytes of one B matrix (NT*8 x 8)
  extern __shared__ __align__(1024) unsigned char smem[];
  const int KC = (Cin + 7) / 8;             // 8-channel chunks
  // B matrices [pair][kc][hi, lo], then the feature tile
  unsigned char* wb = smem;
  float* xs = reinterpret_cast<float*>(smem + (size_t)kPairs * KC * 2 * kMatrix);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;     // fragment row group, thread in group

  // the weight, split: B(k, n) = W[kc*8 + k][n] at pair q's tap, zero past
  // Cin and Cout; a thread's 9 pair loads are in flight together
  for (int kc = 0; kc < KC; ++kc) {
    for (int e = threadIdx.x; e < NT * 64; e += kThreads) {
      const int k = e & 7, n = e >> 3, ci = kc * 8 + k;
      const bool ok = ci < Cin && n < Cout;
      float v[kPairs];
#pragma unroll
      for (int q = 0; q < kPairs; ++q)
        v[q] = ok ? weight[(ci * Cout + n) * 9 + kPairTap[q][0] * 3 + kPairTap[q][1]] : 0.0f;
      const int off = (n / 8) * 64 + (k / 4) * 32 + (n % 8) * 4 + (k % 4);
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        uint32_t* m = reinterpret_cast<uint32_t*>(wb + (size_t)(q * KC + kc) * 2 * kMatrix);
        uint32_t hi, lo;
        split(v[q], hi, lo);
        m[off] = hi;
        m[kMatrix / 4 + off] = lo;
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma

  const int64_t plane = (int64_t)h * w;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int j0 = (int)(tile % tiles_w) * kTileCols;
    const int i0 = (int)(tile / tiles_w % tiles_h) * kTileRows;
    const int b = (int)(tile / tiles_w / tiles_h);
    __syncthreads();  // the previous tile's reads are done (and the weight staged)
    stage_tile(xs, x + (int64_t)b * Cin * plane, Cin, KC, h, w, i0, j0, warp, lane);
    __syncthreads();

    float acc[4][NT][4];  // [parity][class tile][fragment]
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.0f;

    for (int kc = 0; kc < KC; ++kc) {
      // A fragments of the 4 input offsets (di, dj) = (o / 2, o % 2):
      // a0 (pixel g, ci t), a1 (pixel g+8, ci t), a2 (g, t+4), a3 (g+8, t+4)
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const float* s = xs + (kc * 8 + t) * kChanStride +
                         (warp + (o >> 1)) * kRowStride + g + (o & 1);
        split(s[0], ahi[o][0], alo[o][0]);
        split(s[8], ahi[o][1], alo[o][1]);
        split(s[4 * kChanStride], ahi[o][2], alo[o][2]);
        split(s[4 * kChanStride + 8], ahi[o][3], alo[o][3]);
      }
      auto pin_all = [&]() {
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) pin(acc[p][nt][e]);
#pragma unroll
        for (int o = 0; o < 4; ++o)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pin(ahi[o][e]);
            pin(alo[o][e]);
          }
      };
      pin_all();
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const unsigned char* mk = wb + (size_t)kc * 2 * kMatrix;
      const size_t per_pair = (size_t)KC * 2 * kMatrix;
      // pair q reads offset o into parity p (kPairTap's order); lo.hi,
      // hi.lo, then hi.hi
      auto pair = [&](int q, int o, float(&d)[NT][4]) {
        const uint64_t bh = b_desc(mk + q * per_pair), bl = b_desc(mk + q * per_pair + kMatrix);
        if (kSplitA) wgmma_tf32<NT>(d, alo[o], bh);
        wgmma_tf32<NT>(d, ahi[o], bl);
        wgmma_tf32<NT>(d, ahi[o], bh);
      };
      pair(0, 0, acc[0]);
      pair(1, 0, acc[1]);
      pair(2, 0, acc[2]);
      pair(3, 0, acc[3]);
      pair(4, 1, acc[1]);
      pair(5, 1, acc[3]);
      pair(6, 2, acc[2]);
      pair(7, 2, acc[3]);
      pair(8, 3, acc[3]);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin_all();
    }

    // epilogue: lane (g, t) holds classes nt*8 + 2t + {0, 1} of pixels g
    // (fragments 0, 1) and g + 8 (fragments 2, 3) of its warp's row
    const int row = i0 + warp;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float best[4];
      int arg[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        // padded classes (c >= Cout, last class tile only) read -inf: they
        // never win, and lose a tie to any real class (a lower index)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = nt * 8 + 2 * t + e;
            float v = round_to(acc[p][nt][half * 2 + e], x);
            if (nt == NT - 1 && c >= Cout) v = -INFINITY;
            if ((nt == 0 && e == 0) || v > best[p]) {
              best[p] = v;
              arg[p] = c;
            }
          }
        }
      }
      // the quad's merge, transposed: across lanes t ^ 2 each lane keeps
      // the two parities with its own bit 1, across t ^ 1 the one = t
      const bool up = t & 2, odd = t & 1;
      float kv0 = up ? best[2] : best[0], kv1 = up ? best[3] : best[1];
      int ka0 = up ? arg[2] : arg[0], ka1 = up ? arg[3] : arg[1];
      merge(kv0, ka0, __shfl_xor_sync(0xffffffffu, up ? best[0] : best[2], 2),
            __shfl_xor_sync(0xffffffffu, up ? arg[0] : arg[2], 2));
      merge(kv1, ka1, __shfl_xor_sync(0xffffffffu, up ? best[1] : best[3], 2),
            __shfl_xor_sync(0xffffffffu, up ? arg[1] : arg[3], 2));
      float kv = odd ? kv1 : kv0;
      int32_t vote = odd ? ka1 : ka0;
      merge(kv, vote, __shfl_xor_sync(0xffffffffu, odd ? kv0 : kv1, 1),
            __shfl_xor_sync(0xffffffffu, odd ? ka0 : ka1, 1));
      const int col = j0 + half * 8 + g;  // lane t writes parity t
      if (row < h && col < w)
        out[((int64_t)b * 4 + t) * plane + (int64_t)row * w + col] = vote;
    }
  }
}

// Dynamic shared memory of a launch with KC 8-channel chunks: the B
// matrices, then the feature tile.
template <int NT>
size_t smem_bytes(int KC) {
  return (size_t)kPairs * KC * 2 * NT * 256 + (size_t)KC * 8 * kChanStride * sizeof(float);
}

// The persistent grid of kernel<T, NT> with KC chunks on the current
// device: its SMs x the blocks resident on each. Worked out at the first
// launch on each device, which also raises the kernel's shared-memory
// limit to the largest Cin's, and kept: a later launch makes no query.
template <typename T, int NT>
cudaError_t persistent_grid(int KC, int* grid) {
  static std::atomic<int> kept[kMaxDevices][kMaxCin / 8];  // 0: not yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& slot = kept[dev][KC - 1];
  int g = slot.load(std::memory_order_acquire);
  if (g == 0) {
    auto kernel = tconv2x_argmax_parity_major_kernel<T, NT>;
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem_bytes<NT>(kMaxCin / 8))) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem_bytes<NT>(KC))) != cudaSuccess)
      return err;
    g = sms * (per_sm > 0 ? per_sm : 1);
    slot.store(g, std::memory_order_release);
  }
  *grid = g;
  return cudaSuccess;
}

template <typename T, int NT>
int launch_nt(const void* x, const void* weight, void* out, int B, int Cin,
              int h, int w, int Cout, cudaStream_t stream) {
  const int KC = (Cin + 7) / 8;
  int blocks = 0;
  const cudaError_t err = persistent_grid<T, NT>(KC, &blocks);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (h + kTileRows - 1) / kTileRows;
  const int tiles_w = (w + kTileCols - 1) / kTileCols;
  const int64_t tiles = (int64_t)B * tiles_h * tiles_w;
  const int64_t grid = tiles < blocks ? tiles : blocks;
  auto kernel = tconv2x_argmax_parity_major_kernel<T, NT>;
  const size_t smem = smem_bytes<NT>(KC);
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)weight, (int32_t*)out, Cin, h, w, Cout,
      tiles_h, tiles_w, tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* weight, void* out, int B, int Cin, int h,
           int w, int Cout, void* stream_ptr) {
  if (Cin < 1 || Cin > kMaxCin || Cout < 1 || Cout > kMaxCout || B < 1 || h < 1 ||
      w < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (Cout <= 8) return launch_nt<T, 1>(x, weight, out, B, Cin, h, w, Cout, stream);
  if (Cout <= 16) return launch_nt<T, 2>(x, weight, out, B, Cin, h, w, Cout, stream);
  if (Cout <= 24) return launch_nt<T, 3>(x, weight, out, B, Cin, h, w, Cout, stream);
  return launch_nt<T, 4>(x, weight, out, B, Cin, h, w, Cout, stream);
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
