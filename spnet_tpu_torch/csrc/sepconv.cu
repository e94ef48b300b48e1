// Fused inference separable convolution for Hopper (sm_90a), NHWC.
//
//   y = relu?( (pointwise(depthwise3x3_SAME(x)) * scale + bias) )
//
// Replaces the Pallas TPU kernel `spnet_tpu/ops/sepconv_pallas.py::_kernel`
// (called through `sepconv_infer_pallas`): depthwise 3x3 SAME with f32
// taps and f32 accumulation, rounded to the input type; pointwise
// (pixels, C) @ (C, F) with f32 accumulation; folded BatchNorm and an
// optional ReLU in the epilogue; stored in the input type.  The depthwise
// result never goes to device memory.
//
// What bounds it on this card.  In the Xception-331 predict path the
// 10x10x728 middle flow at b=16 is a small GEMM (M = 1600 pixels, K = N =
// 728; 1.7 GFLOP over ~6 MB, under 2 us at either peak), so it is latency
// bound: the serial K loop of load -> depthwise -> product, the barriers,
// the epilogue.  The 80x80 level (C = 64/128) reads and writes ~52 MB per
// call in bf16 for 3.4 GFLOP, ~64 FLOP per byte against the ~295 the
// tensor cores need, so it is bound by bytes.  Either way the fusion saves
// the write and the re-read of the (B, H, W, C) depthwise intermediate.
//
// Design (simple and right first).  One block owns TM output pixels,
// flattened over (B, H, W) so small images still fill a tile, times TN
// output channels.  It walks C in chunks of KC: for each chunk it stages
// the chunk's depthwise taps and the matching (KC, TN) slice of the
// pointwise weight in shared memory, computes the depthwise result of its
// TM pixels into shared memory (halo read from global memory with SAME
// zero padding), and multiplies the two into f32 accumulators.  Against
// the latency bound: every global access moves 16 bytes per thread with
// consecutive threads on consecutive addresses; each thread issues the
// nine halo loads of a pixel before it uses them; and the bf16 tile is
// wide (32 x 256), so one depthwise chunk feeds 256 output channels (the
// depthwise is recomputed once per N tile, ~9/TN of the pointwise work).
// 16-byte accesses need C and F to be multiples of 16 bytes' worth of
// elements (all Xception shapes are); other shapes take the same code one
// element at a time.  bf16 runs the product on the tensor cores through
// WMMA 16x16x16 fragments; f32 runs it as exact f32 FMAs on the CUDA cores
// (no TF32).  wgmma, TMA and a pipelined ring of stages are later work.
//
// The C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 256;  // 8 warps

// Block tile per type: TM output pixels x TN output channels, C walked in
// chunks of KC; MIN_BLOCKS resident blocks per SM bound the registers.
// Chosen by timing the Xception-331 shapes on an H100 (PERF.md).
template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int TM = 32, TN = 256, KC = 64, MIN_BLOCKS = 2;
};
template <>
struct Tile<float> {
  static constexpr int TM = 64, TN = 64, KC = 64, MIN_BLOCKS = 3;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VN consecutive elements: one 16-byte access when VN > 1, else one element.
template <typename T, int VN>
__device__ __forceinline__ void load_f32(const T* p, float (&v)[VN]) {
  if constexpr (VN == 1) {
    v[0] = to_f32(*p);
  } else {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int j = 0; j < VN; ++j) v[j] = to_f32(e[j]);
  }
}

template <typename T, int VN>
__device__ __forceinline__ void store_f32(T* p, const float (&v)[VN]) {
  if constexpr (VN == 1) {
    *p = from_f32<T>(v[0]);
  } else {
    uint4 r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int j = 0; j < VN; ++j) e[j] = from_f32<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = r;
  }
}

template <typename T, int VN>
__device__ __forceinline__ void copy_or_zero(T* dst, const T* src, bool ok) {
  if constexpr (VN == 1) {
    *dst = ok ? *src : from_f32<T>(0.0f);
  } else {
    *reinterpret_cast<uint4*>(dst) =
        ok ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ float epilogue(float z, float s, float b,
                                          int relu) {
  z = z * s + b;
  return relu ? fmaxf(z, 0.0f) : z;
}

// VN: elements per global access, 16 / sizeof(T) when C and F allow it,
// else 1.
template <typename T, int VN>
__global__ void __launch_bounds__(THREADS, Tile<T>::MIN_BLOCKS)
    sepconv_kernel(const T* __restrict__ x, const float* __restrict__ dw,
                   const T* __restrict__ pw, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ out,
                   int H, int W, int C, int F, int M, int relu) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int TM = Tile<T>::TM, TN = Tile<T>::TN, KC = Tile<T>::KC;
  constexpr int PAD = 16 / sizeof(T);  // keeps rows 16-byte aligned
  constexpr int LDA = KC + PAD;        // (also a multiple of 8 for WMMA)
  constexpr int LDB = TN + PAD;
  constexpr int LDC = TN + 4;          // f32 epilogue staging (bf16 only)
  constexpr int AG = KC / VN;          // vector groups per A row
  constexpr int BG = TN / VN;          // vector groups per B row
  static_assert((TM * AG) % THREADS == 0 && (KC * BG) % THREADS == 0,
                "each thread takes the same number of vector groups");
  // bf16: warps tile the block as WM x WN, each warp FR 16x16 fragments
  constexpr int WM = TM / 16, WN = (THREADS / 32) / WM, FR = TN / (16 * WN);
  static_assert(WM * WN == THREADS / 32 && FR * 16 * WN == TN, "warp tiling");
  // f32: thread (ty, tx) of 16 x 16 owns rows ty + 16 i, columns tx + 16 j
  constexpr int RI = TM / 16, RJ = TN / 16;
  static_assert(THREADS == 256, "the f32 tiling assumes 16 x 16 threads");

  // As (TM, LDA) and Bs (KC, LDB) in the K loop; Cs (TM, LDC) f32 after it
  constexpr int kABytes = TM * LDA * sizeof(T), kBBytes = KC * LDB * sizeof(T);
  constexpr int kCBytes = kBf16 ? TM * LDC * 4 : 0;
  constexpr int kBytes =
      kABytes + kBBytes > kCBytes ? kABytes + kBBytes : kCBytes;
  __shared__ __align__(128) unsigned char smem[kBytes];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + kABytes);
  float* Cs = reinterpret_cast<float*>(smem);
  __shared__ float taps[9 * KC];    // depthwise weights of the chunk
  __shared__ int p_h[TM], p_w[TM];
  __shared__ long long p_base[TM];  // flat pixel index of the image's (0, 0)

  const int t = threadIdx.x;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int HW = H * W;

  if (t < TM) {
    const int m = m0 + t;
    if (m < M) {
      const int b = m / HW;
      const int r = m - b * HW;
      p_h[t] = r / W;
      p_w[t] = r - (r / W) * W;
      p_base[t] = (long long)b * HW;
    } else {  // ragged tail: every tap reads as padding, row is never stored
      p_h[t] = -2;
      p_w[t] = -2;
      p_base[t] = 0;
    }
  }

  const int tx = t % 16, ty = t / 16;
  float acc[RI][RJ] = {};
  const int warp = t / 32, wm = warp % WM, wn = warp / WM;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> cf[FR];
  if constexpr (kBf16) {
#pragma unroll
    for (int j = 0; j < FR; ++j) nvcuda::wmma::fill_fragment(cf[j], 0.0f);
  }

  for (int k0 = 0; k0 < C; k0 += KC) {
    // -- stage the chunk's taps (9, KC) and pointwise slice (KC, TN) --
    for (int i = t; i < 9 * KC; i += THREADS) {
      const int c = k0 + i % KC;
      taps[i] = c < C ? dw[(i / KC) * C + c] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < KC * BG / THREADS; ++r) {
      const int u = t + r * THREADS;
      const int k = u / BG, nl = (u % BG) * VN;
      const int gk = k0 + k, gn = n0 + nl;
      copy_or_zero<T, VN>(Bs + k * LDB + nl, pw + (long long)gk * F + gn,
                          gk < C && gn < F);
    }
    __syncthreads();

    // -- depthwise 3x3 SAME for TM pixels x KC channels, f32 taps/acc --
#pragma unroll
    for (int r = 0; r < TM * AG / THREADS; ++r) {
      const int u = t + r * THREADS;
      const int p = u / AG, cl = (u % AG) * VN;
      const int c = k0 + cl;
      float s[VN] = {};
      if (c < C) {  // with VN > 1, C % VN == 0: the whole vector is in range
        const int h = p_h[p], w = p_w[p];
        const T* xp = x + (p_base[p] + (long long)h * W + w) * C + c;
        float v[9][VN];
#pragma unroll
        for (int i = 0; i < 9; ++i) {  // all nine loads before any use
          const int dh = i / 3 - 1, dv = i % 3 - 1;
          const bool in = h + dh >= 0 && h + dh < H && w + dv >= 0 &&
                          w + dv < W;
          if (in) {
            load_f32<T, VN>(xp + (dh * W + dv) * C, v[i]);
          } else {
#pragma unroll
            for (int j = 0; j < VN; ++j) v[i][j] = 0.0f;
          }
        }
#pragma unroll
        for (int i = 0; i < 9; ++i)
#pragma unroll
          for (int j = 0; j < VN; ++j)
            s[j] = fmaf(v[i][j], taps[i * KC + cl + j], s[j]);
      }
      store_f32<T, VN>(As + p * LDA + cl, s);  // rounded to the input type
    }
    __syncthreads();

    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16,
                               __nv_bfloat16, nvcuda::wmma::row_major>
            af;
        nvcuda::wmma::load_matrix_sync(af, As + wm * 16 * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < FR; ++j) {
          nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16,
                                 __nv_bfloat16, nvcuda::wmma::row_major>
              bf;
          nvcuda::wmma::load_matrix_sync(
              bf, Bs + kk * LDB + (wn * FR + j) * 16, LDB);
          nvcuda::wmma::mma_sync(cf[j], af, bf, cf[j]);
        }
      }
    } else {
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        float a[RI], b[RJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = to_f32(As[(ty + 16 * i) * LDA + k]);
#pragma unroll
        for (int j = 0; j < RJ; ++j) b[j] = to_f32(Bs[k * LDB + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // -- epilogue: folded BN, optional ReLU, store in the input type --
  if constexpr (kBf16) {  // Cs reuses As/Bs: the loop ended on a barrier
#pragma unroll
    for (int j = 0; j < FR; ++j)
      nvcuda::wmma::store_matrix_sync(Cs + wm * 16 * LDC + (wn * FR + j) * 16,
                                      cf[j], LDC, nvcuda::wmma::mem_row_major);
    __syncthreads();
    for (int u = t; u < TM * BG; u += THREADS) {
      const int r = u / BG, col = (u % BG) * VN;
      const int m = m0 + r, n = n0 + col;
      if (m >= M || n >= F) continue;  // with VN > 1, F % VN == 0
      float z[VN];
#pragma unroll
      for (int j = 0; j < VN; ++j)
        z[j] = epilogue(Cs[r * LDC + col + j], scale[n + j], bias[n + j],
                        relu);
      store_f32<T, VN>(out + (long long)m * F + n, z);
    }
  } else {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < F)
          out[(long long)m * F + n] =
              from_f32<T>(epilogue(acc[i][j], scale[n], bias[n], relu));
      }
    }
  }
}

template <typename T>
void launch(const void* x, const void* dw, const void* pw, const void* scale,
            const void* bias, void* out, int B, int H, int W, int C, int F,
            int relu, cudaStream_t s) {
  constexpr int VN = 16 / sizeof(T);
  const int M = B * H * W;
  const dim3 grid((M + Tile<T>::TM - 1) / Tile<T>::TM,
                  (F + Tile<T>::TN - 1) / Tile<T>::TN);
  const auto* xt = static_cast<const T*>(x);
  const auto* dwt = static_cast<const float*>(dw);
  const auto* pwt = static_cast<const T*>(pw);
  const auto* st = static_cast<const float*>(scale);
  const auto* bt = static_cast<const float*>(bias);
  auto* ot = static_cast<T*>(out);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(pw) |
        reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  if (aligned && C % VN == 0 && F % VN == 0)
    sepconv_kernel<T, VN><<<grid, THREADS, 0, s>>>(xt, dwt, pwt, st, bt, ot,
                                                   H, W, C, F, M, relu);
  else
    sepconv_kernel<T, 1><<<grid, THREADS, 0, s>>>(xt, dwt, pwt, st, bt, ot,
                                                  H, W, C, F, M, relu);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Shapes: x (B, H, W, C), dw (3, 3, C)
// f32, pw (C, F) in x's type, scale and bias (F,) f32, out (B, H, W, F);
// all contiguous.
extern "C" int spnet_sepconv_infer(const void* x, const void* dw,
                                   const void* pw, const void* scale,
                                   const void* bias, void* out, int B, int H,
                                   int W, int C, int F, int relu, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch<__nv_bfloat16>(x, dw, pw, scale, bias, out, B, H, W, C, F, relu,
                          s);
  else if (dtype == 0)
    launch<float>(x, dw, pw, scale, bias, out, B, H, W, C, F, relu, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
