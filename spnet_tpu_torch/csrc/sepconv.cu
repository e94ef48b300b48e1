// Fused inference separable convolution for Hopper (sm_90a), NHWC.
//
//   y = relu?( pointwise(depthwise3x3_SAME(relu_in?(x))) * scale + bias )
//
// Replaces the Pallas TPU kernel `spnet_tpu/ops/sepconv_pallas.py::_kernel`
// (called through `sepconv_infer_pallas`): depthwise 3x3 SAME with f32
// taps and f32 accumulation, rounded to the input type; pointwise
// (pixels, C) @ (C, F) with f32 accumulation; folded BatchNorm and an
// optional ReLU in the epilogue; stored in the input type.  The depthwise
// result never goes to device memory.  `relu_in` applies max(0, x) to the
// input as it is read (Xception puts a ReLU before 31 of its 34 separable
// convs; SAME zero padding commutes with it), so no separate ReLU pass
// reads and writes the activation.
//
// What bounds each Xception-331 level on an H100 (bf16; 3.35 TB/s, 989
// TFLOP/s; x read once, out written once, the pointwise weight once), and
// what the design does about it:
//   * 80x80 (C = 64/128, F = 128) and 40x40 (128/256 -> 256): bytes, at up
//     to ~70 FLOP per byte against the ~295 the tensor cores need.  One N
//     tile covers F (TN = F), so x is read and its depthwise computed once;
//     the halo rows a tile shares with its neighbours come from L2.
//   * 20x20, 10x10 (728 -> 728/1024): operations, barely (K = 728, a small
//     GEMM: 1.7 GFLOP in ~6 MB at b=16).  The depthwise of the next chunk
//     runs on the CUDA cores while the tensor cores multiply this one, and
//     the copies run ahead of both.  TN = 256 recomputes the depthwise once
//     per N tile (3x at F = 728, 4x at 1024).
//   * 5x5 (1024/1536 -> 1536/2048): bytes again, the weights now the larger
//     part (400 pixels at b=16).  TM drops to 64 wherever 128 would leave
//     SMs idle.
//
// bf16 design (`wgmma_kernel`).  A persistent block of NC = TM/64
// warpgroups walks (TM pixels x TN output channels) tiles blockIdx.x,
// + gridDim.x, ..., pixels flattened over (B, H, W) so small images still
// fill a tile.  Each tile walks C in 64-channel chunks; a (tile, chunk) is
// one step.
//   * Copies.  Thread 0 has TMA copy a step's (64 x TN) pointwise slice into
//     a B stage (128-byte swizzle, the layout the wgmma descriptor reads)
//     and its f32 taps and x halo (the TM pixel rows of the (B*H*W, C) view
//     and W + 1 rows either side) into an x stage; zero fill past C, F and
//     the first and last pixel.  Each stage has a full mbarrier (expect_tx).
//     The x ring is three stages deep, the B ring two.
//   * Every warpgroup, per step: waits for the B stage, issues four
//     `wgmma.mma_async` m64 x TN x k16 (A K-major, B MN-major, both in
//     shared memory) on its 64 rows, commits, and while they run computes
//     the depthwise of the NEXT step from its x stage into the other A
//     buffer: 4 channels and a run of 8 pixel rows a thread, the 3x3 window
//     sliding along the image row in registers (3 loads a pixel, not 9),
//     the input ReLU as a bf16x2 max as it reads, f32 taps and
//     accumulation, rounded to bf16 and written straight into the
//     128-byte-swizzled K-major layout.  Then it waits for its product.
//     The accumulator stays in registers across the whole C loop.
//   * Release.  One block barrier per step marks every stage the step used
//     as empty (the products retired, the next A is complete, the x stage
//     was read), and thread 0 refills them.  The warps that consume a stage
//     also produce the next A, so a separate empty mbarrier would wait on
//     the same event.
//   * Epilogue, at a tile's last chunk: folded BN and the optional ReLU on
//     the registers, bf16 pairs staged in free shared memory (16-byte chunks
//     swizzled by row: no bank conflicts), then 16-byte stores of whole row
//     segments; M and F edges masked.
// Tiles are chosen per shape in Python (`ops/sepconv.py::sepconv_plan`): TN
// follows F (128 at F = 128, else 256), TM is 128 unless that leaves fewer
// tiles than SMs.  This path takes bf16 with C and F multiples of 8,
// 16-byte aligned pointers and a halo that fits in shared memory.
//
// Simple path (`simple_kernel`): float32 (only the parity checks use it),
// and bf16 views or shapes the wgmma path does not take.  One block of 256
// threads owns TM x TN outputs and walks C in chunks of KC: stage taps and
// weights, compute the depthwise into shared memory (nine loads a pixel),
// multiply (WMMA for bf16, exact f32 FMAs for f32), one element at a time
// when C or F is not a multiple of 16 bytes' worth of elements.
//
// The C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// Simple path
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;  // 8 warps

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
    simple_kernel(const T* __restrict__ x, const float* __restrict__ dw,
                  const T* __restrict__ pw, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ out, int H,
                  int W, int C, int F, int M, int relu, int relu_in) {
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
          for (int j = 0; j < VN; ++j) {
            const float xv = relu_in ? fmaxf(v[i][j], 0.0f) : v[i][j];
            s[j] = fmaf(xv, taps[i * KC + cl + j], s[j]);
          }
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
void launch_simple(const void* x, const void* dw, const void* pw,
                   const void* scale, const void* bias, void* out, int B,
                   int H, int W, int C, int F, int relu, int relu_in,
                   cudaStream_t s) {
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
    simple_kernel<T, VN><<<grid, THREADS, 0, s>>>(
        xt, dwt, pwt, st, bt, ot, H, W, C, F, M, relu, relu_in);
  else
    simple_kernel<T, 1><<<grid, THREADS, 0, s>>>(
        xt, dwt, pwt, st, bt, ot, H, W, C, F, M, relu, relu_in);
}

// ---------------------------------------------------------------------------
// wgmma path (bf16)
// ---------------------------------------------------------------------------

constexpr int KC = 64;             // channels per chunk: one 128-byte row
constexpr int ROW_BYTES = KC * 2;  // of bf16, the width of the swizzle

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of `parity` has completed.  A phase that never
// completes (a fault of this kernel) traps after ~4 s instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 4095) == 0) {  // the clock only on long waits
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > 4000000000ull)
        __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all >> 4.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Pins the accumulator registers at this point of the program, so that the
// compiler moves no access to them across a wgmma fence or wait.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major) * B (16 x N, MN-major): a-desc, b-desc, scale-d
// = 1, no negation, A not transposed, B transposed (MN-major).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int TN>
__device__ __forceinline__ void wgmma_k16(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b) {
  if constexpr (TN == 64)
    wgmma_n64(d, a, b);
  else if constexpr (TN == 128)
    wgmma_n128(d, a, b);
  else
    wgmma_n256(d, a, b);
}

template <int NC, int TN>
struct WgmmaCfg {
  static constexpr int TM = 64 * NC;
  static constexpr int THREADS = 128 * NC;
  static constexpr int A_BYTES = TM * ROW_BYTES;  // (TM, 64) bf16, swizzled
  static constexpr int B_BYTES = TN * ROW_BYTES;  // TN/64 boxes of (64, 64)
  static constexpr int TAP_BYTES = 9 * KC * 4;    // the chunk's f32 taps
  // stages in the rings: x halos and taps, weight slices
  static constexpr int B_STAGES = 2, X_STAGES = 3;
  // the x halo of a tile in the flattened (B*H*W, C) view: W + 1 pixel rows
  // before and after its TM, in boxes of at most 256 rows (TMA's limit)
  static __host__ __device__ int halo_rows(int W) { return TM + 2 * W + 2; }
  static __host__ __device__ int halo_boxes(int W) {
    return (halo_rows(W) + 255) / 256;
  }
  static __host__ __device__ int box_rows(int W) {
    return (halo_rows(W) + halo_boxes(W) - 1) / halo_boxes(W);
  }
  static __host__ __device__ int x_tx_bytes(int W) {
    return TAP_BYTES + halo_boxes(W) * box_rows(W) * ROW_BYTES;
  }
  static __host__ __device__ int x_stage_bytes(int W) {
    return (x_tx_bytes(W) + 1023) / 1024 * 1024;
  }
  // 1 KB of alignment slack, two A buffers, the B ring, the x ring,
  // mbarriers
  static __host__ __device__ int smem_bytes(int W) {
    return 1024 + 2 * A_BYTES + B_STAGES * B_BYTES +
           X_STAGES * x_stage_bytes(W) + (B_STAGES + X_STAGES) * 8;
  }
};

// Rows h-1, h, h+1 of one column, the thread's 4 channels (one uint2 of
// bf16 each) from the x halo in shared memory: `xs` points at the column's
// row h; rows and columns outside the image read as zero; `floor` is the
// input ReLU as a bf16x2 max (0, or -inf for none).  Plain loads, no
// branches: the compiler may start the loads of later pixels early.
__device__ __forceinline__ void load_col(const uint2* xs, int W4, bool up,
                                         bool down, bool in_col,
                                         __nv_bfloat162 floor,
                                         float (&col)[3][4]) {
  const uint2 raw[3] = {xs[-W4], xs[0], xs[W4]};
  const bool ok[3] = {up && in_col, in_col, down && in_col};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    uint2 v = ok[r] ? raw[r] : make_uint2(0, 0);
    __nv_bfloat162 a = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&v.x), floor);
    __nv_bfloat162 b = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&v.y), floor);
    const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    col[r][0] = fa.x;
    col[r][1] = fa.y;
    col[r][2] = fb.x;
    col[r][3] = fb.y;
  }
}

// The depthwise of one chunk for the thread's 4 channels (group g) and its
// run of 8 pixel rows (ml0 ... ml0 + 7 of the tile, first at image (h, w)),
// from the x stage (taps, then the halo) into the A buffer, rounded to
// bf16, in the 128-byte-swizzled K-major layout wgmma reads.  Rows past M
// and channels past C are written as zeros.
__device__ __forceinline__ void depthwise_run(
    const unsigned char* xstage, unsigned char* a_buf, int g, int ml0, int h,
    int w, int H, int W, bool live, int rows_left, __nv_bfloat162 floor) {
  const float* taps = reinterpret_cast<const float*>(xstage);
  float tap[3][3][4];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(taps + i * KC + 4 * g);
    tap[i / 3][i % 3][0] = v.x;
    tap[i / 3][i % 3][1] = v.y;
    tap[i / 3][i % 3][2] = v.z;
    tap[i / 3][i % 3][3] = v.w;
  }
  // the thread's 4 channels of halo row 0, in uint2 of 4 bf16: a 128-byte
  // pixel row is 16 of them
  const uint2* xs =
      reinterpret_cast<const uint2*>(xstage + 9 * KC * 4) + g;
  const int W4 = 16 * W;  // one image row down, in uint2
  float win[3][3][4];     // [column w-1, w, w+1][row][channel]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ml = ml0 + j;
    const uint2* xc = xs + 16 * (ml + W + 1);  // the halo row of pixel ml
    const bool up = h > 0, down = h + 1 < H;
    if (j == 0 || w == 0) {  // a fresh row: no column to reuse
      load_col(xc - 16, W4, up, down, w > 0, floor, win[0]);
      load_col(xc, W4, up, down, true, floor, win[1]);
    } else {
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          win[0][r][q] = win[1][r][q];
          win[1][r][q] = win[2][r][q];
        }
    }
    load_col(xc + 16, W4, up, down, w + 1 < W, floor, win[2]);
    // two partial sums a channel: chains of 6 and 3 multiply-adds
    float acc[4], acc2[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[q] = win[0][0][q] * tap[0][0][q];
      acc2[q] = win[0][2][q] * tap[2][0][q];
#pragma unroll
      for (int v = 1; v < 3; ++v) {
        acc[q] = fmaf(win[v][0][q], tap[0][v][q], acc[q]);
        acc2[q] = fmaf(win[v][2][q], tap[2][v][q], acc2[q]);
      }
#pragma unroll
      for (int v = 0; v < 3; ++v)
        acc[q] = fmaf(win[v][1][q], tap[1][v][q], acc[q]);
      acc[q] += acc2[q];
    }
    const bool keep = live && j < rows_left;
    const __nv_bfloat162 lo =
        __floats2bfloat162_rn(keep ? acc[0] : 0.f, keep ? acc[1] : 0.f);
    const __nv_bfloat162 hi =
        __floats2bfloat162_rn(keep ? acc[2] : 0.f, keep ? acc[3] : 0.f);
    // row ml, bytes 8g..8g+7, its 16-byte chunk swizzled by the row
    *reinterpret_cast<uint2*>(a_buf + (ml >> 3) * 1024 + (ml & 7) * 128 +
                              ((((g >> 1) ^ (ml & 7)) << 4) | ((g & 1) << 3))) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
    if (++w == W) {
      w = 0;
      if (++h == H) h = 0;
    }
  }
}

template <int NC, int TN>
__global__ void __launch_bounds__(WgmmaCfg<NC, TN>::THREADS, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap pw_map,
                 const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap dw_map,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int H, int W, int C, int F,
                 int M, int relu, int relu_in) {
  using Cfg = WgmmaCfg<NC, TN>;
  constexpr int TM = Cfg::TM;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the swizzle pattern is a function of the address
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  unsigned char* a_bufs = smem;  // A[0], A[1]
  const uint32_t b_stages = base + 2 * Cfg::A_BYTES;
  const int xsb = Cfg::x_stage_bytes(W);
  constexpr int b_ring = Cfg::B_STAGES;
  unsigned char* x_stages = smem + 2 * Cfg::A_BYTES + b_ring * Cfg::B_BYTES;
  const uint32_t bars = smem_u32(x_stages) + Cfg::X_STAGES * xsb;
  auto b_full = [&](int s) { return bars + 8 * s; };
  auto x_full = [&](int s) { return bars + 8 * (b_ring + s); };

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = t % 32;
  const int HW = H * W;
  const int n_tiles = (F + TN - 1) / TN;
  const int tiles = ((M + TM - 1) / TM) * n_tiles;
  const int chunks = (C + KC - 1) / KC;
  // this block's (tile, chunk) steps: tiles blockIdx.x, + gridDim.x, ...
  const int steps =
      ((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x) * chunks;
  auto step_m0 = [&](int i) {
    return ((blockIdx.x + (i / chunks) * gridDim.x) / n_tiles) * TM;
  };
  auto step_n0 = [&](int i) {
    return ((blockIdx.x + (i / chunks) * gridDim.x) % n_tiles) * TN;
  };
  // thread 0 has TMA copy step i's weight slice (64 x TN) into its B stage
  // and its taps and x halo into its x stage
  const int boxes = Cfg::halo_boxes(W), box_rows = Cfg::box_rows(W);
  auto load_b = [&](int i) {
    const int s = i % b_ring;
    mbar_arrive_expect_tx(b_full(s), Cfg::B_BYTES);
    for (int box = 0; box < TN / 64; ++box)
      tma_load_2d(b_stages + s * Cfg::B_BYTES + box * 64 * ROW_BYTES, &pw_map,
                  b_full(s), step_n0(i) + box * 64, (i % chunks) * KC);
  };
  auto load_x = [&](int i) {
    const int s = i % Cfg::X_STAGES;
    const uint32_t dst = smem_u32(x_stages) + s * xsb;
    mbar_arrive_expect_tx(x_full(s), Cfg::x_tx_bytes(W));
    const int k0 = (i % chunks) * KC;
    tma_load_2d(dst, &dw_map, x_full(s), k0, 0);
    for (int box = 0; box < boxes; ++box)  // rows before 0 or past M: zeros
      tma_load_2d(dst + Cfg::TAP_BYTES + box * box_rows * ROW_BYTES, &x_map,
                  x_full(s), k0, step_m0(i) - W - 1 + box * box_rows);
  };

  if (tid == 0) {
    for (int s = 0; s < b_ring + Cfg::X_STAGES; ++s)
      mbar_init(bars + 8 * s, 1);  // the copying thread's expect_tx arrival
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < Cfg::X_STAGES && i < steps; ++i) load_x(i);
    for (int i = 0; i < b_ring && i < steps; ++i) load_b(i);
  }
  __syncthreads();

  const float lowest = relu_in ? 0.f : __int_as_float(0xff800000);  // -inf
  const __nv_bfloat162 floor = __floats2bfloat162_rn(lowest, lowest);
  // the thread's depthwise share: channels 4g..4g+3 of each chunk, the 8
  // pixel rows ml0 ... ml0 + 7 of the tile
  const int g = t & 15, ml0 = wg * 64 + (t >> 4) * 8;
  auto depthwise = [&](int i) {
    const int m = step_m0(i) + ml0;
    const int hw = m % HW;
    mbar_wait(x_full(i % Cfg::X_STAGES), (i / Cfg::X_STAGES) & 1);
    depthwise_run(x_stages + (i % Cfg::X_STAGES) * xsb,
                  a_bufs + (i % 2) * Cfg::A_BYTES, g, ml0, hw / W, hw % W, H,
                  W, (i % chunks) * KC + 4 * g < C, M - m, floor);
    // the generic-proxy writes of A, visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };

  // A step's depthwise runs while the tensor cores multiply the step before
  // (across tiles too); the first one has nothing to hide behind
  if (steps > 0) depthwise(0);
  __syncthreads();
  float d[TN / 2];
  for (int it = 0; it < steps; ++it) {
    const int kc = it % chunks;
    if (kc == 0) {
#pragma unroll
      for (int r = 0; r < TN / 2; ++r) d[r] = 0.0f;
      fence_operands(d);
    }
    const int bs = it % b_ring;
    mbar_wait(b_full(bs), (it / b_ring) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      // A: this warpgroup's 64 rows, K step of 16 = 32 bytes; B: 16 rows of
      // 128 bytes, N blocks of 64 columns 64 rows apart
      const uint64_t da = wgmma_desc(
          base + (it % 2) * Cfg::A_BYTES + wg * 64 * ROW_BYTES + kk * 32, 16,
          1024);
      const uint64_t db = wgmma_desc(
          b_stages + bs * Cfg::B_BYTES + kk * 16 * ROW_BYTES, 64 * ROW_BYTES,
          1024);
      wgmma_k16<TN>(d, da, db);
    }
    wgmma_commit();
    if (it + 1 < steps) depthwise(it + 1);
    wgmma_wait<0>();
    fence_operands(d);
    // every warpgroup's product of this step has retired (its A and B are
    // free), the next step's A is complete, and its x stage has been read
    __syncthreads();
    if (tid == 0) {
      if (it + b_ring < steps) load_b(it + b_ring);
      if (it + Cfg::X_STAGES < steps) load_x(it + Cfg::X_STAGES);
    }
    if (kc + 1 < chunks) continue;

    // epilogue: BN + ReLU on the registers, bf16 pairs staged in free
    // shared memory (16-byte chunks swizzled by the row), then 16-byte
    // stores of whole row segments.  With 2 warpgroups, the first stages
    // in this step's A buffer and the second in the x stage the next
    // step's depthwise has just read, 128 columns a pass; alone, a
    // warpgroup takes that x stage 64 columns a pass.
    constexpr int PASS = (NC == 2 && TN >= 128) ? 128 : 64;
    constexpr int ROW = 2 * PASS;  // staging row bytes
    const int m0 = step_m0(it), n0 = step_n0(it);
    unsigned char* stg =
        (NC == 2 && wg == 0)
            ? a_bufs + (it % 2) * Cfg::A_BYTES
            : x_stages + ((it + 1) % Cfg::X_STAGES) * xsb;
#pragma unroll
    for (int pass = 0; pass < TN / PASS; ++pass) {
      named_bar_sync(1 + wg, 128);  // the last pass's rows have been read
#pragma unroll
      for (int jj = 0; jj < PASS / 8; ++jj) {
        const int j = pass * (PASS / 8) + jj;
        const int n = n0 + 8 * j + 2 * (lane & 3);
        float2 sc = make_float2(0.f, 0.f), bi = make_float2(0.f, 0.f);
        if (n < F) {  // F % 8 == 0: both columns in or out
          sc = __ldg(reinterpret_cast<const float2*>(scale + n));
          bi = __ldg(reinterpret_cast<const float2*>(bias + n));
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = warp * 16 + (lane >> 2) + 8 * half;
          float z0 = d[4 * j + 2 * half] * sc.x + bi.x;
          float z1 = d[4 * j + 2 * half + 1] * sc.y + bi.y;
          if (relu) {
            z0 = fmaxf(z0, 0.0f);
            z1 = fmaxf(z1, 0.0f);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              stg + row * ROW + ((jj ^ (row & 7)) << 4) + 4 * (lane & 3)) =
              __floats2bfloat162_rn(z0, z1);
        }
      }
      named_bar_sync(1 + wg, 128);
      constexpr int PER_ROW = PASS / 8;  // 16-byte chunks of a row
#pragma unroll
      for (int idx = t; idx < 64 * PER_ROW; idx += 128) {
        const int row = idx / PER_ROW, c = idx % PER_ROW;
        const int m = m0 + wg * 64 + row, n = n0 + pass * PASS + 8 * c;
        if (m < M && n < F)
          *reinterpret_cast<uint4*>(out + (long long)m * F + n) =
              *reinterpret_cast<const uint4*>(stg + row * ROW +
                                              ((c ^ (row & 7)) << 4));
      }
    }
    // the first warpgroup's staging holds the other's A rows of the step
    // after next
    if constexpr (NC == 2) __syncthreads();
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D row-major (rows, cols) tensor of 2- or 4-byte elements as boxes of
// (box_rows, box_cols), zero fill out of bounds, into *out; false when it
// cannot be encoded.  Cached per (pointer, shape, box, swizzle): a model's
// tensors come back to the same few addresses.  The map is copied out, not
// pointed at: a later lookup of the same launch may overwrite its entry
// once the ring has wrapped.
bool tensor_map(CUtensorMap* out, const void* ptr, bool f32, long long rows,
                int cols, int box_rows, int box_cols, bool swizzle) {
  struct Entry {
    const void* ptr;
    long long rows;
    int cols, box_rows, box_cols;
    bool f32, swizzle;
    CUtensorMap map;
  };
  constexpr int N = 256;
  static Entry cache[N];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.ptr == ptr && e.rows == rows && e.cols == cols &&
        e.box_rows == box_rows && e.box_cols == box_cols && e.f32 == f32 &&
        e.swizzle == swizzle) {
      *out = e.map;
      return true;
    }
  }
  EncodeTiled encode = encoder();
  if (!encode) return false;
  Entry& e = cache[next];
  const int esize = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estride[2] = {1, 1};
  if (encode(&e.map,
             f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<void*>(ptr), dims, strides, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  e.ptr = ptr;
  e.rows = rows;
  e.cols = cols;
  e.box_rows = box_rows;
  e.box_cols = box_cols;
  e.f32 = f32;
  e.swizzle = swizzle;
  next = (next + 1) % N;
  if (used < N) ++used;
  *out = e.map;
  return true;
}

template <int NC, int TN>
int launch_wgmma(const void* x, const void* dw, const void* pw,
                 const void* scale, const void* bias, void* out, int B, int H,
                 int W, int C, int F, int relu, int relu_in, int blocks,
                 cudaStream_t s) {
  using Cfg = WgmmaCfg<NC, TN>;
  const long long M = static_cast<long long>(B) * H * W;
  // the weight in (64 x 64) swizzled boxes; x in (box_rows x 64) rows of
  // the (M, C) view; the taps as (9 x 64) of the (9, C) view
  CUtensorMap pw_map, x_map, dw_map;
  if (!tensor_map(&pw_map, pw, false, C, F, 64, 64, true) ||
      !tensor_map(&x_map, x, false, M, C, Cfg::box_rows(W), KC, false) ||
      !tensor_map(&dw_map, dw, true, 9, C, 9, KC, false))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Cfg::smem_bytes(W);
  static int configured = 0;  // the largest size allowed so far
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgmma_kernel<NC, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  wgmma_kernel<NC, TN><<<blocks, Cfg::THREADS, smem, s>>>(
      pw_map, x_map, dw_map, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), H, W,
      C, F, static_cast<int>(M), relu, relu_in);
  return 0;
}

}  // namespace

// Shared memory the wgmma path needs for tiles (tm, tn) at image width w; 0
// for tiles it does not have.
extern "C" int spnet_sepconv_wgmma_smem(int tm, int tn, int w) {
#define SEPCONV_CASE(NC_, TN_) \
  if (tm == 64 * NC_ && tn == TN_) return WgmmaCfg<NC_, TN_>::smem_bytes(w);
  SEPCONV_CASE(1, 64)
  SEPCONV_CASE(1, 128)
  SEPCONV_CASE(1, 256)
  SEPCONV_CASE(2, 64)
  SEPCONV_CASE(2, 128)
  SEPCONV_CASE(2, 256)
#undef SEPCONV_CASE
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  Shapes: x (B, H, W, C), dw (3, 3, C)
// f32, pw (C, F) in x's type, scale and bias (F,) f32, out (B, H, W, F);
// all contiguous.  tm = 0: the simple path; tm = 64 or 128 with tn = 64,
// 128 or 256 (bf16, C and F multiples of 8, 16-byte aligned pointers): the
// wgmma path with `blocks` persistent blocks (`sepconv_plan`).
extern "C" int spnet_sepconv_infer(const void* x, const void* dw,
                                   const void* pw, const void* scale,
                                   const void* bias, void* out, int B, int H,
                                   int W, int C, int F, int relu, int relu_in,
                                   int dtype, int tm, int tn, int blocks,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (tm == 0 && dtype == 1) {
    launch_simple<__nv_bfloat16>(x, dw, pw, scale, bias, out, B, H, W, C, F,
                                 relu, relu_in, s);
  } else if (tm == 0 && dtype == 0) {
    launch_simple<float>(x, dw, pw, scale, bias, out, B, H, W, C, F, relu,
                         relu_in, s);
  } else if (dtype == 1 && C % 8 == 0 && F % 8 == 0 && blocks > 0) {
#define SEPCONV_CASE(NC_, TN_)                                              \
  if (tm == 64 * NC_ && tn == TN_)                                          \
    err = launch_wgmma<NC_, TN_>(x, dw, pw, scale, bias, out, B, H, W, C, F, \
                                 relu, relu_in, blocks, s);                 \
  else
    SEPCONV_CASE(1, 64)
    SEPCONV_CASE(1, 128)
    SEPCONV_CASE(1, 256)
    SEPCONV_CASE(2, 64)
    SEPCONV_CASE(2, 128)
    SEPCONV_CASE(2, 256)
    err = static_cast<int>(cudaErrorInvalidValue);
#undef SEPCONV_CASE
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
