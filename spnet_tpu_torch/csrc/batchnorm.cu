// Train-mode (batch-statistics) BatchNorm for Hopper (sm_90a), with the
// activation that follows it: forward and backward.
//
// Replaces no Pallas kernel: the JAX package leaves flax's
// `nn.BatchNorm(momentum, epsilon=1e-3)` to XLA, which fuses it with its
// neighbours on the TPU.  In the port the layer ran flax's arithmetic as
// separate float32 torch ops over a float32 copy of each activation, about
// 36 kernels a layer a training step with its backward; this family takes
// their place on the card (`models/layers.py::BatchNorm` in train mode on a
// CUDA tensor, through `ops/batchnorm.py`).
//
// What it computes, per channel c of x (rows, C), rows = N * H * W of an
// NHWC activation, in float32 whatever x's type (flax 0.12's order):
//
//   mean = E[x],  raw = E[x^2] - mean^2,  var = max(raw, 0)
//   rstd = rsqrt(var + eps),  mul = rstd * scale (rstd without a scale)
//   z = T((x - mean) * mul + bias),   y = T(act(z))
//   running = m * running + (1 - m) * (mean | var)   (unless update_stats
//   is off; var is the biased variance)
//
// T(.) rounds to x's type; act is none, ReLU, ReLU6 or LeakyReLU(0.1),
// applied to z as the module after the BatchNorm would (so y is bitwise
// what those two ops would give from the same statistics).  The backward
// recomputes z from x, takes dy through act's mask at z (g), and with
// s1 = sum g, s2 = sum g (x - mean) over the rows:
//
//   dbias = s1,  dscale = s2 * rstd
//   dx = T(a g - (c (x - mean) + b)),  a = mul,  b = a s1 / n,
//   c = keep * a * rstd^2 * s2 / n
//
// keep is 0 where the fast variance was clamped (raw < 0: clamp_min passes
// no gradient there), else 1.  In a process group of W ranks the wrapper
// all-reduces the moments between the stats and the finalize, and the
// sums s1, s2 between their finalize and dx (n is then the global count);
// dscale and dbias stay the rank's own, as autograd gives them.
//
// What bounds it.  About one operation a byte: memory.  The least traffic
// is x read and y written forward, x and dy read and dx written backward
// (10 bytes an element in bf16).  Each direction makes two passes over x
// (and dy): the reduction, then the elementwise pass.  The elementwise
// pass walks each thread's rows last to first, so that it starts on the
// rows the reduction read last, which the 50 MB L2 still holds; the
// activations of the models (up to ~26 MB in bf16 at b=16) mostly stay in
// the L2 between the two.
//
// Design.  A thread owns VW consecutive channels (VW = 8, 4, 2 or 1: the
// widest that divides C and the pointers' alignment; 8 bf16 channels are
// one 16-byte load), neighbouring threads neighbouring channels, so a warp
// reads up to 512 contiguous bytes of a row.  A block is 256 threads:
// TW = min(32, next power of two of C / VW) threads across the channels,
// 256 / TW rows deep; the grid is (channel tiles, splits), and the block
// of split s takes rows s * RB + ty, stepping by splits * RB, four rows in
// flight.  `spnet_batchnorm_splits` sizes splits from the shape: enough
// blocks for four on each SM, and at least four rows a thread.  Each
// reduction block sums its rows, then its 256 / TW row lanes by a tree in
// shared memory, and writes one partial per split and channel to a
// scratch buffer; a finalize kernel (one warp a channel) sums the
// partials in a fixed order.  No float atomics: the results depend on the
// shape alone, so a CUDA graph replays the eager steps' bits.
//
// On chip: one launch a direction.  Where a layer's rows fit, the
// wrapper (`ops/batchnorm.py::onchip_plan`) takes batchnorm_onchip_fwd /
// _bwd_kernel instead: the grid is (channel groups, K), launched as
// clusters of K blocks (K <= 8, the portable size), one cluster a group of
// TW * VW channels, each block of it over rows / K rows.  A block copies
// its rows of x (and dy) once into shared memory with cp.async (every row
// of a thread in flight at once), sums them as the reduction kernels do
// (the row lanes by warp shuffles and one block barrier), publishes its
// partials in its own shared memory and waits on the cluster's barrier;
// then every block reads the K partials through distributed shared memory
// in cluster-rank order (the same order on every block, so each finds the
// same statistics, with no float atomics and no broadcast), finishes them
// with the finalize kernels' arithmetic (rank 0 writes stats, the running
// statistics, dscale and dbias) and runs the elementwise pass from the
// slab it holds.  A second cluster barrier, its
// arrival right after the remote reads and its wait at the end, keeps each
// block's shared memory alive until the others have read it.  One launch
// in place of three, x (and dy) read from device memory once, no scratch:
// for the models' small layers the launches and the finalizes, not the
// bytes, were most of the time.  Shared memory bounds it: a block's slab of
// x and dy is rows / K x TW x VW x 2 elements, within what the card allows
// a block beside the kernels' static shared memory, and the grid stays
// within 0.9 blocks an SM, so that every cluster is resident at once (at
// one block an SM an H100 holds clusters of 4 or 8 on only 120 of its SMs,
// and a larger grid ran in two waves, slower than the three-launch path).
// Inside a process group
// of W > 1 ranks the all-reduce sits between the reduction and the
// elementwise pass, so the wrapper keeps the three-launch path there.
//
// The C entries launch on the caller's stream, allocate nothing (the
// wrapper hands in outputs and scratch from `torch.empty`) and return
// cudaGetLastError().  dtype 0 is float32, 1 bfloat16.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_VW = 8;
constexpr int UNROLL = 4;       // rows in flight a thread
constexpr int BLOCKS_PER_SM = 4;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
// the codes of ops/batchnorm.py::ACTS
constexpr int ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2, ACT_LEAKY = 3;

template <typename T, int VW>
struct alignas(sizeof(T) * VW) Pack {
  T v[VW];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v as a tensor of type T holds it
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

template <typename T, int VW>
__device__ __forceinline__ void load(const T* p, float out[VW]) {
  const Pack<T, VW> pk = *reinterpret_cast<const Pack<T, VW>*>(p);
#pragma unroll
  for (int k = 0; k < VW; ++k) out[k] = to_f(pk.v[k]);
}

template <typename T, int VW>
__device__ __forceinline__ void store(T* p, const float in[VW]) {
  Pack<T, VW> pk;
#pragma unroll
  for (int k = 0; k < VW; ++k) pk.v[k] = from_f<T>(in[k]);
  *reinterpret_cast<Pack<T, VW>*>(p) = pk;
}

// z = T((x - mean) * mul + bias), each op rounded as the separate float32
// torch ops of the plain composition round it (no contraction to fma)
template <typename T>
__device__ __forceinline__ float normalized(float x, float mean, float mul,
                                            float bias) {
  return round_to<T>(__fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias));
}

template <typename T>
__device__ __forceinline__ float activate(float z, int act) {
  switch (act) {
    case ACT_RELU: return z < 0.f ? 0.f : z;
    case ACT_RELU6: return z < 0.f ? 0.f : (z > 6.f ? 6.f : z);
    case ACT_LEAKY: return round_to<T>(z > 0.f ? z : z * 0.1f);
    default: return z;
  }
}

// dy through the activation's derivative at z, as torch's backward of
// relu (threshold_backward on the output), relu6 (hardtanh_backward) and
// leaky_relu rounds it
template <typename T>
__device__ __forceinline__ float act_grad(float dy, float z, int act) {
  switch (act) {
    case ACT_RELU: return z > 0.f ? dy : 0.f;
    case ACT_RELU6: return (z <= 0.f || z >= 6.f) ? 0.f : dy;
    case ACT_LEAKY: return z > 0.f ? dy : round_to<T>(dy * 0.1f);
    default: return dy;
  }
}

// The per-channel constants of the elementwise passes for this thread's
// VW channels from c0.
template <int VW>
__device__ __forceinline__ void channel_consts(
    const float* __restrict__ stats, const float* __restrict__ weight,
    const float* __restrict__ bias, int C, int c0, float mean[VW],
    float mul[VW], float b[VW]) {
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    mean[k] = stats[c0 + k];
    const float rstd = stats[C + c0 + k];
    mul[k] = weight ? __fmul_rn(rstd, weight[c0 + k]) : rstd;
    b[k] = bias[c0 + k];
  }
}

// Sums a[] and b[] over the block's row lanes (threadIdx.y) by a tree in
// shared memory; row lane 0 ends with the block's sums.  blockDim.y is a
// power of two.
template <int VW>
__device__ __forceinline__ void sum_row_lanes(float a[VW], float b[VW]) {
  __shared__ float sh[2][THREADS * MAX_VW];
  const int t = (threadIdx.y * blockDim.x + threadIdx.x) * VW;
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    sh[0][t + k] = a[k];
    sh[1][t + k] = b[k];
  }
  __syncthreads();
  for (int h = blockDim.y / 2; h > 0; h >>= 1) {
    if (threadIdx.y < h) {
      const int o = t + h * blockDim.x * VW;
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        a[k] += sh[0][o + k];
        b[k] += sh[1][o + k];
        sh[0][t + k] = a[k];
        sh[1][t + k] = b[k];
      }
    }
    __syncthreads();
  }
}

// part (splits, 2, C): this block's sums of a[] and b[] for its channels
template <int VW>
__device__ __forceinline__ void write_partial(float* __restrict__ part,
                                              int C, int col, int V,
                                              const float a[VW],
                                              const float b[VW]) {
  if (threadIdx.y != 0 || col >= V) return;
  float* p = part + 2LL * blockIdx.y * C + col * VW;
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    p[k] = a[k];
    p[C + k] = b[k];
  }
}

// The sums of part[i][j][c] over i < splits for j = 0, 1, in a fixed order
// (lane strides, then a shuffle tree); every lane of the warp gets them.
__device__ __forceinline__ void sum_partials(const float* __restrict__ part,
                                             int splits, int C, int c,
                                             float& a, float& b) {
  const int lane = threadIdx.x & 31;
  a = 0.f;
  b = 0.f;
  for (int i = lane; i < splits; i += 32) {
    a += part[2LL * i * C + c];
    b += part[(2LL * i + 1) * C + c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  a = __shfl_sync(0xffffffffu, a, 0);
  b = __shfl_sync(0xffffffffu, b, 0);
}

// rstd of a channel from its mean and E[x^2] (flax's fast variance,
// clamped at 0); when stats is given, writes mean, rstd and keep (0 where
// the variance was clamped) of channel c into it, and updates the running
// statistics when running_mean is given.
__device__ __forceinline__ float finish_channel(
    float mean, float mean_sq, float eps, int C, int c,
    float* __restrict__ stats, float* __restrict__ running_mean,
    float* __restrict__ running_var, float momentum,
    float one_minus_momentum) {
  const float raw = __fsub_rn(mean_sq, __fmul_rn(mean, mean));
  const float var = raw < 0.f ? 0.f : raw;
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  if (stats) {
    stats[c] = mean;
    stats[C + c] = rstd;
    stats[2 * C + c] = raw >= 0.f ? 1.f : 0.f;
  }
  if (running_mean) {
    running_mean[c] = __fadd_rn(__fmul_rn(momentum, running_mean[c]),
                                __fmul_rn(one_minus_momentum, mean));
    running_var[c] = __fadd_rn(__fmul_rn(momentum, running_var[c]),
                               __fmul_rn(one_minus_momentum, var));
  }
  return rstd;
}

// The dx pass's coefficients of channel c from its sums s1, s2 (inv_n =
// 1 / the rows' count): a = mul, b = a s1 / n, cc = keep a rstd^2 s2 / n.
__device__ __forceinline__ void grad_coefs(float s1, float s2, float rstd,
                                           float keep,
                                           const float* __restrict__ weight,
                                           int c, float inv_n, float& a,
                                           float& b, float& cc) {
  a = weight ? __fmul_rn(rstd, weight[c]) : rstd;
  b = a * s1 * inv_n;
  cc = keep * a * rstd * rstd * s2 * inv_n;
}

// ---- forward ---------------------------------------------------------

template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
    batchnorm_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                           long long rows, int C) {
  const int V = C / VW;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.y * blockDim.y;
  float s[VW], q[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) s[k] = q[k] = 0.f;
  if (col < V) {
    const T* base = x + (long long)col * VW;
    long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
    for (; r + (UNROLL - 1) * step < rows; r += UNROLL * step) {
      float v[UNROLL][VW];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        load<T, VW>(base + (r + u * step) * C, v[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int k = 0; k < VW; ++k) {
          s[k] += v[u][k];
          q[k] = fmaf(v[u][k], v[u][k], q[k]);
        }
    }
    for (; r < rows; r += step) {
      float v[VW];
      load<T, VW>(base + r * C, v);
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        s[k] += v[k];
        q[k] = fmaf(v[k], v[k], q[k]);
      }
    }
  }
  sum_row_lanes<VW>(s, q);
  write_partial<VW>(part, C, col, V, s, q);
}

// One warp a channel.  From the partials (moments_in null): the local
// moments E[x], E[x^2] (inv_n = 1 / rows), written to moments_out when it
// is given (a group's first half), else finished here.  From moments_in
// (a group's all-reduced sums of the ranks' moments): divided by `ranks`,
// then finished.  Finishing writes stats (3, C) = mean, rstd, keep and,
// when running_mean is given, updates the running statistics.
__global__ void __launch_bounds__(THREADS)
    batchnorm_finalize_kernel(const float* __restrict__ part, int splits,
                              int C, float inv_n,
                              const float* __restrict__ moments_in,
                              float ranks, float* __restrict__ moments_out,
                              float* __restrict__ stats,
                              float* __restrict__ running_mean,
                              float* __restrict__ running_var,
                              float momentum, float one_minus_momentum,
                              float eps) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (c >= C) return;  // the whole warp
  float mean, mean_sq;
  if (moments_in) {
    mean = __fdiv_rn(moments_in[c], ranks);
    mean_sq = __fdiv_rn(moments_in[C + c], ranks);
  } else {
    sum_partials(part, splits, C, c, mean, mean_sq);
    mean = __fmul_rn(mean, inv_n);
    mean_sq = __fmul_rn(mean_sq, inv_n);
  }
  if ((threadIdx.x & 31) != 0) return;
  if (moments_out) {
    moments_out[c] = mean;
    moments_out[C + c] = mean_sq;
    return;
  }
  finish_channel(mean, mean_sq, eps, C, c, stats, running_mean, running_var,
                 momentum, one_minus_momentum);
}

template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
    batchnorm_apply_kernel(const T* __restrict__ x,
                           const float* __restrict__ stats,
                           const float* __restrict__ weight,
                           const float* __restrict__ bias,
                           T* __restrict__ y, long long rows, int C,
                           int act) {
  const int V = C / VW;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.y * blockDim.y;
  const long long first = (long long)blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= V || first >= rows) return;
  float mean[VW], mul[VW], b[VW];
  channel_consts<VW>(stats, weight, bias, C, col * VW, mean, mul, b);
  const long long off = first * C + (long long)col * VW;
  // this thread's rows, last first
  long long i = (rows - 1 - first) / step + 1;
  for (; i >= UNROLL; i -= UNROLL) {
    float v[UNROLL][VW];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      load<T, VW>(x + off + (i - 1 - u) * step * C, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < VW; ++k)
        v[u][k] = activate<T>(normalized<T>(v[u][k], mean[k], mul[k], b[k]),
                              act);
      store<T, VW>(y + off + (i - 1 - u) * step * C, v[u]);
    }
  }
  for (; i > 0; --i) {
    float v[VW];
    load<T, VW>(x + off + (i - 1) * step * C, v);
#pragma unroll
    for (int k = 0; k < VW; ++k)
      v[k] = activate<T>(normalized<T>(v[k], mean[k], mul[k], b[k]), act);
    store<T, VW>(y + off + (i - 1) * step * C, v);
  }
}

// ---- backward --------------------------------------------------------

// g (dy through the activation) and x - mean of one row's VW channels
template <typename T, int VW>
__device__ __forceinline__ void grad_row(const float xv[VW],
                                         const float dv[VW],
                                         const float mean[VW],
                                         const float mul[VW],
                                         const float b[VW], int act,
                                         float g[VW], float xm[VW]) {
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    g[k] = act == ACT_NONE
               ? dv[k]
               : act_grad<T>(dv[k], normalized<T>(xv[k], mean[k], mul[k],
                                                  b[k]),
                             act);
    xm[k] = __fsub_rn(xv[k], mean[k]);
  }
}

template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
    batchnorm_grad_sums_kernel(const T* __restrict__ x,
                               const T* __restrict__ dy,
                               const float* __restrict__ stats,
                               const float* __restrict__ weight,
                               const float* __restrict__ bias,
                               float* __restrict__ part, long long rows,
                               int C, int act) {
  const int V = C / VW;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.y * blockDim.y;
  float s1[VW], s2[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) s1[k] = s2[k] = 0.f;
  if (col < V) {
    float mean[VW], mul[VW], b[VW];
    channel_consts<VW>(stats, weight, bias, C, col * VW, mean, mul, b);
    const long long c0 = (long long)col * VW;
    long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
    for (; r + (UNROLL - 1) * step < rows; r += UNROLL * step) {
      float xv[UNROLL][VW], dv[UNROLL][VW];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        load<T, VW>(x + (r + u * step) * C + c0, xv[u]);
        load<T, VW>(dy + (r + u * step) * C + c0, dv[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float g[VW], xm[VW];
        grad_row<T, VW>(xv[u], dv[u], mean, mul, b, act, g, xm);
#pragma unroll
        for (int k = 0; k < VW; ++k) {
          s1[k] += g[k];
          s2[k] = fmaf(g[k], xm[k], s2[k]);
        }
      }
    }
    for (; r < rows; r += step) {
      float xv[VW], dv[VW], g[VW], xm[VW];
      load<T, VW>(x + r * C + c0, xv);
      load<T, VW>(dy + r * C + c0, dv);
      grad_row<T, VW>(xv, dv, mean, mul, b, act, g, xm);
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        s1[k] += g[k];
        s2[k] = fmaf(g[k], xm[k], s2[k]);
      }
    }
  }
  sum_row_lanes<VW>(s1, s2);
  write_partial<VW>(part, C, col, V, s1, s2);
}

// One warp a channel.  From the partials (sums_in null): the rank's own
// s1, s2, whence dbias = s1 and dweight = s2 * rstd (when dweight is
// given); then written to sums_out when it is given (a group's first
// half), else finished here.  From sums_in (a group's all-reduced sums):
// finished.  Finishing writes coef (3, C) = a, b, c of the dx pass, with
// inv_n = 1 / (the group's rows).
__global__ void __launch_bounds__(THREADS)
    batchnorm_grad_finalize_kernel(const float* __restrict__ part,
                                   int splits, int C,
                                   const float* __restrict__ sums_in,
                                   float* __restrict__ sums_out,
                                   float* __restrict__ dweight,
                                   float* __restrict__ dbias,
                                   const float* __restrict__ stats,
                                   const float* __restrict__ weight,
                                   float inv_n, float* __restrict__ coef) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (c >= C) return;  // the whole warp
  const float rstd = stats[C + c];
  float s1, s2;
  if (sums_in) {
    s1 = sums_in[c];
    s2 = sums_in[C + c];
  } else {
    sum_partials(part, splits, C, c, s1, s2);
  }
  if ((threadIdx.x & 31) != 0) return;
  if (!sums_in) {
    dbias[c] = s1;
    if (dweight) dweight[c] = __fmul_rn(s2, rstd);
    if (sums_out) {
      sums_out[c] = s1;
      sums_out[C + c] = s2;
      return;
    }
  }
  grad_coefs(s1, s2, rstd, stats[2 * C + c], weight, c, inv_n, coef[c],
             coef[C + c], coef[2 * C + c]);
}

template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
    batchnorm_grad_dx_kernel(const T* __restrict__ x,
                             const T* __restrict__ dy,
                             const float* __restrict__ stats,
                             const float* __restrict__ weight,
                             const float* __restrict__ bias,
                             const float* __restrict__ coef,
                             T* __restrict__ dx, long long rows, int C,
                             int act) {
  const int V = C / VW;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.y * blockDim.y;
  const long long first = (long long)blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= V || first >= rows) return;
  const int c0 = col * VW;
  float mean[VW], mul[VW], b[VW], ca[VW], cb[VW], cc[VW];
  channel_consts<VW>(stats, weight, bias, C, c0, mean, mul, b);
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    ca[k] = coef[c0 + k];
    cb[k] = coef[C + c0 + k];
    cc[k] = coef[2 * C + c0 + k];
  }
  const long long off = first * C + c0;
  // this thread's rows, last first
  long long i = (rows - 1 - first) / step + 1;
  for (; i >= UNROLL; i -= UNROLL) {
    float xv[UNROLL][VW], dv[UNROLL][VW];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      load<T, VW>(x + off + (i - 1 - u) * step * C, xv[u]);
      load<T, VW>(dy + off + (i - 1 - u) * step * C, dv[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float g[VW], xm[VW];
      grad_row<T, VW>(xv[u], dv[u], mean, mul, b, act, g, xm);
#pragma unroll
      for (int k = 0; k < VW; ++k)
        g[k] = fmaf(ca[k], g[k], -fmaf(cc[k], xm[k], cb[k]));
      store<T, VW>(dx + off + (i - 1 - u) * step * C, g);
    }
  }
  for (; i > 0; --i) {
    float xv[VW], dv[VW], g[VW], xm[VW];
    load<T, VW>(x + off + (i - 1) * step * C, xv);
    load<T, VW>(dy + off + (i - 1) * step * C, dv);
    grad_row<T, VW>(xv, dv, mean, mul, b, act, g, xm);
#pragma unroll
    for (int k = 0; k < VW; ++k)
      g[k] = fmaf(ca[k], g[k], -fmaf(cc[k], xm[k], cb[k]));
    store<T, VW>(dx + off + (i - 1) * step * C, g);
  }
}

// ---- on chip: one launch a direction ----------------------------------

// The cluster barrier in halves: arrive once this block is done reading
// the others' shared memory, wait before it exits (so that its own stays
// alive for their reads).  Every thread of the block runs both.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" : : : "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" : : : "memory");
}

// One pack of VW channels from device memory into shared memory: with
// cp.async (no registers, so a thread keeps every row of its slab in
// flight at once) where the pack is 4, 8, 16 or 32 bytes; a 2-byte pack
// (bf16, one channel) goes through a register.  Both addresses are
// aligned to the pack.
template <typename T, int VW>
__device__ __forceinline__ void copy_in(T* smem, const T* gmem) {
  constexpr int P = VW * sizeof(T);
  if constexpr (P >= 16) {
#pragma unroll
    for (int i = 0; i < P / 16; ++i) {
      const unsigned s = static_cast<unsigned>(
          __cvta_generic_to_shared(smem + i * 16 / sizeof(T)));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   : : "r"(s), "l"(gmem + i * 16 / sizeof(T)) : "memory");
    }
  } else if constexpr (P >= 4) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 : : "r"(s), "l"(gmem), "n"(P) : "memory");
  } else {
    *reinterpret_cast<Pack<T, VW>*>(smem) =
        *reinterpret_cast<const Pack<T, VW>*>(gmem);
  }
}

// Waits for this thread's copy_in()s: their data is then visible to it.
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" : : : "memory");
}

// This block's place in the on-chip layout: its channel group's thread
// column `col` (VW channels from col * VW), whether those channels exist,
// and its rows [row0, row0 + n) of the cluster's rows.
struct Slab {
  int col, g, t, n;
  long long row0;
  bool live;
};

template <int VW>
__device__ __forceinline__ Slab slab_of(long long rows, int C, int per_block,
                                        unsigned rank) {
  Slab sl;
  sl.col = blockIdx.x * blockDim.x + threadIdx.x;
  sl.g = blockDim.x * VW;  // channels of the group
  sl.t = threadIdx.y * blockDim.x + threadIdx.x;
  sl.live = sl.col < C / VW;
  sl.row0 = (long long)rank * per_block;
  const long long left = rows - sl.row0;
  sl.n = left <= 0 ? 0 : (left < per_block ? (int)left : per_block);
  return sl;
}

// The block's sums of a[] and b[] over its row lanes into part[j][t]
// for the group's channel t < g: the lanes of a warp that share
// threadIdx.x by a shuffle tree, then the warps' sums in warp order by
// the group's first g threads.  One block barrier.
template <int VW>
__device__ __forceinline__ void block_partials(float a[VW], float b[VW],
                                               float (*part)[THREADS]) {
  __shared__ float warps[2][THREADS / 32][THREADS];
  const int tw = blockDim.x;
  const int lin = threadIdx.y * tw + threadIdx.x;
  const int lane = lin & 31, warp = lin >> 5;
  for (int o = 16; o >= tw; o >>= 1) {
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      a[k] += __shfl_xor_sync(0xffffffffu, a[k], o);
      b[k] += __shfl_xor_sync(0xffffffffu, b[k], o);
    }
  }
  if (lane < tw) {
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      warps[0][warp][threadIdx.x * VW + k] = a[k];
      warps[1][warp][threadIdx.x * VW + k] = b[k];
    }
  }
  __syncthreads();
  if (lin < tw * VW) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      sa += warps[0][w][lin];
      sb += warps[1][w][lin];
    }
    part[0][lin] = sa;
    part[1][lin] = sb;
  }
}

// The sums over the cluster of every block's partials part[j][t] (j = 0,
// 1), read through distributed shared memory (all reads issued first),
// added in rank order.
__device__ __forceinline__ void cluster_sums(cg::cluster_group& cluster,
                                             float (*part)[THREADS], int t,
                                             float& a, float& b) {
  const unsigned k = cluster.num_blocks();
  float pa[MAX_CLUSTER], pb[MAX_CLUSTER];
#pragma unroll
  for (unsigned r = 0; r < MAX_CLUSTER; ++r) {
    if (r < k) {
      const float* p = cluster.map_shared_rank(&part[0][0], r);
      pa[r] = p[t];
      pb[r] = p[THREADS + t];
    }
  }
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (unsigned r = 0; r < MAX_CLUSTER; ++r) {
    if (r < k) {
      a += pa[r];
      b += pb[r];
    }
  }
}

template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
    batchnorm_onchip_fwd_kernel(const T* __restrict__ x,
                                const float* __restrict__ weight,
                                const float* __restrict__ bias,
                                T* __restrict__ y, float* __restrict__ stats,
                                float* __restrict__ running_mean,
                                float* __restrict__ running_var,
                                long long rows, int C, int per_block,
                                float inv_n, float momentum,
                                float one_minus_momentum, float eps,
                                int act) {
  extern __shared__ __align__(16) unsigned char slab_bytes[];
  __shared__ float part[2][THREADS];
  __shared__ float cst[2][THREADS];  // mean, mul of the group's channels
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const Slab sl = slab_of<VW>(rows, C, per_block, rank);
  const int step = blockDim.y;
  // local row r of this thread's VW channels at xs + r * g
  T* xs = reinterpret_cast<T*>(slab_bytes) + threadIdx.x * VW;
  const long long base = sl.row0 * C + (long long)sl.col * VW;
  float s[VW], q[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) s[k] = q[k] = 0.f;
  if (sl.live) {
    for (int r = threadIdx.y; r < sl.n; r += step)
      copy_in<T, VW>(xs + r * sl.g, x + base + (long long)r * C);
    copies_done();
    for (int r = threadIdx.y; r < sl.n; r += step) {
      const Pack<T, VW> v =
          *reinterpret_cast<const Pack<T, VW>*>(xs + r * sl.g);
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        const float f = to_f(v.v[k]);
        s[k] += f;
        q[k] = fmaf(f, f, q[k]);
      }
    }
  }
  block_partials<VW>(s, q, part);
  cluster.sync();
  const int c = blockIdx.x * sl.g + sl.t;
  if (sl.t < sl.g && c < C) {
    float sum, sum_sq;
    cluster_sums(cluster, part, sl.t, sum, sum_sq);
    const bool first = rank == 0;
    const float mean = __fmul_rn(sum, inv_n);
    const float rstd = finish_channel(
        mean, __fmul_rn(sum_sq, inv_n), eps, C, c, first ? stats : nullptr,
        first ? running_mean : nullptr, running_var, momentum,
        one_minus_momentum);
    cst[0][sl.t] = mean;
    cst[1][sl.t] = weight ? __fmul_rn(rstd, weight[c]) : rstd;
  }
  cluster_arrive();
  __syncthreads();
  if (sl.live) {
    float mean[VW], mul[VW], b[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      mean[k] = cst[0][threadIdx.x * VW + k];
      mul[k] = cst[1][threadIdx.x * VW + k];
      b[k] = bias[sl.col * VW + k];
    }
#pragma unroll 4
    for (int r = threadIdx.y; r < sl.n; r += step) {
      const Pack<T, VW> pk = *reinterpret_cast<const Pack<T, VW>*>(
          xs + r * sl.g);
      float v[VW];
#pragma unroll
      for (int k = 0; k < VW; ++k)
        v[k] = activate<T>(normalized<T>(to_f(pk.v[k]), mean[k], mul[k],
                                         b[k]),
                           act);
      store<T, VW>(y + base + (long long)r * C, v);
    }
  }
  cluster_wait();
}

template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
    batchnorm_onchip_bwd_kernel(const T* __restrict__ x,
                                const T* __restrict__ dy,
                                const float* __restrict__ stats,
                                const float* __restrict__ weight,
                                const float* __restrict__ bias,
                                T* __restrict__ dx,
                                float* __restrict__ dweight,
                                float* __restrict__ dbias, long long rows,
                                int C, int per_block, float inv_n, int act) {
  extern __shared__ __align__(16) unsigned char slab_bytes[];
  __shared__ float part[2][THREADS];
  __shared__ float cst[3][THREADS];  // a, b, c of the group's channels
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const Slab sl = slab_of<VW>(rows, C, per_block, rank);
  const int step = blockDim.y;
  T* xs = reinterpret_cast<T*>(slab_bytes) + threadIdx.x * VW;
  T* ds = xs + (long long)per_block * sl.g;
  const long long base = sl.row0 * C + (long long)sl.col * VW;
  float mean[VW], mul[VW], b[VW], s1[VW], s2[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) s1[k] = s2[k] = 0.f;
  if (sl.live) {
    channel_consts<VW>(stats, weight, bias, C, sl.col * VW, mean, mul, b);
    for (int r = threadIdx.y; r < sl.n; r += step) {
      const long long o = base + (long long)r * C;
      copy_in<T, VW>(xs + r * sl.g, x + o);
      copy_in<T, VW>(ds + r * sl.g, dy + o);
    }
    copies_done();
    for (int r = threadIdx.y; r < sl.n; r += step) {
      const Pack<T, VW> xv =
          *reinterpret_cast<const Pack<T, VW>*>(xs + r * sl.g);
      const Pack<T, VW> dv =
          *reinterpret_cast<const Pack<T, VW>*>(ds + r * sl.g);
      float xf[VW], df[VW], g[VW], xm[VW];
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        xf[k] = to_f(xv.v[k]);
        df[k] = to_f(dv.v[k]);
      }
      grad_row<T, VW>(xf, df, mean, mul, b, act, g, xm);
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        s1[k] += g[k];
        s2[k] = fmaf(g[k], xm[k], s2[k]);
      }
    }
  }
  block_partials<VW>(s1, s2, part);
  cluster.sync();
  const int c = blockIdx.x * sl.g + sl.t;
  if (sl.t < sl.g && c < C) {
    float t1, t2;
    cluster_sums(cluster, part, sl.t, t1, t2);
    const float rstd = stats[C + c];
    if (rank == 0) {
      dbias[c] = t1;
      if (dweight) dweight[c] = __fmul_rn(t2, rstd);
    }
    grad_coefs(t1, t2, rstd, stats[2 * C + c], weight, c, inv_n,
               cst[0][sl.t], cst[1][sl.t], cst[2][sl.t]);
  }
  cluster_arrive();
  __syncthreads();
  if (sl.live) {
    float ca[VW], cb[VW], cc[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      ca[k] = cst[0][threadIdx.x * VW + k];
      cb[k] = cst[1][threadIdx.x * VW + k];
      cc[k] = cst[2][threadIdx.x * VW + k];
    }
#pragma unroll 4
    for (int r = threadIdx.y; r < sl.n; r += step) {
      const Pack<T, VW> xv =
          *reinterpret_cast<const Pack<T, VW>*>(xs + r * sl.g);
      const Pack<T, VW> dv =
          *reinterpret_cast<const Pack<T, VW>*>(ds + r * sl.g);
      float xf[VW], df[VW], g[VW], xm[VW];
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        xf[k] = to_f(xv.v[k]);
        df[k] = to_f(dv.v[k]);
      }
      grad_row<T, VW>(xf, df, mean, mul, b, act, g, xm);
#pragma unroll
      for (int k = 0; k < VW; ++k)
        g[k] = fmaf(ca[k], g[k], -fmaf(cc[k], xm[k], cb[k]));
      store<T, VW>(dx + base + (long long)r * C, g);
    }
  }
  cluster_wait();
}

// ---- launch ----------------------------------------------------------

struct Tiles {
  int tw, rb, col_tiles;
};

Tiles tiles(int C, int vw) {
  const int v = C / vw;
  int tw = 1;
  while (tw < v && tw < 32) tw <<= 1;
  return {tw, THREADS / tw, (v + tw - 1) / tw};
}

bool shape_ok(long long rows, int C, int vw, int splits) {
  return rows > 0 && C > 0 && (vw == 1 || vw == 2 || vw == 4 || vw == 8) &&
         C % vw == 0 && splits > 0 && splits <= 65535;
}

// f(T{}, integral_constant<VW>) for dtype (0 float32, 1 bfloat16) and vw;
// false for any other pair
template <typename F>
bool with_types(int dtype, int vw, F&& f) {
  using bf16 = __nv_bfloat16;
  switch (dtype * 16 + vw) {
    case 0 * 16 + 1: f(float{}, std::integral_constant<int, 1>{}); break;
    case 0 * 16 + 2: f(float{}, std::integral_constant<int, 2>{}); break;
    case 0 * 16 + 4: f(float{}, std::integral_constant<int, 4>{}); break;
    case 0 * 16 + 8: f(float{}, std::integral_constant<int, 8>{}); break;
    case 1 * 16 + 1: f(bf16{}, std::integral_constant<int, 1>{}); break;
    case 1 * 16 + 2: f(bf16{}, std::integral_constant<int, 2>{}); break;
    case 1 * 16 + 4: f(bf16{}, std::integral_constant<int, 4>{}); break;
    case 1 * 16 + 8: f(bf16{}, std::integral_constant<int, 8>{}); break;
    default: return false;
  }
  return true;
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

int warp_blocks(int C) { return (C + THREADS / 32 - 1) / (THREADS / 32); }

}  // namespace

// The grid's second dimension for (rows, C) at vector width vw on a card
// of `sms` SMs: enough blocks for BLOCKS_PER_SM on each SM, and at least
// UNROLL rows a thread.  The wrapper sizes the partials' scratch
// (splits, 2, C) from it and passes it to every launch of the layer.
extern "C" int spnet_batchnorm_splits(long long rows, int C, int vw,
                                      int sms) {
  if (rows <= 0 || C <= 0 || vw <= 0 || C % vw || sms <= 0) return 0;
  const Tiles t = tiles(C, vw);
  const long long by_rows =
      (rows + (long long)t.rb * UNROLL - 1) / ((long long)t.rb * UNROLL);
  const long long by_card =
      ((long long)BLOCKS_PER_SM * sms + t.col_tiles - 1) / t.col_tiles;
  long long s = by_rows < by_card ? by_rows : by_card;
  if (s > 65535) s = 65535;
  return static_cast<int>(s < 1 ? 1 : s);
}

// x (rows, C) of dtype; part (splits, 2, C) float32: each split's sums of
// x and x^2.
extern "C" int spnet_batchnorm_stats(const void* x, void* part,
                                     long long rows, int C, int dtype,
                                     int vw, int splits, void* stream) {
  if (!shape_ok(rows, C, vw, splits)) return invalid();
  const Tiles t = tiles(C, vw);
  const dim3 grid(t.col_tiles, splits), block(t.tw, t.rb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = with_types(dtype, vw, [&](auto tv, auto wv) {
    using T = decltype(tv);
    batchnorm_stats_kernel<T, decltype(wv)::value><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<float*>(part), rows, C);
  });
  return ok ? static_cast<int>(cudaGetLastError()) : invalid();
}

// See batchnorm_finalize_kernel.  moments_in, moments_out, running_mean
// and running_var may be null (running_var is written with running_mean).
extern "C" int spnet_batchnorm_finalize(
    const void* part, int splits, int C, float inv_n, const void* moments_in,
    float ranks, void* moments_out, void* stats, void* running_mean,
    void* running_var, float momentum, float one_minus_momentum, float eps,
    void* stream) {
  if (C <= 0 || (!moments_in && splits <= 0)) return invalid();
  batchnorm_finalize_kernel<<<warp_blocks(C), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), splits, C, inv_n,
      static_cast<const float*>(moments_in), ranks,
      static_cast<float*>(moments_out), static_cast<float*>(stats),
      static_cast<float*>(running_mean), static_cast<float*>(running_var),
      momentum, one_minus_momentum, eps);
  return static_cast<int>(cudaGetLastError());
}

// y = T(act(T((x - mean) * rstd * weight + bias))); weight may be null.
extern "C" int spnet_batchnorm_apply(const void* x, const void* stats,
                                     const void* weight, const void* bias,
                                     void* y, long long rows, int C,
                                     int dtype, int vw, int splits, int act,
                                     void* stream) {
  if (!shape_ok(rows, C, vw, splits) || act < 0 || act > ACT_LEAKY)
    return invalid();
  const Tiles t = tiles(C, vw);
  const dim3 grid(t.col_tiles, splits), block(t.tw, t.rb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = with_types(dtype, vw, [&](auto tv, auto wv) {
    using T = decltype(tv);
    batchnorm_apply_kernel<T, decltype(wv)::value><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(stats),
        static_cast<const float*>(weight), static_cast<const float*>(bias),
        static_cast<T*>(y), rows, C, act);
  });
  return ok ? static_cast<int>(cudaGetLastError()) : invalid();
}

// part (splits, 2, C): each split's sums of g and g (x - mean).
extern "C" int spnet_batchnorm_grad_sums(const void* x, const void* dy,
                                         const void* stats,
                                         const void* weight, const void* bias,
                                         void* part, long long rows, int C,
                                         int dtype, int vw, int splits,
                                         int act, void* stream) {
  if (!shape_ok(rows, C, vw, splits) || act < 0 || act > ACT_LEAKY)
    return invalid();
  const Tiles t = tiles(C, vw);
  const dim3 grid(t.col_tiles, splits), block(t.tw, t.rb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = with_types(dtype, vw, [&](auto tv, auto wv) {
    using T = decltype(tv);
    batchnorm_grad_sums_kernel<T, decltype(wv)::value>
        <<<grid, block, 0, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(dy),
            static_cast<const float*>(stats),
            static_cast<const float*>(weight),
            static_cast<const float*>(bias), static_cast<float*>(part), rows,
            C, act);
  });
  return ok ? static_cast<int>(cudaGetLastError()) : invalid();
}

// See batchnorm_grad_finalize_kernel.  sums_in, sums_out, dweight and
// weight may be null; dbias is needed unless sums_in is given.
extern "C" int spnet_batchnorm_grad_finalize(
    const void* part, int splits, int C, const void* sums_in, void* sums_out,
    void* dweight, void* dbias, const void* stats, const void* weight,
    float inv_n, void* coef, void* stream) {
  if (C <= 0 || (!sums_in && (splits <= 0 || !dbias))) return invalid();
  batchnorm_grad_finalize_kernel<<<warp_blocks(C), THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), splits, C,
      static_cast<const float*>(sums_in), static_cast<float*>(sums_out),
      static_cast<float*>(dweight), static_cast<float*>(dbias),
      static_cast<const float*>(stats), static_cast<const float*>(weight),
      inv_n, static_cast<float*>(coef));
  return static_cast<int>(cudaGetLastError());
}

// dx = T(a g - (c (x - mean) + b)) with coef (3, C) = a, b, c.
extern "C" int spnet_batchnorm_grad_dx(const void* x, const void* dy,
                                       const void* stats, const void* weight,
                                       const void* bias, const void* coef,
                                       void* dx, long long rows, int C,
                                       int dtype, int vw, int splits, int act,
                                       void* stream) {
  if (!shape_ok(rows, C, vw, splits) || act < 0 || act > ACT_LEAKY)
    return invalid();
  const Tiles t = tiles(C, vw);
  const dim3 grid(t.col_tiles, splits), block(t.tw, t.rb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = with_types(dtype, vw, [&](auto tv, auto wv) {
    using T = decltype(tv);
    batchnorm_grad_dx_kernel<T, decltype(wv)::value><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy),
        static_cast<const float*>(stats), static_cast<const float*>(weight),
        static_cast<const float*>(bias), static_cast<const float*>(coef),
        static_cast<T*>(dx), rows, C, act);
  });
  return ok ? static_cast<int>(cudaGetLastError()) : invalid();
}

// ---- on chip ---------------------------------------------------------

namespace {

// Lets `fn` take what the card allows a block in dynamic shared memory
// beside its static shared memory, once per kernel and device; returns
// that many bytes (0 on an error).
int allow_dynamic_smem(const void* fn) {
  static std::mutex lock;
  static const void* fns[64];
  static int devs[64], bytes[64], n = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < n; ++i)
    if (fns[i] == fn && devs[i] == dev) return bytes[i];
  int optin = 0;
  cudaFuncAttributes fa;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, fn) != cudaSuccess)
    return 0;
  const int dyn = optin - static_cast<int>(fa.sharedSizeBytes);
  if (dyn <= 0 || cudaFuncSetAttribute(
                      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                      dyn) != cudaSuccess)
    return 0;
  if (n < 64) {
    fns[n] = fn;
    devs[n] = dev;
    bytes[n++] = dyn;
  }
  return dyn;
}

// The grid of an on-chip launch: (groups, cluster) blocks of (tw, THREADS
// / tw) threads in clusters of (1, cluster, 1), `smem` bytes of slab; the
// error, or cudaSuccess.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int groups, int tw,
                           int cluster, size_t smem, cudaStream_t stream,
                           Args... args) {
  const int allowed =
      allow_dynamic_smem(reinterpret_cast<const void*>(kernel));
  if (allowed <= 0) {
    const cudaError_t e = cudaGetLastError();
    return e != cudaSuccess ? e : cudaErrorInvalidValue;
  }
  if (smem > static_cast<size_t>(allowed)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups, cluster);
  cfg.blockDim = dim3(tw, THREADS / tw);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// rows / cluster rounded up, the slab's rows a block; 0 for a layout the
// kernels do not take
long long onchip_rows(long long rows, int C, int vw, int tw, int cluster) {
  const bool ok = rows > 0 && C > 0 &&
                  (vw == 1 || vw == 2 || vw == 4 || vw == 8) && C % vw == 0 &&
                  tw >= 1 && tw <= 32 && (tw & (tw - 1)) == 0 &&
                  cluster >= 1 && cluster <= MAX_CLUSTER;
  return ok ? (rows + cluster - 1) / cluster : 0;
}

}  // namespace

// The bytes a block of the on-chip kernels may give its backward slab (x
// and dy of its rows) on the card `device`: what the card allows a block
// in shared memory, opted in (cudaDevAttrMaxSharedMemoryPerBlockOptin),
// less the most static shared memory of any instance of the kernels, the
// forward's half slab counted twice; 0 on an error.  The wrapper plans the
// on-chip layout from it.
extern "C" int spnet_batchnorm_onchip_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  long long slab = optin;
  bool ok = true;
  auto room = [&](const void* fn, int halves) {
    cudaFuncAttributes fa;
    ok = ok && cudaFuncGetAttributes(&fa, fn) == cudaSuccess;
    if (ok)
      slab = std::min(slab, halves * (optin - static_cast<long long>(
                                                  fa.sharedSizeBytes)));
  };
  for (int dtype = 0; dtype < 2; ++dtype)
    for (int vw = 1; vw <= MAX_VW; vw *= 2)
      with_types(dtype, vw, [&](auto tv, auto wv) {
        using T = decltype(tv);
        constexpr int VW = decltype(wv)::value;
        room(reinterpret_cast<const void*>(
                 batchnorm_onchip_fwd_kernel<T, VW>),
             2);
        room(reinterpret_cast<const void*>(
                 batchnorm_onchip_bwd_kernel<T, VW>),
             1);
      });
  return ok && slab > 0 ? static_cast<int>(slab) : 0;
}

// The forward in one launch: stats (3, C) and, when running_mean is given,
// the running statistics' update, as spnet_batchnorm_finalize; y as
// spnet_batchnorm_apply.  tw threads across a group of tw * vw channels,
// clusters of `cluster` blocks over the rows; inv_n = 1 / rows.
extern "C" int spnet_batchnorm_onchip_fwd(
    const void* x, const void* weight, const void* bias, void* y,
    void* stats, void* running_mean, void* running_var, long long rows,
    int C, int dtype, int vw, int tw, int cluster, float inv_n,
    float momentum, float one_minus_momentum, float eps, int act,
    void* stream) {
  const long long per = onchip_rows(rows, C, vw, tw, cluster);
  const int groups = per ? (C / vw + tw - 1) / tw : 0;
  if (!per || per > (1 << 30) || groups > 65535 || act < 0 ||
      act > ACT_LEAKY)
    return invalid();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  with_types(dtype, vw, [&](auto tv, auto wv) {
    using T = decltype(tv);
    constexpr int VW = decltype(wv)::value;
    err = launch_cluster(batchnorm_onchip_fwd_kernel<T, VW>, groups, tw,
                         cluster, per * tw * VW * sizeof(T), s,
                         static_cast<const T*>(x),
                         static_cast<const float*>(weight),
                         static_cast<const float*>(bias), static_cast<T*>(y),
                         static_cast<float*>(stats),
                         static_cast<float*>(running_mean),
                         static_cast<float*>(running_var), rows, C,
                         static_cast<int>(per), inv_n, momentum,
                         one_minus_momentum, eps, act);
  });
  return static_cast<int>(err);
}

// The backward in one launch: dbias, dweight (when given) as
// spnet_batchnorm_grad_finalize, dx as spnet_batchnorm_grad_dx; the
// layout as spnet_batchnorm_onchip_fwd's, inv_n = 1 / rows.
extern "C" int spnet_batchnorm_onchip_bwd(
    const void* x, const void* dy, const void* stats, const void* weight,
    const void* bias, void* dx, void* dweight, void* dbias, long long rows,
    int C, int dtype, int vw, int tw, int cluster, float inv_n, int act,
    void* stream) {
  const long long per = onchip_rows(rows, C, vw, tw, cluster);
  const int groups = per ? (C / vw + tw - 1) / tw : 0;
  if (!per || per > (1 << 30) || groups > 65535 || act < 0 ||
      act > ACT_LEAKY || !dbias)
    return invalid();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  with_types(dtype, vw, [&](auto tv, auto wv) {
    using T = decltype(tv);
    constexpr int VW = decltype(wv)::value;
    err = launch_cluster(batchnorm_onchip_bwd_kernel<T, VW>, groups, tw,
                         cluster, 2 * per * tw * VW * sizeof(T), s,
                         static_cast<const T*>(x), static_cast<const T*>(dy),
                         static_cast<const float*>(stats),
                         static_cast<const float*>(weight),
                         static_cast<const float*>(bias),
                         static_cast<T*>(dx), static_cast<float*>(dweight),
                         static_cast<float*>(dbias), rows, C,
                         static_cast<int>(per), inv_n, act);
  });
  return static_cast<int>(err);
}
