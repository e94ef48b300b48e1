// Fused SPNet multi-task loss for Hopper (sm_90a): the scalar forward and
// its gradient with respect to the prediction.
//
// Replaces the Pallas TPU kernels `spnet_tpu/ops/losses.py::_fwd_kernel`
// (K2, through `spnet_loss_pallas` / `_pallas_fwd`) and `_bwd_kernel` (K3,
// the custom VJP's `_pallas_bwd`).  Per predictor slot s of 8 variables
// [cx, cy, a, b, cos2t, sin2t, noobj, rings], with t = y_true, p = y_pred,
// d = t - p and pobj = 1 - t_noobj:
//
//   term_s = pobj * (w_c (dcx^2 + dcy^2) + w_s (da^2 + db^2) + w_r drings^2
//                    + w_a (dcos^2 + dsin^2) (t_a - t_b)^2)
//          + w_n dnoobj^2                         (loss_type 'same')
//          + w_n BCE-with-logits(p_noobj, t_noobj) (loss_type 'hybrid')
//   loss   = sum_s term_s / (B * M)
//
// and dloss/dp = g/(B*M) * pobj * coef[var] * 2 (p - t), with coef the
// variable's weight (the angle pair scaled by (t_a - t_b)^2); the noobj
// variable takes w_n * 2 (p - t), or w_n (sigmoid(p) - t) under 'hybrid'.
//
// What bounds it on this card.  At the training batch (B = 128, M = 576)
// the forward reads 2 * 128 * 576 * 4 B = 590 KB and the backward reads as
// much and writes half of it again: well under a microsecond of HBM
// traffic each, so both kernels are bound by launch latency.  The plain
// PyTorch version is some twenty small elementwise and reduction launches
// per direction; here the forward is two launches and the backward one.
//
// Design.  No TPU layout: the Pallas kernels transpose (B, M) to (8, B*S)
// so that each variable sits on a sublane and pad the lanes to 2048-wide
// tiles.  Here each thread owns one slot and reads its 8 floats of each
// operand in place (two 16-byte loads when the pointers are 16-byte
// aligned, eight 4-byte loads otherwise), with no transpose and no padding
// copy; the ragged last block is masked.  The forward reduces in two
// deterministic stages and uses no float atomics: every block sums its
// slots with warp shuffles and one shared-memory stage and writes one
// partial; a second one-block launch sums the partials in a fixed order and
// scales by 1/(B*M).  The order of every addition depends only on the
// shape, so the result is bitwise the same from run to run.  The backward
// reads the upstream gradient g through a device pointer, so no host sync
// is needed between the two passes.
//
// The C entries launch on the caller's stream, allocate nothing (the
// wrapper passes the partials buffer) and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // 8 warps; one slot per thread
constexpr int VARS = 8;       // variables per predictor slot

enum { CX, CY, A, B_, COS2T, SIN2T, NOOBJ, RINGS };

struct Weights {
  float center, size, angle, noobj, rings;
};

template <bool VEC>
__device__ __forceinline__ void load_slot(const float* __restrict__ base,
                                          long long slot, float v[VARS]) {
  const float* p = base + slot * VARS;
  if (VEC) {
    const float4 lo = reinterpret_cast<const float4*>(p)[0];
    const float4 hi = reinterpret_cast<const float4*>(p)[1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int k = 0; k < VARS; ++k) v[k] = p[k];
  }
}

__device__ __forceinline__ float bce_with_logits(float z, float t) {
  return fmaxf(z, 0.0f) - z * t + log1pf(expf(-fabsf(z)));
}

__device__ __forceinline__ float slot_loss(const float t[VARS],
                                           const float p[VARS], Weights w,
                                           int hybrid) {
  float sq[VARS];
#pragma unroll
  for (int k = 0; k < VARS; ++k) {
    const float d = t[k] - p[k];
    sq[k] = d * d;
  }
  const float pobj = 1.0f - t[NOOBJ];
  const float ab = t[A] - t[B_];
  float geom = w.center * (sq[CX] + sq[CY]) + w.size * (sq[A] + sq[B_]) +
               w.rings * sq[RINGS];
  geom += w.angle * (sq[COS2T] + sq[SIN2T]) * (ab * ab);
  float loss = pobj * geom;
  loss += hybrid ? w.noobj * bce_with_logits(p[NOOBJ], t[NOOBJ])
                 : w.noobj * sq[NOOBJ];
  return loss;
}

// Sum of v over the block in a fixed order: shuffles inside each warp,
// then warp 0 adds the eight warp sums.  The result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// K2 stage 1: one partial sum per block of THREADS slots.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    loss_partials_kernel(const float* __restrict__ yt,
                         const float* __restrict__ yp,
                         float* __restrict__ partials, long long n_slots,
                         Weights w, int hybrid) {
  const long long slot = (long long)blockIdx.x * THREADS + threadIdx.x;
  float v = 0.0f;
  if (slot < n_slots) {
    float t[VARS], p[VARS];
    load_slot<VEC>(yt, slot, t);
    load_slot<VEC>(yp, slot, p);
    v = slot_loss(t, p, w, hybrid);
  }
  v = block_sum(v);
  if (threadIdx.x == 0) partials[blockIdx.x] = v;
}

// K2 stage 2: one block sums the partials in a fixed order and scales.
__global__ void __launch_bounds__(THREADS)
    loss_finish_kernel(const float* __restrict__ partials, int n_partials,
                       float inv_norm, float* __restrict__ out) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < n_partials; i += THREADS) v += partials[i];
  v = block_sum(v);
  if (threadIdx.x == 0) out[0] = v * inv_norm;
}

// K3: dloss/dy_pred, one slot per thread.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    loss_grad_kernel(const float* __restrict__ yt,
                     const float* __restrict__ yp,
                     const float* __restrict__ g, float* __restrict__ dyp,
                     long long n_slots, float inv_norm, Weights w,
                     int hybrid) {
  const long long slot = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (slot >= n_slots) return;
  float t[VARS], p[VARS];
  load_slot<VEC>(yt, slot, t);
  load_slot<VEC>(yp, slot, p);
  const float scale = g[0] * inv_norm;
  const float pobj = 1.0f - t[NOOBJ];
  const float ab = t[A] - t[B_];
  const float ab2 = ab * ab;
  const float coef[VARS] = {w.center, w.center, w.size,  w.size,
                            w.angle * ab2, w.angle * ab2, 0.0f, w.rings};
  float out[VARS];
#pragma unroll
  for (int k = 0; k < VARS; ++k) {
    const float d2 = 2.0f * (p[k] - t[k]);
    out[k] = pobj * coef[k] * d2 * scale;
  }
  const float z = p[NOOBJ];
  const float noobj = hybrid
                          ? w.noobj * (1.0f / (1.0f + expf(-z)) - t[NOOBJ])
                          : w.noobj * (2.0f * (z - t[NOOBJ]));
  out[NOOBJ] = noobj * scale;
  float* o = dyp + slot * VARS;
  if (VEC) {
    reinterpret_cast<float4*>(o)[0] =
        make_float4(out[0], out[1], out[2], out[3]);
    reinterpret_cast<float4*>(o)[1] =
        make_float4(out[4], out[5], out[6], out[7]);
  } else {
#pragma unroll
    for (int k = 0; k < VARS; ++k) o[k] = out[k];
  }
}

bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) % 16) == 0;
}

int blocks_for(long long n_slots) {
  return static_cast<int>((n_slots + THREADS - 1) / THREADS);
}

}  // namespace

// Number of partial sums the forward needs for n_slots = B * M / 8 slots
// (the size of the scratch buffer the wrapper allocates).
extern "C" int spnet_loss_fwd_partials(long long n_slots) {
  return blocks_for(n_slots);
}

// y_true, y_pred: (B, M) float32, contiguous, M % 8 == 0, n_slots = B*M/8;
// partials: spnet_loss_fwd_partials(n_slots) floats; out: one float.
// hybrid: 0 = 'same', 1 = 'hybrid'.
extern "C" int spnet_loss_fwd(const void* y_true, const void* y_pred,
                              void* partials, int n_partials, void* out,
                              long long n_slots, float inv_norm, float w_center,
                              float w_size, float w_angle, float w_noobj,
                              float w_rings, int hybrid, void* stream) {
  if (n_slots <= 0 || n_partials != blocks_for(n_slots))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Weights w{w_center, w_size, w_angle, w_noobj, w_rings};
  const auto* yt = static_cast<const float*>(y_true);
  const auto* yp = static_cast<const float*>(y_pred);
  auto* part = static_cast<float*>(partials);
  if (aligned16(y_true, y_pred, y_pred))
    loss_partials_kernel<true>
        <<<n_partials, THREADS, 0, s>>>(yt, yp, part, n_slots, w, hybrid);
  else
    loss_partials_kernel<false>
        <<<n_partials, THREADS, 0, s>>>(yt, yp, part, n_slots, w, hybrid);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  loss_finish_kernel<<<1, THREADS, 0, s>>>(part, n_partials, inv_norm,
                                           static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// y_true, y_pred, dy_pred: (B, M) float32, contiguous, M % 8 == 0; g: one
// float on the device (the upstream gradient of the scalar loss).
extern "C" int spnet_loss_bwd(const void* y_true, const void* y_pred,
                              const void* g, void* dy_pred, long long n_slots,
                              float inv_norm, float w_center, float w_size,
                              float w_angle, float w_noobj, float w_rings,
                              int hybrid, void* stream) {
  if (n_slots <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Weights w{w_center, w_size, w_angle, w_noobj, w_rings};
  const auto* yt = static_cast<const float*>(y_true);
  const auto* yp = static_cast<const float*>(y_pred);
  const auto* gp = static_cast<const float*>(g);
  auto* out = static_cast<float*>(dy_pred);
  const int blocks = blocks_for(n_slots);
  if (aligned16(y_true, y_pred, dy_pred))
    loss_grad_kernel<true><<<blocks, THREADS, 0, s>>>(yt, yp, gp, out, n_slots,
                                                      inv_norm, w, hybrid);
  else
    loss_grad_kernel<false><<<blocks, THREADS, 0, s>>>(
        yt, yp, gp, out, n_slots, inv_norm, w, hybrid);
  return static_cast<int>(cudaGetLastError());
}
