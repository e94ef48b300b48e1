// Fused SPNet multi-task loss for Hopper (sm_90a): the scalar loss and its
// gradient with respect to the prediction, in one pass over the operands.
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
// and dloss/dp = 1/(B*M) * pobj * coef[var] * 2 (p - t), with coef the
// variable's weight (the angle pair scaled by (t_a - t_b)^2); the noobj
// variable takes w_n * 2 (p - t), or w_n (sigmoid(p) - t) under 'hybrid'.
//
// What bounds it on this card.  At the training batch (B = 128, M = 576)
// the loss reads 2 * 128 * 576 * 4 B = 590 KB, 0.18 us at 3.35 TB/s, and
// the gradient reads as much and writes half of it again, 0.26 us.  One
// launch costs several microseconds of the device's time (and more of the
// host's), far more than those bytes: the kernels are bound by launches,
// not by memory.
//
// Design: one launch per direction, operands read once, no host state.
//   * `loss_kernel` computes the loss and, when asked (a template flag, so
//     that the plain loss pays for no stores), the gradient from the same
//     registers.  The training step's forward takes both, and its backward
//     only scales the kept gradient by the upstream g (`grad_scale_kernel`,
//     reading g through a device pointer): two launches per step, and the
//     operands are read once.  The standalone gradient (`spnet_loss_bwd`)
//     is the same kernel with the loss off and the scale *g on.
//   * Each thread owns one slot and reads its 8 floats of each operand in
//     place (two 16-byte loads when the pointers are 16-byte aligned, eight
//     4-byte loads otherwise), with no transpose and no padding copy: the
//     Pallas kernels transpose (B, M) to (8, B*S) and pad to 2048-lane
//     tiles for the TPU's layout.  The ragged last block is masked.
//   * The loss reduces across blocks in one launch and in a fixed order,
//     with no float atomics: every block sums its slots with warp shuffles
//     and one shared-memory stage and writes one partial, then draws a
//     ticket from an unsigned counter (releasing the partial); the block
//     that draws the last ticket sums all partials in index order with the
//     same per-thread stride and block sum, scales by 1/(B*M) and sets the
//     counter back to 0.  The ticket is one atomic with acquire-release
//     semantics at device scope in place of a fence on each side.  The
//     order of every addition depends only on the shape, so the result is
//     bitwise the same from run to run (and equal to a second one-block
//     pass over the partials).
//   * The partials and the counter are a small workspace that the caller
//     allocates and zeroes once per (device, stream); the kernel leaves the
//     counter at 0, so eager calls and CUDA-graph replays reuse it and a
//     call can be captured into a graph.
//
// The C entries launch on the caller's stream, allocate nothing and return
// cudaGetLastError().

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

template <bool VEC>
__device__ __forceinline__ void store_slot(float* __restrict__ base,
                                           long long slot,
                                           const float v[VARS]) {
  float* p = base + slot * VARS;
  if (VEC) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < VARS; ++k) p[k] = v[k];
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

// dloss/dp of one slot: inv_norm * pobj * coef[var] * 2 (p - t), and the
// noobj variable's own term.
__device__ __forceinline__ void slot_grad(const float t[VARS],
                                          const float p[VARS], Weights w,
                                          int hybrid, float inv_norm,
                                          float out[VARS]) {
  const float pobj = 1.0f - t[NOOBJ];
  const float ab = t[A] - t[B_];
  const float ab2 = ab * ab;
  const float coef[VARS] = {w.center, w.center, w.size,  w.size,
                            w.angle * ab2, w.angle * ab2, 0.0f, w.rings};
#pragma unroll
  for (int k = 0; k < VARS; ++k) {
    const float d2 = 2.0f * (p[k] - t[k]);
    out[k] = pobj * coef[k] * d2 * inv_norm;
  }
  const float z = p[NOOBJ];
  const float noobj = hybrid
                          ? w.noobj * (1.0f / (1.0f + expf(-z)) - t[NOOBJ])
                          : w.noobj * (2.0f * (z - t[NOOBJ]));
  out[NOOBJ] = noobj * inv_norm;
}

// Sum of v over the block in a fixed order: shuffles inside each warp,
// then warp 0 adds the eight warp sums.  The result is valid in thread 0.
// Two calls in one kernel need a __syncthreads() between them.
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

// K2 and K3 in one pass.  LOSS: out[0] = sum of the slot losses / (B*M),
// reduced across blocks by the last block to finish (see the header).
// GRAD: dyp = dloss/dp, times *g when g is not null.
template <bool VEC, bool LOSS, bool GRAD>
__global__ void __launch_bounds__(THREADS)
    loss_kernel(const float* __restrict__ yt, const float* __restrict__ yp,
                const float* __restrict__ g, float* __restrict__ dyp,
                float* __restrict__ out, float* __restrict__ partials,
                unsigned int* __restrict__ counter, long long n_slots,
                float inv_norm, Weights w, int hybrid) {
  const long long slot = (long long)blockIdx.x * THREADS + threadIdx.x;
  // g is read before the operands, so that its latency overlaps theirs
  const float gs = (GRAD && g != nullptr) ? __ldg(g) : 1.0f;
  float v = 0.0f;
  if (slot < n_slots) {
    float t[VARS], p[VARS];
    load_slot<VEC>(yt, slot, t);
    load_slot<VEC>(yp, slot, p);
    if (LOSS) v = slot_loss(t, p, w, hybrid);
    if (GRAD) {
      float d[VARS];
      slot_grad(t, p, w, hybrid, inv_norm, d);
      if (g != nullptr) {
#pragma unroll
        for (int k = 0; k < VARS; ++k) d[k] = gs * d[k];
      }
      store_slot<VEC>(dyp, slot, d);
    }
  }
  if (!LOSS) return;
  v = block_sum(v);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = v;
    // The ticket, with release (this partial is visible before it is
    // drawn) and acquire (the last block sees every partial) semantics at
    // device scope; the barrier below passes the acquire on to the block.
    // Cheaper on the card than __threadfence() around a relaxed atomicAdd.
    unsigned int ticket;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(ticket)
                 : "l"(counter)
                 : "memory");
    last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  v = 0.0f;
  // L2 reads (__ldcg): the other blocks' partials are not in this SM's L1
  for (int i = threadIdx.x; i < (int)gridDim.x; i += THREADS)
    v += __ldcg(partials + i);
  v = block_sum(v);
  if (threadIdx.x == 0) {
    out[0] = v * inv_norm;
    counter[0] = 0u;  // ready for the next launch on this workspace
  }
}

// The backward of the training step: out = g[0] * grad, one slot per
// thread.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    grad_scale_kernel(const float* __restrict__ g,
                      const float* __restrict__ grad, float* __restrict__ out,
                      long long n_slots) {
  const long long slot = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (slot >= n_slots) return;
  const float s = g[0];
  float v[VARS];
  load_slot<VEC>(grad, slot, v);
#pragma unroll
  for (int k = 0; k < VARS; ++k) v[k] = s * v[k];
  store_slot<VEC>(out, slot, v);
}

bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) % 16) == 0;
}

long long blocks_for(long long n_slots) {
  return (n_slots + THREADS - 1) / THREADS;
}

using LossKernel = void (*)(const float*, const float*, const float*, float*,
                            float*, float*, unsigned int*, long long, float,
                            Weights, int);

template <bool VEC>
LossKernel pick(bool loss, bool grad) {
  if (!loss) return loss_kernel<VEC, false, true>;
  return grad ? loss_kernel<VEC, true, true> : loss_kernel<VEC, true, false>;
}

}  // namespace

// One launch of K2/K3.  y_true, y_pred: (B, M) float32, contiguous,
// M % 8 == 0, n_slots = B*M/8.
//   out: one float for the loss, or null for no loss.  With a loss,
//     partials (capacity floats, at least ceil(n_slots / 256)) and counter
//     (one unsigned int, 0 on entry; left at 0) are a workspace that no
//     other launch uses at the same time.
//   dy_pred: (B, M) float32 for the gradient, or null for none; g: one
//     float on the device that scales the gradient, or null for 1.
// hybrid: 0 = 'same', 1 = 'hybrid'.
extern "C" int spnet_loss(const void* y_true, const void* y_pred,
                          const void* g, void* dy_pred, void* out,
                          void* partials, int capacity, void* counter,
                          long long n_slots, float inv_norm, float w_center,
                          float w_size, float w_angle, float w_noobj,
                          float w_rings, int hybrid, void* stream) {
  const long long blocks = blocks_for(n_slots);
  if (n_slots <= 0 || (!out && !dy_pred) || blocks > 0x7fffffffLL ||
      (out && (!partials || !counter || blocks > capacity)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Weights w{w_center, w_size, w_angle, w_noobj, w_rings};
  const LossKernel kernel =
      aligned16(y_true, y_pred, dy_pred ? dy_pred : y_pred)
          ? pick<true>(out != nullptr, dy_pred != nullptr)
          : pick<false>(out != nullptr, dy_pred != nullptr);
  kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y_true), static_cast<const float*>(y_pred),
      static_cast<const float*>(g), static_cast<float*>(dy_pred),
      static_cast<float*>(out), static_cast<float*>(partials),
      static_cast<unsigned int*>(counter), n_slots, inv_norm, w, hybrid);
  return static_cast<int>(cudaGetLastError());
}

// out = g[0] * grad: grad, out (B, M) float32, contiguous, n_slots =
// B*M/8; g one float on the device.
extern "C" int spnet_loss_grad_scale(const void* g, const void* grad,
                                     void* out, long long n_slots,
                                     void* stream) {
  const long long blocks = blocks_for(n_slots);
  if (n_slots <= 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = aligned16(grad, out, out) ? grad_scale_kernel<true>
                                          : grad_scale_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(grad),
      static_cast<float*>(out), n_slots);
  return static_cast<int>(cudaGetLastError());
}
