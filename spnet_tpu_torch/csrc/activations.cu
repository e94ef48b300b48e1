// Selective (strided) sigmoid for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel
// `spnet_tpu/ops/activations.py::_sel_sigmoid_kernel` (K4, through
// `selective_sigmoid_pallas`).  On a (B, M) float32 head output, M = 8 * S,
// variable IND_NOOBJ = 6 of every 8-wide predictor slot goes through a
// sigmoid and the other seven pass through:
//
//   y[s*8 + k] = sigmoid(x[s*8 + k])  if k == 6,   x[s*8 + k] otherwise
//
// The backward takes the saved output y and the upstream gradient g:
//
//   dx[s*8 + k] = g * (y * (1 - y))  if k == 6,   g otherwise
//
// (the order of JAX's `logistic` JVP).  The JAX package has no backward
// kernel: it differentiates the jnp twin.  The port's training path runs
// this one every step beside the forward.
//
// What bounds it on this card.  At the training batch (128 x 576) each
// direction moves 295 KB in and 295 KB out: a fraction of a microsecond of
// HBM traffic, and 9216 sigmoids.  Both kernels are bound by launch latency
// and by the host time of the call around them: their bytes' bound (0.18
// and 0.26 us) lies below the cost of one launch (about 1 us), and each
// body runs about 0.4 us above that floor, so no standalone launch of
// either can come near its bound, and these kernels are left as they are.
// Where K4 meets the loss, on the 'ss' training step, it runs inside the
// loss kernel's pass instead (csrc/loss.cu, the SS variant): no launch of
// its own, no bytes of its own.  Serving still runs the forward here after
// the head's product, and `SelectiveSigmoid` (forward and backward) stays
// on the paths that do not take the fused loss.
//
// Design.  No TPU layout: the Pallas kernel transposes (B, M) to (8, B*S)
// so that variable 6 becomes one sublane row.  Here one thread owns one
// 8-float slot and reads it in place with two 16-byte loads, so that
// variable 6 is `.z` of the second float4, and writes it back with two
// 16-byte stores; the ragged last block is masked.  The backward reads g
// whole but only variable 6 of y.  A view whose pointers are not 16-byte
// aligned takes eight scalar accesses per operand.
// `expf` (not `__expf`) and IEEE division, as `torch.sigmoid` computes on
// the card, so the two agree to an ulp.
//
// The C entries launch on the caller's stream, allocate nothing and return
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // 8 warps; one slot per thread
constexpr int VARS = 8;       // variables per predictor slot
constexpr int NOOBJ = 6;      // the sigmoided variable

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

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    sel_sigmoid_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                           long long n_slots) {
  const long long slot = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (slot >= n_slots) return;
  float v[VARS];
  load_slot<VEC>(x, slot, v);
  v[NOOBJ] = 1.0f / (1.0f + expf(-v[NOOBJ]));
  store_slot<VEC>(y, slot, v);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    sel_sigmoid_bwd_kernel(const float* __restrict__ y,
                           const float* __restrict__ g,
                           float* __restrict__ dx, long long n_slots) {
  const long long slot = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (slot >= n_slots) return;
  float d[VARS];
  load_slot<VEC>(g, slot, d);
  const float s = y[slot * VARS + NOOBJ];
  d[NOOBJ] = d[NOOBJ] * (s * (1.0f - s));
  store_slot<VEC>(dx, slot, d);
}

bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) % 16) == 0;
}

int blocks_for(long long n_slots) {
  return static_cast<int>((n_slots + THREADS - 1) / THREADS);
}

}  // namespace

// x, y: (B, M) float32, contiguous, M % 8 == 0, n_slots = B * M / 8.
extern "C" int spnet_selective_sigmoid_fwd(const void* x, void* y,
                                           long long n_slots, void* stream) {
  if (n_slots <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  auto* yp = static_cast<float*>(y);
  if (aligned16(x, y, y))
    sel_sigmoid_fwd_kernel<true>
        <<<blocks_for(n_slots), THREADS, 0, s>>>(xp, yp, n_slots);
  else
    sel_sigmoid_fwd_kernel<false>
        <<<blocks_for(n_slots), THREADS, 0, s>>>(xp, yp, n_slots);
  return static_cast<int>(cudaGetLastError());
}

// y (the forward's output), g (the upstream gradient), dx: (B, M) float32,
// contiguous, M % 8 == 0, n_slots = B * M / 8.
extern "C" int spnet_selective_sigmoid_bwd(const void* y, const void* g,
                                           void* dx, long long n_slots,
                                           void* stream) {
  if (n_slots <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* yp = static_cast<const float*>(y);
  const auto* gp = static_cast<const float*>(g);
  auto* dp = static_cast<float*>(dx);
  if (aligned16(g, dx, dx))
    sel_sigmoid_bwd_kernel<true>
        <<<blocks_for(n_slots), THREADS, 0, s>>>(yp, gp, dp, n_slots);
  else
    sel_sigmoid_bwd_kernel<false>
        <<<blocks_for(n_slots), THREADS, 0, s>>>(yp, gp, dp, n_slots);
  return static_cast<int>(cudaGetLastError());
}
