// Adam's update for Hopper (sm_90a): one pass over every trained leaf.
//
// Replaces no Pallas kernel: the JAX package leaves optax's update to XLA,
// which fuses it into the train step.  In the port the update ran as eleven
// `_foreach` passes over the parameter list (`train/optim.py`'s plain twin,
// which stays the CPU's path), each reading and writing whole float32
// tensors, with two temporaries as large as the model; this kernel takes
// their place on the card (`ops/adam.py::adam_apply`).
//
// What it computes, per element of a leaf (p, g, m, v all float32, in
// place), in the twin's order and roundings:
//
//   m = fma(1 - b1, g, m * b1)          `_foreach_mul_`, `_foreach_add_`
//   v = fma(1 - b2, g * g, v * b2)      `_foreach_mul_`, `_foreach_addcmul_`
//   optax: p -= ((m / bc1) / (sqrt(v / bc2) + eps)) * lr
//   Keras: p -= (m / (sqrt(v) + eps)) * lr_t
//
// Each operation rounds once, as the twin's separate passes do (its `add`
// with alpha and its `addcmul` are one fused multiply-add each on the card);
// division and square root are IEEE (`__fdiv_rn`, `__fsqrt_rn`), so p, m
// and v come out bit for bit the twin's.  lr (Keras: lr_t) and the bias
// corrections bc1 = 1 - b1^t, bc2 = 1 - b2^t are read from device scalars
// that the step computes before the launch, so a CUDA graph of the step
// replays with the current step's values.
//
// What bounds it.  A handful of operations an element against 28 bytes
// (p, g, m, v read, p, m, v written): memory.  Nothing else is read or
// written: no temporary, no device table.
//
// Design.  The leaves of one launch (up to MAX_LEAVES) travel in the
// kernel's argument struct: four pointers and the element count a leaf,
// and the leaf's first 4-element group ("quad") in the launch's
// concatenated index space, where every leaf starts on a quad.  A block
// takes CHUNK_QUADS consecutive quads of that space, finds the leaf of its
// first quad by a binary search over the starts, and walks the leaves its
// chunk covers, so one block mixes the small BatchNorm and bias leaves with
// the ends of the large conv weights.  A thread moves one quad a turn, as
// one 16-byte access an operand when every pointer of the launch is 16-byte
// aligned (VEC), else element by element; a leaf's ragged last quad is
// masked.  The table indices are the same across a block, so its reads
// are broadcasts from the constant bank.
//
// The C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a table it
// cannot take.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int MAX_LEAVES = 800;  // the table stays under 32 KB of arguments
constexpr int THREADS = 256;
constexpr int CHUNK_QUADS = 4 * THREADS;  // a block's share: 16 KB a tensor

struct AdamTable {
  float* p[MAX_LEAVES];
  const float* g[MAX_LEAVES];
  float* m[MAX_LEAVES];
  float* v[MAX_LEAVES];
  int numel[MAX_LEAVES];
  int start[MAX_LEAVES + 1];  // first quad of each leaf; start[n]: all quads
  const float* lr;            // optax: lr; Keras: lr_t
  const float* bc1;           // 1 - b1^t (optax only)
  const float* bc2;           // 1 - b2^t (optax only)
  float b1, one_minus_b1, b2, one_minus_b2, eps;
  int n;
  int optax;
};
// Hopper takes up to 32,764 bytes of kernel arguments (CUDA 12.1 and on)
static_assert(sizeof(AdamTable) <= 32764, "AdamTable exceeds the argument "
                                          "space");

struct Coef {
  float lr, bc1, bc2, b1, a1, b2, a2, eps;
  bool optax;
};

__device__ __forceinline__ void adam_element(float& p, float g, float& m,
                                             float& v, const Coef& c) {
  m = __fmaf_rn(c.a1, g, __fmul_rn(m, c.b1));
  v = __fmaf_rn(c.a2, __fmul_rn(g, g), __fmul_rn(v, c.b2));
  const float num = c.optax ? __fdiv_rn(m, c.bc1) : m;
  const float den = __fadd_rn(__fsqrt_rn(c.optax ? __fdiv_rn(v, c.bc2) : v),
                              c.eps);
  p = __fsub_rn(p, __fmul_rn(__fdiv_rn(num, den), c.lr));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    adam_multi_tensor_apply_kernel(const AdamTable t) {
  const int q0 = blockIdx.x * CHUNK_QUADS;
  const int q1 = min(q0 + CHUNK_QUADS, t.start[t.n]);
  int lo = 0, hi = t.n - 1;  // the last leaf starting at or before q0
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.start[mid] <= q0) lo = mid; else hi = mid - 1;
  }
  const Coef c{*t.lr, t.optax ? *t.bc1 : 1.0f, t.optax ? *t.bc2 : 1.0f,
               t.b1, t.one_minus_b1, t.b2, t.one_minus_b2, t.eps,
               t.optax != 0};
  for (int l = lo; l < t.n && t.start[l] < q1; ++l) {
    const int s = t.start[l], n = t.numel[l];
    const int end = min(q1, t.start[l + 1]) - s;
    float* __restrict__ p = t.p[l];
    const float* __restrict__ g = t.g[l];
    float* __restrict__ m = t.m[l];
    float* __restrict__ v = t.v[l];
    for (int q = max(q0, s) - s + threadIdx.x; q < end; q += THREADS) {
      const int e = 4 * q;
      if (VEC && e + 4 <= n) {
        float4 pp = reinterpret_cast<const float4*>(p)[q];
        const float4 gg = reinterpret_cast<const float4*>(g)[q];
        float4 mm = reinterpret_cast<const float4*>(m)[q];
        float4 vv = reinterpret_cast<const float4*>(v)[q];
        adam_element(pp.x, gg.x, mm.x, vv.x, c);
        adam_element(pp.y, gg.y, mm.y, vv.y, c);
        adam_element(pp.z, gg.z, mm.z, vv.z, c);
        adam_element(pp.w, gg.w, mm.w, vv.w, c);
        reinterpret_cast<float4*>(p)[q] = pp;
        reinterpret_cast<float4*>(m)[q] = mm;
        reinterpret_cast<float4*>(v)[q] = vv;
      } else {
        for (int k = e; k < e + 4 && k < n; ++k) {
          float pk = p[k], mk = m[k], vk = v[k];
          adam_element(pk, g[k], mk, vk, c);
          p[k] = pk;
          m[k] = mk;
          v[k] = vk;
        }
      }
    }
  }
}

}  // namespace

extern "C" int spnet_adam_max_leaves() { return MAX_LEAVES; }

// One launch over n leaves: p, g, m, v arrays of n device pointers, numel
// their element counts (each 1 .. INT_MAX - 3, with fewer than INT_MAX
// quads in all); lr, bc1, bc2 0-d float32 device scalars (bc1, bc2 read
// only when optax); vec: every pointer 16-byte aligned.
extern "C" int spnet_adam_apply(void* const* p, void* const* g,
                                void* const* m, void* const* v,
                                const long long* numel, int n,
                                const void* lr, const void* bc1,
                                const void* bc2, float b1, float one_minus_b1,
                                float b2, float one_minus_b2, float eps,
                                int optax, int vec, void* stream) {
  if (n <= 0 || n > MAX_LEAVES || !lr || (optax && (!bc1 || !bc2)))
    return static_cast<int>(cudaErrorInvalidValue);
  AdamTable t;  // copied into the launch's arguments
  long long quads = 0;
  for (int i = 0; i < n; ++i) {
    if (numel[i] <= 0 || numel[i] > INT_MAX - 3 || !p[i] || !g[i] || !m[i] ||
        !v[i])
      return static_cast<int>(cudaErrorInvalidValue);
    t.p[i] = static_cast<float*>(p[i]);
    t.g[i] = static_cast<const float*>(g[i]);
    t.m[i] = static_cast<float*>(m[i]);
    t.v[i] = static_cast<float*>(v[i]);
    t.numel[i] = static_cast<int>(numel[i]);
    t.start[i] = static_cast<int>(quads);
    quads += (numel[i] + 3) / 4;
    if (quads >= INT_MAX - CHUNK_QUADS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  t.start[n] = static_cast<int>(quads);
  t.lr = static_cast<const float*>(lr);
  t.bc1 = static_cast<const float*>(bc1);
  t.bc2 = static_cast<const float*>(bc2);
  t.b1 = b1;
  t.one_minus_b1 = one_minus_b1;
  t.b2 = b2;
  t.one_minus_b2 = one_minus_b2;
  t.eps = eps;
  t.n = n;
  t.optax = optax;
  const int blocks = static_cast<int>((quads + CHUNK_QUADS - 1) / CHUNK_QUADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    adam_multi_tensor_apply_kernel<true><<<blocks, THREADS, 0, s>>>(t);
  else
    adam_multi_tensor_apply_kernel<false><<<blocks, THREADS, 0, s>>>(t);
  return static_cast<int>(cudaGetLastError());
}
