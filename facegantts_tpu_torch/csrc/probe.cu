// Backend probes: the counterparts of the Pallas kernels in
// scripts/pallas_probe.py, which qualify a backend before hot ops move to
// hand-written kernels.
//
// P1 (probe_trivial): y = 2x + 1 elementwise (a (256, 256) f32 array).
//   Bound: memory, one read and one write.  One thread an element.
// P2 (probe_dp_loop): a column-scan DP over (T_y, B, T_x) f32 with a zero
//   initial carry, every column written out:
//     new = col + max(prev, roll(prev, 1 along T_x)),  roll wraps around:
//     the shifted value at x = 0 is prev[T_x - 1].
//   One block per batch item, one thread per x; the carry sits in shared
//   memory (double-buffered, one barrier a column).  The columns do not
//   depend on the DP, so each thread loads its next 16 values into
//   registers at once and the loads overlap.  Bound: the T_y dependent
//   steps (an add and a max behind a barrier); the bytes are 2 MB.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kAhead = 16;  // columns loaded into registers at once

// jnp.maximum / torch.maximum: NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__global__ void affine_kernel(const float* __restrict__ x,
                              float* __restrict__ y, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f + 1.0f;
}

__global__ void dp_loop_kernel(const float* __restrict__ v,
                               float* __restrict__ out, int Ty, int B,
                               int Tx) {
  extern __shared__ float carry[];  // [2][blockDim.x]
  const int b = blockIdx.x, x = threadIdx.x, nt = blockDim.x;
  float* prev = carry;
  float* next = carry + nt;
  prev[x] = 0.f;
  const int left = x == 0 ? Tx - 1 : x - 1;
  __syncthreads();
  for (int y0 = 0; y0 < Ty; y0 += kAhead) {
    float col[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int y = y0 + k;
      col[k] = (y < Ty && x < Tx) ? v[((size_t)y * B + b) * Tx + x] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int y = y0 + k;
      if (y >= Ty) break;  // the same for every thread of the block
      const float nv = col[k] + max_nan(prev[x], prev[left]);
      next[x] = nv;
      if (x < Tx) out[((size_t)y * B + b) * Tx + x] = nv;
      __syncthreads();
      float* t = prev;
      prev = next;
      next = t;
    }
  }
}

}  // namespace

extern "C" int fgt_probe_trivial_f32(const void* x, void* y, long long n,
                                     void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  affine_kernel<<<(unsigned)blocks, threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fgt_probe_dp_loop_f32(const void* v, void* out, int Ty, int B,
                                     int Tx, int threads, void* stream) {
  dp_loop_kernel<<<B, threads, 2 * threads * sizeof(float),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<float*>(out), Ty, B, Tx);
  return static_cast<int>(cudaGetLastError());
}
