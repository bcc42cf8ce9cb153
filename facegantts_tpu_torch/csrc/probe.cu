// Backend probes: the counterparts of the Pallas kernels in
// scripts/pallas_probe.py, which qualify a backend before hot ops move to
// hand-written kernels.
//
// P1 (probe_trivial): y = 2x + 1 elementwise (a (256, 256) f32 array).
//   Bound: memory, one read and one write (0.5 MB: 0.16 us at 3.35 TB/s,
//   far below a launch, so the launch and the host's call set the time).
//   16-byte loads and stores over a grid of a few blocks an SM,
//   grid-stride; the elements before the first 16-byte boundary and after
//   the last stay scalar, and so does everything when x and y are not
//   aligned alike (a view such as x.view(-1)[1:]).
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
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kAhead = 16;  // columns loaded into registers at once

// jnp.maximum / torch.maximum: NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

constexpr int kAffineThreads = 256;
constexpr int kAffineBlocksPerSm = 4;

__device__ __forceinline__ float affine(float v) { return v * 2.0f + 1.0f; }

__global__ void __launch_bounds__(kAffineThreads)
    affine_kernel(const float* __restrict__ x, float* __restrict__ y, long long n) {
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const unsigned xm = reinterpret_cast<uintptr_t>(x) & 15, ym = reinterpret_cast<uintptr_t>(y) & 15;
  if (xm != ym || (xm & 3)) {  // no common 16-byte boundary: all scalar
    for (long long i = first; i < n; i += stride) y[i] = affine(x[i]);
    return;
  }
  const long long head = min(n, (long long)((16 - xm) & 15) / 4);
  const long long nvec = (n - head) / 4;
  if (first < head) y[first] = affine(x[first]);
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  float4* yv = reinterpret_cast<float4*>(y + head);
  for (long long i = first; i < nvec; i += stride) {
    const float4 a = __ldg(xv + i);
    yv[i] = make_float4(affine(a.x), affine(a.y), affine(a.z), affine(a.w));
  }
  const long long tail = head + 4 * nvec + first;
  if (tail < n) y[tail] = affine(x[tail]);
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
  static int sms = 0;  // the card's SM count, read once
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long work = (n + 3) / 4;  // a float4 a thread and round
  const long long blocks = std::max(
      1LL, std::min((work + kAffineThreads - 1) / kAffineThreads, (long long)kAffineBlocksPerSm * sms));
  affine_kernel<<<(unsigned)blocks, kAffineThreads, 0,
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
