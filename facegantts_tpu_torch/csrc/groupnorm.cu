// GroupNorm statistics: per-(batch, channel) sum and sum of squares, in f32,
// of an NCHW (B, C, F, T) f32 tensor.  Output (B, 2, C): [b, 0, c] the sum,
// [b, 1, c] the sum of squares.
//
// Replaces the Pallas TPU kernel facegantts_tpu/ops/groupnorm.py:
// _pallas_lane_sums, which reads an NHWC tensor as (B, R, 128) rows and sums
// each of the 128 lanes (lane l holds channel l % C) so a later fold gives
// per-channel sums.  In NCHW each (b, c) is one contiguous run of F*T
// elements, so the fold has no counterpart: one block reduces one run.
// The fold to groups, the normalise and the affine stay in torch, as the JAX
// package leaves them to XLA.
//
// Bound: memory -- one read of x (the output is 8 bytes a channel).  Each
// thread sums a strided share of the run with 16-byte loads where the run
// allows them, then the block reduces with warp shuffles.  Sums are plain
// f32 in another order than the JAX package's; no atomics, so the result
// does not change from run to run.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void channel_sums_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int C,
                                    long long n) {
  const long long row = blockIdx.x;  // b * C + c
  const float* p = x + row * n;
  float s = 0.f, s2 = 0.f;
  if ((n & 3) == 0 && (reinterpret_cast<size_t>(p) & 15) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    for (long long i = threadIdx.x; i < n / 4; i += kThreads) {
      const float4 v = p4[i];
      s += (v.x + v.y) + (v.z + v.w);
      s2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    }
  } else {
    for (long long i = threadIdx.x; i < n; i += kThreads) {
      const float v = p[i];
      s += v;
      s2 += v * v;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  __shared__ float part[2][kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = s;
    part[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, a2 = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      a += part[0][w];
      a2 += part[1][w];
    }
    const long long b = row / C, c = row % C;
    out[(b * 2) * C + c] = a;
    out[(b * 2 + 1) * C + c] = a2;
  }
}

}  // namespace

extern "C" int fgt_channel_sums_f32(const void* x, void* out, int B, int C,
                                    long long n, void* stream) {
  channel_sums_kernel<<<B * C, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), C, n);
  return static_cast<int>(cudaGetLastError());
}
