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
//   Bound: the T_y dependent column steps (an add and a max each); the
//   bytes (2 MB at the probe's shape) take less.  So the chain must not
//   wait on memory or on block barriers.  A warp owns one batch item
//   (kP2Warps items a block, no block barrier anywhere): lane l keeps rows
//   [l R, l R + R) of the carry in registers, R = ceil(T_x / 32) rounded up
//   to a power of two.  A column step is the lane's own rows plus one
//   shuffle: the left neighbour of its first row from lane l - 1, and for
//   lane 0 the wrap-around value prev[T_x - 1] from the lane that owns it
//   (lane T_x / R - 1, its last row, when R divides T_x; otherwise that
//   lane sends the row it selects, kRagged, in place of its last).  The
//   columns do not depend on the DP: each lane stages its own rows of the
//   coming columns in a shared-memory ring with asynchronous copies
//   (cp.async, 16 bytes where the rows and the tensors align), kP2Ring
//   blocks of K columns ahead, and reads a whole block into registers at
//   once, so between two reads K column steps run on registers and
//   shuffles alone.  Each lane reads back only what it copied, so no
//   barrier is needed.  Stores are 16 bytes a lane where the rows align.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// jnp.maximum / torch.maximum: NaN in either operand gives NaN (one
// instruction; +0 and -0 compare equal, as they do for torch.equal)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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

constexpr int kP2Warps = 4;  // batch items a block, one a warp
constexpr int kP2Ring = 8;   // blocks of columns staged ahead

// Columns a block of the column loop: K columns of a lane's R rows are
// read from shared memory into registers at once, so the K steps between
// two reads are register operations and shuffles only (<= 32 values: on
// an H100 longer blocks with fewer of them in flight ran slower).
template <int R>
__host__ __device__ constexpr int p2_cols() {
  return R <= 8 ? 4 : 32 / R;
}

template <int R>
__host__ __device__ constexpr int p2_smem() {
  return kP2Warps * kP2Ring * p2_cols<R>() * 32 * R * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// grid ceil(B / kP2Warps), block 32 * kP2Warps; dynamic shared memory
// p2_smem<R>().  kVec: T_x % 4 == 0, R >= 4 and both tensors 16-byte
// aligned, so a lane's rows move as 16-byte units.  kRagged: R does not
// divide T_x.
template <int R, bool kVec, bool kRagged>
__global__ void __launch_bounds__(32 * kP2Warps)
    dp_loop_kernel(const float* __restrict__ v, float* __restrict__ out, int Ty, int B, int Tx) {
  constexpr int K = p2_cols<R>();
  constexpr int kStep = kVec ? 4 : 1;
  extern __shared__ __align__(16) float ring[];  // [kP2Warps][kP2Ring][K][32 R]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kP2Warps + warp;
  if (b >= B) return;  // the whole warp: nothing below synchronises the block
  float* my = ring + static_cast<size_t>(warp) * kP2Ring * K * 32 * R + lane * R;
  const int x0 = lane * R;
  const int owner = (Tx - 1) / R;      // the lane holding x = T_x - 1 ...
  const int pos = Tx - 1 - owner * R;  // ... at this row of its R
  // Each lane's left neighbour comes from lane - 1, lane 0's from the owner
  // of x = T_x - 1 (the wrap-around); the owner sends that row in place of
  // its last (inactive when R does not divide T_x, and read by no one).
  const int from = lane == 0 ? owner : lane - 1;
  const int sent = lane == owner ? pos : R - 1;  // the row this lane sends
  const size_t col_stride = static_cast<size_t>(B) * Tx;
  const float* src = v + static_cast<size_t>(b) * Tx + x0;
  float* dst = out + static_cast<size_t>(b) * Tx + x0;
  const int nblocks = (Ty + K - 1) / K;

  // Stage block j (columns [j K, j K + K)) into ring slot j % kP2Ring; one
  // commit group a block, empty past the end, so that
  // wait_group<kP2Ring - 1> always means "block j has landed".
  auto stage = [&](int j) {
    if (j < nblocks) {
      float* slot = my + (j % kP2Ring) * K * 32 * R;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int y = j * K + k;
        if (y < Ty) {
#pragma unroll
          for (int i = 0; i < R; i += kStep) {
            if (x0 + i < Tx) {
              if constexpr (kVec) {
                cp_async16(slot + k * 32 * R + i, src + y * col_stride + i);
              } else {
                cp_async4(slot + k * 32 * R + i, src + y * col_stride + i);
              }
            }
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int j = 0; j < kP2Ring; ++j) stage(j);

  float c[R];
#pragma unroll
  for (int i = 0; i < R; ++i) c[i] = 0.f;
  // One column step: register operations and one shuffle.
  auto step = [&](const float (&col)[R], int y) {
    float send = c[R - 1];
    if constexpr (kRagged) {
#pragma unroll
      for (int i = 0; i < R - 1; ++i) send = i == sent ? c[i] : send;
    }
    const float left = __shfl_sync(0xffffffffu, send, from);
#pragma unroll
    for (int i = R - 1; i > 0; --i) c[i] = col[i] + max_nan(c[i], c[i - 1]);
    c[0] = col[0] + max_nan(c[0], left);
    float* o = dst + y * col_stride;
#pragma unroll
    for (int i = 0; i < R; i += kStep) {
      if (x0 + i < Tx) {
        if constexpr (kVec) {
          *reinterpret_cast<float4*>(o + i) = make_float4(c[i], c[i + 1], c[i + 2], c[i + 3]);
        } else {
          o[i] = c[i];
        }
      }
    }
  };
#pragma unroll 1
  for (int j = 0; j < nblocks; ++j) {
    cp_async_wait<kP2Ring - 1>();
    const float* slot = my + (j % kP2Ring) * K * 32 * R;
    float col[K][R];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < R; i += kStep) {
        if constexpr (kVec) {
          const float4 q = *reinterpret_cast<const float4*>(slot + k * 32 * R + i);
          col[k][i] = q.x, col[k][i + 1] = q.y, col[k][i + 2] = q.z, col[k][i + 3] = q.w;
        } else {
          col[k][i] = slot[k * 32 * R + i];
        }
      }
    }
    if ((j + 1) * K <= Ty) {  // a whole block: K steps with nothing between them
#pragma unroll
      for (int k = 0; k < K; ++k) step(col[k], j * K + k);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (j * K + k < Ty) step(col[k], j * K + k);
      }
    }
    stage(j + kP2Ring);  // into the slot just read: its values are in registers
  }
  cp_async_wait<0>();
}

template <int R, bool kVec, bool kRagged>
int launch_dp_loop(const float* v, float* out, int Ty, int B, int Tx, cudaStream_t stream) {
  static bool ready = false;  // the dynamic shared memory limit, set once
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(dp_loop_kernel<R, kVec, kRagged>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 p2_smem<R>());
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  dp_loop_kernel<R, kVec, kRagged><<<(B + kP2Warps - 1) / kP2Warps, 32 * kP2Warps, p2_smem<R>(),
                                     stream>>>(v, out, Ty, B, Tx);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int dispatch_dp_loop(const float* v, float* out, int Ty, int B, int Tx, cudaStream_t stream) {
  const bool vec = R >= 4 && Tx % 4 == 0 && (reinterpret_cast<uintptr_t>(v) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const bool ragged = Tx % R != 0;
  if constexpr (R >= 4) {
    if (vec) {
      return ragged ? launch_dp_loop<R, true, true>(v, out, Ty, B, Tx, stream)
                    : launch_dp_loop<R, true, false>(v, out, Ty, B, Tx, stream);
    }
  }
  return ragged ? launch_dp_loop<R, false, true>(v, out, Ty, B, Tx, stream)
                : launch_dp_loop<R, false, false>(v, out, Ty, B, Tx, stream);
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

// rows: the rows a lane owns, ceil(T_x / 32) rounded up to a power of two
// (1 <= T_x <= 1024); any other value is refused (cudaErrorInvalidValue).
extern "C" int fgt_probe_dp_loop_f32(const void* v, void* out, int Ty, int B,
                                     int Tx, int rows, void* stream) {
  int want = 1;
  while (32 * want < Tx) want *= 2;
  if (Tx < 1 || Tx > 1024 || Ty < 1 || B < 1 || rows != want)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* in = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return dispatch_dp_loop<1>(in, o, Ty, B, Tx, s);
    case 2: return dispatch_dp_loop<2>(in, o, Ty, B, Tx, s);
    case 4: return dispatch_dp_loop<4>(in, o, Ty, B, Tx, s);
    case 8: return dispatch_dp_loop<8>(in, o, Ty, B, Tx, s);
    case 16: return dispatch_dp_loop<16>(in, o, Ty, B, Tx, s);
    default: return dispatch_dp_loop<32>(in, o, Ty, B, Tx, s);
  }
}
