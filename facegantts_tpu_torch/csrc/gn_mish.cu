// Fused GroupNorm -> Mish -> time mask over an NCHW (B, C, F, T) tensor,
// forward and backward.
//
// The forward replaces the Pallas TPU kernel
// facegantts_tpu/ops/gn_mish.py:_fused_chain and computes what its reference
// chain _xla_chain computes:
//   y = mish(GroupNorm_G(x; scale, bias, eps)) * (t < lens[b])
// with biased variance over (C/G, F, T) per (b, g), masked tail included,
// the per-channel affine, the rational-exp Mish in f32, and a time mask built
// from the per-item length (no mask tensor is read).  The backward replaces
// the JAX custom_vjp backward (_bwd, jax.vjp of _xla_chain) with the same
// gradients in closed form:
//   dz = g * m * mish'(z),  z = xn * s_c + b_c,  xn = (x - mean) * rstd
//   dbias_c = sum dz,  dscale_c = sum dz * xn     (over b, f, t)
//   dx = rstd * (dz s_c - mean_g(dz s_c) - xn * mean_g(dz s_c * xn))
//
// Bound: memory.  The forward must read x once and write y once; the
// backward read x and g once and write dx once.  The arithmetic (~20 flops
// an element forward, ~30 backward) is far below the H100's ridge.
//
// Design.  In NCHW each (b, g) group is one contiguous slab of C/G * F
// rows of T frames.  One launch of thread-block clusters, one cluster per
// slab (up to 16 blocks); the cluster's blocks split the slab's rows.  Each
// block brings its rows into shared memory with 1-D bulk asynchronous
// copies (TMA, completing on an mbarrier) where the slab and the split are
// 16-byte aligned, so x crosses device memory once:
//   forward:  per-thread shifted sums (each part of the tile as soon as it
//             lands) -> Chan merges across the block -> the blocks' (count,
//             mean, M2) exchanged through distributed shared memory ->
//             every block normalises, applies Mish and the mask in place in
//             shared memory, 16 bytes a thread, and writes each part of y
//             out with a bulk copy while it computes the next.  Rank 0
//             writes (mean, rstd) for the backward.
//   backward: x and g arrive in kBwdParts parts, each on its own barrier,
//             and each part is reduced as soon as it lands: every warp takes
//             a slice of the part, 16 bytes a lane, and sums dz and dz * xn
//             per channel (a channel's F*T elements are contiguous; a lane's
//             frame index comes from its offset, its channel from the warp's
//             walk over the channel boundaries).  The slices' sums fold into
//             per-channel sums in slice order; those give the group sums
//             (sum dxn = sum_c s_c sum dz) and the (b, c) parameter
//             partials, both exchanged through distributed shared memory in
//             rank order (deterministic: no atomics); then dx in place and
//             out by bulk copies, part by part.  Where the cluster holds
//             the slab's x and g at two blocks an SM (every training shape,
//             four of the five GAN-436 shapes), they cross device memory
//             once; in f32 dz replaces g in shared memory, so mish' is
//             evaluated once.
// Where a block's rows do not fit its share of shared memory, the same loop
// runs over tiles: the statistics pass streams the tiles, and the output
// pass re-reads all but the last (still resident), from L2 where it holds
// them.  (Holding such a slab whole at one block an SM, which the kernel
// takes as well, measured slower on an H100: two blocks an SM overlap one
// block's arithmetic with the other's copies.)  Shapes whose slabs are not
// 16-byte aligned take the same kernels with plain loads and stores (kVec
// false).
//
// At batch 1 there are only 8 slabs; a 16-block cluster needs 16 SMs of one
// GPC, and the H100 has 7 GPCs that hold one, so one GPC runs two clusters
// (two blocks an SM) and sets the kernel's time.
//
// Plain C interface, loaded with ctypes.  Every entry point launches on the
// given stream and returns cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Stat {
  float n;
  float mean;
  float m2;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Chan et al. pairwise merge of two (count, mean, M2) summaries.
__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float d = b.mean - a.mean;
  const float wb = b.n / n;
  Stat out;
  out.n = n;
  out.mean = a.mean + d * wb;
  out.m2 = a.m2 + b.m2 + d * d * a.n * wb;
  return out;
}

__device__ __forceinline__ Stat warp_merge(Stat s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Stat t;
    t.n = __shfl_down_sync(0xffffffffu, s.n, o);
    t.mean = __shfl_down_sync(0xffffffffu, s.mean, o);
    t.m2 = __shfl_down_sync(0xffffffffu, s.m2, o);
    s = merge(s, t);
  }
  return s;
}

__device__ __forceinline__ float2 warp_sum(float2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, o);
    v.y += __shfl_down_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// Result valid in thread 0.
__device__ Stat block_merge(Stat s) {
  __shared__ Stat sh[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  s = warp_merge(s);
  if (lane == 0) sh[warp] = s;
  __syncthreads();
  if (warp == 0) {
    Stat t = {0.f, 0.f, 0.f};
    if (lane < kWarps) t = sh[lane];
    s = warp_merge(t);
  }
  return s;
}

// Rational-exp Mish (facegantts_tpu/models/unet.py mish): same clamp at 20
// and the same grouping, so the ratio stays in [0, 1).  __expf and
// __fdividef: their relative errors (~1e-6 and ~2e-7 here) move mish by
// less than 1e-5 over the unclamped range.
__device__ __forceinline__ float mish(float v) {
  const float u = __expf(fminf(v, 20.f));
  const float n = u * (u + 2.f);
  return v > 20.f ? v : v * __fdividef(n, n + 2.f);
}

// Its derivative: 1 above the clamp, else w + z (1 - w^2) sigmoid(z) with
// w = n / (n + 2), written as w + z * 4u(u + 1) / (n + 2)^2, both terms from
// one approximate reciprocal r = 1 / (n + 2) (u <= e^20, so n + 2 < 3e17
// and r^2 > 1e-35 stay normal): two special-function operations an element,
// the exp and the reciprocal.
__device__ __forceinline__ float mish_grad(float v) {
  if (v > 20.f) return 1.f;
  const float u = __expf(v);
  const float n = u * (u + 2.f);
  const float r = __fdividef(1.f, n + 2.f);
  return n * r + v * (4.f * u * (u + 1.f)) * (r * r);
}

// The two halves of cluster.sync(): arrive once this block's reads of other
// blocks' shared memory are done, wait before the block exits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// ---- bulk asynchronous copies (TMA, 1-D) and their barriers ----------------

constexpr int kParts = 2;  // a tile moves as kParts bulk copies, so work on one overlaps the next

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One thread: expect `bytes` on the barrier (arriving once); bulk_load
// starts a copy global -> shared that delivers some of them.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  if (bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One thread: copy shared -> global as one bulk group.  Every thread that
// wrote the source must have run proxy_fence() and a barrier before.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  if (bytes == 0) return;
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until the started bulk stores have read their shared memory (their
// writes to global memory are complete when the kernel is).
__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Order this thread's ordinary shared-memory writes before later bulk copies.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Plain copy of n elements (the path for slabs that are not 16-byte aligned).
template <typename T>
__device__ __forceinline__ void copy_plain(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// Shifted sums of one thread's elements: shift = its first element, so
// s2 - s1^2/n does not cancel when |mean| >> std.
struct Shifted {
  float shift, s1, s2;
  int n;
  __device__ __forceinline__ void add(float v) {
    if (n == 0) shift = v;
    const float d = v - shift;
    s1 += d;
    s2 += d * d;
    ++n;
  }
};

// The rows [r0, r1) of its slab that cluster block `rank` owns.
struct Rows {
  int r0, r1, ntiles;
};

__device__ __forceinline__ Rows block_rows(int rank, int rows, int rpb, int rpt) {
  Rows r;
  r.r0 = min(rank * rpb, rows);
  r.r1 = min(r.r0 + rpb, rows);
  r.ntiles = (r.r1 - r.r0 + rpt - 1) / rpt;
  return r;
}

// e / Tn for 0 <= e < 2^22: a float reciprocal, corrected to exact.
__device__ __forceinline__ int row_of(int e, int Tn, float inv_tn) {
  int r = __float2int_rz(static_cast<float>(e) * inv_tn);
  if (r * Tn > e) {
    --r;
  } else if ((r + 1) * Tn <= e) {
    ++r;
  }
  return r;
}

// out[u] = f(x, g, row, frame) element by element over the 16-byte units
// [u0, u1) of a tile of rows of Tn >= V frames (x and g in shared memory;
// out may alias x).  A thread a unit; a unit may cross into the next row.
template <typename T, typename Fn>
__device__ __forceinline__ void map_units(const T* xt, const T* gt, T* out, int u0, int u1,
                                          int Tn, Fn f) {
  constexpr int V = 16 / sizeof(T);
  const float inv_tn = 1.f / Tn;
  for (int u = u0 + threadIdx.x; u < u1; u += kThreads) {
    const int r = row_of(u * V, Tn, inv_tn);
    const int t = u * V - r * Tn;
    const uint4 xi = reinterpret_cast<const uint4*>(xt)[u];
    const uint4 gi = reinterpret_cast<const uint4*>(gt)[u];
    const T* xe = reinterpret_cast<const T*>(&xi);
    const T* ge = reinterpret_cast<const T*>(&gi);
    uint4 res;
    T* o = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const bool next = t + k >= Tn;
      o[k] = from_f32<T>(
          f(to_f32(xe[k]), to_f32(ge[k]), next ? r + 1 : r, next ? t + k - Tn : t + k));
    }
    reinterpret_cast<uint4*>(out)[u] = res;
  }
}

// The same an element a thread over n elements, out in global memory.
template <typename T, typename Fn>
__device__ __forceinline__ void map_elems(const T* xt, const T* gt, T* out, int n, int Tn, Fn f) {
  const float inv_tn = 1.f / Tn;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = row_of(i, Tn, inv_tn);
    out[i] = from_f32<T>(f(to_f32(xt[i]), to_f32(gt[i]), r, i - r * Tn));
  }
}

// Part p of kParts of `units` 16-byte units.
__device__ __forceinline__ int part_start(int units, int p) { return units * p / kParts; }

// Write a tile of `units` 16-byte units computed in place in shared memory
// (tile) out to global memory (dst): part by part, each part's bulk store
// overlapping the computation of the next.  compute(u0, u1) fills units
// [u0, u1) of the tile.
template <typename Compute>
__device__ __forceinline__ void compute_and_store(unsigned char* tile, unsigned char* dst,
                                                  int units, Compute compute) {
#pragma unroll 1
  for (int p = 0; p < kParts; ++p) {
    const int u0 = part_start(units, p), u1 = part_start(units, p + 1);
    compute(u0, u1);
    proxy_fence();
    __syncthreads();
    if (threadIdx.x == 0) bulk_store(dst + 16 * u0, tile + 16 * u0, 16u * (u1 - u0));
  }
}

// grid (cluster, B*G), cluster (cluster, 1, 1); rpb rows per block, rpt
// rows per shared-memory tile.  stats: (B*G, 2) mean, rstd, or null.
// Dynamic shared memory: the x tile (rounded to 16 bytes), then rpt row
// scales (rstd * scale) and rpt row biases.  kVec: the slab, every block's
// and every tile's first row are 16-byte aligned and T >= 16 / sizeof(T),
// so tiles move by bulk copies; else by plain loads and stores.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
gn_mish_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, const int* __restrict__ lens,
                   T* __restrict__ y, float* __restrict__ stats, int F, int Tn, int G,
                   int cg_, int rpb, int rpt, float eps) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const size_t tile_bytes = (static_cast<size_t>(rpt) * Tn * sizeof(T) + 15) / 16 * 16;
  float* rowa = reinterpret_cast<float*>(smem + tile_bytes);
  float* rowb = rowa + rpt;
  __shared__ Stat s_part;
  __shared__ float s_mean, s_rstd;
  __shared__ __align__(8) uint64_t s_bar[kParts];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int slab = blockIdx.y;
  const int rows = cg_ * F;
  const Rows own = block_rows(rank, rows, rpb, rpt);
  const size_t base = static_cast<size_t>(slab) * rows * Tn;
  const T* xs = x + base;
  T* ys = y + base;
  if (kVec && threadIdx.x == 0) {
    for (int p = 0; p < kParts; ++p) mbar_init(&s_bar[p]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned parity = 0;  // of the barriers' current phase: all kParts move together

  // Start the bulk copy of the tile starting at row ra, kParts barriers.
  auto load_parts = [&](int ra, int units) {
    if (threadIdx.x == 0) {
      for (int p = 0; p < kParts; ++p) {
        const int u0 = part_start(units, p), u1 = part_start(units, p + 1);
        mbar_expect(&s_bar[p], 16u * (u1 - u0));
        bulk_load(tile + u0 * V, xs + static_cast<size_t>(ra) * Tn + u0 * V, 16u * (u1 - u0),
                  &s_bar[p]);
      }
    }
  };

  // 1. statistics; the sums of a part start as soon as it has landed
  Shifted acc = {0.f, 0.f, 0.f, 0};
  for (int k = 0; k < own.ntiles; ++k) {
    const int ra = own.r0 + k * rpt;
    const int len = (min(ra + rpt, own.r1) - ra) * Tn;
    if (k > 0) __syncthreads();  // everyone is done with the previous tile
    if constexpr (kVec) {
      const int units = len / V;
      load_parts(ra, units);
      for (int p = 0; p < kParts; ++p) {
        mbar_wait(&s_bar[p], parity);
        const uint4* sv = reinterpret_cast<const uint4*>(tile);
        for (int u = part_start(units, p) + threadIdx.x; u < part_start(units, p + 1);
             u += kThreads) {
          const uint4 w = sv[u];
          const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
          for (int i = 0; i < V; ++i) acc.add(to_f32(e[i]));
        }
      }
      parity ^= 1;
    } else {
      copy_plain(tile, xs + static_cast<size_t>(ra) * Tn, len);
      __syncthreads();
      for (int i = threadIdx.x; i < len; i += kThreads) acc.add(to_f32(tile[i]));
    }
  }
  Stat st = {static_cast<float>(acc.n), 0.f, 0.f};
  if (acc.n > 0) {
    st.mean = acc.shift + acc.s1 / acc.n;
    st.m2 = fmaxf(acc.s2 - acc.s1 * acc.s1 / acc.n, 0.f);
  }
  st = block_merge(st);
  if (threadIdx.x == 0) s_part = st;
  cluster.sync();
  if (threadIdx.x < 32) {  // every block merges the cluster's partials in rank order
    Stat t = {0.f, 0.f, 0.f};
    if (static_cast<int>(threadIdx.x) < cs) t = *cluster.map_shared_rank(&s_part, threadIdx.x);
    t = warp_merge(t);
    if (threadIdx.x == 0) {
      s_mean = t.mean;
      s_rstd = rsqrtf(fmaxf(t.m2 / t.n, 0.f) + eps);
      if (rank == 0 && stats != nullptr) {
        stats[2 * slab] = s_mean;
        stats[2 * slab + 1] = s_rstd;
      }
    }
  }
  cluster_arrive();  // this block reads no other block's shared memory after this
  __syncthreads();

  // 2. normalise, Mish, mask in place, out to y; last tile first (it is
  //    resident)
  const float mean = s_mean, rstd = s_rstd;
  const int g = slab % G;
  const int valid = lens[slab / G];
  const auto y_of = [&](float v, float, int r, int t) {
    return t < valid ? mish((v - mean) * rowa[r] + rowb[r]) : 0.f;
  };
  for (int k = own.ntiles - 1; k >= 0; --k) {
    const int ra = own.r0 + k * rpt;
    const int rb = min(ra + rpt, own.r1);
    const int len = (rb - ra) * Tn;
    if (k != own.ntiles - 1) {
      if (kVec && threadIdx.x == 0) bulk_store_wait();  // the last tile's stores have read it
      __syncthreads();
      if constexpr (kVec) {
        load_parts(ra, len / V);
        for (int p = 0; p < kParts; ++p) mbar_wait(&s_bar[p], parity);
        parity ^= 1;
      } else {
        copy_plain(tile, xs + static_cast<size_t>(ra) * Tn, len);
      }
    }
    for (int i = threadIdx.x; i < rb - ra; i += kThreads) {
      const int c = g * cg_ + (ra + i) / F;
      rowa[i] = rstd * scale[c];
      rowb[i] = bias[c];
    }
    __syncthreads();
    if constexpr (kVec) {
      compute_and_store(smem, reinterpret_cast<unsigned char*>(ys + static_cast<size_t>(ra) * Tn),
                        len / V, [&](int u0, int u1) { map_units(tile, tile, tile, u0, u1, Tn, y_of); });
    } else {
      map_elems(tile, tile, ys + static_cast<size_t>(ra) * Tn, len, Tn, y_of);
    }
  }
  if (kVec && threadIdx.x == 0) bulk_store_wait();  // shared memory stays until read
  cluster_wait();  // no block leaves while another may read its shared memory
}

// ---- backward -------------------------------------------------------------

constexpr int kBwdParts = 2;  // a backward tile moves as kBwdParts (x, g) pairs of bulk copies

// Part p of kBwdParts of `units` units.
__device__ __forceinline__ int bwd_part(int units, int p) { return units * p / kBwdParts; }

// Slice k (= part * kWarps + warp) of a tile of `units` units: [s0, s1),
// the warp's share of part k / kWarps.  Slices are contiguous and ascend with k.
__device__ __forceinline__ void slice_of(int units, int k, int& s0, int& s1) {
  const int p0 = bwd_part(units, k / kWarps), n = bwd_part(units, k / kWarps + 1) - p0;
  const int w = k % kWarps;
  s0 = p0 + n * w / kWarps;
  s1 = p0 + n * (w + 1) / kWarps;
}

// U elements of unit u of a tile (16 bytes when U > 1), as f32.
template <typename T, int U>
__device__ __forceinline__ void load_unit(const T* tile, int u, float (&out)[U]) {
  if constexpr (U == 1) {
    out[0] = to_f32(tile[u]);
  } else {
    const uint4 w = reinterpret_cast<const uint4*>(tile)[u];
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int k = 0; k < U; ++k) out[k] = to_f32(e[k]);
  }
}

// Same grid as the forward (a cluster a slab).  stats (B*G, 2) from the forward; dparams (B, C, 2): per (b, c) sum dz
// (dbias) and sum dz * xn (dscale), summed over b by the caller.  Dynamic
// shared memory: the x tile and the g tile (each rounded to 16 bytes); the
// block's channel sums (min(C/G, rpb / F + 2) float2); a tile's slice
// partials (min(C/G, rpt / F + 2) + kBwdParts * kWarps float2); rpt row
// scales and rpt row biases.  Where the block's rows fit (rpt == rpb) the
// slab stays in shared memory and x and g cross device memory once; in f32
// the first pass leaves dz in the g tile, so the second does not evaluate
// mish' again.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)  // <= 64 registers: two blocks an SM
gn_mish_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const int* __restrict__ lens, const float* __restrict__ stats,
                   T* __restrict__ dx, float* __restrict__ dparams, int F, int Tn, int G,
                   int cg_, int rpb, int rpt) {
  constexpr int kNS = kBwdParts * kWarps;  // pass 1's slices a tile
  constexpr int V = 16 / sizeof(T);
  constexpr int U = kVec ? V : 1;  // elements of a pass-1 unit
  constexpr bool kKeepDz = sizeof(T) == sizeof(float);
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t tile_bytes = (static_cast<size_t>(rpt) * Tn * sizeof(T) + 15) / 16 * 16;
  T* xt = reinterpret_cast<T*>(smem);
  T* gt = reinterpret_cast<T*>(smem + tile_bytes);
  float2* chan = reinterpret_cast<float2*>(smem + 2 * tile_bytes);
  float2* part = chan + min(cg_, rpb / F + 2);
  float* rows_s = reinterpret_cast<float*>(part + min(cg_, rpt / F + 2) + kNS);
  float* rows_b = rows_s + rpt;
  __shared__ float2 s_part;
  __shared__ float2 s_sum;
  __shared__ __align__(8) uint64_t s_bar[kBwdParts];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int slab = blockIdx.y;
  const int b = slab / G, g = slab % G;
  const int rows = cg_ * F;
  const Rows own = block_rows(rank, rows, rpb, rpt);
  const size_t base = static_cast<size_t>(slab) * rows * Tn;
  const float mean = stats[2 * slab], rstd = stats[2 * slab + 1];
  const int valid = min(lens[b], Tn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c_lo = own.r0 / F;
  const int nch = own.r1 > own.r0 ? (own.r1 - 1) / F - c_lo + 1 : 0;
  const float inv_tn = 1.f / Tn, inv_f = 1.f / F;
  if (kVec && threadIdx.x == 0) {
    for (int p = 0; p < kBwdParts; ++p) mbar_init(&s_bar[p]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned parity = 0;  // of the barriers' current phase: all kBwdParts move together

  // Start loading the x and g rows [ra, ra + len / Tn) into the tiles: part
  // p's x and g land on barrier p (vec); else plain copies, complete on return.
  auto load = [&](int ra, int len) {
    const size_t off = base + static_cast<size_t>(ra) * Tn;
    if constexpr (kVec) {
      if (threadIdx.x == 0) {
        const int units = len / V;
        for (int p = 0; p < kBwdParts; ++p) {
          const int u0 = bwd_part(units, p), u1 = bwd_part(units, p + 1);
          const unsigned bytes = 16u * (u1 - u0);
          mbar_expect(&s_bar[p], 2u * bytes);
          bulk_load(xt + u0 * V, x + off + u0 * V, bytes, &s_bar[p]);
          bulk_load(gt + u0 * V, gy + off + u0 * V, bytes, &s_bar[p]);
        }
      }
    } else {
      copy_plain(xt, x + off, len);
      copy_plain(gt, gy + off, len);
      __syncthreads();
    }
  };

  // 1. per channel: sum dz and sum dz * xn (frames past the length have
  //    dz = 0).  Each part of a tile is reduced as soon as it lands, each
  //    warp over its slice of the part, 16 bytes a lane: a lane's frame
  //    index comes from its offset (row_of), its channel from the warp's
  //    walk over the channel boundaries, which is the same for every lane
  //    (a unit may straddle rows and channels).
  //    A warp's sum for a channel goes to part[channel - the tile's first
  //    channel + slice], a slot no other (slice, channel) pair uses.
  for (int k = 0; k < own.ntiles; ++k) {
    const int ra = own.r0 + k * rpt;
    const int rb = min(ra + rpt, own.r1);
    const int len = (rb - ra) * Tn;
    const int units = len / U;
    const int ct0 = ra / F;  // the tile's first channel (of the group's cg_)
    if (k > 0) {  // everyone is done with the previous tile, whose g tile holds dz
      proxy_fence();
      __syncthreads();
    }
    load(ra, len);
    for (int p = 0; p < kBwdParts; ++p) {
      const int kk = p * kWarps + warp;
      int s0, s1;
      slice_of(units, kk, s0, s1);
      // the slice's first channel and its affine, read before the data lands
      int ch = row_of(ra + row_of(s0 * U, Tn, inv_tn), F, inv_f);
      int bnd = ((ch + 1) * F - ra) * Tn;  // the tile element where channel ch ends
      float sc = 0.f, bi = 0.f;
      if (s0 < s1) sc = scale[g * cg_ + ch], bi = bias[g * cg_ + ch];
      if constexpr (kVec) mbar_wait(&s_bar[p], parity);
      if (s0 >= s1) continue;
      float2 acc = make_float2(0.f, 0.f);
      for (int u0 = s0; u0 < s1; u0 += 32) {
        const int u = u0 + lane;
        const bool in = u < s1;
        const int t0 = u * U - row_of(u * U, Tn, inv_tn) * Tn;  // frame of the unit's first element
        float xv[U], gv[U], dz[U];
        if (in) {
          load_unit<T, U>(xt, u, xv);
          load_unit<T, U>(gt, u, gv);
        }
        const int step_end = min(u0 + 32, s1) * U;
        // the elements q of this lane's unit (tile elements u * U + q) in [lo, hi)
        const auto add = [&](int lo, int hi) {
#pragma unroll
          for (int q = 0; q < U; ++q) {
            const int e = u * U + q;
            if (in && e >= lo && e < hi) {
              const int t = t0 + q >= Tn ? t0 + q - Tn : t0 + q;
              const float xn = (xv[q] - mean) * rstd;
              dz[q] = t < valid ? gv[q] * mish_grad(xn * sc + bi) : 0.f;
              acc.x += dz[q];
              acc.y += dz[q] * xn;
            }
          }
        };
        if (step_end <= bnd) {  // the whole step in channel ch: the common case
          add(0, INT_MAX);
        } else {
          int clo = 0;  // elements below clo belong to channels already summed
          while (true) {
            add(clo, bnd);
            if (step_end <= bnd) break;
            // channel ch ends inside this step: its sums are complete
            acc = warp_sum(acc);
            if (lane == 0) part[ch - ct0 + kk] = acc;
            acc = make_float2(0.f, 0.f);
            clo = bnd;
            ++ch;
            bnd += F * Tn;
            sc = scale[g * cg_ + ch];
            bi = bias[g * cg_ + ch];
          }
        }
        if constexpr (kKeepDz) {
          if (in) {
            if constexpr (U == 1) {
              gt[u] = dz[0];
            } else {
              reinterpret_cast<float4*>(gt)[u] = make_float4(dz[0], dz[1], dz[2], dz[3]);
            }
          }
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) part[ch - ct0 + kk] = acc;
    }
    if constexpr (kVec) parity ^= 1;
    __syncthreads();
    // the tile's channel sums, a warp a channel: the partials of the slices
    // that hold part of it, a lane a slice, summed by one fixed shuffle
    // tree; added to the block's totals in tile order (deterministic)
    for (int j = warp; j <= (rb - 1) / F - ct0; j += kWarps) {
      const int ch = ct0 + j;
      const int e_lo = (max(ch * F, ra) - ra) * Tn, e_hi = (min((ch + 1) * F, rb) - ra) * Tn;
      float2 sum = make_float2(0.f, 0.f);
      for (int kk = lane; kk < kNS; kk += 32) {
        int s0, s1;
        slice_of(units, kk, s0, s1);
        if (s0 < s1 && s0 * U < e_hi && s1 * U > e_lo) {
          sum.x += part[j + kk].x;
          sum.y += part[j + kk].y;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        float2& tot = chan[ch - c_lo];
        if (k == 0 || ch * F >= ra) {
          tot = sum;
        } else {
          tot.x += sum.x;
          tot.y += sum.y;
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // this block's part of sum dxn and sum dxn * xn
    float2 p = make_float2(0.f, 0.f);
    for (int kc = 0; kc < nch; ++kc) {
      const float s = scale[g * cg_ + c_lo + kc];
      p.x += s * chan[kc].x;
      p.y += s * chan[kc].y;
    }
    s_part = p;
  }
  cluster.sync();
  if (warp == 0) {  // group sums: a lane a block, one fixed shuffle tree, equal in every block
    float2 sum = make_float2(0.f, 0.f);
    if (lane < cs) sum = *cluster.map_shared_rank(&s_part, lane);
    sum = warp_sum(sum);
    if (lane == 0) s_sum = sum;
  }
  // the block holding a channel's first row sums the channel over the
  // blocks that hold it, in rank order, and writes its (b, c) partials
  for (int kc = threadIdx.x; kc < nch; kc += kThreads) {
    const int c = c_lo + kc;
    if (c * F < own.r0) continue;
    float2 sums = make_float2(0.f, 0.f);
    for (int q = rank; q < cs; ++q) {
      const Rows other = block_rows(q, rows, rpb, rpt);
      if (other.r0 >= other.r1 || other.r0 >= (c + 1) * F) break;
      const float2 p = cluster.map_shared_rank(chan, q)[c - other.r0 / F];
      sums.x += p.x;
      sums.y += p.y;
    }
    float* out = dparams + (static_cast<size_t>(b) * G * cg_ + g * cg_ + c) * 2;
    out[0] = sums.x;
    out[1] = sums.y;
  }
  cluster_arrive();
  __syncthreads();

  // 2. dx in place of x, out to global part by part; last tile first (it is
  //    resident, and in f32 holds dz); a reloaded tile's parts are computed
  //    as they land
  const float inv_n = 1.f / (static_cast<float>(rows) * Tn);
  const float m1 = s_sum.x * inv_n, m2 = s_sum.y * inv_n;
  bool have_dz = kKeepDz;
  const auto dx_of = [&](float xv, float gv, int r, int t) {
    const float s = rows_s[r];
    const float xn = (xv - mean) * rstd;
    float dz = 0.f;
    if (t < valid) dz = have_dz ? gv : gv * mish_grad(xn * s + rows_b[r]);
    return rstd * (dz * s - m1 - xn * m2);
  };
  // dx over the 16-byte units [u0, u1) of the tile, in place of x: a unit's
  // row coefficients read once (it spans at most two rows, as Tn >= V)
  const auto dx_units = [&](int u0, int u1) {
    for (int u = u0 + threadIdx.x; u < u1; u += kThreads) {
      const int r = row_of(u * V, Tn, inv_tn);
      const int t = u * V - r * Tn;
      const float s0 = rows_s[r], s1 = rows_s[r + 1];  // r + 1 <= rpt: in bounds
      float b0 = 0.f, b1 = 0.f;
      if (!have_dz) b0 = rows_b[r], b1 = rows_b[min(r + 1, rpt - 1)];
      const uint4 xi = reinterpret_cast<const uint4*>(xt)[u];
      const uint4 gi = reinterpret_cast<const uint4*>(gt)[u];
      const T* xe = reinterpret_cast<const T*>(&xi);
      const T* ge = reinterpret_cast<const T*>(&gi);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const bool next = t + q >= Tn;
        const float s = next ? s1 : s0;
        const float xn = (to_f32(xe[q]) - mean) * rstd;
        float dz = 0.f;
        if ((next ? t + q - Tn : t + q) < valid) {
          const float gv = to_f32(ge[q]);
          dz = have_dz ? gv : gv * mish_grad(xn * s + (next ? b1 : b0));
        }
        o[q] = from_f32<T>(rstd * (dz * s - m1 - xn * m2));
      }
      reinterpret_cast<uint4*>(xt)[u] = res;
    }
  };
  for (int k = own.ntiles - 1; k >= 0; --k) {
    const int ra = own.r0 + k * rpt;
    const int rb = min(ra + rpt, own.r1);
    const int len = (rb - ra) * Tn;
    const bool reload = k != own.ntiles - 1;
    if (reload) {
      have_dz = false;
      if (kVec && threadIdx.x == 0) bulk_store_wait();  // the stores have read the tile
      __syncthreads();
      load(ra, len);
    }
    for (int i = threadIdx.x; i < rb - ra; i += kThreads) {
      const int c = g * cg_ + (ra + i) / F;
      rows_s[i] = scale[c];
      rows_b[i] = bias[c];
    }
    __syncthreads();
    T* out = dx + base + static_cast<size_t>(ra) * Tn;
    if constexpr (kVec) {
      const int units = len / V;
#pragma unroll 1
      for (int p = 0; p < kBwdParts; ++p) {
        const int u0 = bwd_part(units, p), u1 = bwd_part(units, p + 1);
        if (reload) mbar_wait(&s_bar[p], parity);
        dx_units(u0, u1);
        proxy_fence();
        __syncthreads();
        if (threadIdx.x == 0)
          bulk_store(reinterpret_cast<unsigned char*>(out) + 16 * u0,
                     reinterpret_cast<unsigned char*>(xt) + 16 * u0, 16u * (u1 - u0));
      }
      if (reload) parity ^= 1;
    } else {
      map_elems(xt, gt, out, len, Tn, dx_of);
    }
  }
  if (kVec && threadIdx.x == 0) bulk_store_wait();
  cluster_wait();
}

// The eight instantiations, indexed by kind = 4 * backward + 2 * bf16 + vec.
const void* kernel_of(int kind) {
  switch (kind) {
    case 0: return reinterpret_cast<const void*>(&gn_mish_fwd_kernel<float, false>);
    case 1: return reinterpret_cast<const void*>(&gn_mish_fwd_kernel<float, true>);
    case 2: return reinterpret_cast<const void*>(&gn_mish_fwd_kernel<__nv_bfloat16, false>);
    case 3: return reinterpret_cast<const void*>(&gn_mish_fwd_kernel<__nv_bfloat16, true>);
    case 4: return reinterpret_cast<const void*>(&gn_mish_bwd_kernel<float, false>);
    case 5: return reinterpret_cast<const void*>(&gn_mish_bwd_kernel<float, true>);
    case 6: return reinterpret_cast<const void*>(&gn_mish_bwd_kernel<__nv_bfloat16, false>);
    case 7: return reinterpret_cast<const void*>(&gn_mish_bwd_kernel<__nv_bfloat16, true>);
    default: return nullptr;
  }
}

cudaLaunchConfig_t launch_config(dim3 grid, int cluster, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// A launch plan, made once per shape by the caller (ops/gn_mish.py keeps
// the same field order).
struct Plan {
  int bf16, vec, B, G, cg, F, T, cluster, rpb, rpt, smem;
};

template <typename T, bool kVec>
int launch_fwd(const Plan& p, const void* x, const void* scale, const void* bias,
               const void* lens, void* y, void* stats, float eps, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(dim3(p.cluster, p.B * p.G), p.cluster, p.smem, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gn_mish_fwd_kernel<T, kVec>, static_cast<const T*>(x),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const int*>(lens), static_cast<T*>(y), static_cast<float*>(stats), p.F, p.T,
      p.G, p.cg, p.rpb, p.rpt, eps);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T, bool kVec>
int launch_bwd(const Plan& p, const void* x, const void* gy, const void* scale,
               const void* bias, const void* lens, const void* stats, void* dx, void* dparams,
               cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(dim3(p.cluster, p.B * p.G), p.cluster, p.smem, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gn_mish_bwd_kernel<T, kVec>, static_cast<const T*>(x), static_cast<const T*>(gy),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const int*>(lens), static_cast<const float*>(stats), static_cast<T*>(dx),
      static_cast<float*>(dparams), p.F, p.T, p.G, p.cg, p.rpb, p.rpt);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// Once per device: allow every instantiation max_smem bytes of dynamic
// shared memory and clusters of up to 16 blocks (non-portable).
extern "C" int fgt_gn_mish_setup(int max_smem) {
  for (int kind = 0; kind < 8; ++kind) {
    const void* fn = kernel_of(kind);
    cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// How many clusters of `cluster` blocks with `smem` bytes each can be
// resident at once (0: the configuration does not fit).
extern "C" int fgt_gn_mish_max_clusters(int kind, int cluster, int smem, int* out) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(dim3(cluster, 1, 1), cluster, smem, nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel_of(kind), &cfg));
}

// plan: the 11 ints of Plan.  stats may be null (no gradient to come).
extern "C" int fgt_gn_mish_fwd(const int* plan, const void* x, const void* scale,
                               const void* bias, const void* lens, void* y, void* stats, float eps,
                               void* stream) {
  const Plan& p = *reinterpret_cast<const Plan*>(plan);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.bf16) {
    return p.vec ? launch_fwd<__nv_bfloat16, true>(p, x, scale, bias, lens, y, stats, eps, s)
                 : launch_fwd<__nv_bfloat16, false>(p, x, scale, bias, lens, y, stats, eps, s);
  }
  return p.vec ? launch_fwd<float, true>(p, x, scale, bias, lens, y, stats, eps, s)
               : launch_fwd<float, false>(p, x, scale, bias, lens, y, stats, eps, s);
}

extern "C" int fgt_gn_mish_bwd(const int* plan, const void* x, const void* gy,
                               const void* scale, const void* bias, const void* lens,
                               const void* stats, void* dx, void* dparams, void* stream) {
  const Plan& p = *reinterpret_cast<const Plan*>(plan);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.bf16) {
    return p.vec ? launch_bwd<__nv_bfloat16, true>(p, x, gy, scale, bias, lens, stats, dx,
                                                   dparams, s)
                 : launch_bwd<__nv_bfloat16, false>(p, x, gy, scale, bias, lens, stats, dx,
                                                    dparams, s);
  }
  return p.vec ? launch_bwd<float, true>(p, x, gy, scale, bias, lens, stats, dx, dparams, s)
               : launch_bwd<float, false>(p, x, gy, scale, bias, lens, stats, dx, dparams, s);
}
