// Monotonic alignment search (MAS): the Viterbi path through a log-prior.
//
// Computes what the JAX package's facegantts_tpu/ops/mas.py:maximum_path
// computes (a lax.scan there, not a Pallas kernel), bit for bit:
//   value <- where(mask > 0, value, 0)
//   tx = max(sum_x mask[b, x, 0], 1), ty = max(sum_y mask[b, 0, y], 1)
//   v[x, y] = value[x, y] + max(x == y ? NEG : v[x, y-1],
//                               x == 0 ? (y == 0 ? 0 : NEG) : v[x-1, y-1])
//   inside the band max(0, tx + y - ty) <= x <= min(tx - 1, y), NEG outside
//   (NEG = -1e9), then a backtrack from x = tx - 1 at y = ty - 1 that steps
//   down when x != 0 and (x == y or v[x, y-1] < v[x-1, y-1]).
// The output is the 0/1 path times the mask, (B, T_x, T_y) f32.
//
// Bound: memory.  Value and mask matter only inside the feasibility band
// (tx * (ty - tx + 1) cells an item), and the path is written whole.  One
// item is one chain of ty dependent column steps, so it stays on one SM,
// and its time is the larger of what that SM can read and the chain, plus
// the ty dependent steps of the backtrack.  At the training shapes the
// chain sets it: a column step of a DP warp is a short dependent sequence
// (a shuffle, a max, an add, the band select) that a warp issues in order.
//
// Design: one cluster of two blocks per item, no block barrier inside the
// column loop.
// - Block 1 writes 16-byte zeros over the item's whole (T_x, T_y) output,
//   so block 0's SM moves only the band.
// - In block 0, NW <= 8 DP warps (two on each of the SM's schedulers) walk
//   the columns.  Lane l of DP warp k owns the RL consecutive text rows
//   (32 k + l) RL .. + RL-1 in registers (R = NW RL rows a lane over all
//   DP warps, 32 R >= T_x; R, and so RL and NW, a template parameter).  A
//   column step is RL independent add/max pairs (max.NaN, one instruction)
//   and one __shfl_up_sync for the row above the lane's first; lane 0 of
//   warp k > 0 reads that row from a ring that warp k-1's lane 31 fills, the
//   two warps handing progress over through release/acquire counters once a
//   group of G columns (the warps run a group apart, never in lockstep).  A
//   group's loads come first and its full groups hold no branch, so the
//   scheduler overlaps the band arithmetic with the chain.  A ballot packs
//   each row slot's decision bits of a column into one word in shared
//   memory (T_y x R words: 28 KB at (256, 872)).
// - The other 24 warps form three fill groups of eight, which fill a ring
//   of kStages tiles of W mel columns (W = 32, or 16 or 8 where shared
//   memory is short) in turn with where(mask > 0, value, 0), reading only a
//   tile's band rows max(0, tx + y0 - ty) .. min(tx - 1, y0 + W - 1), 16
//   bytes a load where T_y % 4 == 0, and asking L2 for the group's next
//   tile meanwhile.  Full and empty mbarriers hand each stage between the
//   fill groups and the DP warps.  The fold needs value and mask in
//   registers, so the loads are plain ones (no cp.async stage that would
//   need a second pass through shared memory).  A tile is stored
//   transposed, column-major, row x = (32 k + l) RL + r at (k RL + r) * 33
//   + l of its column, so each DP warp reads a column without bank
//   conflicts and the fill warps' stores spread over the banks.
// After the DP, warp 0 walks the bits back 32 columns a round (each lane
// gathers one column's window of candidate rows; the walk itself is a
// shift and an add a step); after a block barrier and a cluster barrier
// (block 1's zeros are written) the T_y path cells get mask[idx[y], y]: the
// mask is not re-read elsewhere.
//
// Plain C interface, loaded with ctypes; returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kStages = 3;                         // tiles in the ring
constexpr int kThreads = 1024;                     // per block: 32 warps
constexpr int kMaxDP = 8;                          // DP warps at most (two a scheduler)
constexpr int kFillWarp0 = kMaxDP;                 // warps 8-31 fill
constexpr int kGroup = 256;                        // threads of a fill group (8 warps)
constexpr int kGroups = (kThreads / 32 - kFillWarp0) * 32 / kGroup;  // 3
constexpr int kBatch = 4;                          // loads in flight a fill thread
constexpr int kRing = 64;                          // boundary rows between DP warps
// mbarriers, the sum scratch, the DP warps' progress and boundary rings
// (ops/mas.py: _HEADER)
constexpr int kHeader = 2 * kStages * 8 + 32 * 4 + kMaxDP * 4 + (kMaxDP - 1) * kRing * 4;

// floats between two columns of a tile: positions reach 33 R - 2, and the
// stride is odd mod 32 so that the fill warps' stores of neighbouring
// columns differ in bank (ops/mas.py: _col_stride)
__host__ __device__ constexpr int col_stride(int R) { return (33 * R - 1 + 31) / 32 * 32 + 1; }

// jnp.maximum / torch.maximum: NaN in either operand gives NaN (which NaN,
// and which zero of max(+0, -0), no comparison downstream can tell)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float fold(float v, float m) { return m > 0.f ? v : 0.f; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Arrive once (release: this thread's earlier shared-memory accesses are
// ordered before the phase completes).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Whether the barrier's phase `parity` has completed (acquire).
__device__ __forceinline__ bool mbar_try(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the phase: the DP warps poll; the fill warps, which share the DP
// warps' schedulers, sleep between polls so as not to take their issue slots.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  while (!mbar_try(bar, parity)) {
  }
}
__device__ __forceinline__ void mbar_wait_sleeping(uint64_t* bar, unsigned parity) {
  for (unsigned ns = 32; !mbar_try(bar, parity); ns = ns < 512 ? 2 * ns : ns) __nanosleep(ns);
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];\n" : "=r"(v) : "r"(smem_addr(p))
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared::cta.b32 [%0], %1;\n" ::"r"(smem_addr(p)), "r"(v)
               : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) s += scratch[w];
  return s;
}

// Position of text row x in a tile's column (a DP lane's rows RL apart).
template <int RL>
__device__ __forceinline__ int row_slot(int x) {
  const int g = x / RL;  // the owning lane over all DP warps
  return ((g >> 5) * RL + x % RL) * 33 + (g & 31);
}

// A fill group: one tile of the ring, band rows only; gt is the thread's
// index in its group.
template <int RL, int CS, bool kVec>
__device__ __forceinline__ void fill_tile(float* tile, const float* __restrict__ val,
                                          const float* __restrict__ msk, int Ty, int W,
                                          int tx, int ty, int y0, int gt, int ahead) {
  const int xlo = max(0, tx + y0 - ty), xhi = min(tx - 1, y0 + W - 1);
  if (xlo > xhi) return;  // tx > ty: no band row in these columns
  constexpr int kPer = kVec ? 4 : 1;  // columns a load
  const int shift = __ffs(W / kPer) - 1;  // log2 of the loads a row (W / kPer divides kGroup)
  const int items = (xhi - xlo + 1) << shift;
  for (int i0 = gt; i0 < items; i0 += kBatch * kGroup) {
    float v[kBatch][kPer], m[kBatch][kPer];
    // a thread's loads share a column and step kGroup / (W / kPer) rows
    const int col = (i0 & ((1 << shift) - 1)) * kPer, row0 = xlo + (i0 >> shift);
    // a column past ty lies in no band (with 16-byte loads the first column
    // of a group decides: T_y % 4 == 0 keeps the group in the row)
    const bool col_live = y0 + col < ty;
    int row[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      row[k] = row0 + k * (kGroup >> shift);
      const bool live = col_live && row[k] <= xhi;
      const size_t at = (size_t)row[k] * Ty + y0 + col;
      // the same cells `ahead` columns on (this group's next tile) into L2,
      // where they lie in that tile's band
      if (row[k] <= xhi && row[k] >= tx + y0 + ahead - ty && y0 + col + ahead < ty) {
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(val + at + ahead));
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(msk + at + ahead));
      }
      if (!live) row[k] = -1;
      if constexpr (kVec) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
        if (live) {
          a = __ldg(reinterpret_cast<const float4*>(val + at));
          b = __ldg(reinterpret_cast<const float4*>(msk + at));
        }
        v[k][0] = a.x; v[k][1] = a.y; v[k][2] = a.z; v[k][3] = a.w;
        m[k][0] = b.x; m[k][1] = b.y; m[k][2] = b.z; m[k][3] = b.w;
      } else {
        v[k][0] = live ? __ldg(val + at) : 0.f;
        m[k][0] = live ? __ldg(msk + at) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (row[k] < 0) continue;
      float* dst = tile + col * CS + row_slot<RL>(row[k]);
#pragma unroll
      for (int j = 0; j < kPer; ++j) dst[j * CS] = fold(v[k][j], m[k][j]);
    }
  }
}

// Columns a DP warp takes as one group: independent columns whose loads and
// band arithmetic the scheduler overlaps with the dependent chain.
template <int RL>
__host__ __device__ constexpr int group_cols() { return RL == 1 ? 8 : RL == 2 ? 4 : 2; }

// One group of G columns yg .. yend-1 of DP warp k: the loads first, then
// the dependent column steps, then the decision words and the ring.  kFull
// (yend - yg == G) leaves no branch in the group, so the scheduler can move
// a later column's loads and band arithmetic ahead of the chain.
template <int RL, int NW, int CS, int G, bool kFull>
__device__ __forceinline__ void column_group(float (&v)[RL], const float* tile, int yl, int yg,
                                             int yend, const float* above_ring, float* ring,
                                             unsigned* bits, int tx, int ty, int k, int lane,
                                             int first) {
  constexpr int R = RL * NW;
  float in[G][RL], above[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int r = 0; r < RL; ++r) in[j][r] = tile[(yl + j) * CS + r * 33];
    above[j] = above_ring[(yg + j - 1 + kRing) % kRing];
  }
  unsigned word[G][RL];
  float last[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int y = yg + j;
    if (!kFull && y >= yend) break;  // the same in every lane
    // the row above this lane's first, at column y-1
    float up = __shfl_up_sync(0xffffffffu, v[RL - 1], 1);
    const float edge = k == 0 ? (y == 0 ? 0.f : kNeg) : (y == 0 ? kNeg : above[j]);
    up = lane == 0 ? edge : up;
    // rows first + a .. first + b lie in the band; first + rd on the diagonal
    const int a = max(0, tx + y - ty) - first, b = min(tx - 1, y) - first, rd = y - first;
#pragma unroll
    for (int r = RL - 1; r >= 0; --r) {  // downwards: v[r - 1] is still column y-1
      const float pv = v[r];
      const float pd = r > 0 ? v[r - 1] : up;
      const bool on_diag = r == rd;
      // down = x != 0 and (x == y or v[x, y-1] < v[x-1, y-1]), and y > 0
      word[j][r] = __ballot_sync(0xffffffffu, on_diag || pv < pd);
      const float same = on_diag ? kNeg : pv;
      v[r] = r >= a && r <= b ? in[j][r] + max_nan(same, pd) : kNeg;
    }
    if (k == 0) word[j][0] &= ~1u;  // row 0 never steps down
    last[j] = v[RL - 1];
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int y = yg + j;
    if (!kFull && y >= yend) break;
#pragma unroll
    for (int r = 0; r < RL; ++r) bits[(size_t)y * R + k * RL + r] = y == 0 ? 0u : word[j][r];
    if (k < NW - 1 && lane == 31) ring[k * kRing + y % kRing] = last[j];
  }
}

// DP warp k of NW: the column walk over its rows, G columns at a time.  Once
// a group, warp k > 0 waits for warp k-1 to have finished the same group
// (its last rows are then in the ring), and warp k < NW-1 for warp k+1 to
// have read the ring slots it is about to overwrite.  Lane 31 publishes the
// progress; every lane stores the same decision words, so lane 31's release
// covers them.
template <int RL, int NW, int CS>
__device__ __forceinline__ void dp_walk(const float* tiles, uint64_t* full, uint64_t* empty,
                                        int* prog, float* ring, unsigned* bits, int W, int tx,
                                        int ty, int ntiles) {
  constexpr int G = group_cols<RL>();
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = (k * 32 + lane) * RL;  // this lane's first row
  const float* above_ring = ring + max(k - 1, 0) * kRing;
  float v[RL];
#pragma unroll
  for (int r = 0; r < RL; ++r) v[r] = kNeg;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    const float* tile = tiles + (size_t)s * W * CS + k * RL * 33 + lane;
    const int y0 = t * W, ycount = min(W, ty - y0);
    for (int yl = 0; yl < ycount; yl += G) {  // W is a multiple of G
      const int yg = y0 + yl, yend = min(yg + G, ty);
      if (k > 0) {
        while (ld_acquire(&prog[k - 1]) < yend - 1) {
        }
      }
      if (k < NW - 1) {
        while (ld_acquire(&prog[k + 1]) < yend - kRing + 1) {
        }
      }
      if (yend - yg == G)
        column_group<RL, NW, CS, G, true>(v, tile, yl, yg, yend, above_ring, ring, bits, tx, ty,
                                          k, lane, first);
      else
        column_group<RL, NW, CS, G, false>(v, tile, yl, yg, yend, above_ring, ring, bits, tx,
                                           ty, k, lane, first);
      if (lane == 31) st_release(&prog[k], yend);
    }
    mbar_arrive(&empty[s]);  // this lane is done with the tile
  }
}

// Warp 0, once every DP warp's progress reached ty: the path's row at each
// column, 32 columns a round.  Lane j gathers the decision bits of the rows
// the path can be at in column ytop - j (index - j .. index) into a window;
// then every lane walks the 32 steps on the windows (a shift, a mask and an
// add a step, no shared-memory load on the chain) and lane j writes its
// column's row.
template <int RL, int NW>
__device__ __forceinline__ void backtrack(const int* prog, const unsigned* bits, int* idx,
                                          int tx, int ty) {
  constexpr int R = RL * NW;
  const int lane = threadIdx.x & 31;
  for (int w = 0; w < NW; ++w) {
    while (ld_acquire(&prog[w]) < ty) {
    }
  }
  int index = tx - 1;  // the path's row at column ytop
  for (int ytop = ty - 1; ytop >= 0; ytop -= 32) {
    const int y = ytop - lane;
    unsigned win = 0;  // bit m: the decision at row index - m, column y
    const unsigned* col_bits = bits + (size_t)max(y, 0) * R;
    if constexpr (RL == 1) {
      // a column's bits are one string over the rows: two words hold rows
      // index - 31 .. index, reversed into the window
      const int lo = index - 31, w = lo >> 5;  // floor, also below row 0
      const unsigned w0 = w >= 0 ? col_bits[w] : 0u, w1 = w + 1 < NW ? col_bits[w + 1] : 0u;
      win = __brev(__funnelshift_r(w0, w1, lo & 31));
    } else {
#pragma unroll
      for (int m = 0; m < 32; ++m) {  // no branch: the 32 loads go out together
        const int x = max(index - m, 0), g = x / RL;
        const unsigned word = col_bits[(g >> 5) * RL + x % RL];
        win |= (index - m >= 0 ? (word >> (g & 31)) & 1u : 0u) << m;
      }
    }
    int off = 0, mine = 0;  // rows stepped down so far; lane j's at step j
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const unsigned wj = __shfl_sync(0xffffffffu, win, j);
      mine = lane == j ? off : mine;
      off += (wj >> off) & 1u;
    }
    if (ytop - lane >= 0) idx[ytop - lane] = index - mine;
    index -= off;
  }
}

template <int RL, int NW>
__global__ void __launch_bounds__(kThreads, 1)
    mas_kernel(const float* __restrict__ value, const float* __restrict__ mask,
               float* __restrict__ path, int Tx, int Ty, int W, int vec) {
  constexpr int R = RL * NW;
  constexpr int CS = col_stride(R);
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);           // [kStages]
  uint64_t* empty = full + kStages;                             // [kStages]
  float* scratch = reinterpret_cast<float*>(empty + kStages);   // [32]
  int* prog = reinterpret_cast<int*>(scratch + 32);             // [kMaxDP]
  float* ring = reinterpret_cast<float*>(prog + kMaxDP);        // [kMaxDP - 1][kRing]
  float* tiles = reinterpret_cast<float*>(smem + kHeader);      // [kStages][W][CS]
  unsigned* bits = reinterpret_cast<unsigned*>(tiles + (size_t)kStages * W * CS);  // [Ty][R]
  int* idx = reinterpret_cast<int*>(bits + (size_t)Ty * R);     // [Ty]

  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t base = (size_t)(blockIdx.x >> 1) * Tx * Ty;
  float* out = path + base;

  if (blockIdx.x & 1) {
    // ---- block 1: zeros over the whole (T_x, T_y) output, 16 bytes a store ----
    const long long n = (long long)Tx * Ty;
    const long long to16 = ((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) / 4;
    const long long head = to16 < n ? to16 : n;  // out is 4-byte aligned
    const long long nvec = (n - head) / 4;
    if (tid < head) out[tid] = 0.f;
    float4* body = reinterpret_cast<float4*>(out + head);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (long long i = tid; i < nvec; i += kThreads) body[i] = z;
    const long long tail = head + nvec * 4 + tid;
    if (tail < n) out[tail] = 0.f;
    cluster_arrive();  // release: the zeros before block 0's path cells
    cluster_wait();
    return;
  }

  cluster_arrive();
  const float* val = value + base;
  const float* msk = mask + base;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kGroup);
      mbar_init(&empty[s], 32 * NW);
    }
    for (int w = 0; w < kMaxDP; ++w) prog[w] = 0;
  }
  // lengths from the mask's first column and first row, as the JAX op (the
  // barriers inside also publish the initialisation above)
  float sx = 0.f, sy = 0.f;
  for (int x = tid; x < Tx; x += kThreads) sx += msk[(size_t)x * Ty];
  for (int y = tid; y < Ty; y += kThreads) sy += msk[y];
  const int tx = min(max((int)block_sum(sx, scratch), 1), Tx);
  const int ty = min(max((int)block_sum(sy, scratch), 1), Ty);
  const int ntiles = (ty + W - 1) / W;

  if (warp < NW) {
    dp_walk<RL, NW, CS>(tiles, full, empty, prog, ring, bits, W, tx, ty, ntiles);
    if (warp == 0) backtrack<RL, NW>(prog, bits, idx, tx, ty);
  } else if (warp >= kFillWarp0) {
    // ---- fill group g: the tiles t = g mod kGroups ----
    const int g = (warp - kFillWarp0) * 32 / kGroup, gt = (tid - kFillWarp0 * 32) % kGroup;
    for (int t = g; t < ntiles; t += kGroups) {
      const int s = t % kStages;
      if (t >= kStages) mbar_wait_sleeping(&empty[s], (t / kStages - 1) & 1);
      float* tile = tiles + (size_t)s * W * CS;
      if (vec)
        fill_tile<RL, CS, true>(tile, val, msk, Ty, W, tx, ty, t * W, gt, kGroups * W);
      else
        fill_tile<RL, CS, false>(tile, val, msk, Ty, W, tx, ty, t * W, gt, kGroups * W);
      mbar_arrive(&full[s]);
    }
  }  // warps NW .. kFillWarp0 - 1 have no part
  __syncthreads();  // idx complete
  cluster_wait();   // block 1's zeros written
  for (int y = tid; y < ty; y += kThreads) {
    const size_t at = (size_t)idx[y] * Ty + y;
    out[at] = msk[at];
  }
}

template <int RL, int NW>
int launch(const float* value, const float* mask, float* path, int B, int Tx, int Ty, int W,
           int smem, int vec, cudaStream_t stream) {
  static bool attr_set = false;  // the largest dynamic shared memory, once per instance
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(mas_kernel<RL, NW>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, mas_kernel<RL, NW>, value, mask, path, Tx, Ty, W, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// R: rows a lane over all DP warps (1, 2, 4, 8, 16 or 32, with 32 R >= T_x);
// W: mel columns a tile (32, 16 or 8); smem: dynamic shared bytes
// (ops/mas.py: _launch_config); vec: 16-byte loads (T_y % 4 == 0, both
// inputs 16-byte aligned).  B clusters of two blocks.
extern "C" int fgt_mas_f32(const void* value, const void* mask, void* path, int B, int Tx,
                           int Ty, int R, int W, int smem, int vec, void* stream) {
  const float* v = static_cast<const float*>(value);
  const float* m = static_cast<const float*>(mask);
  float* p = static_cast<float*>(path);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {  // <rows a lane in one warp, DP warps>
    case 1: return launch<1, 1>(v, m, p, B, Tx, Ty, W, smem, vec, s);
    case 2: return launch<1, 2>(v, m, p, B, Tx, Ty, W, smem, vec, s);
    case 4: return launch<1, 4>(v, m, p, B, Tx, Ty, W, smem, vec, s);
    case 8: return launch<1, 8>(v, m, p, B, Tx, Ty, W, smem, vec, s);
    case 16: return launch<2, 8>(v, m, p, B, Tx, Ty, W, smem, vec, s);
    case 32: return launch<4, 8>(v, m, p, B, Tx, Ty, W, smem, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
