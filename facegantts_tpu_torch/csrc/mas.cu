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
// Design: one block per batch item, one thread per text position (T_x <=
// 1024).  The block walks the mel columns in order with the previous column
// in shared memory (one barrier a column).  Columns arrive in tiles of 32:
// each warp reads rows of 32 consecutive frames (coalesced) into a
// transposed shared tile, so the column steps read shared memory only.  The
// backtrack decision of every cell is the forward step's comparison of the
// two predecessors; a warp ballot packs it into one bit, and the whole
// (T_x, T_y) bit matrix stays in shared memory (28 KB at 256 x 872).  One
// thread then walks it back, and the block writes the path row by row.
// Nothing goes back to the host, and of value and mask only the rectangle
// x < tx, y < ty is read.
//
// Bound: memory at the training shapes (value and mask read inside the
// feasibility band above, tx * (ty - tx + 1) cells, since outside it the
// output does not depend on them; the path written whole), and below that
// the T_y dependent column steps, each an add and a max behind a block
// barrier.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;  // mel columns per shared-memory tile
constexpr float kNeg = -1e9f;

// jnp.maximum / torch.maximum: NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__device__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += scratch[w];
  return s;
}

__global__ void mas_kernel(const float* __restrict__ value,
                           const float* __restrict__ mask,
                           float* __restrict__ path, int Tx, int Ty) {
  extern __shared__ float smem[];
  const int nt = blockDim.x, nwarps = nt >> 5, nwords = nwarps;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* tile = smem;                          // [kTile][nt + 1]
  float* col_a = tile + kTile * (nt + 1);      // [nt]
  float* col_b = col_a + nt;                   // [nt]
  float* scratch = col_b + nt;                 // [32]
  unsigned* bits = reinterpret_cast<unsigned*>(scratch + 32);  // [Ty][nwords]
  int* idx = reinterpret_cast<int*>(bits + (size_t)Ty * nwords);  // [Ty]

  const size_t base = (size_t)blockIdx.x * Tx * Ty;
  const float* val = value + base;
  const float* msk = mask + base;

  // lengths from the mask's first column and first row, as the JAX op
  float sx = 0.f, sy = 0.f;
  for (int x = tid; x < Tx; x += nt) sx += msk[(size_t)x * Ty];
  for (int y = tid; y < Ty; y += nt) sy += msk[y];
  const int tx = max((int)block_sum(sx, scratch), 1);
  const int ty = max((int)block_sum(sy, scratch), 1);

  float* prev = col_a;
  float* cur = col_b;
  prev[tid] = kNeg;
  const int x = tid;
  for (int y0 = 0; y0 < ty; y0 += kTile) {
    __syncthreads();  // the previous tile is fully consumed
    const int y = y0 + lane;
    for (int r = warp; r < tx; r += nwarps) {
      if (y < ty) {
        const size_t at = (size_t)r * Ty + y;
        tile[lane * (nt + 1) + r] = msk[at] > 0.f ? val[at] : 0.f;
      }
    }
    __syncthreads();
    const int ylast = min(kTile, ty - y0);
    for (int yl = 0; yl < ylast; ++yl) {
      const int yy = y0 + yl;
      const float pv = prev[x];
      const float pd = x > 0 ? prev[x - 1] : (yy == 0 ? 0.f : kNeg);
      const float same = x == yy ? kNeg : pv;
      const int lo = max(0, tx + yy - ty), hi = min(tx - 1, yy);
      const bool valid = x >= lo && x <= hi;
      cur[x] = valid ? tile[yl * (nt + 1) + x] + max_nan(same, pd) : kNeg;
      const bool down = yy > 0 && x != 0 && (x == yy || pv < pd);
      const unsigned word = __ballot_sync(0xffffffffu, down);
      if (lane == 0) bits[(size_t)yy * nwords + warp] = word;
      __syncthreads();
      float* t = prev;
      prev = cur;
      cur = t;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int index = tx - 1;
    for (int y = ty - 1; y >= 0; --y) {
      idx[y] = index;
      const unsigned w = bits[(size_t)y * nwords + (index >> 5)];
      index -= (w >> (index & 31)) & 1u;
    }
  }
  __syncthreads();
  float* out = path + base;
  for (int r = warp; r < Tx; r += nwarps) {
    for (int y = lane; y < Ty; y += 32) {
      const size_t at = (size_t)r * Ty + y;
      out[at] = (r < tx && y < ty && idx[y] == r) ? msk[at] : 0.f;
    }
  }
}

}  // namespace

extern "C" int fgt_mas_f32(const void* value, const void* mask, void* path,
                           int B, int Tx, int Ty, int threads,
                           long long smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mas_kernel<<<B, threads, static_cast<size_t>(smem_bytes),
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(mask),
      static_cast<float*>(path), Tx, Ty);
  return static_cast<int>(cudaGetLastError());
}
