// Grouped SwiGLU expert FFN straight off the expert-cache slot pools, on
// wgmma + TMA (sm_90a).
//
// Replaces the Pallas kernel `expert_ffn` / `expert_ffn_from_pool`
// (repro/kernels/expert_ffn.py): for each group u with pool slot s = slots[u]
//   out[u] = (silu(x[u] @ w1[s]) * (x[u] @ w3[s])).bf16 @ w2[s]
// with f32 accumulation and bf16 output. The slab of slot s is read in place:
// each pool has a 3-D tensor map (columns, rows, slot) and the slot is the
// outer coordinate of every weight tile, so nothing is gathered.
//
// What bounds it on an H100: bytes, barely. At the serve shapes (U=8
// groups, C=256 rows, d=4096, f=14336) one call reads 2.82 GB of expert
// weights (0.84 ms at 3.35 TB/s) and does 0.72 TFLOP (0.73 ms at 989
// TFLOP/s), so the weights have to stream off HBM once while the tensor
// cores stay near their peak; in practice the tensor cores' sustained rate
// sets the pace. The first design (wmma from a 2-stage cp.async ring)
// reached about 175 TFLOP/s, 21% of the bound.
//
// Design. Two passes, as the Pallas kernel rounds h to bf16 between them:
//   up:   h[u, C, f] = silu(x@w1) * (x@w3): both accumulators of a tile in
//         registers, SiLU and the product in f32, stored as bf16
//   down: out[u, C, d] = h @ w2, stored as bf16
// A block computes a 128-row output tile, 128 columns of both w1 and w3 in
// the up pass and 256 columns of w2 in the down pass (so each h tile
// leaves L2 half as often). One producer warp issues TMA loads of the A
// tile (128 rows x 64 deep, 128-byte swizzle, rows past C arrive as zeros)
// and of two B tiles (64 deep x 128 columns; the weights are [K, N]
// row-major, so B is the MN-major operand, two 64-column boxes each) into
// a ring of 4 stages of 48 KB with a full / empty mbarrier pair per stage.
// Two consumer warpgroups of 64 rows each run wgmma m64n128k16 from shared
// memory into f32 registers and keep one wgmma group in flight: a stage is
// released once the group after it has been issued and the group on it
// has completed. The accumulators are not touched between the first wgmma
// and the epilogue, and the roles branch on a warp-uniform warpgroup
// index, so ptxas serializes nothing. The two row tiles of a group
// (C = 256) that share a weight tile are neighbouring blocks (blockIdx.x),
// so the weights come off HBM once and the second read hits L2. A
// warpgroup whose rows all lie past C still issues its products, on
// zeros: a branch around them makes ptxas serialize the wgmmas. Tiles are
// fixed (128 x 128 per operand, K in order) whatever C is, with no
// split-K, so a row's result is bit-identical whatever the size of its
// group.
#include "hopper.cuh"

namespace {

constexpr int BM = 128;                  // rows per block: two warpgroups of 64
constexpr int BN = 128;                  // output columns per block
constexpr int BK = 64;                   // depth per stage: one 128-byte row of A
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int BOX_BYTES = 64 * 128;      // a weight box: 64 rows x 64 bf16 columns

// shared memory: a ring of stages, each the A tile and two B tiles
struct Lay {
  static constexpr int STAGES = 4;
  static constexpr int A = BM * BK * 2;                   // 16 KB
  static constexpr int B = BK * BN * 2;                   // 16 KB: two boxes along N
  static constexpr int STAGE = A + 2 * B;
  static constexpr int bar = STAGES * STAGE;              // full[STAGES], then empty[STAGES]
  static constexpr int bytes = bar + 16 * STAGES + 1024;  // + room to align to 1024
};

// Up (GLU): out[u] tile (blockIdx.x: 128-row tile, .y: 128-column tile,
// .z: group u) = silu(A @ B0) * (A @ B1), B0 and B1 the same columns of
// two pools. Down: out[u] tile of 256 columns = A @ B0, its second 128
// columns read through tb1 = tb0 at column offset BN. A is [U, C, K] and
// each B pool [cap, K, n_out], all bf16; out is [U, C, n_out].
template <bool GLU>
__global__ void __launch_bounds__(THREADS, 1)
    ffn_kernel(__grid_constant__ const CUtensorMap ta, __grid_constant__ const CUtensorMap tb0,
               __grid_constant__ const CUtensorMap tb1, const int* __restrict__ slots,
               bf16* __restrict__ out, int C, int K, int n_out) {
  typedef Lay L;
  constexpr int STAGES = L::STAGES, NB = 2, COLS = GLU ? BN : 2 * BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t full = base + L::bar, empty = full + 8 * STAGES;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * COLS, u = blockIdx.z;
  const int nk = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, made warp-uniform for the compiler by a shuffle,
  // so the consumers' path is not a divergent one to ptxas
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == CONSUMERS / 128) {
    // producer warp: one thread issues every copy
    if (threadIdx.x != CONSUMERS) return;
    const int slot = slots[u];
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(empty + 8 * s, ((kt / STAGES) & 1) ^ 1);  // the first round passes
      const uint32_t st = base + s * L::STAGE, bar = full + 8 * s;
      mbar_expect_tx(bar, L::STAGE);
      tma_load_3d(st, &ta, bar, kt * BK, m0, u);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int bx = 0; bx < BN / 64; ++bx)
          tma_load_3d(st + L::A + nb * L::B + bx * BOX_BYTES, nb == 0 ? &tb0 : &tb1, bar,
                      n0 + (GLU ? 0 : nb * BN) + 64 * bx, kt * BK, slot);
    }
    return;
  }

  // consumer warpgroup wg: rows m0 + 64 wg .. (past C they are zeros: no
  // branch around the products, which ptxas would serialize)
  float acc[NB][64];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[nb][i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint32_t st = base + s * L::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: K-major, 32 bytes per k16 step; B: MN-major, 16 rows (2048 bytes)
      // per k16 step, the next 64-column box BOX_BYTES on
      const uint64_t da = sw128_desc(st + wg * 64 * 128 + kk * 32, 16, 1024);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_ss_n128_tb(acc[nb], da,
                         sw128_desc(st + L::A + nb * L::B + kk * 16 * 128, BOX_BYTES, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group on the previous stage has completed
    if (kt > 0) mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);

  // accumulator fragment: thread (warp w of the warpgroup, lane l) holds rows
  // 16w + l/4 (+8), columns 8j + 2(l%4) (+1): element 4j + 2i + c
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r0 = m0 + 64 * wg + 16 * warp + lane / 4;
  bf16* ob = out + (size_t)u * C * n_out;
#pragma unroll
  for (int nb = 0; nb < (GLU ? 1 : NB); ++nb)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + nb * BN + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        float v0 = acc[nb][4 * j + 2 * i], v1 = acc[nb][4 * j + 2 * i + 1];
        if constexpr (GLU) {
          v0 = v0 / (1.0f + expf(-v0)) * acc[1][4 * j + 2 * i];
          v1 = v1 / (1.0f + expf(-v1)) * acc[1][4 * j + 2 * i + 1];
        }
        if (row < C && col < n_out)
          *reinterpret_cast<uint32_t*>(ob + (size_t)row * n_out + col) = pack_bf16(v0, v1);
      }
    }
}

// [n, rows, cols] bf16, row-major, as a 3-D tensor map with boxes of 64
// columns x box_rows rows x 1
bool map3(CUtensorMap* map, const void* ptr, int n, int rows, int cols, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return bf16_tensor_map(map, ptr, 3, dims, strides, box);
}

template <bool GLU>
int launch(const CUtensorMap& ta, const CUtensorMap& tb0, const CUtensorMap& tb1,
           const void* slots, void* out, int U, int C, int K, int n_out, cudaStream_t s) {
  static bool attr = false;  // dynamic shared memory above 48 KB, once
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(ffn_kernel<GLU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::bytes);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const int cols = GLU ? BN : 2 * BN;
  const dim3 grid((C + BM - 1) / BM, (n_out + cols - 1) / cols, U);
  ffn_kernel<GLU><<<grid, THREADS, Lay::bytes, s>>>(
      ta, tb0, tb1, static_cast<const int*>(slots), static_cast<bf16*>(out), C, K, n_out);
  return cudaGetLastError();
}

}  // namespace

// x [U,C,d]; w1p/w3p [cap,d,f]; w2p [cap,f,d]; slots [U] int32 (device);
// h [U,C,f] scratch; out [U,C,d]; all contiguous, 16-byte aligned.
// Requires d % 128 == 0 and f % 64 == 0. Two launches on `stream`.
extern "C" int expert_ffn_from_pool(const void* x, const void* w1p, const void* w3p,
                                    const void* w2p, const void* slots, void* h, void* out,
                                    int U, int C, int d, int f, int cap, void* stream) {
  if (d % 128 != 0 || f % 64 != 0 || U < 1 || C < 1) return cudaErrorInvalidValue;
  CUtensorMap tx, t1, t3, th, t2;
  if (!map3(&tx, x, U, C, d, BM) || !map3(&t1, w1p, cap, d, f, BK) ||
      !map3(&t3, w3p, cap, d, f, BK) || !map3(&th, h, U, C, f, BM) ||
      !map3(&t2, w2p, cap, f, d, BK))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = launch<true>(tx, t1, t3, slots, h, U, C, d, f, s);
  if (e != cudaSuccess) return e;
  return launch<false>(th, t2, t2, slots, out, U, C, f, d, s);
}
