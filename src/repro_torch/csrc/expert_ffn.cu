// Grouped SwiGLU expert FFN straight off the expert-cache slot pools.
//
// Replaces the Pallas kernel `expert_ffn` / `expert_ffn_from_pool`
// (repro/kernels/expert_ffn.py): for each group u with pool slot s = slots[u]
//   out[u] = (silu(x[u] @ w1[s]) * (x[u] @ w3[s])).bf16 @ w2[s]
// with f32 accumulation and bf16 output. The slab of slot s is found by a
// pointer offset s*d*f into the [capacity, ...] pools: no gather copy.
//
// What bounds it on an H100: at the serve shapes (U=8 groups, C=256 rows,
// d=4096, f=14336) one launch reads 2.8 GB of expert weights and does 0.72
// TFLOP, so it sits near the ridge (0.84 ms of bytes, 0.73 ms of math).
// The design reads every weight tile from device memory once per 128-row
// tile: C <= 128 reads the slabs once, and for C = 256 the two row tiles of
// one weight tile are neighbouring blocks (blockIdx.x), so the second read
// mostly hits L2. Math runs on the tensor cores through wmma (bf16 16x16x16,
// f32 accumulators) from a 2-stage cp.async shared-memory pipeline.
//
// Two passes, as a first design that is right:
//   up:   h[u, C, f] = silu(x@w1) * (x@w3), f32 in registers, stored bf16
//         (the Pallas kernel rounds h to bf16 before the down projection too)
//   down: out[u, C, d] = h @ w2, f32 accumulation, stored bf16
// Tiles are fixed (128 rows) whatever C is, so a row's result never depends
// on the size of its group.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128;      // rows per block tile
constexpr int BK = 32;       // depth per pipeline stage
constexpr int THREADS = 256; // 8 warps: 4 along M x 2 along N
constexpr int PAD = 8;       // shared-memory row padding (bf16 elements)

template <int NB, int BN>
struct __align__(128) Smem {
  bf16 a[2][BM][BK + PAD];
  bf16 b[2][NB][BK][BN + PAD];
  float stage[THREADS / 32][16][16];  // per-warp epilogue staging
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// acc[nb][i][j] += A[BM x K] @ B_nb[K x BN] for this warp's 32 x BN/2 tile.
// A rows >= m_valid read as zeros. K % BK == 0; B rows have stride ldb.
template <int NB, int BN>
__device__ __forceinline__ void mainloop(const bf16* A, int lda, int m_valid, const bf16* B0,
                                         const bf16* B1, int ldb, int K, Smem<NB, BN>& sm,
                                         Acc (&acc)[NB][2][BN / 32]) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, wm = warp % 4, wn = warp / 4;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) wmma::fill_fragment(acc[nb][i][j], 0.0f);

  auto load_stage = [&](int st, int k0) {
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const bool v = r < m_valid;
      cp_async16(&sm.a[st][r][col], A + (size_t)(v ? r : 0) * lda + k0 + col, v);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const bf16* B = nb == 0 ? B0 : B1;
      for (int c = tid; c < BK * BN / 8; c += THREADS) {
        const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
        cp_async16(&sm.b[st][nb][r][col], B + (size_t)(k0 + r) * ldb + col, true);
      }
    }
    cp_async_commit();
  };

  const int nk = K / BK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &sm.a[st][wm * 32 + i * 16][kk], BK + PAD);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < BN / 32; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, &sm.b[st][nb][kk][wn * (BN / 2) + j * 16], BN + PAD);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[nb][i][j], af[i], bfr, acc[nb][i][j]);
        }
    }
    __syncthreads();
  }
}

// Write one 16x16 f32 fragment as bf16 rows [row0, row0+16) of `out`
// (row stride ldo), skipping rows >= m_valid. Each lane writes 8 values.
__device__ __forceinline__ void store_bf16(float (&stg)[16][16], const Acc& frag, bf16* out,
                                           int ldo, int row0, int m_valid) {
  const int lane = threadIdx.x % 32;
  wmma::store_matrix_sync(&stg[0][0], frag, 16, wmma::mem_row_major);
  __syncwarp();
  const int r = lane / 2, c = (lane % 2) * 8;
  if (row0 + r < m_valid) {
    __align__(16) bf16 vals[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) vals[t] = __float2bfloat16(stg[r][c + t]);
    *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * ldo + c) =
        *reinterpret_cast<const uint4*>(vals);
  }
  __syncwarp();
}

// up pass: grid (ceil(C/BM), f/64, U)
__global__ void __launch_bounds__(THREADS)
    ffn_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1p,
                  const bf16* __restrict__ w3p, const int* __restrict__ slots,
                  bf16* __restrict__ h, int C, int d, int f) {
  constexpr int BN = 64;
  __shared__ __align__(128) unsigned char raw[sizeof(Smem<2, BN>)];
  Smem<2, BN>& sm = *reinterpret_cast<Smem<2, BN>*>(raw);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, u = blockIdx.z;
  const int m_valid = min(BM, C - m0);
  const size_t slab = (size_t)slots[u] * d * f;
  const bf16* A = x + ((size_t)u * C + m0) * d;
  Acc acc[2][2][BN / 32];
  mainloop<2, BN>(A, d, m_valid, w1p + slab + n0, w3p + slab + n0, f, d, sm, acc);

  const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;
  bf16* out = h + ((size_t)u * C + m0) * f + n0 + wn * (BN / 2);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      Acc& g = acc[0][i][j];
      const Acc& up = acc[1][i][j];
      // same fragment type => same element mapping, so this is elementwise
#pragma unroll
      for (int t = 0; t < g.num_elements; ++t) {
        const float a = g.x[t];
        g.x[t] = a / (1.0f + expf(-a)) * up.x[t];
      }
      store_bf16(sm.stage[warp], g, out + j * 16, f, wm * 32 + i * 16, m_valid);
    }
}

// down pass: grid (ceil(C/BM), d/128, U)
__global__ void __launch_bounds__(THREADS)
    ffn_down_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w2p,
                    const int* __restrict__ slots, bf16* __restrict__ y, int C, int d, int f) {
  constexpr int BN = 128;
  __shared__ __align__(128) unsigned char raw[sizeof(Smem<1, BN>)];
  Smem<1, BN>& sm = *reinterpret_cast<Smem<1, BN>*>(raw);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, u = blockIdx.z;
  const int m_valid = min(BM, C - m0);
  const bf16* B = w2p + (size_t)slots[u] * f * d + n0;
  const bf16* A = h + ((size_t)u * C + m0) * f;
  Acc acc[1][2][BN / 32];
  mainloop<1, BN>(A, f, m_valid, B, B, d, f, sm, acc);

  const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;
  bf16* out = y + ((size_t)u * C + m0) * d + n0 + wn * (BN / 2);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < BN / 32; ++j)
      store_bf16(sm.stage[warp], acc[0][i][j], out + j * 16, d, wm * 32 + i * 16, m_valid);
}

}  // namespace

// x [U,C,d]; w1p/w3p [cap,d,f]; w2p [cap,f,d]; slots [U] int32 (device);
// h [U,C,f] scratch; out [U,C,d]. Requires d % 128 == 0 and f % 64 == 0.
extern "C" int expert_ffn_from_pool(const void* x, const void* w1p, const void* w3p,
                                    const void* w2p, const void* slots, void* h, void* out,
                                    int U, int C, int d, int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mt = (C + BM - 1) / BM;
  ffn_up_kernel<<<dim3(mt, f / 64, U), THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1p), static_cast<const bf16*>(w3p),
      static_cast<const int*>(slots), static_cast<bf16*>(h), C, d, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ffn_down_kernel<<<dim3(mt, d / 128, U), THREADS, 0, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2p), static_cast<const int*>(slots),
      static_cast<bf16*>(out), C, d, f);
  return cudaGetLastError();
}
