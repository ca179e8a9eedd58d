// Causal / windowed GQA prefill attention with an online softmax, for Hopper.
//
// Replaces the Pallas kernel `flash_attention` (repro/kernels/flash_attention.py):
// scale D^-0.5, mask -1e30, f32 logits and running max / denominator, the
// probabilities rounded to bf16 before the PV product, f32 accumulation, the
// output divided by max(l, 1e-20), and KV tiles that are fully masked (past
// the causal frontier or outside the window) skipped. Query head h reads KV
// head h / G. The exponentials are exp2 of logits pre-scaled by log2(e).
//
// It reads the serving engine's layouts in place through strides: q and o
// [B, S, H, D], k and v [B, S, Hkv, D], the last dimension contiguous.
//
// What bounds it on an H100: at the serve shape (S=512, H=32, Hkv=8, D=128)
// causal attention is 2.1 GFLOP over 10.5 MB of q/k/v/o, a few microseconds
// at peak either way, so the kernel is bound by the latency of its longest
// block's tile loop (8 tiles); at S=4096 it is bound by the tensor cores
// (137 GFLOP). Design:
//   - one block per (64-query tile, head, batch row): one consumer warpgroup
//     (128 threads) and one producer warp, two blocks an SM. Blocks are
//     launched longest first (the q-tile index is the slowest grid axis,
//     reversed), so the causal tail is short.
//   - the producer loads the Q tile once, then K and V tiles of 64 keys into
//     a 2-stage ring, all by TMA (4-D tensor maps over the strided views,
//     128-byte swizzle, boxes 64 columns wide; rows past S arrive as zeros),
//     with a full / empty mbarrier pair per stage.
//   - S = Q K^T by wgmma m64n64k16 from shared memory into f32 registers; the
//     online softmax works on that fragment in registers (a thread holds two
//     rows, so a row max is a 4-lane shuffle; exp2 on the SFU); the
//     per-element mask runs only on the tiles that need it (causal diagonal,
//     window edge, ragged end).
//   - O += P V by wgmma with P converted to bf16 in registers as the A operand
//     and V's [keys, D] tile read as an MN-major B operand, issued in one
//     wgmma group with the next tile's S, so each tile waits on the tensor
//     cores once. No wgmma is in flight while other instructions touch its
//     registers (a pipelined softmax made ptxas serialize or guard them).
//     O (64 x D f32) stays in registers for the whole loop and is written
//     once, divided by l.
//   - D is a template parameter; tiles hold D padded to whole 64-column
//     boxes (TMA zero-fills the columns past D), so any multiple of 16 fits
//     the same layout. D = 64 and 128 are instantiated. (Two consumer
//     warpgroups sharing a deeper ring, 128 rows a block, measured slower.)
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;                     // query rows per block: one wgmma M
constexpr int BKV = 64;                    // keys per tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 128;             // one warpgroup
constexpr int THREADS = CONSUMERS + 32;    // and one producer warp
constexpr int BOX = 64;                    // bf16 columns per TMA box: one 128-byte row
constexpr int BOX_BYTES = 64 * BOX * 2;    // a box of 64 rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int DP = (D + BOX - 1) / BOX * BOX;  // columns held, whole boxes
  static constexpr int NBOX = DP / BOX;
  static constexpr int TILE = NBOX * BOX_BYTES;         // 64 rows x DP (BQ == BKV)
  static constexpr int q = 0;
  static constexpr int kv = TILE;                       // stage s: K at kv + 2s TILE, V after it
  static constexpr int bar = kv + 2 * STAGES * TILE;    // q, full[STAGES], empty[STAGES]
  static constexpr int bytes = bar + 8 * (1 + 2 * STAGES) + 1024;  // + room to align to 1024
};

// 2^x by the SFU (ex2.approx, relative error ~2^-22; -1e30 gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T over DP / 16 steps of 16 columns (32 bytes; 4 per 128-byte box)
template <int DP>
__device__ __forceinline__ void qk_tile(float (&sc)[32], uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss_n64(sc, sw128_desc(sq + off, 16, 1024), sw128_desc(sk + off, 16, 1024), kk > 0);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_attn_kernel(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                      __grid_constant__ const CUtensorMap tv, bf16* __restrict__ o, int S, int G,
                      long long sob, long long sos, long long soh, int causal, int window,
                      float scale_log2) {
  typedef Smem<D> Lay;
  constexpr int DP = Lay::DP, NBOX = Lay::NBOX, TILE = Lay::TILE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t sq = base + Lay::q, bar_q = base + Lay::bar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * STAGES;

  const int qt = gridDim.z - 1 - blockIdx.z;  // longest causal tiles first
  const int q0 = qt * BQ, h = blockIdx.x, b = blockIdx.y, hk = h / G;
  // live KV tiles: up to the causal frontier of the tile's last query, and
  // from the first key its first query can see through the window
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / BKV, t_end = (kv_end + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer warp: one thread issues every copy
    if (threadIdx.x != CONSUMERS) return;
    mbar_expect_tx(bar_q, TILE);
    for (int c = 0; c < NBOX; ++c) tma_load(sq + c * BOX_BYTES, &tq, bar_q, c * BOX, h, q0, b);
    for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
      const int s = it % STAGES;
      mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);  // first round passes
      const uint32_t sk = base + Lay::kv + 2 * s * TILE, sv = sk + TILE;
      mbar_expect_tx(bar_full + 8 * s, 2 * TILE);
      for (int c = 0; c < NBOX; ++c) {
        tma_load(sk + c * BOX_BYTES, &tk, bar_full + 8 * s, c * BOX, hk, t * BKV, b);
        tma_load(sv + c * BOX_BYTES, &tv, bar_full + 8 * s, c * BOX, hk, t * BKV, b);
      }
    }
    return;
  }

  // consumer warpgroup. Fragment of a 64 x N f32 wgmma accumulator: thread (warp w of the
  // warpgroup, lane l) holds rows 16w + l/4 (+8) and columns 8j + 2(l%4) (+1):
  // element 4j + 2i + c is row 16w + l/4 + 8i, column 8j + 2(l%4) + c.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = 16 * warp + lane / 4, col0 = 2 * (lane % 4);
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float m[2] = {KERNEL_NEG_INF, KERNEL_NEG_INF}, l[2] = {0.0f, 0.0f};  // l: this thread's columns

  // Per tile: the softmax, then one wgmma group with O += P V of this tile
  // and S = Q K^T of the next, one wait.
  const int n_tiles = t_end - t_begin;
  float sc[32];
  mbar_wait(bar_q, 0);
  mbar_wait(bar_full, 0);
  fence_regs(sc);
  wgmma_fence();
  qk_tile<DP>(sc, sq, base + Lay::kv);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  for (int it = 0; it < n_tiles; ++it) {
    const int t = t_begin + it, s = it % STAGES, s1 = (it + 1) % STAGES;
    const int k0 = t * BKV;
    const bool edge = k0 + BKV > S || (causal && k0 + BKV - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float x = sc[e] * scale_log2;
      if (edge) {
        const int qi = q0 + row0 + 8 * ((e / 2) % 2), ki = k0 + 8 * (e / 4) + col0 + e % 2;
        const bool ok = ki < S && (!causal || ki <= qi) && (window <= 0 || ki > qi - window);
        x = ok ? x : KERNEL_NEG_INF;
      }
      sc[e] = x;
    }

    // online softmax on the two rows this thread holds
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], sc[e]);
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2_approx(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sc[e] = exp2_approx(sc[e] - mx[(e / 2) % 2]);
      l[(e / 2) % 2] += sc[e];  // the f32 sum, before rounding
    }
    // P as the A operand of four k16 steps: the accumulator's 16 x 16 block
    // of keys 16k..16k+15 is exactly the A fragment of that step
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int k = 0; k < BKV / 16; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[k][r] = pack_bf16(sc[8 * k + 2 * r], sc[8 * k + 2 * r + 1]);
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) acc[e] *= corr[(e / 2) % 2];

    // the next tile's K has to have landed before its S is issued. On the
    // last tile S is computed from a stage no copy is writing and dropped:
    // issuing it unconditionally keeps the wgmma group free of branches.
    if (it + 1 < n_tiles) mbar_wait(bar_full + 8 * s1, ((it + 1) / STAGES) & 1);
    fence_regs(acc);
    fence_regs(sc);
    wgmma_fence();
    // O += P V: V's tile [keys, DP] is MN-major; 16 keys = 2048 bytes
    const uint32_t sv = base + Lay::kv + (2 * s + 1) * TILE;
#pragma unroll
    for (int k = 0; k < BKV / 16; ++k) {
      const uint64_t dv = sw128_desc(sv + k * 16 * 128, BOX_BYTES, 1024);
      if constexpr (DP == 128) wgmma_rs_n128(acc, pa[k], dv, 1);
      else wgmma_rs_n64(acc, pa[k], dv, 1);
    }
    qk_tile<DP>(sc, sq, base + Lay::kv + 2 * s1 * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(sc);
    mbar_arrive(bar_empty + 8 * s);
  }

  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    den[i] = fmaxf(l[i], 1e-20f);
  }
  bf16* ob = o + b * sob + h * soh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + col0;
    if (col >= D) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + row0 + 8 * i;
      if (qi < S)
        *reinterpret_cast<uint32_t*>(ob + qi * sos + col) =
            pack_bf16(acc[4 * j + 2 * i] / den[i], acc[4 * j + 2 * i + 1] / den[i]);
    }
  }
}

// tensor map of a bf16 [B, S, heads, D] view with element strides (sb, ss, sh):
// dims (D, heads, S, B), boxes of 64 columns x 1 head x 64 rows x 1 batch row
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D, long long sb,
                long long ss, long long sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {BOX, 1, BKV, 1};
  return bf16_tensor_map(map, ptr, 4, dims, strides, box);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int Hkv,
           const long long* st, int causal, int window, float scale, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, S, H, D, st[0], st[1], st[2]) ||
      !tensor_map(&tk, k, B, S, Hkv, D, st[3], st[4], st[5]) ||
      !tensor_map(&tv, v, B, S, Hkv, D, st[6], st[7], st[8]))
    return cudaErrorInvalidValue;
  const int bytes = Smem<D>::bytes;
  cudaError_t e =
      cudaFuncSetAttribute(flash_attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_attn_kernel<D><<<grid, THREADS, bytes, s>>>(tq, tk, tv, static_cast<bf16*>(o), S, H / Hkv,
                                                    st[9], st[10], st[11], causal, window,
                                                    scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// strides (elements): q b,s,h; k b,s,h; v b,s,h; o b,s,h — 12 values.
// D must be 64 or 128; every stride and pointer 16-byte aligned.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int H, int Hkv, int D, const long long* strides,
                                   int causal, int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(q, k, v, o, B, S, H, Hkv, strides, causal, window, scale, s);
  if (D == 64) return launch<64>(q, k, v, o, B, S, H, Hkv, strides, causal, window, scale, s);
  return cudaErrorInvalidValue;
}
