// Causal / windowed / cross GQA prefill attention with an online softmax, for Hopper.
//
// Replaces the Pallas kernel `flash_attention` (repro/kernels/flash_attention.py):
// scale D^-0.5, mask -1e30, f32 logits and running max / denominator, the
// probabilities rounded to bf16 before the PV product, f32 accumulation, the
// output divided by max(l, 1e-20), and KV tiles that are fully masked (past
// the causal frontier or outside the window) skipped. Query head h reads KV
// head h / G. The exponentials are exp2 of the logits scaled by
// D^-0.5 log2(e), with one deviation from the Pallas kernel's arithmetic:
// p = exp2(fma(s, c, -m)) with c = D^-0.5 log2(e), so the scaled logit s c
// is not rounded before m is subtracted (Pallas: exp2(round(s c) - m)).
// m is unchanged (round(max s * c) = max round(s c), rounding is monotonic
// and c > 0); p differs by under one f32 ulp of the scaled logit, far
// below its rounding to bf16, and every entry and tile shares the same
// arithmetic, so the bit-equality invariants between entries hold. The
// FMA takes one multiply off each element of the softmax.
//
// It reads the serving engine's layouts in place through strides: q and o
// [B, S, H, D], k and v [B, S, Hkv, D], the last dimension contiguous.
//
// What bounds it on an H100: at S=4096 (H=32, D=128) causal attention is
// 137 GFLOP against 34 MB of q/k/v/o, so the tensor cores bound it (0.139
// ms at 989 TFLOP/s); the cross shapes likewise. At the serve shape (S=512)
// it is 2.1 GFLOP over 10.5 MB, a few microseconds either way, so the
// latency of the longest block's tile loop bounds it. Design, after
// FlashAttention-3 (Shah et al., 2024) on the port's own wgmma / TMA helpers:
//   - up to D = 128, one block per (128-query tile, head, batch row): two
//     consumer warpgroups of 64 rows each (one wgmma M) and one producer
//     warpgroup, one block an SM. Blocks are launched longest first (the
//     q-tile index is the slowest grid axis, reversed), so the causal tail
//     is short. The producer warpgroup drops to 24 registers a thread
//     (setmaxnreg) and the consumers rise to 240.
//   - the wgmma operands of a consumer's turn (O, S and P) must fit the
//     registers the block launches with, 168 a thread for 384 threads:
//     ptxas allocates them below that count whatever setmaxnreg raises the
//     consumers to. With BKV = 128 at D = 112 / 128 they are 152 / 160,
//     and ptxas spilled 144-276 bytes and serialized every wgmma (advisory
//     C7512, "insufficient register resources"), alike at setmaxnreg 240
//     and 256, and under __launch_bounds__(288, 1) with a producer warp
//     (which also stopped at 168: the block takes whole warpgroups' worth
//     of registers, and launching 288 threads at 224 failed for lack of
//     resources). So BKV is 128 keys at D = 64 (O 32 + S 64 + P 32) and
//     96 at D = 112 / 128 (O 64 + S 48 + P 24); S = Q K^T is one wgmma
//     m64nBKVk16 group of D / 16 k-steps from shared memory. 96 keys
//     measured 8-11% faster than 64 at S = 4096 and the cross shape (an
//     m64n64k16 step reads as many shared-memory bytes a cycle as shared
//     memory serves, and each step's fixed costs cover fewer keys).
//   - at D = 256 (gemma3-1b) O alone is 128 registers, so the block is one
//     consumer warpgroup of 64 rows and a producer warp (160 threads, up
//     to 255 registers a thread), without ping-pong, over 64-key tiles.
//   - every wgmma descriptor is built from an address laundered through an
//     opaque move in the step that uses it, so the compiler does not hoist
//     the descriptors of every k-step and ring stage out of the loop.
//   - the producer's one thread loads the Q tile once, then K and V tiles
//     of BKV keys into a ring of STAGES stages, all by TMA (4-D tensor maps
//     over the strided views, 128-byte swizzle, boxes 64 columns wide; rows
//     past S arrive as zeros). K and V have a full / empty mbarrier pair
//     each, so Q K^T starts before V lands; K is released once its scores
//     are masked (a chunk's slot positions ride with K), V once its P V is
//     done. Both warpgroups read every tile the producer brings in once;
//     the KV range is the block's, not the warpgroup's, so both run the
//     same number of steps.
//   - O += P V by wgmma with P converted to bf16 in registers as the A
//     operand and V's [keys, D] tile read as an MN-major B operand.
//   - ping-pong (two warpgroups): two named barriers (ids 1 and 2, 256
//     threads) pass the turn to issue wgmma between the warpgroups, so one
//     warpgroup's products (its tile's Q K^T and the previous tile's P V)
//     run on the tensor cores while the other computes its softmax.
//   - within a warpgroup the softmax of tile j runs while P V of tile j - 1
//     is still in flight (FlashAttention-3's two-stage pipeline): Q K_j^T
//     and P_{j-1} V_{j-1} are committed as two groups, wgmma_wait<1>
//     retires Q K_j^T, the softmax touches only S's registers, and
//     wgmma_wait<0> retires P V before O is rescaled and P_j packed. This
//     order holds one S buffer: issuing Q K_{j+1}^T before the softmax of
//     S_j instead would need a second one, past the register count above.
//     No register of an in-flight wgmma is touched, so ptxas serializes
//     nothing (the build record holds every instantiation's advisories).
//   - the per-element mask runs only on the tiles that need it for the
//     warpgroup's own rows (causal diagonal, window edge, ragged end).
//   - the softmax takes each row's max and sum over four partials a thread
//     (dependent chains of NS / 8 + 2, not NS / 2: one warp of each
//     warpgroup on an SM sub-partition leaves little to hide a chain's
//     latency behind), folds the scale into the exponent's FMA, and skips
//     O's rescale in a warp none of whose rows' max moved (corr = 1).
//   - the epilogue divides O by l in registers, stages it as bf16 in the
//     warpgroup's own 64 rows of the Q tile (in the TMA box layout; its
//     Q K^T reads are done by then) and writes it by TMA store into the
//     strided [B, S, H, D] view: rows past S and columns past D are never
//     written. With an lse pointer, the thread of lane % 4 == 0 that holds
//     a row also writes its log-sum-exp, m ln 2 + ln l (natural log of the
//     scaled logits' exp-sum, what a flash backward recomputes its tiles
//     from), to lse[b, h, row]; o is computed and written as without it.
//   - D is a template parameter; tiles hold D padded to whole 64-column
//     boxes (TMA zero-fills the columns past D). D = 64, 112, 128 and 256
//     are instantiated. At D = 112 (Zamba2-7B) the tensor maps' rows are
//     112 wide (224 bytes); Q K^T runs 7 k-steps and P V is m64n112, so
//     no product touches the zero columns 112-127. At D = 256 O += P V is
//     two m64n128 products a step, one per half of O's columns.
// A row's sums depend only on BKV and on key tiles aligned at key 0 and
// walked in ascending order: a tile fully masked for a row adds exact
// zeros to it (its correction is exp2(0) = 1), or is reset exactly by the
// first live tile (correction exp2(-1e30 - m) = 0). So BQ, the warpgroups
// and the grid change no bit, and BKV is one constant for every entry at
// a given D.
//
// Cross attention (`flash_attention_fwd` with Sk != Sq and causal = 0): Sq
// queries over Sk memory keys, every key valid; the last key tile is
// masked past Sk (1601 patch keys of Llama-3.2-Vision are 16 tiles of 96
// and 65 keys).
//
// Chunked prefill (`flash_attention_chunk_fwd`, the same device code with
// CHUNK = true): C queries at absolute positions q_start .. q_start + C - 1
// attend over a request's KV row of W slots, q and o [B, C, H, D], k and v
// [B, W, Hkv, D] (a view of the engine's slot pool), slot_pos [B, W] int32.
// Slot j is valid for the query at position p when 0 <= slot_pos[j] <= p
// and, for window > 0, slot_pos[j] > p - window: the reference
// `attention(q_pos, k_pos=slot_pos)`'s valid-key set. Q tiles are BQ rows
// from q_start (rows past C are neither computed into o nor written); key
// tiles stay aligned at slot 0 and are walked in ascending order over
// [kv_begin, min(W, q_start + last row + 1)). That range is complete
// because the caller never wraps the ring in prefill: slot j holds
// position j or -1, and q_start + C <= W, so no slot past the chunk's last
// position can be valid, and a window's first valid slot is
// p - window + 1. Each tile's BKV slot positions arrive by TMA with its K
// (int32, OOB slots as zeros, masked by index), and every tile is masked
// by them, so -1 holes anywhere in the range stay exact; with slot_pos =
// arange the chunk's rows equal rows q_start.. of the monolithic kernel
// bit for bit (the same tiles in the same order, the extra ones masked).
// Grid (H, B, ceil(C / BQ)). A chunk of C <= 64 (like S <= 64, or a
// ragged last tile of at most 64 rows) leaves the second warpgroup without
// rows: it releases every tile and issues no product, and the first runs
// alone, without ping-pong.
#include "hopper.cuh"

namespace {

constexpr int WG = 128;                    // threads of a warpgroup
// setmaxnreg.inc takes registers only from what the block's own warps
// release: a block of three warpgroups launches at 168 a thread (65,536 /
// 384, in steps of 8), 64,512 in all, and 128 x 24 + 256 x 240 = 64,512
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int BOX = 64;                    // bf16 columns per TMA box: one 128-byte row
constexpr int ROW_BYTES = BOX * 2;
constexpr int OUT_ROWS = 64;               // a warpgroup's rows, one TMA store box
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int DP = (D + BOX - 1) / BOX * BOX;  // columns held, whole boxes
  static constexpr int NBOX = DP / BOX;
  static constexpr int WGS = DP > 128 ? 1 : 2;          // consumer warpgroups
  static constexpr int BQ = 64 * WGS;                   // query rows per block
  // and a producer warpgroup (its registers handed to the consumers), or
  // at D = 256 a producer warp
  static constexpr int THREADS = WGS * WG + (WGS == 2 ? WG : 32);
  static constexpr int BKV = DP == 64 ? 128 : DP == 128 ? 96 : 64;  // keys per tile
  static constexpr int NS = BKV / 2;                    // S: f32 a thread
  static constexpr int NO = D / 2;                      // O: f32 a thread
  static constexpr int KSTEPS = D / 16;                 // Q K^T k-steps (7 at D = 112)
  static constexpr int PSTEPS = BKV / 16;               // P V k-steps
  static constexpr int STAGES = DP == 64 ? 4 : DP == 128 ? 3 : 2;  // ring depth: what fits
  static constexpr int QBOX = BQ * ROW_BYTES;           // one box of the Q tile
  static constexpr int KBOX = BKV * ROW_BYTES;          // one box of a K or V tile
  static constexpr int KVTILE = NBOX * KBOX;
  static constexpr int SP_BYTES = BKV * 4;              // a tile's int32 slot positions
  static constexpr int q = 0;
  static constexpr int kv = NBOX * QBOX;                // stage s: K at kv + 2s KVTILE, V after it
  static constexpr int sp = kv + 2 * STAGES * KVTILE;   // stage s: slot positions (chunk)
  static constexpr int bar = sp + STAGES * SP_BYTES;    // q, full_k, full_v, empty_k, empty_v
  static constexpr int bytes = bar + 8 * (1 + 4 * STAGES) + 1024;  // + room to align to 1024
  static_assert(bytes <= 232448, "shared memory");
};

// 2^x by the SFU (ex2.approx, relative error ~2^-22; -1e30 gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x through a move the compiler cannot see into: what is computed from it
// stays in the step that computes it
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

// S = Q K^T over D / 16 k-steps of 16 columns (32 bytes; 4 per 128-byte
// box). A descriptor's low 14 bits are the address / 16, so a step's
// descriptor is the tile's plus its offset / 16 (shared memory < 256 KB).
template <int D>
__device__ __forceinline__ void qk_tile(float (&sc)[Cfg<D>::NS], uint32_t sq, uint32_t sk) {
  typedef Cfg<D> C;
  const uint64_t dq = sw128_desc(opaque(sq), 16, 1024), dk = sw128_desc(opaque(sk), 16, 1024);
#pragma unroll
  for (int kk = 0; kk < C::KSTEPS; ++kk) {
    const uint64_t da = dq + ((kk / 4) * C::QBOX + (kk % 4) * 32) / 16;
    const uint64_t db = dk + ((kk / 4) * C::KBOX + (kk % 4) * 32) / 16;
    if constexpr (C::BKV == 128)
      wgmma_ss_n128<0>(sc, da, db, kk > 0);
    else if constexpr (C::BKV == 96)
      wgmma_ss_n96(sc, da, db, kk > 0);
    else
      wgmma_ss_n64(sc, da, db, kk > 0);
  }
}

// O += P V: V's tile [keys, DP] is MN-major, the next 64-column box KBOX
// bytes on (the descriptor's lbo); 16 keys = 2048 bytes
template <int D>
__device__ __forceinline__ void pv_tile(float (&acc)[Cfg<D>::NO],
                                        const uint32_t (&pa)[Cfg<D>::PSTEPS][4], uint32_t sv) {
  typedef Cfg<D> C;
  const uint64_t d0 = sw128_desc(opaque(sv), C::KBOX, 1024);
#pragma unroll
  for (int k = 0; k < C::PSTEPS; ++k) {
    const uint64_t dv = d0 + k * 16 * ROW_BYTES / 16;
    if constexpr (D == 256) {
      // columns 0-127 from boxes 0-1, 128-255 from boxes 2-3: element
      // 64 + 4j + ... of acc is the second product's element 4j + ...
      const uint64_t dv2 = d0 + (2 * C::KBOX + k * 16 * ROW_BYTES) / 16;
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(acc), pa[k], dv, 1);
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(acc + 64), pa[k], dv2, 1);
    } else if constexpr (D == 128) {
      wgmma_rs_n128(acc, pa[k], dv, 1);
    } else if constexpr (D == 112) {
      wgmma_rs_n112(acc, pa[k], dv, 1);
    } else {
      wgmma_rs_n64(acc, pa[k], dv, 1);
    }
  }
}

// the max (MAX) or f32 sum of each of the two rows of a fragment (row r
// holds elements 4j + 2r + c) over four partials a row: the dependent
// chain is NS / 8 + 2 deep, not NS / 2 (one warp of each warpgroup on an
// SM sub-partition leaves little to hide a chain's latency behind)
template <bool MAX, int NS>
__device__ __forceinline__ void row_reduce(const float (&x)[NS], float (&out)[2]) {
  float a[2][4];
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    const int r = (e / 2) % 2, k = ((e / 4) % 2) * 2 + e % 2;
    if (e < 8)
      a[r][k] = x[e];
    else
      a[r][k] = MAX ? fmaxf(a[r][k], x[e]) : a[r][k] + x[e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    out[r] = MAX ? fmaxf(fmaxf(a[r][0], a[r][1]), fmaxf(a[r][2], a[r][3]))
                 : (a[r][0] + a[r][1]) + (a[r][2] + a[r][3]);
}

// Mask a tile's raw scores, keys from k0, for the two rows this thread
// holds (positions q and q + 8): a masked key's score becomes -inf (read
// back as the mask by softmax_tile). CHUNK: by the slot positions sp2 of
// the tile's ring stage (the pair of columns 8j + col0 (+1) is element
// 4j + lane % 4 of int2s).
template <int NS, bool CHUNK>
__device__ __forceinline__ void mask_tile(float (&sc)[NS], const int2* sp2, int k0, int q, int Sk,
                                          int causal, int window, int lane) {
  const int col0 = 2 * (lane % 4);
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    const int qi = q + 8 * ((e / 2) % 2), ki = k0 + 8 * (e / 4) + col0 + e % 2;
    bool ok;
    if constexpr (CHUNK) {
      const int2 kp = sp2[4 * (e / 4) + lane % 4];
      const int pk = e % 2 ? kp.y : kp.x;
      ok = ki < Sk && pk >= 0 && pk <= qi && (window <= 0 || pk > qi - window);
    } else {
      ok = ki < Sk && (!causal || ki <= qi) && (window <= 0 || ki > qi - window);
    }
    sc[e] = ok ? sc[e] : -INFINITY;
  }
}

// The online softmax of a tile (keys from k0) on the two rows this thread
// holds (positions q, q + 8; the warpgroup's first row at qlo), in the
// Pallas kernel's arithmetic: a logit is the score times D^-0.5 log2(e),
// a masked key's is -1e30, m is raised to the row max of the tile's
// logits, p = exp2(logit - m) in place in sc, l (this thread's columns)
// is rescaled and the tile's f32 p summed onto it, and corr is the factor
// O still has to take. The row max is taken on the raw scores and scaled
// (rounding is monotonic, so it is the max of the scaled ones; a masked
// key's -1e30 never raises m, which starts there), and the scale is folded
// into the exponent's FMA. Only a tile that holds a masked key for the
// warpgroup's rows (every chunk tile; the causal diagonal, a window's
// edge, the ragged end) is masked, and there a masked key's p is
// exp2(-1e30 - m): 1 while the row has met no valid key (those sums are
// reset by the first live tile's corr of 0), else 0. Every valid key goes
// through the same operations in every tile and entry, so the chunk form's
// rows stay bit-equal to the monolithic kernel's.
template <int NS, int BKV, bool CHUNK>
__device__ __forceinline__ void softmax_tile(float (&sc)[NS], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const int2* sp2, int k0, int q,
                                             int qlo, int Sk, int causal, int window,
                                             float scale_log2, int lane) {
  const bool edge = CHUNK || k0 + BKV > Sk || (causal && k0 + BKV - 1 > qlo) ||
                    (window > 0 && k0 <= qlo + 63 - window);
  if (edge) mask_tile<NS, CHUNK>(sc, sp2, k0, q, Sk, causal, window, lane);
  float mx[2], sum[2];
  row_reduce<true>(sc, mx);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    mx[i] = fmaxf(m[i], mx[i] * scale_log2);
    corr[i] = exp2_approx(m[i] - mx[i]);
    m[i] = mx[i];
  }
  if (edge) {
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const float mi = mx[(e / 2) % 2];
      sc[e] = exp2_approx(sc[e] == -INFINITY ? KERNEL_NEG_INF - mi : fmaf(sc[e], scale_log2, -mi));
    }
  } else {
#pragma unroll
    for (int e = 0; e < NS; ++e) sc[e] = exp2_approx(fmaf(sc[e], scale_log2, -mx[(e / 2) % 2]));
  }
  row_reduce<false>(sc, sum);  // the f32 sum, before rounding
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
}

// P as the A operand of NS / 8 k16 steps: the accumulator's 16 x 16 block
// of keys 16k..16k+15 is exactly the A fragment of that step
template <int NS>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[NS / 8][4], const float (&sc)[NS]) {
#pragma unroll
  for (int k = 0; k < NS / 8; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[k][r] = pack_bf16(sc[8 * k + 2 * r], sc[8 * k + 2 * r + 1]);
}

// Sq query rows against Sk keys (Sq == Sk but in CHUNK mode and cross
// attention, which is not causal); in CHUNK mode query row r sits at
// position q_start + r, and the keys are masked by the slot positions of
// tensor map tsp (causal is implied). o is written through tensor map to.
template <int D, bool CHUNK>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
    flash_attn_kernel(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                      __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap tsp,
                      __grid_constant__ const CUtensorMap to, float* __restrict__ lse, int Sq,
                      int Sk, int q_start, int G, int causal, int window, float scale_log2) {
  typedef Cfg<D> C;
  constexpr int BQ = C::BQ, BKV = C::BKV, NS = C::NS, NO = C::NO, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sq = base + C::q, bar_q = base + C::bar;
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * STAGES;
  const uint32_t empty_k = full_v + 8 * STAGES, empty_v = empty_k + 8 * STAGES;

  const int qt = gridDim.z - 1 - blockIdx.z;  // longest causal tiles first
  const int q0 = qt * BQ, h = blockIdx.x, b = blockIdx.y, hk = h / G;
  const int p0 = CHUNK ? q_start + q0 : q0;   // position of the tile's first query
  // live KV tiles, one range for the block: up to the causal frontier of
  // its last query, and from the first key its first query can see
  // through the window
  const int kv_end = CHUNK ? min(Sk, p0 + min(BQ, Sq - q0)) : causal ? min(Sk, q0 + BQ) : Sk;
  const int kv_begin = window > 0 ? max(0, p0 - window + 1) : 0;
  const int t_begin = kv_begin / BKV, t_end = (kv_end + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, C::WGS * 4);  // lane 0 of each consumer warp
      mbar_init(empty_v + 8 * s, C::WGS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);  // warp-uniform
  if (wg == C::WGS) {
    // producer: one thread issues every copy
    if constexpr (C::WGS == 2) setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == C::WGS * WG) {
      mbar_expect_tx(bar_q, C::NBOX * C::QBOX);
      for (int c = 0; c < C::NBOX; ++c) tma_load(sq + c * C::QBOX, &tq, bar_q, c * BOX, h, q0, b);
      for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
        const int s = it % STAGES;
        const uint32_t parity = ((it / STAGES) & 1) ^ 1;  // the first round passes
        const uint32_t sk = base + C::kv + 2 * s * C::KVTILE, sv = sk + C::KVTILE;
        mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, C::KVTILE + (CHUNK ? C::SP_BYTES : 0));
        for (int c = 0; c < C::NBOX; ++c)
          tma_load(sk + c * C::KBOX, &tk, full_k + 8 * s, c * BOX, hk, t * BKV, b);
        if (CHUNK) tma_load_2d(base + C::sp + s * C::SP_BYTES, &tsp, full_k + 8 * s, t * BKV, b);
        mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, C::KVTILE);
        for (int c = 0; c < C::NBOX; ++c)
          tma_load(sv + c * C::KBOX, &tv, full_v + 8 * s, c * BOX, hk, t * BKV, b);
      }
    }
  } else {
    if constexpr (C::WGS == 2) setmaxnreg_inc<CONSUMER_REGS>();
    // consumer warpgroup wg owns rows r0 .. r0 + 63 of the block's BQ.
    // Fragment of a 64 x N f32 wgmma accumulator: thread (warp w of the
    // warpgroup, lane l) holds rows 16w + l/4 (+8) and columns 8j + 2(l%4)
    // (+1): element 4j + 2i + c is row 16w + l/4 + 8i, column 8j + 2(l%4) + c.
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int r0 = 64 * wg, row0 = 16 * warp + lane / 4, col0 = 2 * (lane % 4);
    const int turn = 1 + wg, other = 2 - wg;  // named barriers: whose turn to issue
    const uint32_t sqw = sq + r0 * ROW_BYTES;  // this warpgroup's Q rows in each box
    const int qlo = q0 + r0;                   // its first query row
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
    float sc[NS];
    uint32_t pa[C::PSTEPS][4];
    float m[2] = {KERNEL_NEG_INF, KERNEL_NEG_INF}, l[2] = {0.0f, 0.0f};  // l: this thread's columns
    float corr[2];

    // stage s's slot positions (chunk), and the position of this thread's first row
    const int2* sp_base = reinterpret_cast<const int2*>(smem_raw + (base - raw) + C::sp);
    const int qrow = p0 + r0 + row0;
    auto k_stage = [&](int it) { return base + C::kv + 2 * (it % STAGES) * C::KVTILE; };
    auto phase = [](int it) { return static_cast<uint32_t>((it / STAGES) & 1); };

    // the turn to issue wgmma passes between two warpgroups (ping-pong)
    // when both hold queries; the first takes the first turn
    const bool ping_pong = C::WGS == 2 && Sq - q0 > 64;
    auto take_turn = [&]() {
      if (ping_pong) named_sync<2 * WG>(turn);
    };
    auto pass_turn = [&]() {
      if (ping_pong) named_arrive<2 * WG>(other);
    };
    if (ping_pong && wg == 1) named_arrive<2 * WG>(1);
    const int n_tiles = t_end - t_begin;
    if (qlo >= Sq) {
      // no row of this warpgroup is a query (S <= 64, a ragged last tile,
      // a short chunk): it is the second one, and it releases every tile
      // as the first expects, computing nothing; the first runs without
      // ping-pong. The full waits keep its releases in the ring's order.
      for (int it = 0; it <= n_tiles; ++it) {
        if (it < n_tiles) mbar_wait(full_k + 8 * (it % STAGES), phase(it));
        if (it > 0) mbar_wait(full_v + 8 * ((it - 1) % STAGES), phase(it - 1));
        if (lane == 0 && it < n_tiles) mbar_arrive(empty_k + 8 * (it % STAGES));
        if (lane == 0 && it > 0) mbar_arrive(empty_v + 8 * ((it - 1) % STAGES));
      }
      return;
    }
    mbar_wait(bar_q, 0);
    mbar_wait(full_k, 0);
    take_turn();
    fence_regs(sc);
    wgmma_fence();
    qk_tile<D>(sc, sqw, k_stage(0));
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile<NS, BKV, CHUNK>(sc, m, l, corr, sp_base, t_begin * BKV, qrow, qlo, Sk, causal,
                                 window, scale_log2, lane);  // O is zero: no correction
    if (lane == 0) mbar_arrive(empty_k);  // after the mask read its slot positions
    pack_p(pa, sc);

    // Per tile j: Q K_j^T and P_{j-1} V_{j-1} in one turn, two groups; the
    // softmax of S_j while P V is in flight; then O rescaled and P_j packed
    for (int it = 1; it < n_tiles; ++it) {
      const int s = it % STAGES, sp = (it - 1) % STAGES;
      mbar_wait(full_k + 8 * s, phase(it));
      mbar_wait(full_v + 8 * sp, phase(it - 1));
      take_turn();
      fence_regs(acc);
      fence_regs(sc);
      fence_frags(pa);
      wgmma_fence();
      qk_tile<D>(sc, sqw, k_stage(it));
      wgmma_commit();
      pv_tile<D>(acc, pa, k_stage(it - 1) + C::KVTILE);
      wgmma_commit();
      pass_turn();
      wgmma_wait<1>();
      fence_regs(sc);
      softmax_tile<NS, BKV, CHUNK>(sc, m, l, corr, sp_base + s * (C::SP_BYTES / 8),
                                   (t_begin + it) * BKV, qrow, qlo, Sk, causal, window,
                                   scale_log2, lane);
      if (lane == 0) mbar_arrive(empty_k + 8 * s);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frags(pa);
      fence_regs(sc);
      if (lane == 0) mbar_arrive(empty_v + 8 * sp);
      // a row whose max did not move has corr = exp2(0) = 1 exactly: a
      // warp none of whose rows moved skips the product, bit for bit
      if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
        for (int e = 0; e < NO; ++e) acc[e] *= corr[(e / 2) % 2];
      }
      pack_p(pa, sc);
    }

    // the last tile's P V; the second warpgroup's last turn passes to no one
    const int last = n_tiles - 1;
    mbar_wait(full_v + 8 * (last % STAGES), phase(last));
    take_turn();
    fence_regs(acc);
    fence_frags(pa);
    wgmma_fence();
    pv_tile<D>(acc, pa, k_stage(last) + C::KVTILE);
    wgmma_commit();
    if (wg == 0) pass_turn();
    wgmma_wait<0>();
    fence_regs(acc);

    float den[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      den[i] = fmaxf(l[i], 1e-20f);
    }
    // O / l as bf16 into this warpgroup's rows of the Q tile, in the TMA
    // box layout (128-byte swizzle: the 16-byte chunk of a row is XORed
    // with row % 8), then one TMA store a box
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0 + 8 * i;
        const uint32_t at = sqw + (j / 8) * C::QBOX + r * ROW_BYTES + (((j % 8) ^ (r % 8)) << 4) +
                            col0 * 2;
        st_shared_u32(at, pack_bf16(acc[4 * j + 2 * i] / den[i], acc[4 * j + 2 * i + 1] / den[i]));
      }
    }
    fence_proxy_async();
    named_sync<WG>(3 + wg);
    if (tid == 0 && qlo < Sq) {
      for (int c = 0; c < C::NBOX; ++c) tma_store(&to, sqw + c * C::QBOX, c * BOX, h, qlo, b);
      tma_store_commit_and_wait();
    }
    if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = qlo + row0 + 8 * i;
        if (qi < Sq) lse[((long long)b * gridDim.x + h) * Sq + qi] = m[i] * LN2 + logf(den[i]);
      }
    }
  }
}

// tensor map of a bf16 [B, S, heads, D] view with element strides (sb, ss, sh):
// dims (D, heads, S, B), boxes of 64 columns x 1 head x `rows` rows x 1 batch row
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D, long long sb,
                long long ss, long long sh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)rows, 1};
  return bf16_tensor_map(map, ptr, 4, dims, strides, box);
}

// tensor map of the int32 slot positions [B, W] (row stride spb elements):
// dims (W, B), boxes of `slots` slots x 1 row; slots past W arrive as zeros
bool slot_map(CUtensorMap* map, const int* ptr, int B, int W, long long spb, int slots) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)W, (cuuint64_t)B};
  // a row stride is read only for B > 1; one row takes any multiple of 16
  const cuuint64_t strides[1] = {B > 1 ? (cuuint64_t)spb * 4 : ((cuuint64_t)W * 4 + 15) / 16 * 16};
  const cuuint32_t box[2] = {(cuuint32_t)slots, 1}, unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<int*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// st: q b,s,h; k b,s,h; v b,s,h; o b,s,h (elements); slot_pos (chunk only)
template <int D, bool CHUNK>
int launch(const void* q, const void* k, const void* v, const int* slot_pos, void* o, float* lse,
           int B, int Sq, int Sk, int H, int Hkv, const long long* st, long long spb, int q_start,
           int causal, int window, float scale, cudaStream_t s) {
  typedef Cfg<D> C;
  CUtensorMap tq, tk, tv, to, tsp = {};
  if (!tensor_map(&tq, q, B, Sq, H, D, st[0], st[1], st[2], C::BQ) ||
      !tensor_map(&tk, k, B, Sk, Hkv, D, st[3], st[4], st[5], C::BKV) ||
      !tensor_map(&tv, v, B, Sk, Hkv, D, st[6], st[7], st[8], C::BKV) ||
      !tensor_map(&to, o, B, Sq, H, D, st[9], st[10], st[11], OUT_ROWS) ||
      (CHUNK && !slot_map(&tsp, slot_pos, B, Sk, spb, C::BKV)))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_attn_kernel<D, CHUNK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(H, B, (Sq + C::BQ - 1) / C::BQ);
  flash_attn_kernel<D, CHUNK><<<grid, C::THREADS, C::bytes, s>>>(
      tq, tk, tv, tsp, to, lse, Sq, Sk, q_start, H / Hkv, causal, window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// strides (elements): q b,s,h; k b,s,h; v b,s,h; o b,s,h — 12 values.
// q, o [B, Sq, H, D]; k, v [B, Sk, Hkv, D]; Sk != Sq only with causal = 0
// (cross attention). D must be 64, 112, 128 or 256; every stride and
// pointer 16-byte aligned. lse: [B, H, Sq] f32 contiguous, or null for none.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                                   const long long* strides, int causal, int window, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (causal && Sk != Sq) return cudaErrorInvalidValue;
#define FA_LAUNCH(DIM)                                                                          \
  if (D == DIM)                                                                               \
    return launch<DIM, false>(q, k, v, nullptr, o, lse, B, Sq, Sk, H, Hkv, strides, 0, 0, causal, \
                              window, scale, s);
  FA_LAUNCH(128)
  FA_LAUNCH(64)
  FA_LAUNCH(112)
  FA_LAUNCH(256)
#undef FA_LAUNCH
  return cudaErrorInvalidValue;
}

// Chunked prefill: q, o [B, C, H, D]; k, v [B, W, Hkv, D]; slot_pos [B, W]
// int32, row stride spb (elements), its pointer 16-byte aligned and, for
// B > 1, spb a multiple of 4. strides as flash_attention_fwd's; D 64 or
// 128 (the serving engines' models). The caller guarantees q_start + C <= W
// and that slot j holds position j or -1.
extern "C" int flash_attention_chunk_fwd(const void* q, const void* k, const void* v,
                                         const int* slot_pos, void* o, int B, int C, int W, int H,
                                         int Hkv, int D, const long long* strides, long long spb,
                                         int q_start, int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128, true>(q, k, v, slot_pos, o, nullptr, B, C, W, H, Hkv, strides, spb,
                             q_start, 1, window, scale, s);
  if (D == 64)
    return launch<64, true>(q, k, v, slot_pos, o, nullptr, B, C, W, H, Hkv, strides, spb,
                            q_start, 1, window, scale, s);
  return cudaErrorInvalidValue;
}
