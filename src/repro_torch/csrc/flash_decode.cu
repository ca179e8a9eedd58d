// One-token GQA decode attention over a ring-buffer KV cache, split over
// ranges of cache slots (flash-decoding), on the tensor cores.
//
// Replaces the Pallas kernel `flash_decode` (repro/kernels/flash_decode.py),
// with its interface generalised to what the serving engines hold: per-row
// positions pos [B] and slot positions slot_pos [B, W], and the caches read
// in place in the engine's [B, W, Hkv, D] layout. A slot is valid when
// 0 <= slot_pos <= pos (and slot_pos > pos - window when window > 0).
// Scale D^-0.5, mask -1e30, f32 softmax statistics, probabilities rounded to
// bf16 before the PV product, as the Pallas kernel does. The exponentials are
// exp2 of logits pre-scaled by log2(e).
//
// What bounds it on an H100: the bytes of the valid slots' K and V rows
// (3.35 TB/s), at three kinds of shape:
//   - short rows in a batch (the batched engine, B=8 over W=2048 with rows
//     at positions 159..1567): a third of the slots are valid, so what is
//     not read counts most;
//   - many query heads on one KV head (granite-34b, G=48): the K/V range
//     has to be read once for all heads, and the partial results (G rows of
//     D + 2 floats per range) stay small beside it;
//   - few rows with every slot valid (the cross decode, B=2 over 1601
//     slots): the card has to be filled and each block's copies kept in
//     flight, so the latency of one block's chain counts.
// Two launches:
//   - split: grid (Hkv, n_split, B). A block takes one range of whole
//     64-slot tiles of one row and one KV head (kernels/flash_decode.py
//     `n_splits`: from Hkv and W only, so a row's sums are the same alone
//     and in any batch) and serves all G query heads of that KV head: K and
//     V are read once whatever G is. It first reads the range's slot_pos and
//     keeps one validity bit a slot; a tile with no valid slot is never
//     copied or multiplied, and an invalid slot in a live tile is not read
//     (its row is zero-filled). The live tiles' K and V tiles pass in turn
//     through a ring of one-tile stages in dynamic shared memory by
//     cp.async, rows padded by 16 bytes for conflict-free ldmatrix; the ring
//     is the deepest of up to four stages (three at D = 256; two when a
//     range holds one tile) at which the whole grid is resident at once,
//     else two, and registers are held to 128 a thread at D <= 128, so four
//     blocks share an SM: latency is hidden across blocks as well as within
//     one (the depth changes no sum). The G query rows, padded to MT =
//     ceil(G / 16) tiles of 16, are mma.sync m16n8k16 A operands; S = Q K^T
//     and O += P V run on the tensor cores with f32 sums (K by ldmatrix, V
//     by ldmatrix.trans), P taken from S's registers. Warp (mt, wn) takes
//     query tile mt and the 16 slots 16 wn .. 16 wn + 15 of every tile,
//     with its own online softmax (f32 m and l, p rounded to bf16); the four
//     warps of a query tile are merged as (0 + 1) + (2 + 3) and the block
//     writes each head's partial (m, l, acc[D]). A head's arithmetic is the
//     same whatever G is, so its output is too. A range with no valid slot
//     writes only m = -1e30, l = 0.
//   - combine: one block of 128 threads per (query head, batch row, 16
//     columns), launched as a programmatic dependent of the split pass (its
//     blocks are resident and waiting when the split ends); each thread
//     folds every eighth range's acc and l for its column with an online
//     rescale, skipping ranges with no valid slot, and the groups are
//     merged in fixed order. A row with no valid slot at all gives the mean
//     of V over the W slots, as the plain version does (every p is 1 there).
//     Where the caller asks for it, the combine also writes each head's
//     log-sum-exp of the scaled logits in natural log, -inf for a row with
//     no valid slot (a mesh rank's empty block of a slot-sharded ring: its
//     partial then takes zero weight in the cross-rank merge), and such a
//     row's output is 0, not the mean of V.
// Measured (chip_smoke.py --flash-decode, NVIDIA H100 80GB HBM3): the B=8
// row and G=48 run well below SDPA; the cross decode stays behind it, held
// by the combine's second launch (about 3.5 us at every shape) and the
// split's chain before its first copy (slot_pos read, live-tile scan).
// D = 64, 112, 128 and 256 and MT = 1..4 (G <= 64) are instantiated.
#include "common.cuh"

namespace {

constexpr int TILE = 64;          // slots a tile (kernels/flash_decode.py TILE_SLOTS)
constexpr int MAX_TILES = 64;     // tiles a range holds at most (one 64-bit live mask)
constexpr int PAD = 8;            // bf16 row padding: 16 bytes
constexpr int SMEM_MAX = 232448;  // the H100's shared memory a block may use
constexpr float LOG2E = 1.4426950408889634f;

template <int D, int MT>
struct Cfg {
  static constexpr int WN = 4;                   // slot groups a query tile is split into
  static constexpr int NW = MT * WN;             // warps
  static constexpr int NT = 32 * NW;             // threads
  static constexpr int SW = TILE / WN;           // slots of a warp's group in a tile
  static constexpr int NJ = SW / 8;              // n8 blocks of S a warp holds
  static constexpr int ND = D / 8;               // n8 blocks of O
  static constexpr int RS = D + PAD;             // smem row stride (bf16)
  static constexpr int CPR = D / 8;              // 16-byte chunks of a row
  static constexpr int STAGE = TILE * RS;        // bf16 of one ring stage: a K or a V tile
  static constexpr int STAGES = D > 128 ? 3 : 4; // ring stages at most
  static constexpr int RED = 2 * MT * ND * 32 * 16;  // bytes of the merge's two buffers
  // blocks an SM must hold (registers of at most 128 a thread at D <= 128)
  static constexpr int MIN_BLOCKS = D > 128 ? 1 : (4 / MT > 1 ? 4 / MT : 1);
  // shared memory besides the ring: Q rows, validity bits, the warps' m, l
  static constexpr int FIXED = 16 * MT * RS * 2 + MAX_TILES * 2 * 4 + 2 * MT * WN * 16 * 4;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D, int MT>
__global__ void __launch_bounds__(Cfg<D, MT>::NT, Cfg<D, MT>::MIN_BLOCKS)
    decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ pos,
                        const int* __restrict__ slot_pos, float* __restrict__ part,
                        float* __restrict__ stats, int W, int Hkv, int G, int n_split, int ring,
                        long long sqb, long long sqh, long long skb, long long skw, long long skh,
                        long long svb, long long svw, long long svh, long long spb, int window,
                        float scale_log2) {
  typedef Cfg<D, MT> C;
  constexpr int NW = C::NW, NT = C::NT, WN = C::WN, SW = C::SW, NJ = C::NJ, ND = C::ND,
                RS = C::RS, CPR = C::CPR;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring_buf = reinterpret_cast<bf16*>(smem);
  // the ring (then the merge's buffers), Q, validity bits, the warps' m and l
  bf16* qs = ring_buf + max(ring * C::STAGE, C::RED / 2);             // [16 MT][RS]
  uint32_t* vbits = reinterpret_cast<uint32_t*>(qs + 16 * MT * RS);    // [2 MAX_TILES]
  float* red_m = reinterpret_cast<float*>(vbits + 2 * MAX_TILES);       // [MT][WN][16]
  float* red_l = red_m + MT * WN * 16;

  // the combine may launch once every block of this pass has started
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // range `split` is tiles t0 .. t1 - 1 of the row's T tiles (the last one ragged)
  const int hk = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int T = (W + TILE - 1) / TILE;
  const int t0 = (int)((long long)split * T / n_split);
  const int t1 = (int)((long long)(split + 1) * T / n_split);
  const int w0 = t0 * TILE, L = min(W, t1 * TILE) - w0, nt = t1 - t0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* kb = k + b * skb + hk * skh + (long long)w0 * skw;
  const bf16* vb = v + b * svb + hk * svh + (long long)w0 * svw;
  const int* sp = slot_pos + b * spb + w0;

  // the block's G query rows, zeros past G
  for (int i = tid; i < 16 * MT * CPR; i += NT) {
    const int g = i / CPR, c = (i % CPR) * 8;
    const bool ok = g < G;
    cp_async16(qs + g * RS + c, ok ? q + b * sqb + (hk * G + g) * sqh + c : q, ok);
  }
  cp_async_commit();

  // one validity bit a slot of the range, the loads of a pass issued together
  const int p = pos[b];
  const int nwords = (L + 31) / 32;
  constexpr int PER = 8;
  for (int base = warp; base < nwords; base += NW * PER) {
    int s[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int j = (base + u * NW) * 32 + lane;
      s[u] = j < L ? sp[j] : -1;
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const bool ok = s[u] >= 0 && s[u] <= p && (window <= 0 || s[u] > p - window);
      const uint32_t bits = __ballot_sync(0xffffffffu, ok);
      if (lane == 0 && base + u * NW < nwords) vbits[base + u * NW] = bits;
    }
  }
  __syncthreads();
  // the live tiles: bit t of `live` is set when tile t holds a valid slot
  uint64_t live = 0;
  {
    const auto tile_live = [&](int t) {
      return t < nt && (vbits[2 * t] | (2 * t + 1 < nwords ? vbits[2 * t + 1] : 0u)) != 0u;
    };
    const uint32_t lo = __ballot_sync(0xffffffffu, tile_live(lane));
    const uint32_t hi = __ballot_sync(0xffffffffu, tile_live(lane + 32));
    live = (uint64_t)lo | ((uint64_t)hi << 32);
  }
  float* st = stats + (((long long)b * Hkv + hk) * n_split + split) * G * 2;
  if (live == 0) {
    for (int g = tid; g < G; g += NT) {
      st[2 * g] = KERNEL_NEG_INF;
      st[2 * g + 1] = 0.0f;
    }
    cp_async_wait<0>();
    return;
  }
  const int nlive = __popcll(live);

  // ring item i is the K (i even) or V (i odd) tile of the (i / 2)-th live
  // tile, in stage i % ring; an invalid slot's row is zero-filled
  uint64_t to_issue = live;
  int issue_tile = 0;
  auto issue = [&](int i) {
    if (i < 2 * nlive) {
      if (i % 2 == 0) {
        issue_tile = __ffsll(to_issue) - 1;
        to_issue &= to_issue - 1;
      }
      const int t = issue_tile;
      const uint64_t bits = (uint64_t)vbits[2 * t] |
                            ((uint64_t)(2 * t + 1 < nwords ? vbits[2 * t + 1] : 0u) << 32);
      const long long sw = i % 2 ? svw : skw;
      const bf16* src = (i % 2 ? vb : kb) + (long long)t * TILE * sw;
      bf16* dst = ring_buf + (i % ring) * C::STAGE;
      const int swi = (int)sw;
#pragma unroll 2
      for (int u = 0; u < (TILE * CPR + NT - 1) / NT; ++u) {
        const int idx = tid + u * NT, j = idx / CPR, c = (idx % CPR) * 8;
        if (TILE * CPR % NT && idx >= TILE * CPR) break;
        const bool ok = (bits >> j) & 1;
        cp_async16(dst + j * RS + c, ok ? src + j * swi + c : kb, ok);
      }
    }
    cp_async_commit();  // an empty group past the last item keeps the count
  };
  // item i has landed once at most ring - 1 later groups are pending
  const auto wait_ring = [&]() {
    switch (ring) {
      case 2: cp_async_wait<1>(); break;
      case 3: cp_async_wait<2>(); break;
      default: cp_async_wait<3>(); break;
    }
    __syncthreads();
  };
  for (int i = 0; i < ring - 1; ++i) issue(i);

  const int mt = warp / WN, wn = warp % WN;
  const int r0 = lane / 4, c0 = (lane % 4) * 2;  // this lane's C-fragment row and column
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m[2] = {KERNEL_NEG_INF, KERNEL_NEG_INF}, l[2] = {0.0f, 0.0f};
  const bf16* qa = qs + (mt * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * RS + (lane / 16) * 8;
  uint64_t to_use = live;

  for (int kk = 0; kk < nlive; ++kk) {
    issue(2 * kk + ring - 1);
    wait_ring();  // K of tile kk
    const int t = __ffsll(to_use) - 1;
    to_use &= to_use - 1;
    const bf16* ks = ring_buf + ((2 * kk) % ring) * C::STAGE + wn * SW * RS;
    const uint64_t bits = (uint64_t)vbits[2 * t] |
                          ((uint64_t)(2 * t + 1 < nwords ? vbits[2 * t + 1] : 0u) << 32);

    // S = Q K^T over this warp's SW slots
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t a[4];
      ldsm_x4(a, qa + kd * 16);
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + (jj * 16 + (lane % 8) + (lane / 16) * 8) * RS + kd * 16 +
                        ((lane / 8) % 2) * 8);
        mma(s[2 * jj], a, bk[0], bk[1]);
        mma(s[2 * jj + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // K's stage is free
    issue(2 * kk + ring);
    // online softmax: row r0 holds s[.][0..1], row r0 + 8 s[.][2..3]
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = wn * SW + j * 8 + c0 + (e & 1);
        s[j][e] = (bits >> slot) & 1 ? s[j][e] * scale_log2 : KERNEL_NEG_INF;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = s[j][e] == KERNEL_NEG_INF ? 0.0f : exp2f(s[j][e] - m[e / 2]);
        l[e / 2] += pe;
        s[j][e] = pe;
      }
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }
    wait_ring();  // V of tile kk
    const bf16* vs = ring_buf + ((2 * kk + 1) % ring) * C::STAGE + wn * SW * RS;
    // O += P V, P (rounded to bf16) taken from S's registers 16 slots at a time
#pragma unroll
    for (int kk2 = 0; kk2 < SW / 16; ++kk2) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk2][0], s[2 * kk2][1]),
                             pack_bf16(s[2 * kk2][2], s[2 * kk2][3]),
                             pack_bf16(s[2 * kk2 + 1][0], s[2 * kk2 + 1][1]),
                             pack_bf16(s[2 * kk2 + 1][2], s[2 * kk2 + 1][3])};
      const bf16* vr = vs + (kk2 * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * RS + (lane / 16) * 8;
#pragma unroll
      for (int dd = 0; dd < ND / 2; ++dd) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vr + dd * 16);
        mma(o[2 * dd], a, bv[0], bv[1]);
        mma(o[2 * dd + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // V's stage is free for the item issued next
  }
  cp_async_wait<0>();

  // merge the WN slot groups of each query tile in fixed order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (lane % 4 == 0) {
    red_m[(mt * WN + wn) * 16 + r0] = m[0];
    red_m[(mt * WN + wn) * 16 + r0 + 8] = m[1];
    red_l[(mt * WN + wn) * 16 + r0] = l[0];
    red_l[(mt * WN + wn) * 16 + r0 + 8] = l[1];
  }
  __syncthreads();
  float mrow[2], lrow[2] = {0.0f, 0.0f}, f[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* rm = red_m + mt * WN * 16 + r0 + 8 * h;
    mrow[h] = rm[0];
#pragma unroll
    for (int w = 1; w < WN; ++w) mrow[h] = fmaxf(mrow[h], rm[w * 16]);
#pragma unroll
    for (int w = 0; w < WN; ++w) lrow[h] += red_l[mt * WN * 16 + w * 16 + r0 + 8 * h] *
                                            exp2f(rm[w * 16] - mrow[h]);
    f[h] = exp2f(m[h] - mrow[h]);
  }
  // O scaled to the tile's max, summed as (w0 + w1) + (w2 + w3) through two
  // buffers [2][MT][ND][32] of float4 in the ring's memory
  float4* red_o = reinterpret_cast<float4*>(ring_buf);
  float x[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    x[i][0] = o[i][0] * f[0];
    x[i][1] = o[i][1] * f[0];
    x[i][2] = o[i][2] * f[1];
    x[i][3] = o[i][3] * f[1];
  }
  const auto slot_of = [&](int buf, int i) { return ((buf * MT + mt) * ND + i) * 32 + lane; };
  if (wn % 2) {
#pragma unroll
    for (int i = 0; i < ND; ++i)
      red_o[slot_of(wn / 2, i)] = make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
  }
  __syncthreads();
  if (wn % 2 == 0) {
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const float4 y = red_o[slot_of(wn / 2, i)];
      x[i][0] += y.x;
      x[i][1] += y.y;
      x[i][2] += y.z;
      x[i][3] += y.w;
    }
  }
  __syncthreads();
  if (wn == 2) {
#pragma unroll
    for (int i = 0; i < ND; ++i)
      red_o[slot_of(0, i)] = make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
  }
  __syncthreads();
  if (wn > 0) return;
  float* out = part + (((long long)b * Hkv + hk) * n_split + split) * G * D;
  const int g0 = mt * 16 + r0, g1 = g0 + 8;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const float4 y = red_o[slot_of(0, i)];
    if (g0 < G)
      *reinterpret_cast<float2*>(out + g0 * D + i * 8 + c0) =
          make_float2(x[i][0] + y.x, x[i][1] + y.y);
    if (g1 < G)
      *reinterpret_cast<float2*>(out + g1 * D + i * 8 + c0) =
          make_float2(x[i][2] + y.z, x[i][3] + y.w);
  }
  if (lane % 4 == 0) {
    if (g0 < G) {
      st[2 * g0] = mrow[0];
      st[2 * g0 + 1] = lrow[0];
    }
    if (g1 < G) {
      st[2 * g1] = mrow[1];
      st[2 * g1 + 1] = lrow[1];
    }
  }
}

constexpr int COMBINE_COLS = 16;   // columns of a combine block
constexpr int COMBINE_GROUPS = 8;  // its range groups: 16 x 8 threads

// one block per (query head, batch row, 16 columns): thread (d, c) folds
// column d of ranges c, c + CS, ... into (m, l, acc) with an online rescale
// (its loads issued together; a range with no valid slot, m_i = -1e30,
// wrote no acc and is skipped), then thread (d, 0) merges the CS groups in
// fixed order. Blocks this small fit beside the split pass's, so they are
// resident and waiting when it ends. With lse (else null) the column-0
// block's thread (0, 0) writes lse[b, h] = ln 2 (mx + log2 den), the
// statistics being in the exp2 domain, or -inf where no slot is valid.
template <int D>
__global__ void __launch_bounds__(COMBINE_COLS * COMBINE_GROUPS)
    decode_combine_kernel(const float* __restrict__ part, const float* __restrict__ stats,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int W, int Hkv, int G, int n_split,
                          long long svb, long long svw, long long svh, long long sob,
                          long long soh) {
  constexpr int CC = COMBINE_COLS, CS = COMBINE_GROUPS;
  __shared__ float s_m[CS], s_l[CS], s_acc[CS][CC];
  // the split pass's partials are complete and visible past this point
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int h = blockIdx.x, b = blockIdx.y, hk = h / G, g = h % G;
  const int tid = threadIdx.x, dl = tid % CC, c = tid / CC, d = blockIdx.z * CC + dl;
  const float* st = stats + (((long long)b * Hkv + hk) * n_split * G + g) * 2;  // range i at 2 G i
  const float* pa = part + (((long long)b * Hkv + hk) * n_split * G + g) * D + d;  // at G D i
  float m = KERNEL_NEG_INF, l = 0.0f, acc = 0.0f;
#pragma unroll 4
  for (int i = c; i < n_split; i += CS) {
    const float mi = st[2 * G * i], li = st[2 * G * i + 1], ai = pa[(long long)G * D * i];
    if (mi > KERNEL_NEG_INF) {
      const float mn = fmaxf(m, mi), sc = exp2f(m - mn), w = exp2f(mi - mn);
      l = l * sc + li * w;
      acc = acc * sc + ai * w;
      m = mn;
    }
  }
  s_acc[c][dl] = acc;
  if (dl == 0) {
    s_m[c] = m;
    s_l[c] = l;
  }
  __syncthreads();
  float mx = s_m[0];
#pragma unroll
  for (int k = 1; k < CS; ++k) mx = fmaxf(mx, s_m[k]);
  // no valid slot in the row: every p is 1, the mean of V; with lse the
  // output is 0 instead (its weight in a merge is 0, and the mean's W-slot
  // read would cost more than the rest of the call)
  if (mx <= KERNEL_NEG_INF && lse == nullptr) {
    const bf16* vr = v + b * svb + hk * svh + d;
    float sum = 0.0f;
    for (int w = c; w < W; w += CS) sum += __bfloat162float(vr[(long long)w * svw]);
    __syncthreads();
    s_acc[c][dl] = sum;
    __syncthreads();
  }
  if (c == 0) {
    float sum = 0.0f, den = 0.0f;
#pragma unroll
    for (int k = 0; k < CS; ++k) {
      const float w = mx > KERNEL_NEG_INF ? exp2f(s_m[k] - mx) : 1.0f;
      sum += w * s_acc[k][dl];
      den += w * s_l[k];
    }
    if (lse != nullptr && d == 0)  // 0xff800000: -inf
      lse[(long long)b * Hkv * G + h] =
          mx > KERNEL_NEG_INF ? (mx + log2f(den)) * 0.69314718055994531f : __int_as_float(0xff800000);
    if (mx <= KERNEL_NEG_INF) den = (float)W;
    o[b * sob + h * soh + d] = __float2bfloat16(sum / fmaxf(den, 1e-20f));
  }
}

template <int D, int MT>
int launch_split(const void* q, const void* k, const void* v, const void* pos,
                 const void* slot_pos, float* part, float* stats, int B, int Hkv, int W, int G,
                 const long long* st, int window, float scale, int n_split, cudaStream_t s) {
  typedef Cfg<D, MT> C;
  // per device (at most 16): the SM count, then the blocks an SM holds at
  // each ring depth (dynamic shared memory above 48 KB allowed first)
  static int sms[16] = {}, occupancy[16][C::STAGES + 1] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16) return cudaErrorInvalidDevice;
  const auto bytes_of = [](int r) { return (size_t)max(r * C::STAGE * 2, C::RED) + C::FIXED; };
  // ring stages: at most STAGES, no more than a range's K and V tiles, within SMEM_MAX
  const int T = (W + TILE - 1) / TILE, longest = (T + n_split - 1) / n_split;
  const int fit = (SMEM_MAX - C::FIXED) / (C::STAGE * 2);
  const int top = min(min(C::STAGES, 2 * longest), fit);
  if (top < 2 || longest > MAX_TILES) return cudaErrorInvalidValue;
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(decode_split_kernel<D, MT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    for (int r = 2; e == cudaSuccess && r <= min(C::STAGES, fit); ++r)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[dev][r],
                                                        decode_split_kernel<D, MT>, C::NT,
                                                        bytes_of(r));
    if (e != cudaSuccess) return e;
  }
  // the deepest ring at which the whole grid is resident at once, else the
  // shallowest (the most blocks an SM); the depth changes no sum
  const long long blocks = (long long)Hkv * n_split * B;
  int ring = 2;
  for (int r = top; r > 2; --r)
    if ((long long)occupancy[dev][r] * sms[dev] >= blocks) {
      ring = r;
      break;
    }
  const size_t bytes = bytes_of(ring);
  decode_split_kernel<D, MT><<<dim3(Hkv, n_split, B), C::NT, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(pos), static_cast<const int*>(slot_pos), part, stats, W, Hkv, G,
      n_split, ring, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], window,
      scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* pos, const void* slot_pos,
           void* o, float* lse, float* scratch, int B, int H, int Hkv, int W,
           const long long* st, int window, float scale, int n_split, cudaStream_t s) {
  const int G = H / Hkv;
  float* part = scratch;
  float* stats = scratch + (long long)B * H * n_split * D;
  int e;
  if (G <= 16)
    e = launch_split<D, 1>(q, k, v, pos, slot_pos, part, stats, B, Hkv, W, G, st, window, scale,
                           n_split, s);
  else if (G <= 32)
    e = launch_split<D, 2>(q, k, v, pos, slot_pos, part, stats, B, Hkv, W, G, st, window, scale,
                           n_split, s);
  else if (G <= 48)
    e = launch_split<D, 3>(q, k, v, pos, slot_pos, part, stats, B, Hkv, W, G, st, window, scale,
                           n_split, s);
  else
    e = launch_split<D, 4>(q, k, v, pos, slot_pos, part, stats, B, Hkv, W, G, st, window, scale,
                           n_split, s);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B, D / COMBINE_COLS);
  cfg.blockDim = dim3(COMBINE_COLS * COMBINE_GROUPS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* cpart = part;
  const float* cstats = stats;
  const bf16* cv = static_cast<const bf16*>(v);
  bf16* co = static_cast<bf16*>(o);
  return cudaLaunchKernelEx(&cfg, decode_combine_kernel<D>, cpart, cstats, cv, co, lse, W, Hkv,
                            G, n_split, st[5], st[6], st[7], st[9], st[10]);
}

}  // namespace

// q [B,H,D]; k, v [B,W,Hkv,D]; pos [B] int32; slot_pos [B,W] int32; o [B,H,D];
// lse: null, or [B,H] f32 contiguous (each head's log-sum-exp, -inf where no
// slot is valid); scratch: B*H*n_split*(D + 2) floats (partial acc, then
// (m, l) pairs).
// strides (elements): q b,h; k b,w,h; v b,w,h; slot_pos b; o b,h — 11 values
// (slot_pos may have batch stride 0). D must be 64, 112, 128 or 256,
// G = H / Hkv at most 64, the q/k/v pointers and strides 16-byte aligned,
// and a range at most 64 tiles of 64 slots (n_split >= ceil(W / 4096)).
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, const void* pos,
                                const void* slot_pos, void* o, void* lse, void* scratch, int B,
                                int H, int Hkv, int W, int D, const long long* strides,
                                int window, float scale, int n_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = (W + TILE - 1) / TILE;
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > 64 || W < 1 || n_split < 1 || n_split > T)
    return cudaErrorInvalidValue;
  float* f = static_cast<float*>(scratch);
  float* l = static_cast<float*>(lse);
  if (D == 128)
    return launch<128>(q, k, v, pos, slot_pos, o, l, f, B, H, Hkv, W, strides, window, scale,
                       n_split, s);
  if (D == 64)
    return launch<64>(q, k, v, pos, slot_pos, o, l, f, B, H, Hkv, W, strides, window, scale,
                      n_split, s);
  if (D == 112)
    return launch<112>(q, k, v, pos, slot_pos, o, l, f, B, H, Hkv, W, strides, window, scale,
                       n_split, s);
  if (D == 256)
    return launch<256>(q, k, v, pos, slot_pos, o, l, f, B, H, Hkv, W, strides, window, scale,
                       n_split, s);
  return cudaErrorInvalidValue;
}
