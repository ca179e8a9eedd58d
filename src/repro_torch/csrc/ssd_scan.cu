// Mamba2 SSD chunked scan (arXiv:2405.21060), chunk-parallel on the tensor cores.
//
// Replaces the Pallas kernel `ssd_scan` (repro/kernels/ssd_scan.py), with its
// interface generalised to the model's layout: x [B,S,H,P], b / c [B,S,G,N]
// read through strides by head h as group h / (H/G) (Mamba2 has G = 1, so a
// repeated copy would read B and C H times), da / dt [B,S,H] f32; it writes
// y [B,S,H,P] f32 and the final state [B,H,N,P] f32 that decode continues
// from. Per (b, h), over chunks of cl rows, with h zero at first:
//   cs = cumsum(da);  y = ((C B^T) o L o dt^T) x + exp(cs) o (C h_in),
//   L_ij = exp(cs_i - cs_j) for i >= j else 0;
//   h_out = exp(cs_last) h_in + sum_j exp(cs_last - cs_j) dt_j B_j x_j^T.
//
// What bounds it on an H100: bytes. At Mamba2-2.7B's prefill (B=1, S=2048,
// H=80, P=64, N=128, cl=256) x, B, C (bf16), da, dt (f32) read once and y
// (f32, as the Pallas kernel's output type) and the state written once are
// 68 MB, 0.020 ms at 3.35 TB/s; y alone is 62% of it. The chunked form's
// 13.1 GFLOP would take 0.013 ms at 989 TFLOP/s on the tensor cores. The
// f32 recurrence on the CUDA cores (5.4 GFLOP at 67 TFLOP/s, 0.081 ms) was
// the bound of the first design, which walked a head's chunks in one block
// (80 blocks for 132 SMs) with scalar f32 FMAs.
//
// Design: the SSD decomposition in three launches, every chunk in parallel.
//   1. chunk states, grid (chunk, head, batch): cs = cumsum(da) in the
//      chunk (one warp); s_c = sum_j B_j^T (w_j x_j), w_j = exp(cs_last -
//      cs_j) dt_j, an [N,P] product over the chunk's rows in 64-row tiles,
//      one warp per 16 state rows, the next tile's loads in flight during
//      a tile's products; s_c and cs_last go to f32 scratch.
//   2. state passing, one thread per (b, h, state entry): the recurrence
//      over chunks, h_in(c) = exp(cs_last(c-1)) h_in(c-1) + s_{c-1},
//      written as bf16 hi and lo planes (scratch); the last one is the
//      `state` output.
//   3. chunk scan, grid (64-row tile, chunk, head, batch), four warps of 16
//      rows: y_i = exp(cs_i) (C_i h_in) + sum_{j <= i} (C_i B_j^T o L o dt)
//      x_j; tiles above the diagonal are never computed, the decay applies
//      by select (exp may be inf above the diagonal), and the masked tile
//      stays in registers: the accumulator of C_i B_j^T is, pair by pair,
//      the A operand of its product with x_j. Row tiles are launched
//      longest first. bf16 tiles and h_in's planes arrive by cp.async,
//      so staging holds no registers (four blocks an SM fit).
// Products run on the tensor cores by warp-level mma.sync m16n8k16 (bf16
// in, f32 accumulation), operands staged in shared memory as bf16 and read
// by ldmatrix (.trans where the contraction runs over rows). An operand
// that is f32 (B o dec, the masked tile, h_in, and every input when x, B, C
// are f32) is split into hi = bf16(v) and lo = bf16(v - hi) and both
// products are accumulated: about 2^-16 relative error per product. Routes
// by input type: bf16 x, B, C (the Mamba2 path) take C B^T as it is and
// split only the f32 operands; f32 inputs (reduced configs and tests) split
// every operand and accumulate three products (hi hi + hi lo + lo hi).
// Rows past S or past the chunk load as zeros with dt = da = 0.
// Requires 16-byte aligned x, B, C rows (pointers and strides).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int T = 64;        // rows of a tile
constexpr int MAXCL = 256;   // longest chunk
constexpr int PAD = 8;       // bf16 row padding: 16 bytes, conflict-free ldmatrix
constexpr int SCAN_THREADS = 128;

struct Strides {  // elements
  long long xb, xs, xh, bb, bs, bg, cb, cs, cg, ab, as, ah, tb, ts, th;
};

// two f32 values (lower column first) as packed bf16 hi and lo = bf16(v - hi)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// eight consecutive values as loaded (bf16: one 16-byte load; f32: two)
struct F8 {
  float4 a, b;
};
__device__ __forceinline__ uint4 load8(const bf16* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ F8 load8(const float* p) {
  return F8{reinterpret_cast<const float4*>(p)[0], reinterpret_cast<const float4*>(p)[1]};
}
template <typename In>
using Raw8 = decltype(load8(static_cast<const In*>(nullptr)));

__device__ __forceinline__ void unpack8(float (&v)[8], const uint4& u) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x, v[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack8(float (&v)[8], const F8& u) {
  v[0] = u.a.x, v[1] = u.a.y, v[2] = u.a.z, v[3] = u.a.w;
  v[4] = u.b.x, v[5] = u.b.y, v[6] = u.b.z, v[7] = u.b.w;
}

// A thread's share of a tile of rows [0, T) of a [*, W] matrix (row
// stride rs elements; rows at or past `valid` read as zeros), held in
// registers as loaded between `fetch` and `put`, so every load of a thread
// is issued before its first store (the compiler cannot tell the global
// and shared pointers apart) and pass 1 can fetch a tile while the one
// before it is multiplied. `put` writes the rows, each times
// scale[i] when scale is given, into the bf16 plane hi [T][W + PAD]
// and, when LO, lo = bf16(v - hi) into the plane that follows it.
template <typename In, int W, int NT>
struct Tile {
  static constexpr int LD = W + PAD, PER = W / 8, ITEMS = T * PER;
  static constexpr int ITER = (ITEMS + NT - 1) / NT;
  Raw8<In> raw[ITER];

  __device__ __forceinline__ void fetch(const In* src, long long rs, int valid) {
#pragma unroll
    for (int t = 0; t < ITER; ++t) {
      const int e = threadIdx.x + t * NT, i = e / PER, k = (e % PER) * 8;
      raw[t] = Raw8<In>{};
      if (e < ITEMS && i < valid) raw[t] = load8(src + i * rs + k);
    }
  }

  template <bool LO>
  __device__ __forceinline__ void put(bf16* hi, const float* scale) const {
    bf16* lo = hi + T * LD;
#pragma unroll
    for (int t = 0; t < ITER; ++t) {
      const int e = threadIdx.x + t * NT, i = e / PER, k = (e % PER) * 8;
      if (e >= ITEMS) break;
      float v[8];
      unpack8(v, raw[t]);
      if (scale != nullptr) {
        const float s = scale[i];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] *= s;
      }
      uint4 h, l;
      split2(v[0], v[1], h.x, l.x);
      split2(v[2], v[3], h.y, l.y);
      split2(v[4], v[5], h.z, l.z);
      split2(v[6], v[7], h.w, l.w);
      *reinterpret_cast<uint4*>(hi + i * LD + k) = h;
      if constexpr (LO) *reinterpret_cast<uint4*>(lo + i * LD + k) = l;
    }
  }
};

// rows [0, ROWS) of a [*, W] bf16 matrix (row stride rs elements) into
// dst [ROWS][W + PAD] by cp.async, 16 bytes a copy; rows at or past `valid`
// are written as zeros. The caller commits and waits.
template <int W, int ROWS, int NT>
__device__ __forceinline__ void copy_async(bf16* dst, const bf16* src, long long rs, int valid) {
  constexpr int PER = W / 8;
  for (int e = threadIdx.x; e < ROWS * PER; e += NT) {
    const int i = e / PER, k = (e % PER) * 8;
    const bool ok = i < valid;
    cp_async16(dst + i * (W + PAD) + k, src + (ok ? i * rs + k : 0), ok);
  }
}

// a 64-row input tile into its planes: bf16 inputs as they are, by
// cp.async (the caller commits and waits); f32 inputs split into hi and lo
template <typename In, int W, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const In* src, long long rs, int valid) {
  if constexpr (std::is_same<In, float>::value) {
    Tile<In, W, NT> t;
    t.fetch(src, rs, valid);
    t.template put<true>(dst, nullptr);
  } else {
    copy_async<W, T, NT>(dst, src, rs, valid);
  }
}

// sCs = cumsum(da) over the chunk's rows [s0, s0 + r), sDt = dt; both zero-
// extended (da = dt = 0) to MAXCL, so cs stays at cs_last past the chunk
template <int NT>
__device__ __forceinline__ void chunk_cumsum(float* sCs, float* sDt, const float* dag,
                                             const float* dtg, int s0, int r, const Strides& st) {
  const int tid = threadIdx.x;
  constexpr int ITER = MAXCL / NT;
  float a[ITER], d[ITER];  // every load before the first store
#pragma unroll
  for (int t = 0; t < ITER; ++t) {
    const int i = tid + t * NT;
    a[t] = i < r ? dag[(long long)(s0 + i) * st.as] : 0.0f;
    d[t] = i < r ? dtg[(long long)(s0 + i) * st.ts] : 0.0f;
  }
#pragma unroll
  for (int t = 0; t < ITER; ++t) sCs[tid + t * NT] = a[t], sDt[tid + t * NT] = d[t];
  __syncthreads();
  if (tid < 32) {
    constexpr int PER = MAXCL / 32;
    float v[PER], run = 0.0f;
#pragma unroll
    for (int k = 0; k < PER; ++k) v[k] = (run += sCs[tid * PER + k]);
    float tot = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, tot, o);
      if (tid >= o) tot += t;
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) sCs[tid * PER + k] = v[k] + (tot - run);
  }
  __syncthreads();
}

// shared-memory layouts (bf16 elements); a split operand's lo plane follows its hi plane
template <int P, int N, bool LO>
struct Lay {
  static constexpr int planes = LO ? 2 : 1;     // planes of an input operand (x, B, C)
  static constexpr int tileN = T * (N + PAD);   // a 64-row tile of B or C
  static constexpr int tileP = T * (P + PAD);   // a 64-row tile of x
  // pass 1: B_j planes, then w o x_j (always split)
  static constexpr int s1_b = 0, s1_x = planes * tileN;
  static constexpr size_t s1_bytes = sizeof(bf16) * (s1_x + 2 * tileP);
  // pass 3: C_i planes, then either h_in (split, [N][P + PAD]) or B_j and x_j planes
  static constexpr int s3_c = 0, s3_u = planes * tileN;
  static constexpr int s3_b = s3_u, s3_x = s3_u + planes * tileN, s3_h = s3_u;
  static constexpr int u_elems = planes * (tileN + tileP) > 2 * N * (P + PAD)
                                     ? planes * (tileN + tileP)
                                     : 2 * N * (P + PAD);
  static constexpr size_t s3_bytes = sizeof(bf16) * (s3_u + u_elems);
};

// pass 1: grid (chunk, head, batch), N / 16 warps
template <typename In, int P, int N>
__global__ void __launch_bounds__(2 * N)
    chunk_state_kernel(const In* __restrict__ x, const In* __restrict__ b,
                       const float* __restrict__ da, const float* __restrict__ dt,
                       float* __restrict__ sc, float* __restrict__ cs_last, int S, int H, int hpg,
                       int cl, Strides st) {
  constexpr int NT = 2 * N;
  constexpr bool LO = std::is_same<In, float>::value;
  typedef Lay<P, N, LO> L;
  constexpr int LDN = N + PAD, LDP = P + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16 *sB = sm + L::s1_b, *sX = sm + L::s1_x;
  __shared__ float sCs[MAXCL], sDt[MAXCL], sW[MAXCL];

  const int ci = blockIdx.x, h = blockIdx.y, bi = blockIdx.z, g = h / hpg, nc = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, q = lane / 8, rr = lane % 8;
  const int s0 = ci * cl, r = min(cl, S - s0);
  const In* xg = x + bi * st.xb + h * st.xh + (long long)s0 * st.xs;
  const In* bg = b + bi * st.bb + g * st.bg + (long long)s0 * st.bs;

  Tile<In, N, NT> tb;
  Tile<In, P, NT> tx;
  tb.fetch(bg, st.bs, r);  // in flight during the cumsum
  tx.fetch(xg, st.xs, r);
  chunk_cumsum<NT>(sCs, sDt, da + bi * st.ab + h * st.ah, dt + bi * st.tb + h * st.th, s0, r, st);
  const float last = sCs[r - 1];
  for (int i = tid; i < MAXCL; i += NT) sW[i] = expf(last - sCs[i]) * sDt[i];
  const long long bhc = ((long long)bi * H + h) * nc + ci;
  if (tid == 0) cs_last[bhc] = last;

  // s_c [N][P]: this warp's 16 state rows n, all P columns
  float acc[P / 8][4] = {};
  for (int j0 = 0; j0 < r; j0 += T) {
    __syncthreads();  // sW written; the previous tile consumed
    tb.template put<LO>(sB, nullptr);
    tx.template put<true>(sX, sW + j0);
    if (j0 + T < r) {  // the next tile's loads in flight during this one's products
      tb.fetch(bg + (j0 + T) * st.bs, st.bs, r - j0 - T);
      tx.fetch(xg + (j0 + T) * st.xs, st.xs, r - j0 - T);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < T; kk += 16) {
      // A = B_j^T: stored [j][n] = [k][m], so .trans
      uint32_t ah[4], al[4];
      const int ao = (kk + (q / 2) * 8 + rr) * LDN + warp * 16 + (q % 2) * 8;
      ldsm_x4_t(ah, sB + ao);
      if constexpr (LO) ldsm_x4_t(al, sB + T * LDN + ao);
#pragma unroll
      for (int n2 = 0; n2 < P / 16; ++n2) {
        // B = w o x_j: stored [j][p] = [k][n], so .trans; two 8-column tiles
        uint32_t bh[4], bl[4];
        const int bo = (kk + (q % 2) * 8 + rr) * LDP + n2 * 16 + (q / 2) * 8;
        ldsm_x4_t(bh, sX + bo);
        ldsm_x4_t(bl, sX + T * LDP + bo);
        mma(acc[2 * n2], ah, bh[0], bh[1]);
        mma(acc[2 * n2 + 1], ah, bh[2], bh[3]);
        mma(acc[2 * n2], ah, bl[0], bl[1]);
        mma(acc[2 * n2 + 1], ah, bl[2], bl[3]);
        if constexpr (LO) {
          mma(acc[2 * n2], al, bh[0], bh[1]);
          mma(acc[2 * n2 + 1], al, bh[2], bh[3]);
        }
      }
    }
  }

  float* out = sc + bhc * N * P;
  const int n0 = warp * 16 + lane / 4;
#pragma unroll
  for (int nt = 0; nt < P / 8; ++nt) {
    const int col = nt * 8 + 2 * (lane % 4);
    *reinterpret_cast<float2*>(out + n0 * P + col) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + (n0 + 8) * P + col) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// pass 2: grid (ceil(N P / 256), B H). h_in of every chunk, from the chunk
// states sc [B H, nc, N P], into hin [B H, nc, 2, N P] as bf16 hi and lo
// planes (split once here, not in every pass-3 block); K loads of a thread
// are in flight before its first store.
template <int K>
__global__ void __launch_bounds__(256)
    state_pass_kernel(const float* __restrict__ sc, const float* __restrict__ cs_last,
                      bf16* __restrict__ hin, float* __restrict__ state, int nc, int np) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= np) return;
  const long long bh = blockIdx.y;
  const float* s = sc + bh * nc * np + e;
  bf16* o = hin + bh * nc * 2 * np + e;
  const float* dec = cs_last + bh * nc;
  float hc = 0.0f;
  for (int c0 = 0; c0 < nc; c0 += K) {
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = c0 + k < nc ? s[(long long)(c0 + k) * np] : 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (c0 + k < nc) {
        const bf16 hi = __float2bfloat16(hc);
        o[(long long)(c0 + k) * 2 * np] = hi;
        o[(long long)(c0 + k) * 2 * np + np] = __float2bfloat16(hc - __bfloat162float(hi));
        hc = expf(dec[c0 + k]) * hc + v[k];
      }
  }
  state[bh * np + e] = hc;
}

// pass 3: grid (chunk, head, row tile x batch), four warps of 16 rows
template <typename In, int P, int N>
__global__ void __launch_bounds__(SCAN_THREADS)
    chunk_scan_kernel(const In* __restrict__ x, const In* __restrict__ b,
                      const In* __restrict__ c, const float* __restrict__ da,
                      const float* __restrict__ dt, const bf16* __restrict__ hin,
                      float* __restrict__ y, int S, int H, int hpg, int cl, Strides st) {
  constexpr int NT = SCAN_THREADS;
  constexpr bool LO = std::is_same<In, float>::value;
  typedef Lay<P, N, LO> L;
  constexpr int LDN = N + PAD, LDP = P + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16 *sC = sm + L::s3_c, *sB = sm + L::s3_b, *sX = sm + L::s3_x, *sH = sm + L::s3_h;
  __shared__ float sCs[MAXCL], sDt[MAXCL];

  const int nt = (cl + T - 1) / T, B = gridDim.z / nt;
  const int ci = blockIdx.x, h = blockIdx.y, bi = blockIdx.z % B;
  const int it = nt - 1 - blockIdx.z / B;  // the longest row tiles first
  const int s0 = ci * cl, r = min(cl, S - s0), i0 = it * T;
  if (i0 >= r) return;  // a tile past S in the last chunk
  const int g = h / hpg;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, q = lane / 8, rr = lane % 8;
  const In* xg = x + bi * st.xb + h * st.xh + (long long)s0 * st.xs;
  const In* bg = b + bi * st.bb + g * st.bg + (long long)s0 * st.bs;
  const In* cg = c + bi * st.cb + g * st.cg + (long long)s0 * st.cs;

  load_tile<In, N, NT>(sC, cg + i0 * st.cs, st.cs, r - i0);
  if (ci > 0) {  // h_in's planes; the incoming state is zero in the first chunk
    const bf16* hp = hin + (((long long)bi * H + h) * gridDim.x + ci) * 2 * N * P;
    copy_async<P, N, NT>(sH, hp, P, N);
    copy_async<P, N, NT>(sH + N * LDP, hp + N * P, P, N);
  }
  cp_async_commit();
  chunk_cumsum<NT>(sCs, sDt, da + bi * st.ab + h * st.ah, dt + bi * st.tb + h * st.th, s0, r, st);
  cp_async_wait<0>();
  __syncthreads();

  // rows of this thread's accumulator fragments, chunk-local
  const int ra = i0 + warp * 16 + lane / 4, rb = ra + 8;
  const int ca = (warp * 16 + (q % 2) * 8 + rr) * LDN + (q / 2) * 8;  // A from C_i, + k
  float acc[P / 8][4] = {};

  if (ci > 0) {
#pragma unroll
    for (int kk = 0; kk < N; kk += 16) {
      uint32_t ah[4], al[4];
      ldsm_x4(ah, sC + ca + kk);
      if constexpr (LO) ldsm_x4(al, sC + T * LDN + ca + kk);
#pragma unroll
      for (int n2 = 0; n2 < P / 16; ++n2) {
        // B = h_in: stored [n][p] = [k][n], so .trans
        uint32_t bh[4], bl[4];
        const int bo = (kk + (q % 2) * 8 + rr) * LDP + n2 * 16 + (q / 2) * 8;
        ldsm_x4_t(bh, sH + bo);
        ldsm_x4_t(bl, sH + N * LDP + bo);
        mma(acc[2 * n2], ah, bh[0], bh[1]);
        mma(acc[2 * n2 + 1], ah, bh[2], bh[3]);
        mma(acc[2 * n2], ah, bl[0], bl[1]);
        mma(acc[2 * n2 + 1], ah, bl[2], bl[3]);
        if constexpr (LO) {
          mma(acc[2 * n2], al, bh[0], bh[1]);
          mma(acc[2 * n2 + 1], al, bh[2], bh[3]);
        }
      }
    }
    const float ea = expf(sCs[ra]), eb = expf(sCs[rb]);
#pragma unroll
    for (int nt8 = 0; nt8 < P / 8; ++nt8) {
      acc[nt8][0] *= ea, acc[nt8][1] *= ea;
      acc[nt8][2] *= eb, acc[nt8][3] *= eb;
    }
  }

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * T;
    __syncthreads();  // h_in or the previous B_j, x_j consumed
    load_tile<In, N, NT>(sB, bg + j0 * st.bs, st.bs, r - j0);
    load_tile<In, P, NT>(sX, xg + j0 * st.xs, st.xs, r - j0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // G = C_i B_j^T: this warp's 16 rows x 64 columns j
    float gm[T / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < N; kk += 16) {
      uint32_t ah[4], al[4];
      ldsm_x4(ah, sC + ca + kk);
      if constexpr (LO) ldsm_x4(al, sC + T * LDN + ca + kk);
#pragma unroll
      for (int n2 = 0; n2 < T / 16; ++n2) {
        // B = B_j^T: stored [j][n] = [n][k], no .trans
        uint32_t bh[4], bl[4];
        const int bo = (n2 * 16 + (q / 2) * 8 + rr) * LDN + kk + (q % 2) * 8;
        ldsm_x4(bh, sB + bo);
        mma(gm[2 * n2], ah, bh[0], bh[1]);
        mma(gm[2 * n2 + 1], ah, bh[2], bh[3]);
        if constexpr (LO) {
          ldsm_x4(bl, sB + T * LDN + bo);
          mma(gm[2 * n2], ah, bl[0], bl[1]);
          mma(gm[2 * n2 + 1], ah, bl[2], bl[3]);
          mma(gm[2 * n2], al, bh[0], bh[1]);
          mma(gm[2 * n2 + 1], al, bh[2], bh[3]);
        }
      }
    }
    // decay and dt by select: above the diagonal exp may be inf
    const float csa = sCs[ra], csb = sCs[rb];
#pragma unroll
    for (int n8 = 0; n8 < T / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ra : rb, j = j0 + n8 * 8 + 2 * (lane % 4) + e % 2;
        gm[n8][e] = i >= j ? gm[n8][e] * expf((e < 2 ? csa : csb) - sCs[j]) * sDt[j] : 0.0f;
      }

    // y += M x_j: the accumulator's 16 x 16 block of columns 16k.. is the A
    // fragment of step k, split into hi and lo
#pragma unroll
    for (int ks = 0; ks < T / 16; ++ks) {
      uint32_t mh[4], ml[4];
      split2(gm[2 * ks][0], gm[2 * ks][1], mh[0], ml[0]);
      split2(gm[2 * ks][2], gm[2 * ks][3], mh[1], ml[1]);
      split2(gm[2 * ks + 1][0], gm[2 * ks + 1][1], mh[2], ml[2]);
      split2(gm[2 * ks + 1][2], gm[2 * ks + 1][3], mh[3], ml[3]);
#pragma unroll
      for (int n2 = 0; n2 < P / 16; ++n2) {
        // B = x_j: stored [j][p] = [k][n], so .trans
        uint32_t bh[4], bl[4];
        const int bo = (ks * 16 + (q % 2) * 8 + rr) * LDP + n2 * 16 + (q / 2) * 8;
        ldsm_x4_t(bh, sX + bo);
        mma(acc[2 * n2], mh, bh[0], bh[1]);
        mma(acc[2 * n2 + 1], mh, bh[2], bh[3]);
        mma(acc[2 * n2], ml, bh[0], bh[1]);
        mma(acc[2 * n2 + 1], ml, bh[2], bh[3]);
        if constexpr (LO) {
          ldsm_x4_t(bl, sX + T * LDP + bo);
          mma(acc[2 * n2], mh, bl[0], bl[1]);
          mma(acc[2 * n2 + 1], mh, bl[2], bl[3]);
        }
      }
    }
  }

  float* yg = y + (((long long)bi * S + s0) * H + h) * P;
#pragma unroll
  for (int n8 = 0; n8 < P / 8; ++n8) {
    const int col = n8 * 8 + 2 * (lane % 4);
    if (ra < r)
      *reinterpret_cast<float2*>(yg + (long long)ra * H * P + col) =
          make_float2(acc[n8][0], acc[n8][1]);
    if (rb < r)
      *reinterpret_cast<float2*>(yg + (long long)rb * H * P + col) =
          make_float2(acc[n8][2], acc[n8][3]);
  }
}

template <typename In, int P, int N>
int launch(const void* x, const void* b, const void* c, const void* da, const void* dt, void* y,
           void* state, void* sc, void* cs_last, void* hin, int B, int S, int H, int G, int cl,
           const Strides& st, cudaStream_t s) {
  typedef Lay<P, N, std::is_same<In, float>::value> L;
  static bool attrs = false;  // dynamic shared memory above 48 KB, once
  if (!attrs) {
    cudaError_t e = cudaFuncSetAttribute(chunk_state_kernel<In, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::s1_bytes));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(chunk_scan_kernel<In, P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::s3_bytes));
    if (e != cudaSuccess) return e;
    attrs = true;
  }
  const int nc = (S + cl - 1) / cl, nt = (cl + T - 1) / T, hpg = H / G;
  const In *xp = static_cast<const In*>(x), *bp = static_cast<const In*>(b),
           *cp = static_cast<const In*>(c);
  const float *dai = static_cast<const float*>(da), *dti = static_cast<const float*>(dt);
  float* scf = static_cast<float*>(sc);
  chunk_state_kernel<In, P, N><<<dim3(nc, H, B), 2 * N, L::s1_bytes, s>>>(
      xp, bp, dai, dti, scf, static_cast<float*>(cs_last), S, H, hpg, cl, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 g2((N * P + 255) / 256, B * H);
  const float* dec = static_cast<const float*>(cs_last);
  bf16* hp = static_cast<bf16*>(hin);
  if (nc <= 8)
    state_pass_kernel<8><<<g2, 256, 0, s>>>(scf, dec, hp, static_cast<float*>(state), nc, N * P);
  else
    state_pass_kernel<32><<<g2, 256, 0, s>>>(scf, dec, hp, static_cast<float*>(state), nc, N * P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chunk_scan_kernel<In, P, N><<<dim3(nc, H, B * nt), SCAN_THREADS, L::s3_bytes, s>>>(
      xp, bp, cp, dai, dti, hp, static_cast<float*>(y), S, H, hpg, cl, st);
  return cudaGetLastError();
}

template <typename In>
int dispatch(const void* x, const void* b, const void* c, const void* da, const void* dt, void* y,
             void* state, void* sc, void* cs_last, void* hin, int B, int S, int H, int G, int P,
             int N, int cl, const Strides& st, cudaStream_t s) {
  if (P == 64 && N == 128)
    return launch<In, 64, 128>(x, b, c, da, dt, y, state, sc, cs_last, hin, B, S, H, G, cl, st,
                               s);
  if (P == 64 && N == 64)
    return launch<In, 64, 64>(x, b, c, da, dt, y, state, sc, cs_last, hin, B, S, H, G, cl, st,
                              s);
  if (P == 16 && N == 16)
    return launch<In, 16, 16>(x, b, c, da, dt, y, state, sc, cs_last, hin, B, S, H, G, cl, st,
                             s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [B,S,H,P]; b, c [B,S,G,N] (bf16 if in_bf16 else f32, last dim
// contiguous, rows 16-byte aligned); da, dt [B,S,H] f32; y [B,S,H,P] f32
// and state [B,H,N,P] f32, contiguous; scratch sc [B,H,nc,N,P] f32,
// cs_last [B,H,nc] f32 and hin [B,H,nc,2,N,P] bf16 with nc = ceil(S / cl).
// strides (elements): x b,s,h; b b,s,g; c b,s,g; da b,s,h; dt b,s,h — 15
// values. (P, N) is (64, 128) (Mamba2-2.7B), (64, 64) (Zamba2-7B) or
// (16, 16); 1 <= cl <= 256. Three launches on `stream`.
extern "C" int ssd_scan_fwd(const void* x, const void* b, const void* c, const void* da,
                            const void* dt, void* y, void* state, void* sc, void* cs_last,
                            void* hin, int B, int S, int H, int G, int P, int N, int cl,
                            int in_bf16, const long long* strides, void* stream) {
  if (cl < 1 || cl > MAXCL || G < 1 || H % G != 0 || S < 1 || B < 1) return cudaErrorInvalidValue;
  Strides st;
  long long* dst = &st.xb;
  for (int k = 0; k < 15; ++k) dst[k] = strides[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return dispatch<bf16>(x, b, c, da, dt, y, state, sc, cs_last, hin, B, S, H, G, P, N, cl,
                          st, s);
  return dispatch<float>(x, b, c, da, dt, y, state, sc, cs_last, hin, B, S, H, G, P, N, cl, st,
                         s);
}
