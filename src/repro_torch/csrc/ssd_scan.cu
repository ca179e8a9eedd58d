// Mamba2 SSD chunked scan (arXiv:2405.21060).
//
// Replaces the Pallas kernel `ssd_scan` (repro/kernels/ssd_scan.py), with its
// interface generalised to the model's layout: x [B,S,H,P], b / c [B,S,G,N]
// read through strides by head h as group h / (H/G) (Mamba2 has G = 1, so a
// repeated copy would read B and C H times), da / dt [B,S,H] f32; it writes
// y [B,S,H,P] f32 and the final state [B,H,N,P] f32 that decode continues
// from. Per (b, h), over chunks of cl rows in order, with h zero at first:
//   cs = cumsum(da);  y = ((C B^T) o L o dt^T) x + exp(cs) o (C h_in),
//   L_ij = exp(cs_i - cs_j) for i >= j else 0;
//   h_out = exp(cs_last) h_in + sum_j exp(cs_last - cs_j) dt_j B_j x_j^T.
// Arithmetic is f32 on the CUDA cores, as the Pallas kernel's f32 dots.
//
// What bounds it on an H100: operations. At Mamba2-2.7B's prefill (B=1,
// S=2048, H=80, P=64, N=128) the least work that yields y and the state is
// the recurrence, one row per chunk: per token and head C_t.B_t, its product
// with x_t, the state update and the incoming-state term, 5.4 GFLOP, 0.081 ms
// at 67 TFLOP/s f32, against 0.02 ms for its 68 MB of bytes at 3.35 TB/s.
// The chunked form at cl=256 does 13.1 GFLOP (it adds the masked lower
// triangle of C B^T and of its product with x) so that its products are
// 64x64 tiles that reuse every staged operand 64 times.
//
// Design. The Pallas grid runs chunks in order with the state in VMEM; on
// Hopper nothing carries between blocks, so one block of 256 threads per
// (b, h) walks its chunks in a loop and keeps the [N,P] state in shared
// memory (80 blocks on 132 SMs at B=1). A chunk is cut into 64-row tiles:
// for each output tile i the block stages C_i, then for each j <= i the
// tiles B_j and x_j (converted to f32 on the load; rows past S or past the
// chunk load as zeros, with dt = da = 0), forms the 64x64 tile of C B^T,
// applies the decay mask by select (exp may be inf above the diagonal),
// and accumulates its product with x_j in registers; tiles above the
// diagonal are never computed. Each thread owns a 4x4 block of a 64x64
// tile and reads its operands as float4 rows of padded row-major tiles.
// Staging a whole 256-row chunk in f32 would need 320 KB (x 64 + B 128 +
// C 128) of the 227 KB a block may have; the tiles need 137 KB.
// Known next steps: split the chunks of one head over blocks (chunk states
// in parallel, then a short scan over them) to fill all SMs, double-buffer
// the tile loads, and tensor cores (their own tolerance).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr int T = 64;         // rows of a tile (i and j)
constexpr int MAXCL = 256;    // longest chunk

struct Strides {  // elements
  long long xb, xs, xh, bb, bs, bg, cb, cs, cg, ab, as, ah, tb, ts, th;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <int K>
__device__ __forceinline__ void ld(float (&dst)[K], const float* src) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + k);
      dst[k] = v.x, dst[k + 1] = v.y, dst[k + 2] = v.z, dst[k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k] = src[k];
  }
}

// rows [r0, r0 + T) of a [S, W] matrix (row stride rs) into dst [T][ld] f32;
// rows at or past `valid` load as zeros
template <typename In, int W>
__device__ __forceinline__ void load_tile(float* dst, int ld, const In* src, long long rs,
                                          int valid) {
  for (int e = threadIdx.x; e < T * W; e += THREADS) {
    const int i = e / W, k = e % W;
    dst[i * ld + k] = i < valid ? to_f(src[i * rs + k]) : 0.0f;
  }
}

template <typename In, int P, int N>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const In* __restrict__ x, const In* __restrict__ b, const In* __restrict__ c,
                    const float* __restrict__ da, const float* __restrict__ dt,
                    float* __restrict__ y, float* __restrict__ state, int S, int H, int hpg,
                    int cl, Strides st) {
  constexpr int LDN = N + 4, LDG = T + 4;  // padded rows, still 16-byte aligned
  constexpr int PC = P / 16, NR = N / 16;  // columns / state rows per thread
  extern __shared__ __align__(16) float smem[];
  float* sH = smem;              // [N][P]  carried state
  float* sC = sH + N * P;        // [T][LDN] C_i
  float* sB = sC + T * LDN;      // [T][LDN] B_j
  float* sX = sB + T * LDN;      // [T][P]   x_j
  float* sG = sX + T * P;        // [T][LDG] masked (C B^T) tile
  float* sCs = sG + T * LDG;     // [MAXCL]  cumsum(da)
  float* sDt = sCs + MAXCL;      // [MAXCL]
  float* sDec = sDt + MAXCL;     // [MAXCL]  exp(cs_last - cs_j) dt_j

  const int h = blockIdx.x, bi = blockIdx.y, g = h / hpg;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const In* xg = x + bi * st.xb + h * st.xh;
  const In* bg = b + bi * st.bb + g * st.bg;
  const In* cg = c + bi * st.cb + g * st.cg;
  const float* dag = da + bi * st.ab + h * st.ah;
  const float* dtg = dt + bi * st.tb + h * st.th;
  float* yg = y + ((long long)bi * S * H + h) * P;

  for (int e = tid; e < N * P; e += THREADS) sH[e] = 0.0f;

  const int nc = (S + cl - 1) / cl;
  for (int ci = 0; ci < nc; ++ci) {
    const int s0 = ci * cl;
    const int r = min(cl, S - s0);  // rows of this chunk inside S
    const int nt = (r + T - 1) / T;

    // cumsum(da) over the chunk (one warp), dt, and the state-update weights
    for (int i = tid; i < MAXCL; i += THREADS) {
      const bool ok = i < r;
      sCs[i] = ok ? dag[(long long)(s0 + i) * st.as] : 0.0f;
      sDt[i] = ok ? dtg[(long long)(s0 + i) * st.ts] : 0.0f;
    }
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
    const float cs_last = sCs[r - 1];
    for (int i = tid; i < MAXCL; i += THREADS) sDec[i] = expf(cs_last - sCs[i]) * sDt[i];

    // output tiles: y_i = exp(cs_i) (C_i h_in) + sum_{j <= i} (C_i B_j^T o L o dt) x_j
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * T;
      load_tile<In, N>(sC, LDN, cg + (long long)(s0 + i0) * st.cs, st.cs, r - i0);
      __syncthreads();
      float acc[4][PC] = {};
      if (ci > 0) {  // the incoming state is zero in the first chunk
#pragma unroll 2
        for (int n = 0; n < N; n += 4) {
          float cv[4][4], hv[4][PC];
#pragma unroll
          for (int a = 0; a < 4; ++a) ld(cv[a], sC + (ty * 4 + a) * LDN + n);
#pragma unroll
          for (int k = 0; k < 4; ++k) ld(hv[k], sH + (n + k) * P + tx * PC);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int q = 0; q < PC; ++q) acc[a][q] += cv[a][k] * hv[k][q];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float e = expf(sCs[i0 + ty * 4 + a]);
#pragma unroll
          for (int q = 0; q < PC; ++q) acc[a][q] *= e;
        }
      }
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * T;
        load_tile<In, N>(sB, LDN, bg + (long long)(s0 + j0) * st.bs, st.bs, r - j0);
        load_tile<In, P>(sX, P, xg + (long long)(s0 + j0) * st.xs, st.xs, r - j0);
        __syncthreads();
        float gm[4][4] = {};
#pragma unroll 2
        for (int n = 0; n < N; n += 4) {
          float cv[4][4], bv[4][4];
#pragma unroll
          for (int a = 0; a < 4; ++a) ld(cv[a], sC + (ty * 4 + a) * LDN + n);
#pragma unroll
          for (int q = 0; q < 4; ++q) ld(bv[q], sB + (tx * 4 + q) * LDN + n);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int k = 0; k < 4; ++k) gm[a][q] += cv[a][k] * bv[q][k];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty * 4 + a;
          float out[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tx * 4 + q;
            // select, never multiply: above the diagonal exp may be inf
            out[q] = i >= j ? gm[a][q] * expf(sCs[i] - sCs[j]) * sDt[j] : 0.0f;
          }
          *reinterpret_cast<float4*>(sG + (ty * 4 + a) * LDG + tx * 4) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
        __syncthreads();
#pragma unroll 2
        for (int j = 0; j < T; j += 4) {
          float gv[4][4], xv[4][PC];
#pragma unroll
          for (int a = 0; a < 4; ++a) ld(gv[a], sG + (ty * 4 + a) * LDG + j);
#pragma unroll
          for (int k = 0; k < 4; ++k) ld(xv[k], sX + (j + k) * P + tx * PC);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int q = 0; q < PC; ++q) acc[a][q] += gv[a][k] * xv[k][q];
        }
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty * 4 + a;
        if (i < r) {
          float* yr = yg + (long long)(s0 + i) * H * P + tx * PC;
#pragma unroll
          for (int q = 0; q < PC; ++q) yr[q] = acc[a][q];
        }
      }
    }

    // state update: h = exp(cs_last) h + sum_j B_j^T (exp(cs_last - cs_j) dt_j x_j)
    float hacc[NR][PC] = {};
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * T;
      load_tile<In, N>(sB, LDN, bg + (long long)(s0 + j0) * st.bs, st.bs, r - j0);
      load_tile<In, P>(sX, P, xg + (long long)(s0 + j0) * st.xs, st.xs, r - j0);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < T; ++j) {
        float bv[NR], xv[PC];
        ld(bv, sB + j * LDN + ty * NR);
        ld(xv, sX + j * P + tx * PC);
        const float w = sDec[j0 + j];
#pragma unroll
        for (int q = 0; q < PC; ++q) xv[q] *= w;
#pragma unroll
        for (int a = 0; a < NR; ++a)
#pragma unroll
          for (int q = 0; q < PC; ++q) hacc[a][q] += bv[a] * xv[q];
      }
      __syncthreads();
    }
    const float decay = expf(cs_last);
#pragma unroll
    for (int a = 0; a < NR; ++a)
#pragma unroll
      for (int q = 0; q < PC; ++q) {
        float* hp = sH + (ty * NR + a) * P + tx * PC + q;
        *hp = decay * *hp + hacc[a][q];
      }
    __syncthreads();
  }

  float* sg = state + ((long long)bi * H + h) * N * P;
  for (int e = tid; e < N * P; e += THREADS) sg[e] = sH[e];
}

template <typename In, int P, int N>
int launch(const void* x, const void* b, const void* c, const void* da, const void* dt, void* y,
           void* state, int B, int S, int H, int G, int cl, const Strides& st, cudaStream_t s) {
  constexpr size_t smem =
      sizeof(float) * (N * P + 2 * T * (N + 4) + T * P + T * (T + 4) + 3 * MAXCL);
  cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel<In, P, N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  ssd_scan_kernel<In, P, N><<<dim3(H, B), THREADS, smem, s>>>(
      static_cast<const In*>(x), static_cast<const In*>(b), static_cast<const In*>(c),
      static_cast<const float*>(da), static_cast<const float*>(dt), static_cast<float*>(y),
      static_cast<float*>(state), S, H, H / G, cl, st);
  return cudaGetLastError();
}

template <typename In>
int dispatch(const void* x, const void* b, const void* c, const void* da, const void* dt, void* y,
             void* state, int B, int S, int H, int G, int P, int N, int cl, const Strides& st,
             cudaStream_t s) {
  if (P == 64 && N == 128)
    return launch<In, 64, 128>(x, b, c, da, dt, y, state, B, S, H, G, cl, st, s);
  if (P == 16 && N == 16)
    return launch<In, 16, 16>(x, b, c, da, dt, y, state, B, S, H, G, cl, st, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [B,S,H,P]; b, c [B,S,G,N] (bf16 if in_bf16 else f32, last dim
// contiguous); da, dt [B,S,H] f32; y [B,S,H,P] f32 and state [B,H,N,P] f32,
// contiguous. strides (elements): x b,s,h; b b,s,g; c b,s,g; da b,s,h;
// dt b,s,h — 15 values. (P, N) is (64, 128) or (16, 16); 1 <= cl <= 256.
extern "C" int ssd_scan_fwd(const void* x, const void* b, const void* c, const void* da,
                            const void* dt, void* y, void* state, int B, int S, int H, int G,
                            int P, int N, int cl, int in_bf16, const long long* strides,
                            void* stream) {
  if (cl < 1 || cl > MAXCL || G < 1 || H % G != 0 || S < 1) return cudaErrorInvalidValue;
  Strides st;
  long long* dst = &st.xb;
  for (int k = 0; k < 15; ++k) dst[k] = strides[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) return dispatch<bf16>(x, b, c, da, dt, y, state, B, S, H, G, P, N, cl, st, s);
  return dispatch<float>(x, b, c, da, dt, y, state, B, S, H, G, P, N, cl, st, s);
}
