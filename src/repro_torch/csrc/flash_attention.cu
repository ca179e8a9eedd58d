// Causal / windowed GQA prefill attention with an online softmax.
//
// Replaces the Pallas kernel `flash_attention` (repro/kernels/flash_attention.py):
// scale D^-0.5, mask -1e30, f32 logits and running max / denominator, the
// probabilities rounded to bf16 before the PV product, and KV tiles that are
// fully masked (past the causal frontier or outside the window) skipped.
// Query head h reads KV head h / G.
//
// It reads the serving engine's layouts in place through strides: q and o
// [B, S, H, D], k and v [B, S, Hkv, D], the last dimension contiguous.
//
// What bounds it on an H100: at the serve shape (S=512, H=32, Hkv=8, D=128)
// causal attention is 2.1 GFLOP over 10.5 MB of q/k/v/o, a few microseconds
// at peak either way; the kernel is latency-bound by its tile loop. Design:
// one block of 4 warps per (64-query tile, head, batch row); each KV tile of
// 64 keys is staged in shared memory and each warp owns 16 query rows end to
// end (scores, softmax, output accumulator), so only the K/V staging needs
// block-wide barriers. QK^T and PV run on the tensor cores through wmma; the
// output accumulator lives in shared memory in f32 so that rows can be
// rescaled by the online-softmax correction.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 64;  // keys per tile
constexpr int THREADS = 128;
constexpr int SLD = BKV + 4;  // f32 score row stride
constexpr int PLD = BKV + 8;  // bf16 probability row stride

template <int D>
struct Layout {
  static constexpr int QLD = D + 8;  // bf16 row stride of Q/K/V tiles
  static constexpr int OLD = D + 4;  // f32 row stride of the accumulator
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * BQ * QLD;
  static constexpr size_t v = k + sizeof(bf16) * BKV * QLD;
  static constexpr size_t s = v + sizeof(bf16) * BKV * QLD;
  static constexpr size_t p = s + sizeof(float) * BQ * SLD;
  static constexpr size_t o = p + sizeof(bf16) * BQ * PLD;
  static constexpr size_t m = o + sizeof(float) * BQ * OLD;
  static constexpr size_t l = m + sizeof(float) * BQ;
  static constexpr size_t bytes = l + sizeof(float) * BQ;
};

// rows [0, 64) of a [S, D] slab (row stride ld) into shared memory; rows
// past S read as zeros
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld, int row0,
                                          int S) {
  constexpr int QLD = Layout<D>::QLD;
  for (int c = threadIdx.x; c < 64 * D / 8; c += THREADS) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < S) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * ld + col);
    *reinterpret_cast<uint4*>(dst + r * QLD + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int S, int G,
                      long long sqb, long long sqs, long long sqh, long long skb, long long sks,
                      long long skh, long long svb, long long svs, long long svh, long long sob,
                      long long sos, long long soh, int causal, int window, float scale) {
  typedef Layout<D> Lay;
  constexpr int QLD = Lay::QLD, OLD = Lay::OLD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Lay::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Lay::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Lay::v);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + Lay::p);
  float* Os = reinterpret_cast<float*>(smem + Lay::o);
  float* Ms = reinterpret_cast<float*>(smem + Lay::m);
  float* Ls = reinterpret_cast<float*>(smem + Lay::l);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + hk * skh;
  const bf16* vb = v + b * svb + hk * svh;

  load_tile<D>(Qs, qb, sqs, q0, S);
  for (int i = tid; i < BQ * OLD; i += THREADS) Os[i] = 0.0f;
  if (tid < BQ) {
    Ms[tid] = KERNEL_NEG_INF;
    Ls[tid] = 0.0f;
  }

  // live KV tiles: up to the causal frontier of the tile's last query, and
  // from the first key its first query can see through the window
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int row0 = warp * 16;

  for (int t = kv_begin / BKV; t * BKV < kv_end; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // previous tile fully consumed (and Q/O/M/L initialised)
    load_tile<D>(Ks, kb, sks, k0, S);
    load_tile<D>(Vs, vb, svs, k0, S);
    __syncthreads();

    // scores of this warp's 16 rows against the 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BKV / 16];
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(sf[j], 0.0f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
        wmma::load_matrix_sync(qa, Qs + row0 * QLD + kk, QLD);
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, Ks + (j * 16) * QLD + kk, QLD);
          wmma::mma_sync(sf[j], qa, kf, sf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j)
        wmma::store_matrix_sync(Ss + row0 * SLD + j * 16, sf[j], SLD, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this warp's rows; lane handles keys lane, lane+32
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r, qi = q0 + row;
      float sv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ki = k0 + lane + 32 * c;
        bool ok = ki < S;
        if (causal) ok = ok && ki <= qi;
        if (window > 0) ok = ok && ki > qi - window;
        sv[c] = ok ? Ss[row * SLD + lane + 32 * c] * scale : KERNEL_NEG_INF;
      }
      const float m_old = Ms[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(sv[0], sv[1])));
      const float p0 = expf(sv[0] - m_new), p1 = expf(sv[1] - m_new);
      Ps[row * PLD + lane] = __float2bfloat16(p0);
      Ps[row * PLD + lane + 32] = __float2bfloat16(p1);
      const float sum = warp_sum(p0 + p1);
      const float corr = expf(m_old - m_new);
      for (int c = lane; c < D; c += 32) Os[row * OLD + c] *= corr;
      __syncwarp();
      if (lane == 0) {
        Ms[row] = m_new;
        Ls[row] = Ls[row] * corr + sum;
      }
    }
    __syncwarp();

    // O[rows] += P[rows] @ V
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, Os + row0 * OLD + j * 16, OLD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pa, Ps + row0 * PLD + kk, PLD);
        wmma::load_matrix_sync(vf, Vs + kk * QLD + j * 16, QLD);
        wmma::mma_sync(of, pa, vf, of);
      }
      wmma::store_matrix_sync(Os + row0 * OLD + j * 16, of, OLD, wmma::mem_row_major);
    }
  }
  __syncwarp();

  bf16* ob = o + b * sob + h * soh;
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r, qi = q0 + row;
    if (qi >= S) break;
    const float denom = fmaxf(Ls[row], 1e-20f);
    for (int c = lane; c < D; c += 32)
      ob[qi * sos + c] = __float2bfloat16(Os[row * OLD + c] / denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int Hkv,
           const long long* st, int causal, int window, float scale, cudaStream_t s) {
  const size_t bytes = Layout<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(flash_attn_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attn_kernel<D><<<grid, THREADS, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, H / Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], causal, window, scale);
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
