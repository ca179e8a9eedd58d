// One-token GQA decode attention over a ring-buffer KV cache.
//
// Replaces the Pallas kernel `flash_decode` (repro/kernels/flash_decode.py),
// with its interface generalised to what the serving engines hold: per-row
// positions pos [B] and slot positions slot_pos [B, W], and the caches read
// in place in the engine's [B, W, Hkv, D] layout. A slot is valid when
// 0 <= slot_pos <= pos (and slot_pos > pos - window when window > 0).
// Scale D^-0.5, mask -1e30, f32 online softmax, probabilities rounded to
// bf16 before the PV product, as the Pallas kernel does.
//
// What bounds it on an H100: the cache bytes (W=545 slots x 8 KV heads x
// 128 x 2 tensors x 2 B = 2.2 MB, under a microsecond at 3.35 TB/s). This
// first design runs one block of 4 warps per (KV head, batch row) serving
// its G query heads, so at B=1 only Hkv blocks are busy and the kernel is
// latency-bound; splitting W across blocks is the known next step. Per chunk
// of 128 slots: each warp scores whole slots (one coalesced 256-byte K row
// per warp, a shuffle reduction per head), one warp per head updates the
// running max and denominator, and each thread then owns one of the D
// output dimensions for the PV sum over the chunk (coalesced V rows).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int CH = 128;   // slots per chunk
constexpr int MAXG = 8;   // query heads per KV head

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ pos,
                        const int* __restrict__ slot_pos, bf16* __restrict__ o, int W, int G,
                        long long sqb, long long sqh, long long skb, long long skw,
                        long long skh, long long svb, long long svw, long long svh,
                        long long spb, long long sob, long long soh, int window, float scale) {
  constexpr int PER = D / 32;  // q / k elements per lane
  __shared__ float s_p[MAXG][CH];
  __shared__ float s_m[MAXG], s_l[MAXG], s_corr[MAXG];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = pos[b];
  const int* sp = slot_pos + b * spb;

  float qr[MAXG][PER];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < PER; ++e)
      qr[g][e] = g < G ? __bfloat162float(q[b * sqb + (hk * G + g) * sqh + lane * PER + e])
                       : 0.0f;
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.0f;
  if (tid < G) {
    s_m[tid] = KERNEL_NEG_INF;
    s_l[tid] = 0.0f;
  }

  const bf16* kb = k + b * skb + hk * skh;
  const bf16* vb = v + b * svb + hk * svh;
  for (int c0 = 0; c0 < W; c0 += CH) {
    const int n = min(CH, W - c0);
    // scores: warp-per-slot
    for (int j = warp; j < n; j += THREADS / 32) {
      const int s = sp[c0 + j];
      const bool ok = s >= 0 && s <= p && (window <= 0 || s > p - window);
      if (!ok) {  // warp-uniform: every lane read the same slot position
        if (lane < MAXG) s_p[lane][j] = KERNEL_NEG_INF;
        continue;
      }
      const bf16* kr = kb + (long long)(c0 + j) * skw + lane * PER;
      float kv[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) kv[e] = __bfloat162float(kr[e]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < PER; ++e) part += qr[g][e] * kv[e];
        part = warp_sum(part);
        if (lane == 0) s_p[g][j] = part * scale;
      }
    }
    __syncthreads();

    // running max / denominator, one warp per head; s_p becomes p (bf16-rounded)
    for (int g = warp; g < G; g += THREADS / 32) {
      float mx = KERNEL_NEG_INF;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s_p[g][j]);
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const float pj = expf(s_p[g][j] - m_new);
        sum += pj;
        s_p[g][j] = __bfloat162float(__float2bfloat16(pj));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_corr[g] = corr;
        s_l[g] = s_l[g] * corr + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    // PV: thread tid owns output dimension tid
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] *= s_corr[g];
      for (int j = 0; j < n; ++j) {
        const float vv = __bfloat162float(vb[(long long)(c0 + j) * svw + tid]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) acc[g] += s_p[g][j] * vv;
      }
    }
    __syncthreads();
  }

  if (tid < D) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G)
        o[b * sob + (hk * G + g) * soh + tid] = __float2bfloat16(acc[g] / fmaxf(s_l[g], 1e-20f));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* pos, const void* slot_pos,
           void* o, int B, int H, int Hkv, int W, const long long* st, int window, float scale,
           cudaStream_t s) {
  flash_decode_kernel<D><<<dim3(Hkv, B), THREADS, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(pos), static_cast<const int*>(slot_pos), static_cast<bf16*>(o), W,
      H / Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      window, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B,H,D]; k, v [B,W,Hkv,D]; pos [B] int32; slot_pos [B,W] int32; o [B,H,D].
// strides (elements): q b,h; k b,w,h; v b,w,h; slot_pos b; o b,h — 11 values
// (slot_pos may have batch stride 0). D must be 64 or 128 and H/Hkv <= 8.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, const void* pos,
                                const void* slot_pos, void* o, int B, int H, int Hkv, int W,
                                int D, const long long* strides, int window, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H / Hkv > MAXG) return cudaErrorInvalidValue;
  if (D == 128)
    return launch<128>(q, k, v, pos, slot_pos, o, B, H, Hkv, W, strides, window, scale, s);
  if (D == 64)
    return launch<64>(q, k, v, pos, slot_pos, o, B, H, Hkv, W, strides, window, scale, s);
  return cudaErrorInvalidValue;
}
