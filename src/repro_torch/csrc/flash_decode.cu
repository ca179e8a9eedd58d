// One-token GQA decode attention over a ring-buffer KV cache, split over the
// cache slots (flash-decoding).
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
// What bounds it on an H100: the cache bytes (W=545 slots x 8 KV heads x
// 128 x 2 tensors x 2 B = 2.2 MB, under a microsecond at 3.35 TB/s), so the
// card has to be filled with blocks even at B=1, and each block's copies
// have to be in flight together. Two launches:
//   - split: grid (Hkv, n_split, B). Each block takes one contiguous range of
//     at most 64 slots (the host picks n_split: kernels/flash_decode.py
//     `n_splits`) for one KV head and serves its G query heads (register
//     arrays sized by G rounded up to a power of two). The range's K rows
//     and V rows are issued at once through a cp.async double buffer, 16
//     bytes a lane, D / 8 lanes to a row, so a warp reads whole rows of
//     several slots at once. Scores of all G heads are reduced over a row's
//     lanes by a reduce-scatter (log2(D/8) shuffle steps for all heads),
//     kept in shared memory, and turned into p = exp(s - m) rounded to bf16
//     with the range's own max m. The PV sum runs over the staged V rows in
//     f32 registers and is summed across the block's slot groups. The block
//     writes its partial (m, l, acc[G][D]).
//   - combine: one block per (b, query head), D x 4 threads each taking a
//     quarter of the ranges, rescales the partials by exp(m_i - m) and
//     divides by max(l, 1e-20). A range with no valid slot has m = -1e30 and weight 0 beside any range
//     that has one; if no range has one, every p is 1, as in the plain
//     version (the mean of V).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAXG = 8;        // query heads per KV head
constexpr int CH = 64;         // slots per staged chunk
constexpr int MAX_SPLIT = 64;  // slots per block (kernels/flash_decode.py MAX_SPLIT_SLOTS)
constexpr float LOG2E = 1.4426950408889634f;

template <int D, int GP>
struct Dec {
  static constexpr int LPS = D / 8;        // lanes per slot row, 16 bytes each
  static constexpr int NG = THREADS / LPS; // slot groups in the block
  static constexpr int STAGE = CH * D;     // bf16 of one staged chunk
  static constexpr int RED = NG * GP * D;  // f32 of the cross-group sum
  static constexpr int BUF_BYTES = 2 * STAGE * 2 > RED * 4 ? 2 * STAGE * 2 : RED * 4;
};

// Sum the GP per-lane partial dot products v[] over the LPS lanes of a slot
// row. On return v[0] holds the full sum for head sub / (LPS / GP).
template <int LPS, int GP>
__device__ __forceinline__ float reduce_scatter(float (&v)[GP], int sub) {
  int cnt = GP;
#pragma unroll
  for (int w = LPS / 2; w >= 1; w /= 2) {
    if (cnt > 1) {
      const bool hi = (sub & w) != 0;
      const int half = cnt / 2;
#pragma unroll
      for (int i = 0; i < GP / 2; ++i) {
        if (i < half) {
          const float send = hi ? v[i] : v[i + half];
          const float keep = hi ? v[i + half] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, w);
        }
      }
      cnt = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], w);
    }
  }
  return v[0];
}

__device__ __forceinline__ void unpack8(uint4 raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// GP: G rounded up to a power of two, the register arrays' size
template <int D, int GP>
__global__ void __launch_bounds__(THREADS)
    decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ pos,
                        const int* __restrict__ slot_pos, float* __restrict__ part,
                        float* __restrict__ stats, int W, int G, int n_split, long long sqb,
                        long long sqh, long long skb, long long skw, long long skh, long long svb,
                        long long svw, long long svh, long long spb, int window, float scale_log2) {
  typedef Dec<D, GP> C;
  constexpr int LPS = C::LPS, NG = C::NG;
  __shared__ __align__(16) unsigned char buf[C::BUF_BYTES];  // staged chunks, then the sum
  __shared__ float s_p[GP][MAX_SPLIT];                       // scores, then bf16-rounded p
  bf16* stage_buf = reinterpret_cast<bf16*>(buf);

  const int hk = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int w0 = (int)((long long)split * W / n_split);
  const int L = (int)((long long)(split + 1) * W / n_split) - w0;
  const int nc = (L + CH - 1) / CH;
  const int tid = threadIdx.x, grp = tid / LPS, sub = tid % LPS, col = sub * 8;
  const int p = pos[b];
  const int* sp = slot_pos + b * spb + w0;
  const bf16* kb = k + b * skb + hk * skh + (long long)w0 * skw;
  const bf16* vb = v + b * svb + hk * svh + (long long)w0 * svw;

  // chunk c < nc is K's chunk c, chunk c >= nc is V's chunk c - nc
  auto stage = [&](int c) {
    const bool is_k = c < nc;
    const bf16* src = is_k ? kb : vb;
    const long long sw = is_k ? skw : svw;
    const int j0 = (is_k ? c : c - nc) * CH, n = min(CH, L - j0);
    bf16* dst = stage_buf + (c & 1) * C::STAGE;
    for (int i = tid; i < n * LPS; i += THREADS) {
      const int j = i / LPS, e = (i % LPS) * 8;
      cp_async16(dst + j * D + e, src + (j0 + j) * sw + e, true);
    }
    cp_async_commit();
  };
  stage(0);

  float qr[GP][8];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < G) {
      unpack8(*reinterpret_cast<const uint4*>(q + b * sqb + (hk * G + g) * sqh + col), qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] = 0.0f;
    }
  }
  float acc[GP][8];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.0f;
  const int head = sub / (LPS / GP);  // the head whose score this lane ends with

  for (int c = 0; c < 2 * nc; ++c) {
    if (c + 1 < 2 * nc) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cur = stage_buf + (c & 1) * C::STAGE;

    if (c < nc) {
      // scores; every lane takes part in every shuffle
      const int j0 = c * CH, n = min(CH, L - j0);
      for (int jb = 0; jb < n; jb += NG) {
        const int j = jb + grp;
        float kv[8], dg[GP];
        if (j < n) {
          unpack8(*reinterpret_cast<const uint4*>(cur + j * D + col), kv);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) kv[e] = 0.0f;
        }
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float s = 0.0f;
#pragma unroll
          for (int e = 0; e < 8; ++e) s += qr[g][e] * kv[e];
          dg[g] = s;
        }
        const float dot = reduce_scatter<LPS, GP>(dg, sub);
        if (j < n && head < G && sub % (LPS / GP) == 0) {
          const int s = sp[j0 + j];
          const bool ok = s >= 0 && s <= p && (window <= 0 || s > p - window);
          s_p[head][j0 + j] = ok ? dot * scale_log2 : KERNEL_NEG_INF;
        }
      }
    } else {
      if (c == nc) {
        // the range's softmax: one warp per head; s_p becomes p rounded to bf16
        for (int g = tid / 32; g < G; g += THREADS / 32) {
          const int lane = tid % 32;
          float mx = KERNEL_NEG_INF;
          for (int j = lane; j < L; j += 32) mx = fmaxf(mx, s_p[g][j]);
          mx = warp_max(mx);
          float sum = 0.0f;
          for (int j = lane; j < L; j += 32) {
            const float pj = exp2f(s_p[g][j] - mx);
            sum += pj;
            s_p[g][j] = __bfloat162float(__float2bfloat16(pj));
          }
          sum = warp_sum(sum);
          if (lane == 0) {
            float* st = stats + ((((long long)b * gridDim.x + hk) * n_split + split) * G + g) * 2;
            st[0] = mx;
            st[1] = sum;
          }
        }
        __syncthreads();
      }
      // PV over this chunk's rows: slot group grp takes rows grp, grp + NG, ...
      const int j0 = (c - nc) * CH, n = min(CH, L - j0);
      for (int j = grp; j < n; j += NG) {
        float vv[8];
        unpack8(*reinterpret_cast<const uint4*>(cur + j * D + col), vv);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          if (g < G) {
            const float pj = s_p[g][j0 + j];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] += pj * vv[e];
          }
        }
      }
    }
    __syncthreads();  // the buffer is free for the chunk after next
  }

  // sum the slot groups' partial PV and write acc[G][D]
  float* red = reinterpret_cast<float*>(buf);
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < G) {
      float4* dst = reinterpret_cast<float4*>(red + (grp * GP + g) * D + col);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  __syncthreads();
  float* out = part + (((long long)b * gridDim.x + hk) * n_split + split) * G * D;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < NG; ++r) s += red[(r * GP + g) * D + d];
    out[i] = s;
  }
}

constexpr int CS = 4;  // range groups of the combine: a block has D x CS threads

// one block per (query head, batch row): thread (d, c) sums column d over
// ranges c, c + CS, ...
template <int D>
__global__ void __launch_bounds__(D * CS)
    decode_combine_kernel(const float* __restrict__ part, const float* __restrict__ stats,
                          bf16* __restrict__ o, int Hkv, int G, int n_split, long long sob,
                          long long soh) {
  __shared__ float s_max[D * CS / 32], s_l[CS], s_acc[CS][D];
  const int h = blockIdx.x, b = blockIdx.y, hk = h / G, g = h % G;
  const int tid = threadIdx.x, d = tid % D, c = tid / D;
  const float* st = stats + (((long long)b * Hkv + hk) * n_split * G + g) * 2;  // range i at 2 G i
  const float* pa = part + (((long long)b * Hkv + hk) * n_split * G + g) * D + d;  // at G D i
  float m = KERNEL_NEG_INF;
  for (int i = tid; i < n_split; i += D * CS) m = fmaxf(m, st[2 * G * i]);
  m = warp_max(m);
  if (tid % 32 == 0) s_max[tid / 32] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < D * CS / 32; ++w) m = fmaxf(m, s_max[w]);
  float l = 0.0f, acc = 0.0f;
#pragma unroll 8
  for (int i = c; i < n_split; i += CS) {
    const float w = exp2f(st[2 * G * i] - m);
    l += st[2 * G * i + 1] * w;
    acc += pa[(long long)G * D * i] * w;
  }
  s_acc[c][d] = acc;
  if (d == 0) s_l[c] = l;
  __syncthreads();
  if (c == 0) {
    float sum = 0.0f, den = 0.0f;
#pragma unroll
    for (int k = 0; k < CS; ++k) {
      sum += s_acc[k][d];
      den += s_l[k];
    }
    o[b * sob + h * soh + d] = __float2bfloat16(sum / fmaxf(den, 1e-20f));
  }
}

template <int D, int GP>
void launch_split(const void* q, const void* k, const void* v, const void* pos,
                  const void* slot_pos, float* part, float* stats, int B, int Hkv, int W, int G,
                  const long long* st, int window, float scale, int n_split, cudaStream_t s) {
  decode_split_kernel<D, GP><<<dim3(Hkv, n_split, B), THREADS, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(pos), static_cast<const int*>(slot_pos), part, stats, W, G, n_split,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], window, scale * LOG2E);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* pos, const void* slot_pos,
           void* o, float* scratch, int B, int H, int Hkv, int W, const long long* st,
           int window, float scale, int n_split, cudaStream_t s) {
  const int G = H / Hkv;
  float* part = scratch;
  float* stats = scratch + (long long)B * Hkv * n_split * G * D;
  if (G == 1)
    launch_split<D, 1>(q, k, v, pos, slot_pos, part, stats, B, Hkv, W, G, st, window, scale, n_split, s);
  else if (G == 2)
    launch_split<D, 2>(q, k, v, pos, slot_pos, part, stats, B, Hkv, W, G, st, window, scale, n_split, s);
  else if (G <= 4)
    launch_split<D, 4>(q, k, v, pos, slot_pos, part, stats, B, Hkv, W, G, st, window, scale, n_split, s);
  else
    launch_split<D, 8>(q, k, v, pos, slot_pos, part, stats, B, Hkv, W, G, st, window, scale, n_split, s);
  decode_combine_kernel<D><<<dim3(H, B), D * CS, 0, s>>>(part, stats, static_cast<bf16*>(o), Hkv,
                                                         G, n_split, st[9], st[10]);
  return cudaGetLastError();
}

}  // namespace

// q [B,H,D]; k, v [B,W,Hkv,D]; pos [B] int32; slot_pos [B,W] int32; o [B,H,D];
// scratch: B*Hkv*n_split*G*(D + 2) floats (partial acc, then (m, l) pairs).
// strides (elements): q b,h; k b,w,h; v b,w,h; slot_pos b; o b,h — 11 values
// (slot_pos may have batch stride 0). D must be 64 or 128, H/Hkv <= 8, the
// q/k/v pointers and strides 16-byte aligned, and ceil(W / n_split) <= 64.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, const void* pos,
                                const void* slot_pos, void* o, void* scratch, int B, int H,
                                int Hkv, int W, int D, const long long* strides, int window,
                                float scale, int n_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H / Hkv > MAXG || n_split < 1 || (W + n_split - 1) / n_split > MAX_SPLIT)
    return cudaErrorInvalidValue;
  float* f = static_cast<float*>(scratch);
  if (D == 128)
    return launch<128>(q, k, v, pos, slot_pos, o, f, B, H, Hkv, W, strides, window, scale,
                       n_split, s);
  if (D == 64)
    return launch<64>(q, k, v, pos, slot_pos, o, f, B, H, Hkv, W, strides, window, scale,
                      n_split, s);
  return cudaErrorInvalidValue;
}
