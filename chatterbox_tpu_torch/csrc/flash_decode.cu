// K1 and K2: single-token decode attention over the T3 KV cache, and the
// writes of one step's K/V into that cache.
//
// K1 replaces chatterbox_tpu/ops/flash_decode.py::flash_decode_layer_attention
// (Pallas _kernel, flash_decode.py:54-270), in three variants:
//   a  (flash_decode_kernel<T, false>): bf16 cache, no stats;
//   b  (flash_decode_kernel<T, true>): a, plus the final softmax stats (m, l)
//      of each (row, head) (Pallas return_stats, flash_decode.py:260-270);
//   c+d (flash_decode_int8_kernel<T>): the int8 cache with per-token K/V
//      scales below merge_base, and the tail of the most recent tokens in the
//      working dtype from merge_base to cur_len (flash_decode.py:109-140,
//      204-256).
// K2 replaces chatterbox_tpu/ops/flash_decode.py::flash_cache_merge_ds
// (Pallas _merge_kernel, flash_decode.py:273-353), in two variants:
//   K2  (kv_append_kernel): one step's K/V copied into one slot of every
//       layer: the bf16 cache's per-step write, and the int8 path's append
//       to its tail;
//   K2b (kv_quantize_kernel<T>): n tokens per (layer, k/v, row, head)
//       quantized to int8 with one fp32 scale each and written in place: the
//       prefill's s0 tokens, and every 8th step the full tail (the XLA
//       quantize_kv plus the int8 column merge, llama.py:632-646).
//
// Cache layout: (L, 2, B, H, S, D), contiguous, K plane then V plane per
// layer; int8 scales (L, 2, B, H, S) fp32; the tail (L, 2, B, H, W, D). The
// TPU kernel's (D, S) layout existed for the TPU's lane tiling; here a
// slot's D values are one contiguous row. The tail keeps its TPU purpose
// in part only: it holds the last < W tokens exact until they are quantized
// W at a time, so the int8 path matches the JAX package's arithmetic.
//
// K1 -- what bounds it: bytes. Each (row, head) reads its live K and V rows
// once (2 * cur_len * D elements, 1 byte each below merge_base on the int8
// path, plus 8 bytes of scales per slot) and does 4 flops per element, far
// below Hopper's ~295 flop/byte bf16 ridge. Design: one 128-thread block per
// (row, head) of layer `layer`, addressed by strides into the full cache (no
// copy). The block walks the live slots in tiles of 128, one slot per thread
// for the q.k dot (16-byte loads of the K row: 8 bf16 or 16 int8 values), an
// fp32 online softmax seeded with the current token's self-logit, and a
// dim-parallel pass over the V rows whose probability is non-zero. On the
// int8 path the K scale multiplies the logit and the V scale the
// probability, as the Pallas kernel folds them (flash_decode.py:231-243), so
// no dequantized row is formed; the tail is one more tile, read exact.
// Slots that are invalid (the text-padding gap) or at/after cur_len are
// never read. Only B*H blocks exist (2*batch*16 at full width): at small
// batch the card is under-filled and each block streams its rows serially.
// Splitting S across blocks (flash-decoding), wgmma and TMA are queued for a
// later PR. Variant b writes two floats more per block and is launched at
// the alignment layer only. The main path runs K1 in bf16; the float
// instantiations serve one check: chip_smoke.py's reference phase runs a
// small T3 in fp32 on the card and requires its tokens to equal the CPU's
// exactly, which a bf16 cache cannot promise.
//
// K2 -- what bounds it: bytes (L*2*B*H*D elements read and written once).
// Design: one thread per 16-byte vector of the (L, 2, B, H, D) new K/V,
// written to slot `pos` of the matching cache (or tail) row: one launch per
// decode step for all layers.
//
// K2b -- what bounds it: bytes (n tokens read in the working dtype, written
// as int8 plus one fp32 scale). Design: one warp per (layer, k/v, row, head,
// token): the absmax over D by shuffle, scale = max(absmax * f32(1/127),
// 1e-8) (the multiply XLA makes of quantize_kv's division by the constant
// 127 when it compiles the decode loop), and q = clamp(rint(x / scale), -127,
// 127), where x / scale is an IEEE division (nvcc's default -prec-div=true;
// not a multiply by a reciprocal) and rintf rounds ties to even: the result
// is bit-exact with quantize_kv as the JAX package runs it.

#include "common.cuh"

namespace {

constexpr int DEC_THREADS = 128;
constexpr int DEC_MAX_D = 128;

// q.k for one cache row held in shared memory as fp32; 16-byte loads.
template <typename T>
__device__ __forceinline__ float dot_row(const T* __restrict__ row, const float* q_s, int D) {
  float acc = 0.f;
  const uint4* r = reinterpret_cast<const uint4*>(row);
  if constexpr (std::is_same<T, bf16>::value) {
    for (int c = 0; c < D / 8; ++c) {
      uint4 u = r[c];
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __bfloat1622float2(h2[j]);
        acc += f.x * q_s[c * 8 + 2 * j] + f.y * q_s[c * 8 + 2 * j + 1];
      }
    }
  } else {
    for (int c = 0; c < D / 4; ++c) {
      uint4 u = r[c];
      const float* f = reinterpret_cast<const float*>(&u);
      acc += f[0] * q_s[c * 4] + f[1] * q_s[c * 4 + 1] + f[2] * q_s[c * 4 + 2] +
             f[3] * q_s[c * 4 + 3];
    }
  }
  return acc;
}

// q.k8 for one int8 cache row (D % 16 == 0); 16-byte loads. The scale is
// applied by the caller.
__device__ __forceinline__ float dot_row_i8(const int8_t* __restrict__ row, const float* q_s,
                                            int D) {
  float acc = 0.f;
  const uint4* r = reinterpret_cast<const uint4*>(row);
  for (int c = 0; c < D / 16; ++c) {
    uint4 u = r[c];
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int j = 0; j < 16; ++j) acc += static_cast<float>(b[j]) * q_s[c * 16 + j];
  }
  return acc;
}

// The block's online softmax: every thread holds the same running max m (of
// the scaled logits) and sum l = sum exp(logit - m); thread d < D holds the
// accumulator of output dim d.
struct Softmax {
  float m, l, acc;
};

// Load q into shared memory and seed the softmax with the current token's
// self-logit: m = q.k_new * scale, l = 1, acc = v_new.
template <typename T>
__device__ __forceinline__ Softmax seed_self(const T* __restrict__ q, const T* __restrict__ k_new,
                                             const T* __restrict__ v_new, long long vec, int D,
                                             float scale, float* q_s, float* red_s) {
  const int tid = threadIdx.x;
  if (tid < D) q_s[tid] = to_float(q[vec + tid]);
  __syncthreads();
  const float self = block_sum<DEC_THREADS>(
      tid < D ? q_s[tid] * to_float(k_new[vec + tid]) : 0.f, red_s);
  Softmax st;
  st.m = self * scale;
  st.l = 1.f;
  st.acc = tid < D ? to_float(v_new[vec + tid]) : 0.f;
  return st;
}

// Fold one tile of n <= DEC_THREADS slots into the softmax. Thread t brings
// tile slot t's scaled logit s (-INF when the slot is invalid or t >= n) and
// the factor its probability takes into the V sum (1, or the slot's V
// scale; 1 for an invalid slot); v_at(j, dim) reads dim `dim` of tile slot
// j's V row as float. Only slots with a non-zero product are read.
template <typename VAt>
__device__ __forceinline__ void fold_tile(Softmax& st, float s, float v_mult, int n, int D,
                                          VAt v_at, float* p_s, float* part_s, float* red_s) {
  const int tid = threadIdx.x;
  const float m_new = fmaxf(st.m, block_max<DEC_THREADS>(s, red_s));
  const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
  p_s[tid] = p * v_mult;
  const float l_tile = block_sum<DEC_THREADS>(p, red_s);  // its barriers also publish p_s
  const float alpha = expf(st.m - m_new);

  const int groups = DEC_THREADS / D;  // key groups of the V pass
  const int dim = tid % D;
  const int grp = tid / D;
  float part = 0.f;
  for (int j = grp; j < n; j += groups) {
    const float pj = p_s[j];
    if (pj != 0.f) part += pj * v_at(j, dim);
  }
  part_s[tid] = part;
  __syncthreads();
  if (tid < D) {
    float sum = 0.f;
    for (int g = 0; g < groups; ++g) sum += part_s[g * D + tid];
    st.acc = st.acc * alpha + sum;
  }
  st.l = st.l * alpha + l_tile;
  st.m = m_new;
  __syncthreads();  // p_s / part_s are rewritten by the next tile
}

template <typename T, bool STATS>
__global__ void __launch_bounds__(DEC_THREADS) flash_decode_kernel(
    const T* __restrict__ k_layer,  // cache + offset of (layer, K plane)
    const T* __restrict__ v_layer,  // cache + offset of (layer, V plane)
    int H, int S, int D,
    const int* __restrict__ row_prefix, int gap_end, int cur_len,
    const T* __restrict__ q, const T* __restrict__ k_new, const T* __restrict__ v_new,
    T* __restrict__ out, float* __restrict__ ml, float scale) {
  __shared__ float q_s[DEC_MAX_D];
  __shared__ float p_s[DEC_THREADS];
  __shared__ float part_s[DEC_THREADS];
  __shared__ float red_s[DEC_THREADS / 32];

  const int bh = blockIdx.x;  // (row, head), row-major over (B, H)
  const int b = bh / H;
  const int tid = threadIdx.x;
  const long long plane = (long long)S * D;
  const T* kbase = k_layer + (long long)bh * plane;
  const T* vbase = v_layer + (long long)bh * plane;
  const long long vec = (long long)bh * D;

  Softmax st = seed_self(q, k_new, v_new, vec, D, scale, q_s, red_s);
  const int rp = row_prefix[b];
  for (int start = 0; start < cur_len; start += DEC_THREADS) {
    const int n = min(DEC_THREADS, cur_len - start);
    const int i = start + tid;
    float s = -INFINITY;
    if (tid < n && (i < rp || i >= gap_end)) {
      s = dot_row(kbase + (long long)i * D, q_s, D) * scale;
    }
    const T* vt = vbase + (long long)start * D;
    fold_tile(st, s, 1.f, n, D, [&](int j, int c) { return to_float(vt[(long long)j * D + c]); },
              p_s, part_s, red_s);
  }
  if (tid < D) out[vec + tid] = from_float<T>(st.acc / st.l);
  if (STATS && tid == 0) {
    ml[2 * bh] = st.m;
    ml[2 * bh + 1] = st.l;
  }
}

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS) flash_decode_int8_kernel(
    const int8_t* __restrict__ k_layer, const int8_t* __restrict__ v_layer,  // int8 cache planes
    const float* __restrict__ sk_layer, const float* __restrict__ sv_layer,  // their scales
    const T* __restrict__ tk_layer, const T* __restrict__ tv_layer,          // tail planes
    int H, int S, int W, int D,
    const int* __restrict__ row_prefix, int gap_end, int cur_len, int merge_base,
    const T* __restrict__ q, const T* __restrict__ k_new, const T* __restrict__ v_new,
    T* __restrict__ out, float scale) {
  __shared__ float q_s[DEC_MAX_D];
  __shared__ float p_s[DEC_THREADS];
  __shared__ float part_s[DEC_THREADS];
  __shared__ float red_s[DEC_THREADS / 32];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int8_t* kbase = k_layer + (long long)bh * S * D;
  const int8_t* vbase = v_layer + (long long)bh * S * D;
  const float* skb = sk_layer + (long long)bh * S;
  const float* svb = sv_layer + (long long)bh * S;
  const T* tkb = tk_layer + (long long)bh * W * D;
  const T* tvb = tv_layer + (long long)bh * W * D;
  const long long vec = (long long)bh * D;

  Softmax st = seed_self(q, k_new, v_new, vec, D, scale, q_s, red_s);
  const int rp = row_prefix[b];
  // the int8 cache: slots [0, merge_base), k ~ k8 * s_k and v ~ v8 * s_v
  for (int start = 0; start < merge_base; start += DEC_THREADS) {
    const int n = min(DEC_THREADS, merge_base - start);
    const int i = start + tid;
    float s = -INFINITY, v_mult = 1.f;
    if (tid < n && (i < rp || i >= gap_end)) {
      s = dot_row_i8(kbase + (long long)i * D, q_s, D) * skb[i] * scale;
      v_mult = svb[i];
    }
    const int8_t* vt = vbase + (long long)start * D;
    fold_tile(st, s, v_mult, n, D,
              [&](int j, int c) { return static_cast<float>(vt[(long long)j * D + c]); },
              p_s, part_s, red_s);
  }
  // the tail: slots [merge_base, cur_len) at tail slot i - merge_base, exact
  const int n_tail = cur_len - merge_base;
  if (n_tail > 0) {
    const int i = merge_base + tid;
    float s = -INFINITY;
    if (tid < n_tail && (i < rp || i >= gap_end)) {
      s = dot_row(tkb + (long long)tid * D, q_s, D) * scale;
    }
    fold_tile(st, s, 1.f, n_tail, D, [&](int j, int c) { return to_float(tvb[j * D + c]); },
              p_s, part_s, red_s);
  }
  if (tid < D) out[vec + tid] = from_float<T>(st.acc / st.l);
}

__global__ void kv_append_kernel(char* __restrict__ cache, const char* __restrict__ new_kv,
                                 long long rows, long long row_stride, int vecs_per_row,
                                 long long pos_off) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = idx / vecs_per_row;
  const int c = (int)(idx % vecs_per_row);
  if (r >= rows) return;
  const uint4* src = reinterpret_cast<const uint4*>(new_kv) + r * vecs_per_row + c;
  uint4* dst = reinterpret_cast<uint4*>(cache + r * row_stride + pos_off) + c;
  *dst = *src;
}

template <typename T>
__global__ void kv_quantize_kernel(int8_t* __restrict__ cache8, float* __restrict__ scales,
                                   const T* __restrict__ src, long long rows, int S, int n, int D,
                                   int pos) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows * n) return;  // warp-uniform: blockDim is a multiple of 32
  const long long r = warp / n;
  const int t = (int)(warp % n);
  const T* x = src + (r * n + t) * D;
  float amax = 0.f;
  for (int c = lane; c < D; c += 32) amax = fmaxf(amax, fabsf(to_float(x[c])));
  amax = warp_max(amax);
  const float sc = fmaxf(amax * (1.f / 127.f), 1e-8f);
  const long long slot = r * S + pos + t;
  int8_t* dst = cache8 + slot * D;
  for (int c = lane; c < D; c += 32) {
    const float qv = fminf(fmaxf(rintf(to_float(x[c]) / sc), -127.f), 127.f);
    dst[c] = static_cast<int8_t>(qv);
  }
  if (lane == 0) scales[slot] = sc;
}

template <typename T>
void launch_decode(const void* cache, int layer, int B, int H, int S, int D,
                   const void* row_prefix, int gap_end, int cur_len, const void* q,
                   const void* k_new, const void* v_new, void* out, void* ml, float scale,
                   cudaStream_t st) {
  const long long plane = (long long)B * H * S * D;  // one (layer, K|V) plane
  const T* c = reinterpret_cast<const T*>(cache);
  const T* kl = c + (2LL * layer) * plane;
  const T* vl = c + (2LL * layer + 1) * plane;
  const int* rp = reinterpret_cast<const int*>(row_prefix);
  const T* qq = reinterpret_cast<const T*>(q);
  const T* kn = reinterpret_cast<const T*>(k_new);
  const T* vn = reinterpret_cast<const T*>(v_new);
  T* o = reinterpret_cast<T*>(out);
  float* stats = reinterpret_cast<float*>(ml);
  if (stats) {
    flash_decode_kernel<T, true><<<B * H, DEC_THREADS, 0, st>>>(
        kl, vl, H, S, D, rp, gap_end, cur_len, qq, kn, vn, o, stats, scale);
  } else {
    flash_decode_kernel<T, false><<<B * H, DEC_THREADS, 0, st>>>(
        kl, vl, H, S, D, rp, gap_end, cur_len, qq, kn, vn, o, nullptr, scale);
  }
}

template <typename T>
void launch_decode_int8(const void* cache8, const void* scales, const void* tail, int layer, int B,
                        int H, int S, int W, int D, const void* row_prefix, int gap_end,
                        int cur_len, int merge_base, const void* q, const void* k_new,
                        const void* v_new, void* out, float scale, cudaStream_t st) {
  const long long bh = (long long)B * H;
  const int8_t* c8 = reinterpret_cast<const int8_t*>(cache8);
  const float* sc = reinterpret_cast<const float*>(scales);
  const T* tl = reinterpret_cast<const T*>(tail);
  const long long k_pl = 2LL * layer, v_pl = 2LL * layer + 1;  // plane indices
  flash_decode_int8_kernel<T><<<B * H, DEC_THREADS, 0, st>>>(
      c8 + k_pl * bh * S * D, c8 + v_pl * bh * S * D, sc + k_pl * bh * S, sc + v_pl * bh * S,
      tl + k_pl * bh * W * D, tl + v_pl * bh * W * D, H, S, W, D,
      reinterpret_cast<const int*>(row_prefix), gap_end, cur_len, merge_base,
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k_new),
      reinterpret_cast<const T*>(v_new), reinterpret_cast<T*>(out), scale);
}

}  // namespace

extern "C" {

// K1a / K1b. dtype: 0 = float32, 1 = bfloat16. cache (L, 2, B, H, S, D); q,
// k_new, v_new, out (B, H, D); row_prefix (B,) int32; ml (B, H, 2) fp32 for
// the stats (m, l), or null for none. All device pointers.
int cbx_flash_decode(const void* cache, int dtype, int layer, int B, int H, int S, int D,
                     const void* row_prefix, int gap_end, int cur_len, const void* q,
                     const void* k_new, const void* v_new, void* out, void* ml, float scale,
                     void* stream) {
  if (D > DEC_MAX_D || DEC_THREADS % D != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch_decode<bf16>(cache, layer, B, H, S, D, row_prefix, gap_end, cur_len, q, k_new, v_new,
                        out, ml, scale, st);
  } else if (dtype == 0) {
    launch_decode<float>(cache, layer, B, H, S, D, row_prefix, gap_end, cur_len, q, k_new, v_new,
                         out, ml, scale, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K1c+d. cache8 (L, 2, B, H, S, D) int8; scales (L, 2, B, H, S) fp32; tail
// (L, 2, B, H, W, D), q, k_new, v_new and out (B, H, D) of `dtype` (0 =
// float32, 1 = bfloat16); row_prefix (B,) int32. Requires
// 0 <= merge_base <= cur_len <= merge_base + W and D % 16 == 0.
int cbx_flash_decode_int8(const void* cache8, const void* scales, const void* tail, int dtype,
                          int layer, int B, int H, int S, int W, int D, const void* row_prefix,
                          int gap_end, int cur_len, int merge_base, const void* q,
                          const void* k_new, const void* v_new, void* out, float scale,
                          void* stream) {
  if (D > DEC_MAX_D || DEC_THREADS % D != 0 || D % 16 != 0) return (int)cudaErrorInvalidValue;
  if (merge_base < 0 || merge_base > cur_len || cur_len - merge_base > W || W > DEC_THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch_decode_int8<bf16>(cache8, scales, tail, layer, B, H, S, W, D, row_prefix, gap_end,
                             cur_len, merge_base, q, k_new, v_new, out, scale, st);
  } else if (dtype == 0) {
    launch_decode_int8<float>(cache8, scales, tail, layer, B, H, S, W, D, row_prefix, gap_end,
                              cur_len, merge_base, q, k_new, v_new, out, scale, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K2. cache (rows, S, row_bytes) viewed as bytes with rows = L*2*B*H; new_kv
// (rows, row_bytes). Writes new_kv[r] to cache[r, pos]. row_bytes % 16 == 0.
int cbx_kv_append(void* cache, const void* new_kv, long long rows, int S, int row_bytes,
                  int pos, void* stream) {
  if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  const int vecs = row_bytes / 16;
  const long long total = rows * vecs;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  kv_append_kernel<<<(unsigned int)blocks, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<char*>(cache), reinterpret_cast<const char*>(new_kv), rows,
      (long long)S * row_bytes, vecs, (long long)pos * row_bytes);
  return (int)cudaGetLastError();
}

// K2b. src (rows, n, D) of `dtype` (0 = float32, 1 = bfloat16), rows =
// L*2*B*H; cache8 (rows, S, D) int8 and scales (rows, S) fp32. Quantizes
// src[r, t] into cache8[r, pos + t] and scales[r, pos + t]; pos + n <= S.
int cbx_kv_quantize(void* cache8, void* scales, const void* src, int dtype, long long rows, int S,
                    int n, int D, int pos, void* stream) {
  if (n <= 0 || pos < 0 || pos + n > S) return (int)cudaErrorInvalidValue;
  const int threads = 256;  // 8 warps, one (row, token) each
  const long long warps = rows * n;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int8_t* c8 = reinterpret_cast<int8_t*>(cache8);
  float* sc = reinterpret_cast<float*>(scales);
  if (dtype == 1) {
    kv_quantize_kernel<bf16><<<(unsigned int)blocks, threads, 0, st>>>(
        c8, sc, reinterpret_cast<const bf16*>(src), rows, S, n, D, pos);
  } else if (dtype == 0) {
    kv_quantize_kernel<float><<<(unsigned int)blocks, threads, 0, st>>>(
        c8, sc, reinterpret_cast<const float*>(src), rows, S, n, D, pos);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
