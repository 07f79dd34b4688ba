// K1 and K2: single-token decode attention over the T3 KV cache, and the
// writes of one step's K/V into that cache.
//
// K1 replaces chatterbox_tpu/ops/flash_decode.py::flash_decode_layer_attention
// (Pallas _kernel, flash_decode.py:54-270, called at :542), in three
// variants:
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
// once (2 * 64 values a slot; 1 byte each below merge_base on the int8 path,
// plus 8 bytes of scales a slot) and does 4 flops a value, far below
// Hopper's ~295 flop/byte bf16 ridge. Design: split-S flash-decoding in one
// launch. The live slots [0, cur_len) of each (row, head) are cut into
// chunks of CH = 64; one 128-thread CTA owns one chunk of one (row, head),
// so that 16 CFG rows x 16 heads give thousands of CTAs, several waves over
// the 132 SMs. Each lane owns 8 of the 64 dims, 8 lanes a cache row: every
// thread issues its 4 rows' K and V segments (16 bytes each in bf16) with
// cp.async into shared memory before it reads any (16 KB a CTA in flight,
// and ~14 CTAs an SM), and reads back only the bytes it copied, so no
// barrier guards the copies. Invalid slots (the text-padding gap) and slots
// at or past cur_len are zero-filled, never read; on the int8 path nothing
// of the int8 cache at or past merge_base is read: those slots come from the
// tail, exact. The q.k dot is 8 products a lane and 3 shuffles; each warp
// takes the max and the sums of its 16 rows by shuffles, and the 4 warps'
// partials merge once, through shared memory, into the chunk's (m, l,
// acc[64]) in fp32. On the int8 path the K scale multiplies the logit and
// the V scale the probability, as the Pallas kernel folds them
// (flash_decode.py:231-243), so no dequantized row is formed.
// The combine runs in the same launch: each chunk writes its partial to a
// workspace, then takes a ticket on its (row, head)'s counter after a
// __threadfence; the last chunk to arrive takes the max and each chunk's
// factor exp(m_c - M) one chunk a thread, then sums the partials in chunk
// order (so the result does not depend on which CTA came last: repeated
// calls are bit-identical); an empty chunk (m = -inf, l = 0) weighs 0. It
// folds in the current token's self-logit once, writes the output (and for
// K1b the whole softmax's m and l), and resets the counter to 0. No second
// kernel: T3 is host-bound, and one would add a launch a layer a step. The
// workspace and the counters belong to the cache (the wrapper allocates them
// once per cache). The grid is (chunks of S, B*H): its shape does not depend
// on cur_len, and the chunks past cur_len return at once. Chunks of 128
// slots were tried in development and were no faster. The main path runs K1
// in bf16; the float instantiations serve one check: chip_smoke.py's
// reference phase runs a small T3 in fp32 on the card and requires its
// tokens to equal the CPU's exactly, which a bf16 cache cannot promise.
//
// K2 -- what bounds it: bytes (L*2*B*H*D elements read and written once).
// Design: one thread per 16-byte vector of the (L, 2, B, H, D) new K/V,
// written to slot `pos` of the matching cache (or tail) row: one launch per
// decode step for all layers.
//
// K2b -- what bounds it: bytes (n tokens read in the working dtype, written
// as int8 plus one fp32 scale), with the IEEE divisions close behind. Design:
// 8 lanes a token, each with one 16-byte vector of its 64 values (8 bf16, or
// two float4 on the fp32 reference path), loaded non-coherently; the absmax
// by a 3-step shuffle inside the 8-lane group, scale = max(absmax * f32(1/127),
// 1e-8) (the multiply XLA makes of quantize_kv's division by the constant 127
// when it compiles the decode loop), and q = clamp(rint(x / scale), -127,
// 127), where x / scale is an IEEE division (nvcc's default -prec-div=true;
// not a multiply by a reciprocal) and rintf rounds ties to even: the result
// is bit-exact with quantize_kv as the JAX package runs it. Each lane stores
// its 8 int8 values as one 8-byte word. A warp holds 8 consecutive tokens, 4
// at a time over Q_TPT = 2 rounds, and issues both rounds' loads before any
// reduction; its 8 scales are gathered into lanes 0-7 and written by one
// store. The grid covers every token once, so blocks that start as others
// finish overlap their loads with the others' divisions; a grid of one wave
// striding over the tokens, 4 rounds a lane, was slower (PERF.md, K2b).
// The first design, one warp a token, had 128 bytes in flight a warp.

#include "common.cuh"

namespace {

constexpr int HD = 64;                        // head dim (T3's only one)
constexpr int CH = 64;                        // slots a chunk: one CTA
constexpr int DEC_THREADS = 128;              // 4 warps
constexpr int WARPS = DEC_THREADS / 32;
constexpr int LPR = HD / 8;                   // lanes a cache row, 8 dims each
constexpr int ROWS_STEP = DEC_THREADS / LPR;  // rows the CTA covers at once: 16
constexpr int NR = CH / ROWS_STEP;            // rows a thread: 4
constexpr int PART = HD + 2;                  // a chunk's partial: acc[HD], m, l
constexpr int MAX_CHUNKS = 256;               // chunks a (row, head) may have
constexpr unsigned FULL = 0xffffffffu;

static_assert(CH % ROWS_STEP == 0 && 32 % LPR == 0 && HD <= DEC_THREADS, "K1's thread layout");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 8 bytes global -> shared with cp.async; where pred is false the
// destination is zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// this lane's segment of a row (8 values, 8 * sizeof(T) bytes), copied
template <typename T>
__device__ __forceinline__ void copy_seg(void* dst, const T* src, bool pred) {
  if constexpr (sizeof(T) == 1) {
    cp_async8(dst, src, pred);
  } else {
#pragma unroll
    for (int o = 0; o < 8 * (int)sizeof(T); o += 16) {
      cp_async16(static_cast<char*>(dst) + o, reinterpret_cast<const char*>(src) + o, pred);
    }
  }
}

// 8 values of T (shared or global memory, 8 * sizeof(T)-byte aligned) as float
template <typename T>
__device__ __forceinline__ void seg_to_float(const void* p, float (&x)[8]) {
  if constexpr (std::is_same<T, bf16>::value) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      x[2 * j] = f.x;
      x[2 * j + 1] = f.y;
    }
  } else if constexpr (std::is_same<T, float>::value) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = static_cast<float>(c[j]);
  }
}

// this lane's part of a dot product, summed over the LPR lanes of its row
__device__ __forceinline__ float row_dot(const float (&x)[8], const float (&q)[8]) {
  float d = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) d += x[k] * q[k];
#pragma unroll
  for (int o = 1; o < LPR; o <<= 1) d += __shfl_xor_sync(FULL, d, o);
  return d;
}

// the warps' partials of a chunk, merged through shared memory
struct WarpParts {
  float m[WARPS], l[WARPS];
  float acc[WARPS][HD];
};

// The chunk's softmax partial from this thread's NR rows: s[j] the scaled
// logit of row j (-INF where the slot is invalid), w[j] the factor its
// probability takes into the V sum (1, or the slot's V scale), v_row(j, x)
// row j's 8 values of this lane. Each warp reduces its rows by shuffles;
// the warps merge in order into part = (acc[HD], m, l): m the chunk's max
// logit (-INF if it has no valid slot), l = sum exp(s - m), acc = sum
// exp(s - m) w v. Rows whose probability is 0 are not read.
template <typename VRow>
__device__ __forceinline__ void chunk_partial(const float (&s)[NR], const float (&w)[NR],
                                              VRow v_row, WarpParts& red, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m = s[0];
#pragma unroll
  for (int j = 1; j < NR; ++j) m = fmaxf(m, s[j]);
  m = warp_max(m);
  float l = 0.f, acc[8] = {};
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - m);
    l += p;
    if (p != 0.f) {
      float x[8];
      v_row(j, x);
      const float pw = p * w[j];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] += pw * x[k];
    }
  }
  l = warp_sum(lane % LPR == 0 ? l : 0.f);  // one lane a row group
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] += __shfl_xor_sync(FULL, acc[k], o);
  }
  if (lane == 0) {
    red.m[warp] = m;
    red.l[warp] = l;
  }
  if (lane < LPR) {
#pragma unroll
    for (int k = 0; k < 8; ++k) red.acc[warp][8 * lane + k] = acc[k];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < HD) {
    float mc = red.m[0];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) mc = fmaxf(mc, red.m[i]);
    float lc = 0.f, ac = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      if (red.l[i] > 0.f) {
        const float e = expf(red.m[i] - mc);
        lc += red.l[i] * e;
        ac += red.acc[i][t] * e;
      }
    }
    part[t] = ac;
    if (t == 0) {
      part[HD] = mc;
      part[HD + 1] = lc;
    }
  }
}

// After the CTA's partial is written: true (in every thread) in the last of
// the (row, head)'s n chunk CTAs to take a ticket, which resets the counter.
__device__ __forceinline__ bool last_chunk(int* ticket, int n, int* flag) {
  __threadfence();  // this thread's partial is visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(ticket, 1) == n - 1;
    if (last) {
      *ticket = 0;
      __threadfence();
    }
    *flag = last;
  }
  __syncthreads();
  return *flag != 0;
}

// In the last chunk CTA (every thread): fold the n partials (parts, PART
// floats each) with the self-logit m_self (probability weight 1 at m_self,
// value v_new) into out[t] = acc / l for t < HD. The max M and each chunk's
// factor exp(m_c - M) (0 for a chunk without a valid slot: m_c = -inf, and
// its l and acc are 0) are taken one chunk a thread, into e_s and le_s
// (shared, MAX_CHUNKS floats each); the sums then run in chunk order.
// Returns (M, l) of the whole softmax (l in threads t < HD).
template <typename T>
__device__ __forceinline__ float2 combine(const float* parts, int n, float m_self,
                                          const T* v_new, T* out, float* e_s, float* le_s,
                                          float* red) {
  const int t = threadIdx.x;
  float mx = m_self;
  for (int c = t; c < n; c += DEC_THREADS) mx = fmaxf(mx, __ldcg(parts + c * PART + HD));
  mx = warp_max(mx);
  if ((t & 31) == 0) red[t >> 5] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) mx = fmaxf(mx, red[i]);
  for (int c = t; c < n; c += DEC_THREADS) {
    const float e = expf(__ldcg(parts + c * PART + HD) - mx);
    e_s[c] = e;
    le_s[c] = __ldcg(parts + c * PART + HD + 1) * e;
  }
  __syncthreads();
  float l = 0.f;
  if (t < HD) {
    const float es = expf(m_self - mx);
    float a = es * to_float(v_new[t]);
    l = es;
    for (int c = 0; c < n; ++c) {
      l += le_s[c];
      a += __ldcg(parts + c * PART + t) * e_s[c];
    }
    out[t] = from_float<T>(a / l);
  }
  return make_float2(mx, l);
}

// the live chunks of a launch: at least one, so that a (row, head) with
// cur_len = 0 still writes its self-only output
__device__ __forceinline__ int live_chunks(int cur_len) { return max(1, (cur_len + CH - 1) / CH); }

template <typename T, bool STATS>
__global__ void __launch_bounds__(DEC_THREADS) flash_decode_kernel(
    const T* __restrict__ k_layer,  // cache + offset of (layer, K plane)
    const T* __restrict__ v_layer,  // cache + offset of (layer, V plane)
    int H, int S, const int* __restrict__ row_prefix, int gap_end, int cur_len,
    const T* __restrict__ q, const T* __restrict__ k_new, const T* __restrict__ v_new,
    T* __restrict__ out, float* __restrict__ ml, float scale, float* __restrict__ parts,
    int* __restrict__ tickets) {
  const int chunk = blockIdx.x;
  const int n_live = live_chunks(cur_len);
  if (chunk >= n_live) return;
  __shared__ __align__(16) unsigned char k_s[CH * HD * sizeof(T)];
  __shared__ __align__(16) unsigned char v_s[CH * HD * sizeof(T)];
  __shared__ WarpParts red;
  __shared__ float e_s[MAX_CHUNKS], le_s[MAX_CHUNKS];
  __shared__ int last;

  const int bh = blockIdx.y;  // (row, head), row-major over (B, H)
  const int tid = threadIdx.x;
  const int g = tid % LPR;  // this lane's dims: [8g, 8g + 8)
  const int start = chunk * CH, end = min(start + CH, cur_len);
  const int rp = row_prefix[bh / H];
  const long long plane = (long long)S * HD;
  const T* kb = k_layer + bh * plane + 8 * g;
  const T* vb = v_layer + bh * plane + 8 * g;
  const int seg = (tid / LPR * HD + 8 * g) * sizeof(T);  // row tid / LPR, this lane's bytes

  bool valid[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int i = start + j * ROWS_STEP + tid / LPR;
    valid[j] = i < end && (i < rp || i >= gap_end);
    const long long off = valid[j] ? (long long)i * HD : 0;
    const int so = seg + j * ROWS_STEP * HD * sizeof(T);
    copy_seg(k_s + so, kb + off, valid[j]);
    copy_seg(v_s + so, vb + off, valid[j]);
  }
  float qf[8];
  seg_to_float<T>(q + bh * HD + 8 * g, qf);
  cp_async_wait_all();

  float s[NR], w[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    float x[8];
    seg_to_float<T>(k_s + seg + j * ROWS_STEP * HD * sizeof(T), x);
    const float d = row_dot(x, qf);
    s[j] = valid[j] ? d * scale : -INFINITY;
    w[j] = 1.f;
  }
  float* bh_parts = parts + (long long)bh * gridDim.x * PART;
  chunk_partial(
      s, w,
      [&](int j, float (&x)[8]) { seg_to_float<T>(v_s + seg + j * ROWS_STEP * HD * sizeof(T), x); },
      red, bh_parts + chunk * PART);
  if (!last_chunk(tickets + bh, n_live, &last)) return;

  float kx[8];
  seg_to_float<T>(k_new + bh * HD + 8 * g, kx);
  const float m_self = row_dot(kx, qf) * scale;
  const float2 st =
      combine(bh_parts, n_live, m_self, v_new + bh * HD, out + bh * HD, e_s, le_s, red.m);
  if (STATS && tid == 0) {
    ml[2 * bh] = st.x;
    ml[2 * bh + 1] = st.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS) flash_decode_int8_kernel(
    const int8_t* __restrict__ k_layer, const int8_t* __restrict__ v_layer,  // int8 cache planes
    const float* __restrict__ sk_layer, const float* __restrict__ sv_layer,  // their scales
    const T* __restrict__ tk_layer, const T* __restrict__ tv_layer,          // tail planes
    int H, int S, int W, const int* __restrict__ row_prefix, int gap_end, int cur_len,
    int merge_base, const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, T* __restrict__ out, float scale, float* __restrict__ parts,
    int* __restrict__ tickets) {
  const int chunk = blockIdx.x;
  const int n_live = live_chunks(cur_len);
  if (chunk >= n_live) return;
  // a chunk row holds an int8 cache row (slot < merge_base, its first HD
  // bytes) or a tail row, in a T-sized row of shared memory either way
  __shared__ __align__(16) unsigned char k_s[CH * HD * sizeof(T)];
  __shared__ __align__(16) unsigned char v_s[CH * HD * sizeof(T)];
  __shared__ WarpParts red;
  __shared__ float e_s[MAX_CHUNKS], le_s[MAX_CHUNKS];
  __shared__ int last;

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int g = tid % LPR;
  const int start = chunk * CH, end = min(start + CH, cur_len);
  const int rp = row_prefix[bh / H];
  const int8_t* kb = k_layer + bh * (long long)S * HD + 8 * g;
  const int8_t* vb = v_layer + bh * (long long)S * HD + 8 * g;
  const float* skb = sk_layer + bh * (long long)S;
  const float* svb = sv_layer + bh * (long long)S;
  const T* tkb = tk_layer + bh * (long long)W * HD + 8 * g;
  const T* tvb = tv_layer + bh * (long long)W * HD + 8 * g;
  const int row = tid / LPR * HD * sizeof(T);  // this thread's first row in shared memory
  const int seg8 = row + 8 * g, segt = row + 8 * g * sizeof(T);

  bool valid[NR], tail[NR];
  float sk[NR], w[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int i = start + j * ROWS_STEP + tid / LPR;
    const int so = j * ROWS_STEP * HD * sizeof(T);
    valid[j] = i < end && (i < rp || i >= gap_end);
    tail[j] = i >= merge_base;
    sk[j] = w[j] = 1.f;
    if (tail[j]) {
      const long long off = valid[j] ? (long long)(i - merge_base) * HD : 0;
      copy_seg(k_s + segt + so, tkb + off, valid[j]);
      copy_seg(v_s + segt + so, tvb + off, valid[j]);
    } else {
      const long long off = valid[j] ? (long long)i * HD : 0;
      copy_seg(k_s + seg8 + so, kb + off, valid[j]);
      copy_seg(v_s + seg8 + so, vb + off, valid[j]);
      if (valid[j]) {
        sk[j] = skb[i];
        w[j] = svb[i];
      }
    }
  }
  float qf[8];
  seg_to_float<T>(q + bh * HD + 8 * g, qf);
  cp_async_wait_all();

  float s[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int so = j * ROWS_STEP * HD * sizeof(T);
    float x[8];
    if (tail[j]) {
      seg_to_float<T>(k_s + segt + so, x);
    } else {
      seg_to_float<int8_t>(k_s + seg8 + so, x);
    }
    const float d = row_dot(x, qf);  // every lane of the row takes the same branch
    s[j] = !valid[j] ? -INFINITY : tail[j] ? d * scale : d * sk[j] * scale;
  }
  float* bh_parts = parts + (long long)bh * gridDim.x * PART;
  chunk_partial(
      s, w,
      [&](int j, float (&x)[8]) {
        const int so = j * ROWS_STEP * HD * sizeof(T);
        if (tail[j]) {
          seg_to_float<T>(v_s + segt + so, x);
        } else {
          seg_to_float<int8_t>(v_s + seg8 + so, x);
        }
      },
      red, bh_parts + chunk * PART);
  if (!last_chunk(tickets + bh, n_live, &last)) return;

  float kx[8];
  seg_to_float<T>(k_new + bh * HD + 8 * g, kx);
  const float m_self = row_dot(kx, qf) * scale;
  combine(bh_parts, n_live, m_self, v_new + bh * HD, out + bh * HD, e_s, le_s, red.m);
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

constexpr int Q_THREADS = 256;  // K2b's block
constexpr int Q_LANES = 8;      // lanes a token: 8 values each
constexpr int Q_TPT = 2;        // rounds: tokens a lane holds at once
constexpr int Q_WARP_TOKENS = (32 / Q_LANES) * Q_TPT;  // 8 consecutive tokens a warp

// 8 values of a token's row from 16 (bf16) or 32 (fp32) bytes, read
// through the non-coherent path (src is not written by this kernel)
__device__ __forceinline__ void load8(const bf16* p, float* x) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ uint32_t pack4_int8(const float* q) {
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) w |= (uint32_t)(uint8_t)(int8_t)(int)q[j] << (8 * j);
  return w;
}

template <typename T>
__global__ void __launch_bounds__(Q_THREADS) kv_quantize_kernel(
    int8_t* __restrict__ cache8, float* __restrict__ scales, const T* __restrict__ src,
    long long tokens, int S, int n, int pos) {
  const int lane = threadIdx.x & 31;
  const int grp = lane / Q_LANES, sub = lane % Q_LANES;
  const long long base = ((long long)blockIdx.x * (Q_THREADS / 32) + (threadIdx.x >> 5)) *
                         Q_WARP_TOKENS;
  if (base >= tokens) return;  // warp-uniform: the shuffles below see full warps
  float x[Q_TPT][8];
#pragma unroll
  for (int it = 0; it < Q_TPT; ++it) {
    const long long f = base + it * (32 / Q_LANES) + grp;
    if (f < tokens) {
      load8(src + f * HD + 8 * sub, x[it]);
    } else {  // past the end: zeros, stored nowhere
#pragma unroll
      for (int j = 0; j < 8; ++j) x[it][j] = 0.f;
    }
  }
  // the cache slot of the warp's token base + k: one division a warp (the
  // launcher takes fewer than 2^31 tokens), then steps along the rows
  const unsigned r0 = (unsigned)base / (unsigned)n, t0 = (unsigned)base - r0 * (unsigned)n;
  auto slot = [&](int k) {
    unsigned t = t0 + k, r = r0;
    while (t >= (unsigned)n) t -= n, ++r;
    return (long long)r * S + pos + t;
  };
  float my_scale = 0.f;  // lane l < 8 ends with token base + l's scale
#pragma unroll
  for (int it = 0; it < Q_TPT; ++it) {
    const int k = it * (32 / Q_LANES) + grp;
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(x[it][j]));
#pragma unroll
    for (int o = 1; o < Q_LANES; o <<= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
    const float sc = fmaxf(amax * (1.f / 127.f), 1e-8f);
    float q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = fminf(fmaxf(rintf(x[it][j] / sc), -127.f), 127.f);
    const float s_l = __shfl_sync(FULL, sc, (lane & 3) * Q_LANES);
    if ((lane >> 2) == it) my_scale = s_l;
    if (base + k < tokens) {
      *reinterpret_cast<uint2*>(cache8 + slot(k) * HD + 8 * sub) =
          make_uint2(pack4_int8(q), pack4_int8(q + 4));
    }
  }
  if (lane < Q_WARP_TOKENS && base + lane < tokens) scales[slot(lane)] = my_scale;
}

// the chunks a launch's grid holds along x: all of S's, whatever cur_len
int s_chunks(int S) { return (S + CH - 1) / CH; }

template <typename T>
void launch_decode(const void* cache, int layer, int B, int H, int S, const void* row_prefix,
                   int gap_end, int cur_len, const void* q, const void* k_new, const void* v_new,
                   void* out, void* ml, float scale, void* work, void* tickets, cudaStream_t st) {
  const long long plane = (long long)B * H * S * HD;  // one (layer, K|V) plane
  const T* c = reinterpret_cast<const T*>(cache);
  const T* kl = c + (2LL * layer) * plane;
  const T* vl = c + (2LL * layer + 1) * plane;
  const int* rp = reinterpret_cast<const int*>(row_prefix);
  const T* qq = reinterpret_cast<const T*>(q);
  const T* kn = reinterpret_cast<const T*>(k_new);
  const T* vn = reinterpret_cast<const T*>(v_new);
  T* o = reinterpret_cast<T*>(out);
  float* stats = reinterpret_cast<float*>(ml);
  float* parts = reinterpret_cast<float*>(work);
  int* tk = reinterpret_cast<int*>(tickets);
  const dim3 grid(s_chunks(S), B * H);
  if (stats) {
    flash_decode_kernel<T, true><<<grid, DEC_THREADS, 0, st>>>(
        kl, vl, H, S, rp, gap_end, cur_len, qq, kn, vn, o, stats, scale, parts, tk);
  } else {
    flash_decode_kernel<T, false><<<grid, DEC_THREADS, 0, st>>>(
        kl, vl, H, S, rp, gap_end, cur_len, qq, kn, vn, o, nullptr, scale, parts, tk);
  }
}

template <typename T>
void launch_decode_int8(const void* cache8, const void* scales, const void* tail, int layer, int B,
                        int H, int S, int W, const void* row_prefix, int gap_end, int cur_len,
                        int merge_base, const void* q, const void* k_new, const void* v_new,
                        void* out, float scale, void* work, void* tickets, cudaStream_t st) {
  const long long bh = (long long)B * H;
  const int8_t* c8 = reinterpret_cast<const int8_t*>(cache8);
  const float* sc = reinterpret_cast<const float*>(scales);
  const T* tl = reinterpret_cast<const T*>(tail);
  const long long k_pl = 2LL * layer, v_pl = 2LL * layer + 1;  // plane indices
  const dim3 grid(s_chunks(S), B * H);
  flash_decode_int8_kernel<T><<<grid, DEC_THREADS, 0, st>>>(
      c8 + k_pl * bh * S * HD, c8 + v_pl * bh * S * HD, sc + k_pl * bh * S, sc + v_pl * bh * S,
      tl + k_pl * bh * W * HD, tl + v_pl * bh * W * HD, H, S, W,
      reinterpret_cast<const int*>(row_prefix), gap_end, cur_len, merge_base,
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k_new),
      reinterpret_cast<const T*>(v_new), reinterpret_cast<T*>(out), scale,
      reinterpret_cast<float*>(work), reinterpret_cast<int*>(tickets));
}

// what both K1 entry points take: head dim HD, a (B*H)-row grid,
// 0 <= cur_len <= S, and 1 to MAX_CHUNKS chunks of S
bool decode_shape_ok(int B, int H, int S, int D, int cur_len) {
  return D == HD && B > 0 && H > 0 && (long long)B * H <= 65535 && 0 <= cur_len &&
         cur_len <= S && 1 <= S && s_chunks(S) <= MAX_CHUNKS;
}

}  // namespace

extern "C" {

// K1a / K1b. dtype: 0 = float32, 1 = bfloat16. cache (L, 2, B, H, S, D); q,
// k_new, v_new, out (B, H, D); row_prefix (B,) int32; ml (B, H, 2) fp32 for
// the stats (m, l), or null for none; work (B*H*ceil(S/64)*(D + 2),) fp32
// and tickets (B*H,) int32, zero, both reused by the launches on one cache,
// which must run in order; 1 <= S <= 256*64. All device pointers.
int cbx_flash_decode(const void* cache, int dtype, int layer, int B, int H, int S, int D,
                     const void* row_prefix, int gap_end, int cur_len, const void* q,
                     const void* k_new, const void* v_new, void* out, void* ml, float scale,
                     void* work, void* tickets, void* stream) {
  if (!decode_shape_ok(B, H, S, D, cur_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch_decode<bf16>(cache, layer, B, H, S, row_prefix, gap_end, cur_len, q, k_new, v_new, out,
                        ml, scale, work, tickets, st);
  } else if (dtype == 0) {
    launch_decode<float>(cache, layer, B, H, S, row_prefix, gap_end, cur_len, q, k_new, v_new, out,
                         ml, scale, work, tickets, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K1c+d. cache8 (L, 2, B, H, S, D) int8; scales (L, 2, B, H, S) fp32; tail
// (L, 2, B, H, W, D), q, k_new, v_new and out (B, H, D) of `dtype` (0 =
// float32, 1 = bfloat16); row_prefix (B,) int32; work and tickets as
// K1a's. Requires 0 <= merge_base <= cur_len <= merge_base + W.
int cbx_flash_decode_int8(const void* cache8, const void* scales, const void* tail, int dtype,
                          int layer, int B, int H, int S, int W, int D, const void* row_prefix,
                          int gap_end, int cur_len, int merge_base, const void* q,
                          const void* k_new, const void* v_new, void* out, float scale,
                          void* work, void* tickets, void* stream) {
  if (!decode_shape_ok(B, H, S, D, cur_len)) return (int)cudaErrorInvalidValue;
  if (merge_base < 0 || merge_base > cur_len || cur_len - merge_base > W) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch_decode_int8<bf16>(cache8, scales, tail, layer, B, H, S, W, row_prefix, gap_end,
                             cur_len, merge_base, q, k_new, v_new, out, scale, work, tickets,
                             st);
  } else if (dtype == 0) {
    launch_decode_int8<float>(cache8, scales, tail, layer, B, H, S, W, row_prefix, gap_end,
                              cur_len, merge_base, q, k_new, v_new, out, scale, work, tickets,
                              st);
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
// L*2*B*H, 16-byte aligned; cache8 (rows, S, D) int8, 8-byte aligned, and
// scales (rows, S) fp32. Quantizes src[r, t] into cache8[r, pos + t] and
// scales[r, pos + t]; D = 64, pos + n <= S, rows * n < 2^31.
int cbx_kv_quantize(void* cache8, void* scales, const void* src, int dtype, long long rows, int S,
                    int n, int D, int pos, void* stream) {
  const long long tokens = rows * n;
  if (D != HD || n <= 0 || pos < 0 || pos + n > S || rows <= 0 || tokens >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  // one warp a group of Q_WARP_TOKENS tokens, each token once
  const long long blocks = (tokens + Q_WARP_TOKENS * (Q_THREADS / 32) - 1) /
                           (Q_WARP_TOKENS * (Q_THREADS / 32));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int8_t* c8 = reinterpret_cast<int8_t*>(cache8);
  float* sc = reinterpret_cast<float*>(scales);
  if (dtype == 1) {
    kv_quantize_kernel<bf16><<<(unsigned int)blocks, Q_THREADS, 0, st>>>(
        c8, sc, reinterpret_cast<const bf16*>(src), tokens, S, n, pos);
  } else {
    kv_quantize_kernel<float><<<(unsigned int)blocks, Q_THREADS, 0, st>>>(
        c8, sc, reinterpret_cast<const float*>(src), tokens, S, n, pos);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
