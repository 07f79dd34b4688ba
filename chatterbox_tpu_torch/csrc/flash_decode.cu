// K1 and K2: single-token decode attention over the T3 KV cache, and the
// in-place append of one step's K/V into every layer of that cache.
//
// K1 replaces chatterbox_tpu/ops/flash_decode.py::flash_decode_layer_attention
// (Pallas _kernel, flash_decode.py:54-270), variant a: bf16 cache, no stats.
// K2 replaces chatterbox_tpu/ops/flash_decode.py::flash_cache_merge_ds
// (Pallas _merge_kernel, flash_decode.py:273-296).
//
// Cache layout: (L, 2, B, H, S, D), contiguous, K plane then V plane per
// layer. The TPU kernel's (D, S) layout and 8-token SD tail existed for the
// TPU's lane tiling; here a slot's D values are one contiguous row.
//
// K1 -- what bounds it: bytes. Each (row, head) reads its live K and V rows
// once (2 * cur_len * D elements) and does 4 flops per element, far below
// Hopper's ~295 flop/byte bf16 ridge. Design: one 128-thread block per
// (row, head) of layer `layer`, addressed by strides into the full cache (no
// copy). The block walks the live slots [0, cur_len) in tiles of 128, one
// slot per thread for the q.k dot (16-byte loads of the K row), an fp32
// online softmax seeded with the current token's self-logit, and a
// dim-parallel pass over the V rows whose probability is non-zero. Slots
// that are invalid (the text-padding gap) or at/after cur_len are never
// read. Only B*H blocks exist (2*batch*16 at full width): at small batch the
// card is under-filled and each block streams its rows serially. Splitting S
// across blocks (flash-decoding) is the queued fix, in a later PR.
// The main path runs K1 in bf16 only. The float instantiation is kept for
// one check: chip_smoke.py's reference phase runs a small T3 in fp32 on the
// card and requires its tokens to equal the CPU's exactly, which a bf16
// cache cannot promise.
//
// K2 -- what bounds it: bytes (L*2*B*H*D elements read and written once).
// Design: one thread per 16-byte vector of the (L, 2, B, H, D) new K/V,
// written to slot `pos` of the matching cache row: one launch per decode
// step for all layers.

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

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS) flash_decode_kernel(
    const T* __restrict__ k_layer,  // cache + offset of (layer, K plane)
    const T* __restrict__ v_layer,  // cache + offset of (layer, V plane)
    int H, int S, int D,
    const int* __restrict__ row_prefix, int gap_end, int cur_len,
    const T* __restrict__ q, const T* __restrict__ k_new, const T* __restrict__ v_new,
    T* __restrict__ out, float scale) {
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

  if (tid < D) q_s[tid] = to_float(q[vec + tid]);
  __syncthreads();

  // the current token's self-logit seeds the online softmax
  float self = block_sum<DEC_THREADS>(
      tid < D ? q_s[tid] * to_float(k_new[vec + tid]) : 0.f, red_s);
  float m = self * scale;
  float l = 1.f;
  float acc = tid < D ? to_float(v_new[vec + tid]) : 0.f;

  const int rp = row_prefix[b];
  const int groups = DEC_THREADS / D;  // key groups of the V pass
  const int dim = tid % D;
  const int grp = tid / D;

  for (int start = 0; start < cur_len; start += DEC_THREADS) {
    const int n = min(DEC_THREADS, cur_len - start);
    const int i = start + tid;
    float s = -INFINITY;
    if (tid < n && (i < rp || i >= gap_end)) {
      s = dot_row(kbase + (long long)i * D, q_s, D) * scale;
    }
    const float m_new = fmaxf(m, block_max<DEC_THREADS>(s, red_s));
    const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
    p_s[tid] = p;
    const float l_tile = block_sum<DEC_THREADS>(p, red_s);  // also publishes p_s
    const float alpha = expf(m - m_new);

    float part = 0.f;
    if (grp < groups) {
      for (int j = grp; j < n; j += groups) {
        const float pj = p_s[j];
        if (pj != 0.f) part += pj * to_float(vbase[(long long)(start + j) * D + dim]);
      }
    }
    part_s[tid] = part;
    __syncthreads();
    if (tid < D) {
      float sum = 0.f;
      for (int g = 0; g < groups; ++g) sum += part_s[g * D + tid];
      acc = acc * alpha + sum;
    }
    l = l * alpha + l_tile;
    m = m_new;
    __syncthreads();  // p_s / part_s are rewritten by the next tile
  }
  if (tid < D) out[vec + tid] = from_float<T>(acc / l);
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. cache (L, 2, B, H, S, D); q, k_new,
// v_new, out (B, H, D); row_prefix (B,) int32. All device pointers.
int cbx_flash_decode(const void* cache, int dtype, int layer, int B, int H, int S, int D,
                     const void* row_prefix, int gap_end, int cur_len, const void* q,
                     const void* k_new, const void* v_new, void* out, float scale,
                     void* stream) {
  if (D > DEC_MAX_D || DEC_THREADS % D != 0) return (int)cudaErrorInvalidValue;
  const long long plane = (long long)B * H * S * D;  // one (layer, K|V) plane
  const long long k_off = (2LL * layer) * plane;
  const long long v_off = (2LL * layer + 1) * plane;
  dim3 grid(B * H);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const bf16* c = reinterpret_cast<const bf16*>(cache);
    flash_decode_kernel<bf16><<<grid, DEC_THREADS, 0, st>>>(
        c + k_off, c + v_off, H, S, D, reinterpret_cast<const int*>(row_prefix), gap_end,
        cur_len, reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k_new),
        reinterpret_cast<const bf16*>(v_new), reinterpret_cast<bf16*>(out), scale);
  } else if (dtype == 0) {
    const float* c = reinterpret_cast<const float*>(cache);
    flash_decode_kernel<float><<<grid, DEC_THREADS, 0, st>>>(
        c + k_off, c + v_off, H, S, D, reinterpret_cast<const int*>(row_prefix), gap_end,
        cur_len, reinterpret_cast<const float*>(q), reinterpret_cast<const float*>(k_new),
        reinterpret_cast<const float*>(v_new), reinterpret_cast<float*>(out), scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// cache (rows, S, row_bytes) viewed as bytes with rows = L*2*B*H; new_kv
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

}  // extern "C"
