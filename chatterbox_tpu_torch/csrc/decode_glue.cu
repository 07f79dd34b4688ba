// The glue of T3's Llama decode step (models/t3/llama.py llama_decode_step),
// fused into three kernels, each in bf16 and in fp32. No TPU kernel is
// replaced: on the TPU, XLA fuses this elementwise work into the
// neighbouring operations by itself; eager PyTorch launches each operation
// alone, ~38 of them a layer (casts, squares, means, rsqrt, rope's halves
// and concatenations, copies, adds).
//
//   add_rms_norm   h = x + r (rounded as the eager add rounds), written
//                  over r; y = (h32 * rsqrt(mean(h32^2) + eps)).to(T) *
//                  scale (HF's LlamaRMSNorm); r absent: h = x. A layer's
//                  two norms with their residual adds, and the final norm.
//   rope_split_kv  q, k, v (rows of the q/k/v projections, the fused
//                  product's views or three tensors) -> rope'd q as a
//                  contiguous (B, Hq, 64), rope'd k and v written into the
//                  step's (B, Hkv, 64) K/V slices, which K1 reads and K2
//                  writes into the cache.
//   silu_mul       (B, 2F) gate|up -> silu(g) * u (B, F).
//
// Every rounding is the eager chain's: each eager operation computes in
// fp32 and rounds to T (to nearest even in bf16), so rope, the residual add,
// silu_mul and the norm's last two steps give the eager results bit for
// bit. The norm's statistics are an fp32 sum in another order than
// PyTorch's mean, so rsqrt's argument, and through it a few roundings of y,
// may differ.
//
// What bounds them: launches. At T3's 128 CFG rows in bf16 a norm moves
// 1 MiB, rope 1.5 MiB and silu_mul 3 MiB (0.3-0.9 us at 3.35 TB/s), against
// a launch's ~2-3 us; so each is one launch with 16-byte accesses and
// nothing else, in units of 8 values (one access in bf16, two in fp32):
// add_rms_norm one 128-thread CTA a row, its row in registers (C <= 4096);
// rope_split_kv one 256-thread CTA a row, a thread a pair of 8-value units
// of one head (j and j + 32); silu_mul a thread a unit.

#include "common.cuh"

namespace {

constexpr int NORM_THREADS = 128;
constexpr int NORM_VECS = 4;  // vectors of 8 values a thread: C <= 128 * 8 * 4
constexpr int HEAD_DIM = 64;
constexpr int HALF = HEAD_DIM / 2;
constexpr int ROPE_THREADS = 256;
constexpr int ACT_THREADS = 256;

// 8 consecutive values to fp32 and back: one 16-byte access in bf16, two in
// fp32. load8 reads through the read-only path; load8_rw a value the thread
// writes back.
__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(p[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ void unpack8(const float4& a, const float4& b, float* f) {
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), f);
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4* v = reinterpret_cast<const float4*>(p);
  unpack8(__ldg(v), __ldg(v + 1), f);
}

__device__ __forceinline__ void load8_rw(const bf16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void load8_rw(const float* p, float* f) {
  const float4* v = reinterpret_cast<const float4*>(p);
  unpack8(v[0], v[1], f);
}

// rounds each value to bf16 (to nearest even)
__device__ __forceinline__ void store8(bf16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  float4* v = reinterpret_cast<float4*>(p);
  v[0] = make_float4(f[0], f[1], f[2], f[3]);
  v[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// an fp32 value rounded to T and back: one eager operation's result in T
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_float<T>(from_float<T>(v)); }

template <typename T>
__global__ void __launch_bounds__(NORM_THREADS) add_rms_norm_kernel(
    const T* __restrict__ x, T* __restrict__ r, const T* __restrict__ scale, T* __restrict__ y,
    int C, float eps) {
  __shared__ float red[NORM_THREADS / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * C;
  const int nv = C / 8;
  float h[NORM_VECS][8];
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < NORM_VECS; ++v) {
    const int c = threadIdx.x + v * NORM_THREADS;
    if (c < nv) {
      load8(x + base + 8 * c, h[v]);
      if (r != nullptr) {
        float rv[8];
        load8_rw(r + base + 8 * c, rv);
        // the norm reads the rounded sum, as the eager chain
#pragma unroll
        for (int j = 0; j < 8; ++j) h[v][j] = rnd<T>(__fadd_rn(h[v][j], rv[j]));
        store8(r + base + 8 * c, h[v]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) ss += h[v][j] * h[v][j];
    }
  }
  // PyTorch's mean: the sum times 1/C
  const float inv = rsqrtf(__fadd_rn(block_sum<NORM_THREADS>(ss, red) * (1.f / C), eps));
#pragma unroll
  for (int v = 0; v < NORM_VECS; ++v) {
    const int c = threadIdx.x + v * NORM_THREADS;
    if (c < nv) {
      float s[8], o[8];
      load8(scale + 8 * c, s);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = __fmul_rn(rnd<T>(__fmul_rn(h[v][j], inv)), s[j]);
      store8(y + base + 8 * c, o);
    }
  }
}

// out = x * cos + rotate_half(x) * sin, each product and the sum rounded to
// T (apply_rope); cos and sin rounded to T first (their .to(dtype)); the
// _rn intrinsics keep nvcc from contracting a product and a sum into one
// fma, which the eager chain's separate operations never do.
// One call: values j0..j0+7 of the first half and their partners in the
// second, of one head at src, written to dst.
template <typename T>
__device__ __forceinline__ void rope_pair(const T* src, T* dst, const float* cr,
                                          const float* sr, int j0) {
  float lo[8], hi[8], olo[8], ohi[8];
  load8(src + j0, lo);
  load8(src + j0 + HALF, hi);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int j = j0 + t;
    const float c_lo = rnd<T>(__ldg(cr + j)), s_lo = rnd<T>(__ldg(sr + j));
    const float c_hi = rnd<T>(__ldg(cr + j + HALF)), s_hi = rnd<T>(__ldg(sr + j + HALF));
    olo[t] = __fadd_rn(rnd<T>(__fmul_rn(lo[t], c_lo)), rnd<T>(__fmul_rn(-hi[t], s_lo)));
    ohi[t] = __fadd_rn(rnd<T>(__fmul_rn(hi[t], c_hi)), rnd<T>(__fmul_rn(lo[t], s_hi)));
  }
  store8(dst + j0, olo);
  store8(dst + j0 + HALF, ohi);
}

template <typename T>
__global__ void __launch_bounds__(ROPE_THREADS) rope_split_kv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, int q_stride,
    int k_stride, int v_stride, const float* __restrict__ cos, const float* __restrict__ sin,
    T* __restrict__ q_out, T* __restrict__ k_out, T* __restrict__ v_out, int Hq, int Hkv) {
  const int b = blockIdx.x;
  constexpr int PAIRS = HALF / 8;  // rope units a head
  const float* cr = cos + static_cast<size_t>(b) * HEAD_DIM;
  const float* sr = sin + static_cast<size_t>(b) * HEAD_DIM;
  const int q_units = Hq * PAIRS, k_units = Hkv * PAIRS, v_units = Hkv * (HEAD_DIM / 8);
  const T* qr = q + static_cast<size_t>(b) * q_stride;
  const T* kr = k + static_cast<size_t>(b) * k_stride;
  const T* vr = v + static_cast<size_t>(b) * v_stride;
  T* qo = q_out + static_cast<size_t>(b) * Hq * HEAD_DIM;
  T* ko = k_out + static_cast<size_t>(b) * Hkv * HEAD_DIM;
  T* vo = v_out + static_cast<size_t>(b) * Hkv * HEAD_DIM;
  for (int u = threadIdx.x; u < q_units + k_units + v_units; u += ROPE_THREADS) {
    if (u < q_units) {
      const int off = (u / PAIRS) * HEAD_DIM;
      rope_pair(qr + off, qo + off, cr, sr, (u % PAIRS) * 8);
    } else if (u < q_units + k_units) {
      const int w = u - q_units, off = (w / PAIRS) * HEAD_DIM;
      rope_pair(kr + off, ko + off, cr, sr, (w % PAIRS) * 8);
    } else {
      const int w = u - q_units - k_units;
      float t[8];
      load8(vr + 8 * w, t);  // heads lie back to back in a row
      store8(vo + 8 * w, t);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(ACT_THREADS) silu_mul_kernel(
    const T* __restrict__ gate_up, T* __restrict__ out, int rows, int F) {
  const int nv = F / 8;
  const size_t i = static_cast<size_t>(blockIdx.x) * ACT_THREADS + threadIdx.x;
  if (i >= static_cast<size_t>(rows) * nv) return;
  const size_t row = i / nv, c = i % nv;
  float g[8], u[8], o[8];
  load8(gate_up + row * 2 * F + 8 * c, g);
  load8(gate_up + row * 2 * F + F + 8 * c, u);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[j] = __fmul_rn(rnd<T>(g[j] / (1.f + expf(-g[j]))), u[j]);  // F.silu's form
  }
  store8(out + row * F + 8 * c, o);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (as the other kernels' wrappers pass it)
#define GLUE_DISPATCH(dtype, LAUNCH)          \
  if (dtype == 1) {                           \
    LAUNCH(bf16);                             \
  } else if (dtype == 0) {                    \
    LAUNCH(float);                            \
  } else {                                    \
    return (int)cudaErrorInvalidValue;        \
  }                                           \
  return (int)cudaGetLastError();

extern "C" {

// x, r, y (rows, C) and scale (C,) of `dtype`, contiguous, 16-byte aligned,
// C a multiple of 8 up to 4096; r may be null (no residual); else x + r is
// written over r. All device pointers.
int cbx_add_rms_norm(const void* x, void* r, const void* scale, void* y, int dtype, int rows,
                     int C, float eps, void* stream) {
  if (rows <= 0 || C <= 0 || C % 8 != 0 || C > NORM_THREADS * 8 * NORM_VECS) {
    return (int)cudaErrorInvalidValue;
  }
#define LAUNCH(T)                                                                          \
  add_rms_norm_kernel<T><<<rows, NORM_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>( \
      reinterpret_cast<const T*>(x), reinterpret_cast<T*>(r),                               \
      reinterpret_cast<const T*>(scale), reinterpret_cast<T*>(y), C, eps)
  GLUE_DISPATCH(dtype, LAUNCH)
#undef LAUNCH
}

// q (B, Hq * 64), k and v (B, Hkv * 64) rows of `dtype` at the given strides
// (in values, multiples of 8), 16-byte aligned; cos, sin (B, 64) fp32,
// contiguous; q_out (B, Hq, 64), k_out and v_out (B, Hkv, 64) of `dtype`,
// contiguous, 16-byte aligned. All device pointers.
int cbx_rope_split_kv(const void* q, const void* k, const void* v, int dtype, int q_stride,
                      int k_stride, int v_stride, const void* cos, const void* sin, void* q_out,
                      void* k_out, void* v_out, int B, int Hq, int Hkv, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || (q_stride | k_stride | v_stride) % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
#define LAUNCH(T)                                                                            \
  rope_split_kv_kernel<T><<<B, ROPE_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(     \
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k),                           \
      reinterpret_cast<const T*>(v), q_stride, k_stride, v_stride,                            \
      reinterpret_cast<const float*>(cos), reinterpret_cast<const float*>(sin),               \
      reinterpret_cast<T*>(q_out), reinterpret_cast<T*>(k_out), reinterpret_cast<T*>(v_out), \
      Hq, Hkv)
  GLUE_DISPATCH(dtype, LAUNCH)
#undef LAUNCH
}

// gate_up (rows, 2F) and out (rows, F) of `dtype`, contiguous, 16-byte
// aligned, F a multiple of 8. Device pointers.
int cbx_silu_mul(const void* gate_up, void* out, int dtype, int rows, int F, void* stream) {
  if (rows <= 0 || F <= 0 || F % 8 != 0) return (int)cudaErrorInvalidValue;
  const size_t n = static_cast<size_t>(rows) * (F / 8);
  const size_t blocks = (n + ACT_THREADS - 1) / ACT_THREADS;
  if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
#define LAUNCH(T)                                                                  \
  silu_mul_kernel<T><<<static_cast<unsigned>(blocks), ACT_THREADS, 0,              \
                       reinterpret_cast<cudaStream_t>(stream)>>>(                  \
      reinterpret_cast<const T*>(gate_up), reinterpret_cast<T*>(out), rows, F)
  GLUE_DISPATCH(dtype, LAUNCH)
#undef LAUNCH
}

}  // extern "C"
