// P1-P5: the kernels of the five Pallas probes in scripts/, each computing
// what its Pallas kernel computes (not a block-by-block copy of it).
//
// P1 replaces scripts/probe_boundary.py::_noop (pallas_call :120-122), a
//    kernel whose only cost is its launch: noop_copy_kernel copies q
//    (rows, H, D). What bounds it: its launch (2 * 32 KB at full width is
//    ~0.02 us of HBM time). Design: one thread per 16-byte vector, grid-
//    stride. The boundary probe (probes/boundary.py) puts it in the
//    attention slot of each of T3's 30 layers.
//
// P2 and P3 replace scripts/probe_cache_write2.py::make_rmw (:30-78, call
//    :67) and ::make_col (:81-114, call :103), and scripts/
//    probe_cache_write3.py::make_col (:27-59, call :48) and ::make_rmw
//    (:62-97, call :86): one K/V column new (L, 2, B, H, D) written at slot
//    `pos` of a (L, 2, B, H, D, S) bf16 cache, in place (the function of
//    lax.dynamic_update_slice). The Pallas variants differ in the work of
//    one grid cell, and so do these kernels' blocks:
//      cache_column_kernel: one block per (layer, group of b_blk rows),
//        writing that group's 2 * b_blk * H * D values of the column only
//        (P2/P3 "col", b_blk 16 or 4);
//      cache_rmw_kernel: one block per (layer, [k/v unless folded], group of
//        b_blk rows), reading the s_blk-slot segment that holds `pos` of
//        every (k/v, row, head, dim) line it owns and writing it back with
//        slot pos replaced (P2 "rmw", b_blk 8/16, K/V folded or not,
//        s_blk 128; P3 "rmw" b_blk 8, s_blk 64).
//    What bounds them: bytes. The column is 2 * L * B * H * D values, but
//    in the (D, S) layout each lies S * 2 bytes from the next, so every
//    2-byte store dirties its own 32-byte sector; the RMW variants move
//    the whole s_blk segment twice (0.5 GB at s_blk 128 at full width).
//    Both are copies: the result is bit for bit the slice assignment.
//
// P4 replaces scripts/probe_int8_cache.py::run_case (pallas_call :41-52)
//    with its six cases (:61-97): int8 fragments of an int8 KV-cache read
//    (load + convert, dequant.q.K, p.V, int8 x f32 dot, f32 -> int8 store by
//    truncation, the (8, D) int8 tail . q) on K8 (64, 128) int8, SC (8, 128)
//    f32, Q (8, 64) f32 and KSD8 (8, 64) int8. int8_probe_kernel<CASE> runs
//    the probe's two grid steps in order, each writing the one output block.
//
// P5 replaces scripts/probe_ops.py::run_case (pallas_call :26-36) with its
//    nine online-softmax fragments A-I (:45-144) on x (8, 128) f32, v (128,
//    64) f32 and a (1, 64) f32 scratch that persists across the probe's two
//    grid steps. softmax_probe_kernel<CASE> runs both steps in order in one
//    block over one shared-memory scratch, initialised from the caller's
//    scr0 (case H reads the scratch before writing it on the first step, so
//    its initial value is an input).
//
// P4 and P5: what bounds them is the launch (a few KB in, at most 16 KB
// out). Design: one block of 128 threads (one per slot of the 128-wide
// block), reductions through common.cuh's block_max/block_sum.

#include "common.cuh"

namespace {

constexpr int SB = 128;  // the probes' slot block
constexpr int PD = 64;   // the probes' head dim
constexpr int NT = 128;  // threads of the P4/P5 blocks

__global__ void noop_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                                 long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = src[i];
}

// cache (L, 2, B, H, D, S) and new (L, 2, B, H, D), 2-byte elements. Block
// (layer l, row group g) writes rows [g * b_blk, (g + 1) * b_blk) of both
// planes at slot pos.
__global__ void cache_column_kernel(uint16_t* __restrict__ cache, const uint16_t* __restrict__ nw,
                                    int B, int H, int D, int S, int pos, int b_blk) {
  const int l = blockIdx.x, g = blockIdx.y;
  const int per_plane = b_blk * H * D;
  for (int i = threadIdx.x; i < 2 * per_plane; i += blockDim.x) {
    const int kv = i / per_plane, j = i % per_plane;
    const long long line = ((long long)(l * 2 + kv) * B + (long long)g * b_blk) * H * D + j;
    cache[line * S + pos] = nw[line];
  }
}

// Block (layer l, plane group y, row group g) owns n_kv planes (2 if
// folded, else plane y) of rows [g * b_blk, (g + 1) * b_blk): it reads the
// s_blk-slot segment holding pos of each of those lines, 8 slots (16 bytes)
// at a time, replaces slot pos and writes the segment back.
__global__ void cache_rmw_kernel(uint16_t* __restrict__ cache, const uint16_t* __restrict__ nw,
                                 int B, int H, int D, int S, int pos, int b_blk, int s_blk,
                                 int n_kv) {
  const int l = blockIdx.x, g = blockIdx.z;
  const int kv0 = n_kv == 2 ? 0 : blockIdx.y;
  const int s0 = pos / s_blk * s_blk;
  const int vecs = s_blk / 8;
  const int per_plane = b_blk * H * D;
  const long long total = (long long)n_kv * per_plane * vecs;
  for (long long i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = (int)(i % vecs);
    const long long lj = i / vecs;
    const int kv = kv0 + (int)(lj / per_plane), j = (int)(lj % per_plane);
    const long long line = ((long long)(l * 2 + kv) * B + (long long)g * b_blk) * H * D + j;
    uint4* seg = reinterpret_cast<uint4*>(cache + line * S + s0) + c;
    uint4 v = *seg;
    const int off = pos - (s0 + 8 * c);
    if (off >= 0 && off < 8) reinterpret_cast<uint16_t*>(&v)[off] = nw[line];
    *seg = v;
  }
}

// P4: k8 (PD, SB) int8, sc (8, SB) f32, q (8, PD) f32, t8 (8, PD) int8.
// Outputs: case 0 (PD, PD) f32; cases 1, 2, 3, 5 (1, PD) f32; case 4 (8, SB)
// int8.
template <int CASE>
__global__ void int8_probe_kernel(const int8_t* __restrict__ k8, const float* __restrict__ sc,
                                  const float* __restrict__ q, const int8_t* __restrict__ t8,
                                  void* __restrict__ out) {
  __shared__ float red[NT / 32];
  const int t = threadIdx.x;
  for (int step = 0; step < 2; ++step) {  // the probe's grid (2,), one output block
    if constexpr (CASE == 0) {  // i8_load_convert: k8[:, :PD] * 0.5
      float* o = static_cast<float*>(out);
      for (int i = t; i < PD * PD; i += NT) o[i] = (float)k8[(i / PD) * SB + i % PD] * 0.5f;
    } else if constexpr (CASE == 4) {  // i8_store: (sc * 100) -> int8, truncated
      int8_t* o = static_cast<int8_t*>(out);
      for (int i = t; i < 8 * SB; i += NT)
        o[i] = (int8_t)fminf(fmaxf(truncf(sc[i] * 100.f), -128.f), 127.f);
    } else if constexpr (CASE == 2) {  // i8_pv: out[d] = sum_s sc[0, s] * k8[d, s]
      if (t < PD) {
        float acc = 0.f;
        for (int s = 0; s < SB; ++s) acc += sc[s] * (float)k8[t * SB + s];
        static_cast<float*>(out)[t] = acc;
      }
    } else {  // cases 1, 3, 5: a dot per slot, summed over the slots, broadcast
      float qk = 0.f;
      if constexpr (CASE == 1) {  // i8_dequant_matmul: q[0] . (k8[:, t] * sc[0, t])
        for (int d = 0; d < PD; ++d) qk += q[d] * ((float)k8[d * SB + t] * sc[t]);
      } else if constexpr (CASE == 3) {  // i8_matmul_direct: q[0] . k8[:, t]
        for (int d = 0; d < PD; ++d) qk += q[d] * (float)k8[d * SB + t];
      } else {  // i8_sd_tail: q[0] . t8[t, :] for the 8 tail rows
        if (t < 8)
          for (int d = 0; d < PD; ++d) qk += q[d] * (float)t8[t * PD + d];
      }
      const float total = block_sum<NT>(qk, red);
      if (t < PD) static_cast<float*>(out)[t] = 0.f + total;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// P5: x (8, SB) f32 (row 0 used), v (SB, PD) f32, scr0 (PD,) f32 the
// scratch's initial value; out (1, PD) f32. Thread t owns slot t; threads
// t < PD own output dim t.
template <int CASE>
__global__ void softmax_probe_kernel(const float* __restrict__ x, const float* __restrict__ v,
                                     const float* __restrict__ scr0, float* __restrict__ out) {
  __shared__ float vs[SB * PD];
  __shared__ float e_s[SB];
  __shared__ float scr[PD];
  __shared__ float red[NT / 32];
  const int t = threadIdx.x;
  for (int i = t; i < SB * PD; i += NT) vs[i] = v[i];
  if (t < PD) scr[t] = scr0[t];
  __syncthreads();
  const float p = x[t];  // x[0, t]
  for (int step = 0; step < 2; ++step) {
    if constexpr (CASE == 1 || CASE == 5) {  // B, F: sum(p) broadcast-stored
      const float s = block_sum<NT>(p, red);
      if (t < PD) { scr[t] = 0.f + s; out[t] = scr[t]; }
    } else if constexpr (CASE == 2) {  // C: p @ ones(SB, PD), stored, then * 2
      if (t < PD) {
        float acc = 0.f;
        for (int s = 0; s < SB; ++s) acc += x[s] * 1.f;
        scr[t] = acc;
        out[t] = scr[t] * 2.f;
      }
    } else if constexpr (CASE == 3) {  // D: max(p) broadcast-stored
      const float m = block_max<NT>(p, red);
      if (t < PD) { scr[t] = m; out[t] = scr[t]; }
    } else if constexpr (CASE == 7) {  // H: q.k^T, softmax pieces, online update of scr
      float sc = 0.f;
      for (int d = 0; d < PD; ++d) sc += x[d] * vs[t * PD + d];
      const float m = block_max<NT>(sc, red);
      const float e = expf(sc - m);
      const float l = block_sum<NT>(e, red);
      e_s[t] = e;
      __syncthreads();
      if (t < PD) {
        float pv = 0.f;
        for (int s = 0; s < SB; ++s) pv += e_s[s] * vs[s * PD + t];
        const float m_prev = scr[t];
        // the NaN-propagating max of jnp.maximum (fmaxf would drop a NaN)
        const float m_new = (m_prev != m_prev || m_prev > m) ? m_prev : m;
        const float alpha = expf(m_prev - m_new), beta = expf(m - m_new);
        scr[t] = scr[t] * alpha + pv * beta + l;
        out[t] = scr[t];
      }
    } else if constexpr (CASE == 8) {  // I: bf16 q.k^T and bf16 e.v, fp32 sums
      float sc = 0.f;
      for (int d = 0; d < PD; ++d) sc += bf16_round(x[d]) * bf16_round(vs[t * PD + d]);
      const float m = block_max<NT>(sc, red);
      e_s[t] = bf16_round(expf(sc - m));
      __syncthreads();
      if (t < PD) {
        float pv = 0.f;
        for (int s = 0; s < SB; ++s) pv += e_s[s] * bf16_round(vs[s * PD + t]);
        out[t] = pv;
      }
    } else {  // A (0), E (4), G (6): softmax pieces of p, then e @ v
      const float m = block_max<NT>(p, red);
      const float e = expf(p - m);
      float l = 0.f;
      if constexpr (CASE != 4) l = block_sum<NT>(e, red);
      e_s[t] = CASE == 0 ? e / l : e;  // A: the probabilities
      __syncthreads();
      if (t < PD) {
        float acc = 0.f;
        for (int s = 0; s < SB; ++s) acc += e_s[s] * vs[s * PD + t];
        if constexpr (CASE == 0) {
          out[t] = acc;
        } else if constexpr (CASE == 4) {
          scr[t] = 0.f + m;
          out[t] = acc + scr[t];
        } else {
          scr[t] = 0.f + m + l;
          out[t] = acc / (0.f + l);
        }
      }
    }
    __syncthreads();
  }
}

template <int CASE>
int launch_int8(const void* k8, const void* sc, const void* q, const void* t8, void* out,
                cudaStream_t st) {
  int8_probe_kernel<CASE><<<1, NT, 0, st>>>(static_cast<const int8_t*>(k8),
                                            static_cast<const float*>(sc),
                                            static_cast<const float*>(q),
                                            static_cast<const int8_t*>(t8), out);
  return (int)cudaGetLastError();
}

template <int CASE>
int launch_softmax(const void* x, const void* v, const void* scr0, void* out, cudaStream_t st) {
  softmax_probe_kernel<CASE><<<1, NT, 0, st>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(v),
                                               static_cast<const float*>(scr0),
                                               static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// P1. Copies `bytes` (a multiple of 16; both pointers 16-byte aligned).
int cbx_noop_copy(const void* src, void* dst, long long bytes, void* stream) {
  if (bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  const long long n = bytes / 16;
  const int threads = 256;
  const long long blocks = n == 0 ? 1 : (n + threads - 1) / threads;
  noop_copy_kernel<<<(unsigned int)(blocks < 1024 ? blocks : 1024), threads, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n);
  return (int)cudaGetLastError();
}

// P2/P3 "col". cache (L, 2, B, H, D, S), new (L, 2, B, H, D), 2-byte
// elements; b_blk divides B.
int cbx_cache_column_write(void* cache, const void* new_kv, int L, int B, int H, int D, int S,
                           int pos, int b_blk, void* stream) {
  if (b_blk <= 0 || B % b_blk != 0 || pos < 0 || pos >= S) return (int)cudaErrorInvalidValue;
  cache_column_kernel<<<dim3(L, B / b_blk), 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(cache), static_cast<const uint16_t*>(new_kv), B, H, D, S, pos,
      b_blk);
  return (int)cudaGetLastError();
}

// P2/P3 "rmw". As above, with s_blk a multiple of 8 dividing S (the cache
// 16-byte aligned); fold_kv puts both planes in one block.
int cbx_cache_block_rmw(void* cache, const void* new_kv, int L, int B, int H, int D, int S,
                        int pos, int b_blk, int s_blk, int fold_kv, void* stream) {
  if (b_blk <= 0 || B % b_blk != 0 || pos < 0 || pos >= S || s_blk <= 0 || s_blk % 8 != 0 ||
      S % s_blk != 0)
    return (int)cudaErrorInvalidValue;
  const int n_kv = fold_kv ? 2 : 1;
  cache_rmw_kernel<<<dim3(L, 2 / n_kv, B / b_blk), 256, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(cache), static_cast<const uint16_t*>(new_kv), B, H, D, S, pos,
      b_blk, s_blk, n_kv);
  return (int)cudaGetLastError();
}

// P4. which: 0 load_convert, 1 dequant_matmul, 2 pv, 3 matmul_direct,
// 4 store, 5 sd_tail.
int cbx_int8_probe(int which, const void* k8, const void* sc, const void* q, const void* t8,
                   void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: return launch_int8<0>(k8, sc, q, t8, out, st);
    case 1: return launch_int8<1>(k8, sc, q, t8, out, st);
    case 2: return launch_int8<2>(k8, sc, q, t8, out, st);
    case 3: return launch_int8<3>(k8, sc, q, t8, out, st);
    case 4: return launch_int8<4>(k8, sc, q, t8, out, st);
    case 5: return launch_int8<5>(k8, sc, q, t8, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// P5. which: 0..8 for cases A..I.
int cbx_softmax_probe(int which, const void* x, const void* v, const void* scr0, void* out,
                      void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: return launch_softmax<0>(x, v, scr0, out, st);
    case 1: return launch_softmax<1>(x, v, scr0, out, st);
    case 2: return launch_softmax<2>(x, v, scr0, out, st);
    case 3: return launch_softmax<3>(x, v, scr0, out, st);
    case 4: return launch_softmax<4>(x, v, scr0, out, st);
    case 5: return launch_softmax<5>(x, v, scr0, out, st);
    case 6: return launch_softmax<6>(x, v, scr0, out, st);
    case 7: return launch_softmax<7>(x, v, scr0, out, st);
    case 8: return launch_softmax<8>(x, v, scr0, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
