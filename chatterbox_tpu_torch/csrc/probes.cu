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
//    lax.dynamic_update_slice). The Pallas variants differ only in the work
//    of one grid cell (b_blk rows, an s_blk-slot segment rewritten around
//    pos, K/V folded or not): a TPU moves whole (D, s_blk) blocks, the
//    smallest unit its DMA and (8, 128) tiling allow. The card writes 32-byte
//    sectors, so every variant launches one kernel, cache_column_kernel,
//    whose grid follows the column alone.
//    What bounds it: sectors. The column's n = L * 2 * B * H * D values lie
//    S * 2 bytes apart (768 B at S = 384), so each 2-byte store dirties its
//    own 32-byte sector: 16x the column's bytes (31.5 MB at the probes'
//    shape, 9.4 us of HBM time against the 1.17 us bound of the column read
//    and written once), and no kernel on this layout reaches half the bound.
//    Nor do the sectors stay in L2 between writes: L2 allocates 128-byte
//    lines, and the column touches 983,040 of them (126 MB against 50 MB),
//    so each write likely reaches HBM as a partial sector, read and written
//    (63 MB, 19 us at 3.35 TB/s; measured ~72 us, PERF.md). TMA cannot help:
//    a box's innermost extent spans a multiple of 16 bytes.
//    Design: memory-level parallelism over the whole card, the grid sized
//    from the column: one thread a line, a coalesced 2-byte load of new and
//    one 2-byte store at line * S + pos (3840 blocks of 256 threads at the
//    probes' shape, all resident on 132 SMs); threads past n return. 8 and
//    16 values a thread (16-byte loads), and a read of the 4-byte word or
//    the 32-byte sector before the store, were measured and were slower
//    (PERF.md, PR 12). The result is bit for bit the slice assignment.
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

// cache: n lines of S 2-byte slots; nw: n values. cache[line * S + pos] =
// nw[line], one line a thread.
__global__ void cache_column_kernel(uint16_t* __restrict__ cache, const uint16_t* __restrict__ nw,
                                    long long n, int S, int pos) {
  const long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (line < n) cache[line * S + pos] = nw[line];
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

// P2/P3. cache (n, S) and new (n,), 2-byte elements: cache[:, pos] = new.
int cbx_cache_column_write(void* cache, const void* new_kv, long long n, int S, int pos,
                           void* stream) {
  if (n < 0 || pos < 0 || pos >= S) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = n == 0 ? 1 : (n + threads - 1) / threads;
  cache_column_kernel<<<(unsigned int)blocks, threads, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(cache), static_cast<const uint16_t*>(new_kv), n, S, pos);
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
