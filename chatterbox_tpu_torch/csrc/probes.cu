// P1-P5: the kernels of the five Pallas probes in scripts/, each computing
// what its Pallas kernel computes (not a block-by-block copy of it).
//
// P1 replaces scripts/probe_boundary.py::_noop (pallas_call :120-122), a
//    kernel whose only cost is its launch: noop_copy_kernel copies q
//    (rows, H, D). What bounds it: its launch (2 * 32 KB at full width is
//    ~0.02 us of HBM time; a launch is ~50x that). A grid-stride loop
//    launched with <<<>>> lost to clone's memcpy node in a CUDA graph
//    (0.00132 against 0.00116 ms, PERF.md). Design: programmatic dependent launch
//    (launch_pdl below): the kernel may be scheduled while the previous
//    kernel on the stream runs, waits (griddepcontrol.wait) before it
//    touches memory, and at once lets the next PDL-launched kernel be
//    scheduled, so that chained launches overlap their set-up. One 16-byte
//    vector a thread, no loop, 32-bit indices, P1_THREADS a block (16
//    blocks at 32 KB; the geometries tried are in PERF.md). The
//    boundary probe (probes/boundary.py) puts it in the attention slot of
//    each of T3's layers.
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
//    f32, Q (8, 64) f32 and KSD8 (8, 64) int8. The probe's two grid steps
//    read the same blocks and write the same output block with the same
//    values, so the kernel computes it once.
//    What bounds it: the launch (at most 8.6 KB in and 16 KB out, ~24 K
//    operations, nanoseconds of the card's rates), then one round trip to
//    L2, and the work that one SM does. The kernel this one replaced ran
//    both steps, launched without PDL, and read K8 a byte a load in 64- and
//    128-long dependent chains (pv on 64 of 128 threads): 1.5-14.4 us a case.
//    Design, int8_probe_kernel<CASE>, launched by launch_pdl: every input
//    read in coalesced 16-byte vectors (the convert in 4-byte words), the
//    int8 values summed in 16-long chains over a vector. store (one block) and sd_tail (one warp:
//    KSD8's 32 vectors, one warp_sum, no barrier) sit at the PDL launch.
//    The convert (8 blocks, a word in and a float4 out a thread) and pv (4
//    blocks, a K8 vector a thread, a row's 8 lanes added by shuffles) spread
//    over SMs: on one block they took 0.5-0.8 us more. dequant_matmul and
//    matmul_direct sum all of K8 into one value, so they stay on one block
//    (4 vectors a thread, then common.cuh's block_sum): matmul_direct sums a
//    vector's 16 bytes exactly with dp4a, but dequant_matmul converts and
//    multiplies 8192 values on one SM, which bounds it (~0.6 us over the
//    launch, unmoved by 512 threads or by a byte-permute convert). Measured
//    and dropped (PERF.md): the four blocks of a cluster adding their
//    sums through distributed shared memory (0.75-1.0 us slower); a bulk
//    copy of a block's K8 bytes into shared memory, as P5 loads v (equal in
//    dequant_matmul and pv, 0.14-0.2 us slower in the convert and
//    matmul_direct).
//    The sums are taken in another order than the plain version's (dequant
//    as q (sum k sc)), within probes/int8_cache.py's limit; the convert and
//    the store are exact.

// P5 replaces scripts/probe_ops.py::run_case (pallas_call :26-36) with its
//    nine online-softmax fragments A-I (:45-144) on x (8, 128) f32, v (128,
//    64) f32 and a (1, 64) f32 scratch that persists across the probe's two
//    grid steps. Both steps read the same x and v blocks (both index maps are
//    (0, 0)), so scores, max, exps, sums and e @ v are the same in both:
//    only case H reads the scratch (its m_prev) before writing it, and its
//    update is applied twice; every other case writes the same output on
//    both steps. The scratch's initial value is the caller's scr0.
//    What bounds it: the launch, and before this design the block's
//    dependent chains (each case copied v by 64 scalar loads a thread, ran e @ v as a
//    128-long FMA chain on 64 of 128 threads, H and I's q.k^T with a 32-way
//    bank conflict, and all of it twice; 1.3-7.2 us a launch). Design,
//    softmax_probe_kernel<CASE>: one block of NT threads (the work is ~16 K
//    FMAs; a split over SMs would need a second pass), launched by
//    launch_pdl; the step-invariant work computed once; v (for A, E, G, H
//    and I only) by one 32 KB bulk copy into shared memory completing on an
//    mbarrier, issued by one thread while the others read row 0 of x;
//    q.k^T (H, I) a key row a thread in 16-byte vectors whose column is
//    rotated by the row (no bank conflicts, four 16-long chains); e @ v
//    over all four warps (32 slots a warp, two output dims a lane, the
//    warps' sums added through shared memory: 32-long chains); C's sum the
//    block reduction that B uses.

#include "common.cuh"

namespace {

constexpr int SB = 128;  // the probes' slot block
constexpr int PD = 64;   // the probes' head dim
constexpr int NT = 128;  // threads of the P4/P5 blocks
constexpr int P1_THREADS = 128;

// ---- programmatic dependent launch (PDL) -----------------------------------
// A kernel launched by launch_pdl may be scheduled while the previous kernel
// on the stream still runs. It calls pdl_wait() before it touches global
// memory: griddepcontrol.wait returns once the grids it depends on have
// completed and their writes are visible. pdl_trigger() lets the next
// PDL-launched kernel be scheduled at once; that kernel waits in turn, so
// the trigger needs nothing of this grid's work to be done.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

template <typename... Params, typename... Args>
int launch_pdl(void (*kernel)(Params...), unsigned int blocks, unsigned int threads,
               cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// ---- mbarrier and bulk copy (P5's load of v) --------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0: a barrier that completes when ``bytes`` have landed at ``dst``,
// and the copy of ``src`` (both 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void bulk_load_start(void* dst, const void* src, uint32_t bytes,
                                                uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Every thread: wait for the copy (the barrier's first phase). A copy that
// never lands would spin forever: after 2^33 cycles (seconds) the kernel
// traps, and the launch reports an error.
__device__ __forceinline__ void bulk_load_wait(uint64_t* bar) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 33)) __trap();
  }
}

// P1: n 16-byte vectors, one a thread.
__global__ void __launch_bounds__(P1_THREADS)
    noop_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, int n) {
  pdl_wait();
  pdl_trigger();
  const int i = blockIdx.x * P1_THREADS + threadIdx.x;
  if (i < n) dst[i] = src[i];
}

// cache: n lines of S 2-byte slots; nw: n values. cache[line * S + pos] =
// nw[line], one line a thread.
__global__ void cache_column_kernel(uint16_t* __restrict__ cache, const uint16_t* __restrict__ nw,
                                    long long n, int S, int pos) {
  const long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (line < n) cache[line * S + pos] = nw[line];
}

// P4: k8 (PD, SB) int8, sc (8, SB) f32, q (8, PD) f32, t8 (8, PD) int8, each
// 16-byte aligned. Outputs: case 0 (PD, PD) f32; cases 1, 2, 3, 5 (1, PD)
// f32; case 4 (8, SB) int8. k8 is 512 16-byte vectors, row d the 8 vectors
// 8 d .. 8 d + 7. Cases 1 and 3: one block, thread t holds vectors t + NT r
// (r < P4_VECS: row t / 8 + 16 r, slots 16 (t % 8) .. + 15), so it needs
// sc[0, 16 (t % 8) ..] and q[0, t / 8 + 16 r] only. Case 2: block r holds
// the same vectors NT r + t (rows 16 r .. 16 r + 15). Case 0: block b holds
// rows 8 b .. 8 b + 7, a thread a 4-byte word of k8[:, :PD] and a float4 of
// the output. Case 5: one warp, lane l t8's vector l (row l / 4, dims
// 16 (l % 4) .. + 15). Case 4: sc's float4 t + NT r, r < 2.
constexpr int P4_VECS = PD * SB / 16 / NT;           // 4 k8 vectors a thread (cases 1, 3)
constexpr int P4_CONVERT_BLOCKS = PD * PD / 4 / NT;  // 8: an output float4 a thread
constexpr int P4_TAIL_THREADS = 8 * PD / 16;         // 32: a t8 vector a lane

template <int CASE>
__host__ __device__ constexpr int p4_blocks() {
  return CASE == 0 ? P4_CONVERT_BLOCKS : CASE == 2 ? P4_VECS : 1;
}

template <int CASE>
__host__ __device__ constexpr int p4_threads() {
  return CASE == 5 ? P4_TAIL_THREADS : NT;
}

// byte j of w as a signed integer, in f32
__device__ __forceinline__ float i8_at(uint32_t w, int j) {
  return (float)((int32_t)(w << (24 - 8 * j)) >> 24);
}

__device__ __forceinline__ float i8_at(const uint4& v, int k) {
  const uint32_t w = k < 4 ? v.x : k < 8 ? v.y : k < 12 ? v.z : v.w;
  return i8_at(w, k & 3);
}

// f32 -> int8 by truncation toward zero, as the plain version converts
// in-range values; out-of-range values saturate
__device__ __forceinline__ uint32_t i8_store_byte(float x) {
  return (uint32_t)(uint8_t)(int8_t)fminf(fmaxf(truncf(x * 100.f), -128.f), 127.f);
}

// sc[0, 16 c .. 16 c + 15]
__device__ __forceinline__ void load_sc16(const float* __restrict__ sc, int c, float s[16]) {
  const float4* s4 = reinterpret_cast<const float4*>(sc) + 4 * c;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 f = s4[m];
    s[4 * m] = f.x, s[4 * m + 1] = f.y, s[4 * m + 2] = f.z, s[4 * m + 3] = f.w;
  }
}

// sum_k s[k] b_k over a vector's 16 int8 values b, one chain
__device__ __forceinline__ float dot16(const float s[16], const uint4& v) {
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) a = fmaf(s[k], i8_at(v, k), a);
  return a;
}

// the sum of a vector's 16 int8 values, exact in int32
__device__ __forceinline__ float sum16(const uint4& v) {
  const int ones = 0x01010101;
  return (float)__dp4a((int)v.w, ones, __dp4a((int)v.z, ones,
                       __dp4a((int)v.y, ones, __dp4a((int)v.x, ones, 0))));
}

template <int CASE>
__global__ void __launch_bounds__(p4_threads<CASE>())
    int8_probe_kernel(const int8_t* __restrict__ k8, const float* __restrict__ sc,
                      const float* __restrict__ q, const int8_t* __restrict__ t8,
                      void* __restrict__ out) {
  static_assert(NT == SB && PD == 64 && P4_VECS == 4 && P4_CONVERT_BLOCKS == 8 &&
                    P4_TAIL_THREADS == 32,
                "the layout above");
  constexpr int kBytes = PD * SB / p4_blocks<CASE>();  // the k8 bytes a block reads
  __shared__ float red[NT / 32];
  const int t = threadIdx.x, b = blockIdx.x;
  const uint4* k4 = reinterpret_cast<const uint4*>(k8 + kBytes * b);  // this block's

  pdl_wait();
  pdl_trigger();

  if constexpr (CASE == 0) {  // i8_load_convert: k8[:, :PD] * 0.5, a word a thread
    const uint32_t w = reinterpret_cast<const uint32_t*>(k4)[(t / 16) * (SB / 4) + t % 16];
    static_cast<float4*>(out)[NT * b + t] =
        make_float4(i8_at(w, 0) * 0.5f, i8_at(w, 1) * 0.5f, i8_at(w, 2) * 0.5f,
                    i8_at(w, 3) * 0.5f);
  } else if constexpr (CASE == 4) {  // i8_store: (sc * 100) -> int8, four a store
    const float4* s4 = reinterpret_cast<const float4*>(sc);
    uint32_t* o = static_cast<uint32_t*>(out);
    float4 x[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) x[r] = s4[t + NT * r];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      o[t + NT * r] = i8_store_byte(x[r].x) | i8_store_byte(x[r].y) << 8 |
                      i8_store_byte(x[r].z) << 16 | i8_store_byte(x[r].w) << 24;
  } else if constexpr (CASE == 5) {  // i8_sd_tail: q[0] . t8[row, :], summed over the rows
    const uint4 v = reinterpret_cast<const uint4*>(t8)[t];
    float qd[16];
    load_sc16(q, t % 4, qd);  // q[0, 16 (t % 4) ..]
    const float total = 0.f + warp_sum(dot16(qd, v));
    if (t < PD / 4) static_cast<float4*>(out)[t] = make_float4(total, total, total, total);
  } else if constexpr (CASE == 2) {  // i8_pv: out[d] = sum_s sc[0, s] k8[d, s]
    float s[16];
    load_sc16(sc, t % 8, s);
    float p = dot16(s, k4[t]);
    // the 8 lanes that hold row d add their partials
    p += __shfl_xor_sync(0xffffffffu, p, 4);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    if (t % 8 == 0) static_cast<float*>(out)[16 * b + t / 8] = p;
  } else {  // cases 1, 3: sum_d q[0, d] (row d's partial), summed over the block
    float s[16];
    if constexpr (CASE == 1) load_sc16(sc, t % 8, s);
    float qd[P4_VECS];
#pragma unroll
    for (int r = 0; r < P4_VECS; ++r) qd[r] = q[t / 8 + 16 * r];
    uint4 v[P4_VECS];
#pragma unroll
    for (int r = 0; r < P4_VECS; ++r) v[r] = k4[t + NT * r];
    // dequant_matmul: sum_s sc[0, s] k8[d, s] (q (k sc) reassociated as
    // q (sum k sc)); matmul_direct: sum_s k8[d, s], exact
    float a[P4_VECS];
#pragma unroll
    for (int r = 0; r < P4_VECS; ++r) {
      float p;
      if constexpr (CASE == 1)
        p = dot16(s, v[r]);
      else
        p = sum16(v[r]);
      a[r] = __fmul_rn(qd[r], p);
    }
    const float total = 0.f + block_sum<NT>(__fadd_rn(__fadd_rn(a[0], a[1]),
                                                      __fadd_rn(a[2], a[3])), red);
    if (t < PD / 4) static_cast<float4*>(out)[t] = make_float4(total, total, total, total);
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// P5: x (8, SB) f32 (row 0 used), v (SB, PD) f32 (16-byte aligned), scr0
// (PD,) f32 the scratch's initial value; out (1, PD) f32. Thread t owns slot
// t (p = x[0, t]; for H and I the score of key row t); threads t < PD own
// output dim t. The two grid steps' shared work is done once (see the note).
template <int CASE>
__global__ void __launch_bounds__(NT)
    softmax_probe_kernel(const float* __restrict__ x, const float* __restrict__ v,
                         const float* __restrict__ scr0, float* __restrict__ out) {
  static_assert(NT == SB && PD == 64 && NT / 32 == 4, "a thread a slot, four warps");
  constexpr bool kReadsV = CASE == 0 || CASE == 4 || CASE == 6 || CASE == 7 || CASE == 8;
  constexpr bool kScores = CASE == 7 || CASE == 8;  // H, I: q.k^T with q = x[0, :PD]
  __shared__ __align__(16) float vs[kReadsV ? SB * PD : 4];
  __shared__ __align__(16) float qs[PD];
  __shared__ __align__(16) float part[NT / 32][PD];  // each warp's share of e @ v
  __shared__ float red[NT / 32];
  __shared__ __align__(8) uint64_t bar;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;

  pdl_wait();
  pdl_trigger();
  if constexpr (kReadsV) {
    if (t == 0) bulk_load_start(vs, v, SB * PD * sizeof(float), &bar);
  }
  const float p = x[t];  // x[0, t]
  if constexpr (kScores) {
    if (t < PD) qs[t] = CASE == 8 ? bf16_round(p) : p;
  }
  if constexpr (kReadsV) __syncthreads();  // the barrier is initialised (and qs written)

  if constexpr (CASE == 1 || CASE == 5) {  // B, F: sum(p) broadcast-stored
    const float s = block_sum<NT>(p, red);
    if (t < PD) out[t] = 0.f + s;
  } else if constexpr (CASE == 2) {  // C: p @ ones(SB, PD), stored, then * 2
    const float s = block_sum<NT>(p, red);
    if (t < PD) out[t] = s * 2.f;
  } else if constexpr (CASE == 3) {  // D: max(p) broadcast-stored
    const float m = block_max<NT>(p, red);
    if (t < PD) out[t] = m;
  } else {  // A, E, G, H, I: softmax pieces of a row of 128, then e @ v
    float sc = p;
    if constexpr (kScores) {
      bulk_load_wait(&bar);
      // key row t: its 16-byte column block j + t (mod 16), so that the 8
      // threads of a quarter warp read 8 different bank quads of vs and qs
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < PD / 4; ++j) {
        const int c = ((j + t) & (PD / 4 - 1)) * 4;
        const float4 k4 = *reinterpret_cast<const float4*>(&vs[t * PD + c]);
        const float4 q4 = *reinterpret_cast<const float4*>(&qs[c]);
        if constexpr (CASE == 8) {
          a[0] = fmaf(q4.x, bf16_round(k4.x), a[0]);
          a[1] = fmaf(q4.y, bf16_round(k4.y), a[1]);
          a[2] = fmaf(q4.z, bf16_round(k4.z), a[2]);
          a[3] = fmaf(q4.w, bf16_round(k4.w), a[3]);
        } else {
          a[0] = fmaf(q4.x, k4.x, a[0]);
          a[1] = fmaf(q4.y, k4.y, a[1]);
          a[2] = fmaf(q4.z, k4.z, a[2]);
          a[3] = fmaf(q4.w, k4.w, a[3]);
        }
      }
      sc = (a[0] + a[1]) + (a[2] + a[3]);
    }
    const float m = block_max<NT>(sc, red);
    float e = expf(sc - m), l = 0.f;
    if constexpr (CASE != 4 && CASE != 8) l = block_sum<NT>(e, red);
    if constexpr (CASE == 0) e = e / l;  // A: the probabilities
    if constexpr (CASE == 8) e = bf16_round(e);
    if constexpr (!kScores) bulk_load_wait(&bar);
    // e @ v: warp w takes slots 32w..32w+31 (their e from the owning lane),
    // lane takes output dims 2 lane and 2 lane + 1
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      const float ek = __shfl_sync(0xffffffffu, e, k);
      float2 v2 = *reinterpret_cast<const float2*>(&vs[(32 * w + k) * PD + 2 * lane]);
      if constexpr (CASE == 8) v2 = make_float2(bf16_round(v2.x), bf16_round(v2.y));
      acc.x = fmaf(ek, v2.x, acc.x);
      acc.y = fmaf(ek, v2.y, acc.y);
    }
    *reinterpret_cast<float2*>(&part[w][2 * lane]) = acc;
    __syncthreads();
    if (t < PD) {
      const float pv = (part[0][t] + part[1][t]) + (part[2][t] + part[3][t]);
      if constexpr (CASE == 0 || CASE == 8) {  // A, I
        out[t] = pv;
      } else if constexpr (CASE == 4) {  // E: the scratch holds m
        out[t] = pv + (0.f + m);
      } else if constexpr (CASE == 6) {  // G
        out[t] = pv / (0.f + l);
      } else {  // H: the online update of the scratch, once a grid step
        float s = scr0[t];
#pragma unroll
        for (int step = 0; step < 2; ++step) {
          // the NaN-propagating max of jnp.maximum (fmaxf would drop a NaN)
          const float m_new = (s != s || s > m) ? s : m;
          s = s * expf(s - m_new) + pv * expf(m - m_new) + l;
        }
        out[t] = s;
      }
    }
  }
}

template <int CASE>
int launch_int8(const void* k8, const void* sc, const void* q, const void* t8, void* out,
                cudaStream_t st) {
  return launch_pdl(int8_probe_kernel<CASE>, p4_blocks<CASE>(), p4_threads<CASE>(), st,
                    k8, sc, q, t8, out);
}

template <int CASE>
int launch_softmax(const void* x, const void* v, const void* scr0, void* out, cudaStream_t st) {
  return launch_pdl(softmax_probe_kernel<CASE>, 1, NT, st, x, v, scr0, out);
}

}  // namespace

extern "C" {

// P1. Copies `bytes` (a multiple of 16, under 2^35; both pointers 16-byte
// aligned).
int cbx_noop_copy(const void* src, void* dst, long long bytes, void* stream) {
  if (bytes < 0 || bytes % 16 != 0 || bytes / 16 > (1LL << 31) - P1_THREADS)
    return (int)cudaErrorInvalidValue;
  const int n = (int)(bytes / 16);
  const int blocks = n == 0 ? 1 : (n + P1_THREADS - 1) / P1_THREADS;
  return launch_pdl(noop_copy_kernel, blocks, P1_THREADS, reinterpret_cast<cudaStream_t>(stream),
                    src, dst, n);
}

// The CUDA runtime this library was built with and the driver's version
// (1000 * major + 10 * minor): PDL in a captured CUDA graph needs 12.3.
int cbx_cuda_versions(int* runtime, int* driver) {
  const cudaError_t err = cudaRuntimeGetVersion(runtime);
  return (int)(err != cudaSuccess ? err : cudaDriverGetVersion(driver));
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
// 4 store, 5 sd_tail. All four inputs 16-byte aligned.
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
