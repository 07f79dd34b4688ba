// K3, K4 and K5 on Hopper: the exact (non-causal) softmax attentions of the
// S3Gen flow, one warp-specialised wgmma design behind three entry points.
//
// K3 replaces chatterbox_tpu/ops/flash_attention.py::flash_self_attention_packed
// (Pallas _packed_kernel, flash_attention.py:76-108, called at :154): UNet
// self-attention read straight from the packed to_qkv output (B, T, 3*H*64);
// q, k and v are the column bands [0, HD), [HD, 2HD), [2HD, 3HD); the output
// is (B, T, H*64).
// K5 replaces chatterbox_tpu/ops/flash_attention.py::flash_self_attention
// (Pallas _kernel, flash_attention.py:52-73, called at :200): the same
// function on separate contiguous q, k, v in (B, H, T, 64), output
// (B, H, T, 64).
// Both compute softmax(q.k^T / sqrt(64) + key_bias) . v with an fp32 (B, T)
// additive key bias (pad keys -1e10). Like the Pallas kernels they round the
// unnormalised probabilities of the online softmax to bf16 before the value
// product, keep the row sum in fp32 and divide by it at the end.
// K4 replaces chatterbox_tpu/ops/flash_attention.py::flash_relpos_attention
// (Pallas _relpos_kernel, flash_attention.py:229-261, called at :295): the
// conformer's ESPnet rel-pos attention, scores = (q_u.k^T + qhat_h.shat^T) *
// scale + key_bias, with q_u, k, v (B, T, H*64), qhat (B, T, H*C) (the
// rope-rotated query folded with W_pos) and shat (T, C) (the sinusoid table
// every (row, head) shares), C = 512 at full width; pad keys -1e9. It is
// K3's function at q/k depth 64 + C, and rounds P the same way.
//
// What bounds them: operations. A (row, head) reads 3*T*64 bf16 values and
// does 4*T*T*64 flops on the tensor cores; at T = 1024 that is ~680
// flop/byte, above the bf16 ridge of ~295. At head dim 64 the softmax's
// exponentials are as costly as the products: a score costs 256 tensor
// flops and one exp2, and an SM does 4096 dense bf16 flops but 16 exp2 a
// clock, so the SFU alone needs about as long as the tensor-core bound.
// K4 likewise: 2*T*T*(2*64 + C) flops on (3*64 + C)*T values a (row, head).
//
// Design (one CTA of 3 warpgroups per 128 query rows of one (row, head);
// grid (T/128, H, B), the query tile fastest so that the CTAs reading one
// head's K/V run together in L2):
// - A producer warpgroup gives up its registers (setmaxnreg 40); one thread
//   loads Q once and then K, V and the key bias of 128-key tiles into a ring
//   of STAGES = 3 shared-memory stages with TMA (128-byte swizzle: one
//   64-wide bf16 row is 128 B), each stage completing on an mbarrier.
//   Shared memory: Q 16 KB + 3 x (K 16 KB + V 16 KB + bias 0.5 KB) + a 16 KB
//   staging tile for the output, 133,688 B with the alignment slack: one
//   CTA an SM. The registers (two consumer warpgroups at 232) allow one CTA
//   an SM whatever the stage count, so three stages keep two tiles in
//   flight while one is consumed.
// - Two consumer warpgroups (setmaxnreg 232) own 64 query rows each. For
//   every tile: S = Q.K^T with wgmma m64n128k16 (both operands from shared
//   memory, K-major; 4 k-steps over D = 64), the fp32 scores in registers;
//   the online softmax on the accumulator fragment (each thread holds parts
//   of two rows; the row max takes two shuffles in the quad; scale and bias
//   fold into one FMA in the log2 domain, then ex2); P rounded to bf16 in
//   registers, where it is already the A fragment of the next product
//   (the accumulator and A layouts agree); O += P.V with wgmma m64n64k16, A
//   from registers and V as a transposed (MN-major) operand from shared
//   memory; O (64 x 64 fp32) stays in registers and is rescaled each tile.
//   The per-thread partial row sums are reduced across the quad once, at
//   the end.
// - The exponentials run in the shadow of the products, within each
//   warpgroup: tile j's S and tile j-1's P.V are issued together, and tile
//   j's softmax runs while that P.V is on the tensor cores (the order of
//   FlashAttention-3, Shah et al. 2024). Ping-pong scheduling of the two
//   warpgroups on named barriers gave no gain in development and is not
//   used.
// - The epilogue divides by the row sum, rounds to bf16, stages the tile in
//   shared memory (XOR-swizzled 16-byte chunks) and writes it with 16-byte
//   stores.
// K3 and K5 differ only in their TMA descriptors and output strides: the
// kernel body is the same, so the two give bit-identical results on the
// same q, k, v.
// K4 (relpos_body) keeps the warp roles, the online softmax, P.V and the
// epilogue. Its tensor work a key tile is (64 + C) / 64 + 1 = 10 times a
// 128 x 128 x 64 product against K3's 2, for the same softmax, so the
// exponentials no longer set the pace: the products and their operands do.
// Q of depth 576 is 144 KB, a K-side tile as much: so Q (q_u and the 8
// 64-wide qhat chunks, one 128-byte-swizzle box each) stays resident, and
// every key tile streams through a ring of RP_RING single 16 KB boxes, in
// order k, shat chunks 0-7, v (with the tile's bias). S accumulates in one
// fp32 fragment over the 9 depth chunks (4 k-steps of m64n128k16 each); a
// box is released as soon as the wgmma group that reads it completes, while
// the next chunk's group runs. shat is one (T, C) tensor that every CTA
// reads (L2 holds it: 2.6 MB at T = 2560). Shared memory: 147,456 (Q) +
// 5 x 16,384 (the ring) + 1,024 (bias by tile parity) + barriers and the
// alignment slack: 231,576 B of the 232,448 a block may have. The output is
// staged in the warpgroup's own rows of the q_u box, read by then.
// The S chain waits for its last chunk before the softmax, and P.V before
// the next tile: within a warpgroup nothing overlaps the softmax; the other
// warpgroup's products do.
// The descriptors are encoded on the host for every call through the
// driver's cuTensorMapEncodeTiled, fetched once with the runtime's
// cudaGetDriverEntryPoint[ByVersion] (no -lcuda), and passed by value as
// __grid_constant__ parameters.

#include "common.cuh"
#include <cuda.h>

namespace {

constexpr int D = 64;          // head dim (the flow's only one)
constexpr int BM = 128;        // query rows a CTA (two consumer warpgroups of 64)
constexpr int BN = 128;        // keys a tile
constexpr int STAGES = 3;      // K/V/bias ring depth
constexpr int THREADS = 384;   // warpgroups 0-1 consume, warpgroup 2 produces
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 <= 65536
constexpr uint32_t TILE_BYTES = BN * D * 2;  // a K or V tile, and Q (BM == BN)
constexpr uint32_t BIAS_BYTES = BN * 4;
constexpr float LOG2E = 1.4426950408889634f;
constexpr long long WAIT_LIMIT_CYCLES = 1LL << 33;  // seconds: a stalled pipeline traps

static_assert(BM == BN, "Q and the K/V tiles share one TMA box");

// Shared memory, from a 1024-byte aligned base: the 128-byte swizzle repeats
// every 8 rows (1024 B), and wgmma's descriptors assume tiles start on it.
struct Smem {
  bf16 q[BM * D];
  bf16 k[STAGES][BN * D];
  bf16 v[STAGES][BN * D];
  bf16 o[BM * D];               // epilogue staging
  float bias[STAGES][BN];
  uint64_t q_full;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;  // + the alignment slack

// K4: Q of depth 64 + C resident (q_u, then q-hat in 64-wide chunks, one TMA
// box each), and a ring of single boxes through which every key tile
// streams its K side and V: k, s-hat chunks 0 .. C/64 - 1, v.
constexpr int RP_QBOXES = 1 + 8;  // q_u and up to 8 q-hat chunks: C <= 512
constexpr int RP_RING = 5;
struct SmemRelpos {
  bf16 q[RP_QBOXES][BM * D];
  bf16 ring[RP_RING][BN * D];
  float bias[2][BN];  // the key tile's bias, by the tile's parity
  uint64_t q_full[RP_QBOXES];
  uint64_t full[RP_RING];
  uint64_t empty[RP_RING];
};
constexpr int RP_SMEM_BYTES = sizeof(SmemRelpos) + 1024;
static_assert(RP_SMEM_BYTES <= 232448, "K4's shared memory exceeds a block's 227 KB");

struct Args {
  const float* bias;  // (B, T) additive key bias
  bf16* out;          // element (b, h, t, d) at b*out_bstride + h*out_hstride + t*out_ld + d
  long long out_ld, out_bstride, out_hstride;
  int T;
  int row_b, row_h;   // TMA row of (b, h, t): b*row_b + h*row_h + t
  int col_q, col_k, col_v, col_h;  // TMA column of head h's band: col_x + h*col_h
  float scale_log2;   // softmax scale * log2(e)
  int col_qh_h;       // K4: the q-hat column of depth chunk c of head h is
                      // h*col_qh_h + 64c, of the s-hat table 64c
};

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of this parity. A pipeline
// fault would otherwise spin forever: after WAIT_LIMIT_CYCLES the kernel
// traps, and the launch reports an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - t0 > WAIT_LIMIT_CYCLES) __trap();
  }
}

// 2-D TMA tile load (c0 the column, c1 the row), completing on ``bar``
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// contiguous bulk copy global -> shared, completing on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows in TMA's 128-byte
// swizzle: start address (16-byte units, bits 0-13), leading byte offset
// (bits 16-29; unused by these two layouts, whose operand width fits one
// swizzle atom), stride byte offset (bits 32-45: 1024 B from one 8-row group
// to the next) and the layout type (bits 62-63: 1 = 128-byte swizzle). The
// same descriptor serves Q and K (K-major: D contiguous) and V (MN-major:
// D, the N of P.V, contiguous; 8 keys a 1024-byte group).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin a register's reads and writes to this point of the program: the
// compiler must not move them across the asynchronous wgmma that reads or
// writes the register.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S (64 x 128 fp32) += A (64 x 16, shared) . B (16 x 128, shared, K-major);
// the accumulator fragment: d[4j + 2i + e] is row 16*warp + lane/4 + 8i,
// column 8j + 2*(lane%4) + e.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// S (64 x 128) = Q (64 x 64) . K^T: 4 k-steps of 16 along D, 32 B apart in
// the swizzled rows of both K-major tiles
__device__ __forceinline__ void issue_scores(float (&sc)[64], const uint64_t (&dq)[D / 16],
                                             const uint64_t (&dk)[D / 16]) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k) wgmma_m64n128k16_ss(sc, dq[k], dk[k], k);
}

// the k-step descriptors of a K-major tile (32 B apart) or of V (2048 B apart)
template <int N>
__device__ __forceinline__ void step_descs(uint64_t (&d)[N], const void* tile, int step16) {
  const uint64_t base = sw128_desc(tile);
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = base + i * step16;
}

// O (64 x 64) += P (64 x 128, registers) . V (128 x 64): 8 k-steps of 16 keys,
// V's rows 2048 B apart; p[4kk..4kk+3] is the A fragment of keys [16kk, 16kk+16)
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[32],
                                         const uint64_t (&dv)[BN / 16]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t frag[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_m64n64k16_rs(o, frag, dv[kk]);
  }
}

// The online softmax of a consumer thread's two rows (lo: r_lo, hi: r_lo + 8)
// in the log2 domain: the running max m and this thread's part of the row
// sum l, both fp32.
struct OnlineSoftmax {
  float m_lo = -INFINITY, m_hi = -INFINITY;
  float l_lo = 0.f, l_hi = 0.f;

  // One tile, in place on the fp32 scores: x = s * scale * log2(e) +
  // bias * log2(e) (one FMA), the new row max (two shuffles in the quad),
  // P = exp2(x - m) in fp32, l updated. Returns (alpha_lo, alpha_hi) =
  // exp2(m_old - m_new), 0 on the first tile, by which O is to be rescaled.
  __device__ __forceinline__ float2 tile(float (&sc)[64], const float* bias, int cq,
                                         float scale_log2) {
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(bias + 8 * j + cq);
      const float b0 = bj.x * LOG2E, b1 = bj.y * LOG2E;
      sc[4 * j + 0] = fmaf(sc[4 * j + 0], scale_log2, b0);
      sc[4 * j + 1] = fmaf(sc[4 * j + 1], scale_log2, b1);
      sc[4 * j + 2] = fmaf(sc[4 * j + 2], scale_log2, b0);
      sc[4 * j + 3] = fmaf(sc[4 * j + 3], scale_log2, b1);
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j + 0], sc[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float2 alpha = make_float2(ex2(m_lo - mn_lo), ex2(m_hi - mn_hi));
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      sc[4 * j + 0] = ex2(sc[4 * j + 0] - mn_lo);
      sc[4 * j + 1] = ex2(sc[4 * j + 1] - mn_lo);
      sc[4 * j + 2] = ex2(sc[4 * j + 2] - mn_hi);
      sc[4 * j + 3] = ex2(sc[4 * j + 3] - mn_hi);
      sum_lo += sc[4 * j + 0] + sc[4 * j + 1];
      sum_hi += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_lo = l_lo * alpha.x + sum_lo;
    l_hi = l_hi * alpha.y + sum_hi;
    return alpha;
  }
};

// P rounded to bf16 pairs: the S accumulator's layout is the A fragment's, so
// p[4kk..4kk+3] is the A operand of keys [16kk, 16kk + 16)
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&p)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// O's rows r_lo (o[4j], o[4j+1]) and r_lo + 8 (o[4j+2], o[4j+3]) times alpha
__device__ __forceinline__ void rescale(float (&o)[32], float2 alpha) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= alpha.x;
    o[4 * j + 1] *= alpha.x;
    o[4 * j + 2] *= alpha.y;
    o[4 * j + 3] *= alpha.y;
  }
}

// A consumer warpgroup's epilogue: O / l (l reduced across the quad) in
// bf16, staged in ``stage`` (64 rows of 128 B) with its 16-byte chunks
// XOR-swizzled by row (conflict-free), then written with 16-byte stores to
// query rows [t0, t0 + 64) of head h of batch row b.
__device__ __forceinline__ void store_rows(const float (&o)[32], const OnlineSoftmax& st,
                                           unsigned char* stage, const Args& a, int b, int h,
                                           int t0, int tid) {
  const int lane = tid % 32;
  const int r_lo = (tid / 32) * 16 + lane / 4;
  const float l_lo_all = quad_sum(st.l_lo), l_hi_all = quad_sum(st.l_hi);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = (j ^ (r_lo & 7)) * 16 + (lane % 4) * 4;
    *reinterpret_cast<uint32_t*>(stage + r_lo * 128 + c) =
        pack_bf16(o[4 * j + 0] / l_lo_all, o[4 * j + 1] / l_lo_all);
    *reinterpret_cast<uint32_t*>(stage + (r_lo + 8) * 128 + c) =
        pack_bf16(o[4 * j + 2] / l_hi_all, o[4 * j + 3] / l_hi_all);
  }
  named_barrier(1 + threadIdx.x / 128, 128);  // this warpgroup's staging is written
  bf16* out = a.out + (long long)b * a.out_bstride + (long long)h * a.out_hstride +
              (long long)t0 * a.out_ld;
#pragma unroll
  for (int i = 0; i < 64 * D / 8 / 128; ++i) {
    const int idx = tid + 128 * i;
    const int r = idx / 8;
    const int c = idx % 8;
    *reinterpret_cast<uint4*>(out + (long long)r * a.out_ld + c * 8) =
        *reinterpret_cast<const uint4*>(stage + r * 128 + ((c ^ (r & 7)) * 16));
  }
}

// The kernel body of K3 and K5 (see the note at the top).
__device__ __forceinline__ void attention_body(const CUtensorMap* tq, const CUtensorMap* tk,
                                               const CUtensorMap* tv, const Args& a) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = a.T / BN;
  const int row0 = b * a.row_b + h * a.row_h;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);             // the producer's arrive + the bytes
      mbar_init(&sm.empty[s], 2 * 128);      // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every copy
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      mbar_expect_tx(&sm.q_full, TILE_BYTES);
      tma_load(sm.q, tq, &sm.q_full, a.col_q + h * a.col_h, row0 + q0);
      const float* bias = a.bias + (long long)b * a.T;
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % STAGES;
        // the n-th reuse of a stage waits for the n-th release (phase n - 1)
        if (kt >= STAGES) mbar_wait(&sm.empty[s], ((kt / STAGES) + 1) & 1);
        mbar_expect_tx(&sm.full[s], 2 * TILE_BYTES + BIAS_BYTES);
        tma_load(sm.k[s], tk, &sm.full[s], a.col_k + h * a.col_h, row0 + kt * BN);
        tma_load(sm.v[s], tv, &sm.full[s], a.col_v + h * a.col_h, row0 + kt * BN);
        bulk_load(sm.bias[s], bias + kt * BN, BIAS_BYTES, &sm.full[s]);
      }
    }
  } else {
    // ---- consumers: 64 query rows each. Tile j's S = Q.K^T and tile j-1's
    // O += P.V are issued back to back; tile j's softmax then runs on S's
    // fp32 registers while that P.V is on the tensor cores, and P is rounded
    // to bf16 only after it (FlashAttention-3's intra-warpgroup order). No
    // other instruction may write a register of a pending wgmma: where one
    // does, ptxas serialises every wgmma of the kernel (its note C7513).
    setmaxnreg_inc<CONSUMER_REGS>();
    const int lane = tid % 32;
    const int cq = 2 * (lane % 4);  // this thread's first column in each 8-column block
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float sc[64];   // S of the newest tile, then its P in fp32
    uint32_t p[32];  // P of the tile whose P.V is next, bf16x2
    OnlineSoftmax sm_state;
    uint64_t dq[D / 16], dk[D / 16], dv[BN / 16];
    step_descs(dq, sm.q + wg * 64 * D, 2);
    mbar_wait(&sm.q_full, 0);

    mbar_wait(&sm.full[0], 0);
    step_descs(dk, sm.k[0], 2);
    wgmma_fence();
    issue_scores(sc, dq, dk);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(sc[i]);
    sm_state.tile(sc, sm.bias[0], cq, a.scale_log2);  // O is 0: no rescale
    pack_p(sc, p);

    float2 alpha = make_float2(1.f, 1.f);  // O's pending rescale
    for (int kt = 1; kt < n_tiles; ++kt) {
      const int s = kt % STAGES;
      const int sp = (kt - 1) % STAGES;
      mbar_wait(&sm.full[s], (kt / STAGES) & 1);
      step_descs(dk, sm.k[s], 2);
      step_descs(dv, sm.v[sp], 16 * 128 / 16);
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(sc[i]);
      wgmma_fence();
      issue_scores(sc, dq, dk);
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(sc[i]);
      rescale(o, alpha);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        reg_fence(o[i]);
        reg_fence(p[i]);
      }
      wgmma_fence();
      issue_pv(o, p, dv);
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        reg_fence(o[i]);
        reg_fence(p[i]);
      }
      wgmma_wait<1>();  // S of tile kt; P.V of tile kt-1 may still run
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(sc[i]);
      alpha = sm_state.tile(sc, sm.bias[s], cq, a.scale_log2);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        reg_fence(o[i]);
        reg_fence(p[i]);
      }
      mbar_arrive(&sm.empty[sp]);  // K, V and the bias of stage sp are read
      pack_p(sc, p);
    }

    // the last tile's P.V
    rescale(o, alpha);
    step_descs(dv, sm.v[(n_tiles - 1) % STAGES], 16 * 128 / 16);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      reg_fence(o[i]);
      reg_fence(p[i]);
    }
    wgmma_fence();
    issue_pv(o, p, dv);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      reg_fence(o[i]);
      reg_fence(p[i]);
    }

    store_rows(o, sm_state, reinterpret_cast<unsigned char*>(sm.o + wg * 64 * D), a, b, h,
               q0 + wg * 64, tid);
  }
}

// The kernel body of K4 (see the note at the top): K3's warp roles and
// online softmax; S accumulates in one fp32 wgmma fragment over the depth
// chunks of a key tile, each a 16 KB box of the ring, released as soon as
// the wgmma that reads it completes.
template <int NQH>
__device__ __forceinline__ void relpos_body(const CUtensorMap* tq, const CUtensorMap* tqh,
                                            const CUtensorMap* tk, const CUtensorMap* ts,
                                            const CUtensorMap* tv, const Args& a) {
  extern __shared__ unsigned char smem_raw[];
  SmemRelpos& sm = *reinterpret_cast<SmemRelpos*>(
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = a.T / BN;
  constexpr int n_q = 1 + NQH;     // Q boxes, and the depth chunks of a key tile
  constexpr int n_box = n_q + 1;   // ring boxes a key tile: the depth chunks, then v
  const int row0 = b * a.row_b + h * a.row_h;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int c = 0; c < RP_QBOXES; ++c) mbar_init(&sm.q_full[c], 1);
#pragma unroll
    for (int s = 0; s < RP_RING; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every copy. Tile kt's bias goes to
    // bias[kt & 1] with its v box, whose slot is free only once the
    // consumers have released a box of tile kt - 1, after tile kt - 2's
    // softmax read bias[kt & 1] (n_box >= 3 > RP_RING / 2).
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      for (int c = 0; c < n_q; ++c) {
        mbar_expect_tx(&sm.q_full[c], TILE_BYTES);
        if (c == 0) {
          tma_load(sm.q[0], tq, &sm.q_full[0], a.col_q + h * a.col_h, row0 + q0);
        } else {
          tma_load(sm.q[c], tqh, &sm.q_full[c], h * a.col_qh_h + (c - 1) * D, row0 + q0);
        }
      }
      const float* bias = a.bias + (long long)b * a.T;
      int n = 0;
      for (int kt = 0; kt < n_tiles; ++kt) {
        for (int j = 0; j < n_box; ++j, ++n) {
          const int s = n % RP_RING;
          if (n >= RP_RING) mbar_wait(&sm.empty[s], ((n / RP_RING) + 1) & 1);
          if (j == n_box - 1) {
            mbar_expect_tx(&sm.full[s], TILE_BYTES + BIAS_BYTES);
            tma_load(sm.ring[s], tv, &sm.full[s], a.col_v + h * a.col_h, row0 + kt * BN);
            bulk_load(sm.bias[kt & 1], bias + kt * BN, BIAS_BYTES, &sm.full[s]);
          } else {
            mbar_expect_tx(&sm.full[s], TILE_BYTES);
            if (j == 0) {
              tma_load(sm.ring[s], tk, &sm.full[s], a.col_k + h * a.col_h, row0 + kt * BN);
            } else {
              tma_load(sm.ring[s], ts, &sm.full[s], (j - 1) * D, kt * BN);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each. For every key tile, S takes one
    // depth chunk at a time (4 k-steps of m64n128k16), each box released
    // when its wgmma group is complete while the next is on the tensor
    // cores; then the online softmax on S's registers, then O += P.V.
    setmaxnreg_inc<CONSUMER_REGS>();
    const int lane = tid % 32;
    const int cq = 2 * (lane % 4);
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float sc[64];
    uint32_t p[32];
    OnlineSoftmax sm_state;
    int n = 0;
    for (int kt = 0; kt < n_tiles; ++kt) {
      // unrolled: a chunk's wgmma group is pending across the next chunk's
      // issue, and a loop edge there would copy S's registers under it
#pragma unroll
      for (int c = 0; c < n_q; ++c, ++n) {
        const int s = n % RP_RING;
        if (kt == 0) mbar_wait(&sm.q_full[c], 0);
        mbar_wait(&sm.full[s], (n / RP_RING) & 1);
        uint64_t dq[D / 16], dk[D / 16];
        step_descs(dq, sm.q[c] + wg * 64 * D, 2);
        step_descs(dk, sm.ring[s], 2);
#pragma unroll
        for (int i = 0; i < 64; ++i) reg_fence(sc[i]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k) wgmma_m64n128k16_ss(sc, dq[k], dk[k], c > 0 || k > 0);
        wgmma_commit();
#pragma unroll
        for (int i = 0; i < 64; ++i) reg_fence(sc[i]);
        if (c > 0) {
          wgmma_wait<1>();  // the previous chunk's box is read
          mbar_arrive(&sm.empty[(n - 1) % RP_RING]);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(sc[i]);
      mbar_arrive(&sm.empty[(n - 1) % RP_RING]);

      const int s = n % RP_RING;  // v and the bias
      mbar_wait(&sm.full[s], (n / RP_RING) & 1);
      const float2 alpha = sm_state.tile(sc, sm.bias[kt & 1], cq, a.scale_log2);
      rescale(o, alpha);  // alpha is 0 on the first tile, where O is 0
      pack_p(sc, p);
      uint64_t dv[BN / 16];
      step_descs(dv, sm.ring[s], 16 * 128 / 16);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        reg_fence(o[i]);
        reg_fence(p[i]);
      }
      wgmma_fence();
      issue_pv(o, p, dv);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        reg_fence(o[i]);
        reg_fence(p[i]);
      }
      mbar_arrive(&sm.empty[s]);
      ++n;
    }
    // the q_u box of this warpgroup's rows is read: it stages the output
    store_rows(o, sm_state, reinterpret_cast<unsigned char*>(sm.q[0] + wg * 64 * D), a, b, h,
               q0 + wg * 64, tid);
  }
}

// K3 and K5: their own symbols, so that a profile tells their launches apart
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_packed_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                       const __grid_constant__ CUtensorMap tk,
                                       const __grid_constant__ CUtensorMap tv, const Args a) {
  attention_body(&tq, &tk, &tv, a);
}

__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_heads_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                      const __grid_constant__ CUtensorMap tk,
                                      const __grid_constant__ CUtensorMap tv, const Args a) {
  attention_body(&tq, &tk, &tv, a);
}

template <int NQH>
__global__ void __launch_bounds__(THREADS, 1)
    flash_relpos_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tqh,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap ts,
                             const __grid_constant__ CUtensorMap tv, const Args a) {
  relpos_body<NQH>(&tq, &tqh, &tk, &ts, &tv, a);
}

// ---- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A failed descriptor encode returns ENCODE_FAILED + the driver's CUresult,
// a missing entry point ENCODE_FAILED: both apart from cudaError_t values.
constexpr int ENCODE_FAILED = 100000;

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, cols) bf16 matrix with ``row_elems`` elements between rows, read
// in boxes of BN rows x 64 columns with the 128-byte swizzle.
int encode_map(CUtensorMap* map, const void* base, long long rows, long long cols,
               long long row_elems) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return ENCODE_FAILED;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_elems * 2};
  const cuuint32_t box[2] = {D, BN};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                         dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int launch(void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, Args), const CUtensorMap& tq,
           const CUtensorMap& tk, const CUtensorMap& tv, const Args& a, int B, int H,
           cudaStream_t st) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.T / BM, H, B);
  kernel<<<grid, THREADS, SMEM_BYTES, st>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

// what both entry points take: T a positive multiple of 128, every TMA row
// coordinate an int, 16-byte aligned pointers
bool shapes_ok(int B, int T, int H) {
  return B > 0 && H > 0 && T > 0 && T % BM == 0 && (long long)B * H * T < (1LL << 31);
}

}  // namespace

extern "C" {

// K3. qkv (B, T, 3*H*64) bf16, bias (B, T) f32, out (B, T, H*64) bf16.
// T % 128 == 0.
int cbx_flash_attention_packed(const void* qkv, const void* bias, void* out, int B, int T,
                               int H, float scale, void* stream) {
  if (!shapes_ok(B, T, H) || !aligned16(qkv) || !aligned16(bias) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const long long hd = (long long)H * D;
  CUtensorMap map;
  const int st = encode_map(&map, qkv, (long long)B * T, 3 * hd, 3 * hd);
  if (st != 0) return st;
  Args a{};
  a.bias = reinterpret_cast<const float*>(bias);
  a.out = reinterpret_cast<bf16*>(out);
  a.out_ld = hd;
  a.out_bstride = (long long)T * hd;
  a.out_hstride = D;
  a.T = T;
  a.row_b = T;
  a.row_h = 0;
  a.col_q = 0;
  a.col_k = (int)hd;
  a.col_v = (int)(2 * hd);
  a.col_h = D;
  a.scale_log2 = scale * LOG2E;
  return launch(flash_attention_packed_sm90_kernel, map, map, map, a, B, H,
                reinterpret_cast<cudaStream_t>(stream));
}

// K5. q, k, v, out (B, H, T, 64) bf16, each contiguous; bias (B, T) f32.
// T % 128 == 0.
int cbx_flash_attention_heads(const void* q, const void* k, const void* v, const void* bias,
                              void* out, int B, int T, int H, float scale, void* stream) {
  if (!shapes_ok(B, T, H) || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(bias) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * T;
  CUtensorMap mq, mk, mv;
  int st = encode_map(&mq, q, rows, D, D);
  if (st == 0) st = encode_map(&mk, k, rows, D, D);
  if (st == 0) st = encode_map(&mv, v, rows, D, D);
  if (st != 0) return st;
  Args a{};
  a.bias = reinterpret_cast<const float*>(bias);
  a.out = reinterpret_cast<bf16*>(out);
  a.out_ld = D;
  a.out_hstride = (long long)T * D;
  a.out_bstride = (long long)H * T * D;
  a.T = T;
  a.row_b = H * T;
  a.row_h = T;
  a.col_q = a.col_k = a.col_v = a.col_h = 0;
  a.scale_log2 = scale * LOG2E;
  return launch(flash_attention_heads_sm90_kernel, mq, mk, mv, a, B, H,
                reinterpret_cast<cudaStream_t>(stream));
}

// K4. q_u, k, v, out (B, T, H*64) bf16; q_hat (B, T, H*C) bf16; s_hat (T, C)
// bf16; bias (B, T) f32. T % 128 == 0; C a multiple of 64, at most 512.
int cbx_flash_relpos(const void* q_u, const void* k, const void* v, const void* q_hat,
                     const void* s_hat, const void* bias, void* out, int B, int T, int H, int C,
                     float scale, void* stream) {
  if (!shapes_ok(B, T, H) || C <= 0 || C % D != 0 || C / D > RP_QBOXES - 1 ||
      (long long)B * T * H * C >= (1LL << 31) || !aligned16(q_u) || !aligned16(k) ||
      !aligned16(v) || !aligned16(q_hat) || !aligned16(s_hat) || !aligned16(bias) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const long long hd = (long long)H * D, rows = (long long)B * T;
  CUtensorMap mq, mqh, mk, ms, mv;
  int st = encode_map(&mq, q_u, rows, hd, hd);
  if (st == 0) st = encode_map(&mqh, q_hat, rows, (long long)H * C, (long long)H * C);
  if (st == 0) st = encode_map(&mk, k, rows, hd, hd);
  if (st == 0) st = encode_map(&ms, s_hat, T, C, C);
  if (st == 0) st = encode_map(&mv, v, rows, hd, hd);
  if (st != 0) return st;
  Args a{};
  a.bias = reinterpret_cast<const float*>(bias);
  a.out = reinterpret_cast<bf16*>(out);
  a.out_ld = hd;
  a.out_bstride = (long long)T * hd;
  a.out_hstride = D;
  a.T = T;
  a.row_b = T;
  a.row_h = 0;
  a.col_q = a.col_k = a.col_v = 0;
  a.col_h = D;
  a.scale_log2 = scale * LOG2E;
  a.col_qh_h = C;
  using Kernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, Args);
  static const Kernel kernels[RP_QBOXES - 1] = {
      flash_relpos_sm90_kernel<1>, flash_relpos_sm90_kernel<2>, flash_relpos_sm90_kernel<3>,
      flash_relpos_sm90_kernel<4>, flash_relpos_sm90_kernel<5>, flash_relpos_sm90_kernel<6>,
      flash_relpos_sm90_kernel<7>, flash_relpos_sm90_kernel<8>};
  const Kernel kernel = kernels[C / D - 1];
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RP_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(T / BM, H, B);
  kernel<<<grid, THREADS, RP_SMEM_BYTES, reinterpret_cast<cudaStream_t>(stream)>>>(mq, mqh, mk,
                                                                                   ms, mv, a);
  return (int)cudaGetLastError();
}

}  // extern "C"
