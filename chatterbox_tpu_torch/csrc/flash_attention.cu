// K4: the conformer's exact (non-causal) rel-pos softmax attention, a WMMA
// tensor-core kernel. K3 and K5 (the UNet's self-attention) run the Hopper
// kernel of flash_attention_sm90.cu; the body here keeps its RELPOS template
// parameter, and only RELPOS = true is instantiated.
//
// K4 replaces chatterbox_tpu/ops/flash_attention.py::flash_relpos_attention
// (Pallas _relpos_kernel, flash_attention.py:229-261): conformer ESPnet
// rel-pos attention, scores = (q_u.k^T + qhat.shat^T) * scale + key_bias,
// where qhat (B, T, H*C) is the rope-rotated query folded with W_pos and shat
// (T, C) the absolute sinusoid table shared by all heads (C = model width).
// Like the Pallas kernel, it rounds the unnormalised probabilities to bf16
// for the value product and divides by the row sum afterwards.
//
// What bounds it: operations. At the flow's shapes (T ~ 1000-2560, D = 64,
// C = 512) a (row, head) reads 3*T*D + T*C bf16 values and does
// 4*T*T*D + 2*T*T*C flops, well above the bf16 ridge of ~295 flop/byte.
// Design: one 128-thread block (4 warps) per (q-tile of 64 rows, head, row).
// The block walks the keys in tiles of 64 with an fp32 online softmax; the
// TPU kernel's full (Tq, T) logits row does not fit shared memory at the
// long-form bucket (T = 2304), and its 8-row bias tiling is not needed. Both
// products run on the tensor cores through WMMA 16x16x16 bf16 fragments with
// fp32 accumulation: each warp owns 16 query rows of the tile. The second
// term accumulates into the same score fragments over C in chunks of 64 (the
// block's qhat rows stay in shared memory). Tiles move to shared memory with
// plain 16-byte loads. The Hopper-native form (TMA, wgmma), as K3 and K5
// have it, is queued.

#include "common.cuh"
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int HD = 64;        // head dim (the flow's only one)
constexpr int CCH = 64;       // K4: depth chunk of the qhat.shat^T term
constexpr int NT = 128;       // 4 warps x 16 query rows
constexpr int PADH = 8;       // bf16 row padding (keeps 32-byte fragment alignment)
constexpr int PADF = 4;       // fp32 row padding
constexpr int LDH = HD + PADH;
constexpr int LDP = BN + PADH;
constexpr int LDS = BN + PADF;
constexpr int LDO = HD + PADF;
constexpr int LDSH = CCH + PADH;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Byte offsets of the shared-memory regions; the same arithmetic on both
// sides of the launch.
struct SmemLayout {
  size_t q, k, v, p, s, o, t, m, l, al, qh, sh, total;
  __host__ __device__ SmemLayout(int C, bool relpos) {
    size_t off = 0;
    q = off; off = align128(off + sizeof(bf16) * BM * LDH);
    k = off; off = align128(off + sizeof(bf16) * BN * LDH);
    v = off; off = align128(off + sizeof(bf16) * BN * LDH);
    p = off; off = align128(off + sizeof(bf16) * BM * LDP);
    s = off; off = align128(off + sizeof(float) * BM * LDS);
    o = off; off = align128(off + sizeof(float) * BM * LDO);
    t = off; off = align128(off + sizeof(float) * BM * LDO);
    m = off; off = align128(off + sizeof(float) * BM);
    l = off; off = align128(off + sizeof(float) * BM);
    al = off; off = align128(off + sizeof(float) * BM);
    qh = off; if (relpos) off = align128(off + sizeof(bf16) * BM * (C + PADH));
    sh = off; if (relpos) off = align128(off + sizeof(bf16) * BN * LDSH);
    total = off;
  }
};

struct AttnArgs {
  const bf16* q;        // element (b, h, t, d) at b*bstride + h*hstride + t*ld + d
  const bf16* k;
  const bf16* v;
  long long ld;         // row (time) stride of q/k/v (elements)
  long long bstride;    // batch stride of q/k/v
  long long hstride;    // head stride of q/k/v
  const float* bias;    // (B, T) additive key bias
  bf16* out;            // the same indexing with the out_* strides
  long long out_ld, out_bstride, out_hstride;
  const bf16* qhat;     // K4: (B, T, H*C)
  const bf16* shat;     // K4: (T, C)
  int T, H, C;
  float scale;
};

// rows x cols bf16 tile, global (row stride ld_src) -> shared (row stride
// ld_dst), 16 bytes per thread per step. cols % 8 == 0.
__device__ __forceinline__ void load_tile(bf16* dst, int ld_dst, const bf16* src,
                                          long long ld_src, int rows, int cols) {
  const int vpr = cols / 8;
  for (int idx = threadIdx.x; idx < rows * vpr; idx += NT) {
    const int r = idx / vpr;
    const int c = (idx % vpr) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld_dst + c) =
        *reinterpret_cast<const uint4*>(src + (long long)r * ld_src + c);
  }
}

template <bool RELPOS>
__device__ __forceinline__ void attention_body(const AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemLayout lay(a.C, RELPOS);
  bf16* q_s = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* k_s = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* p_s = reinterpret_cast<bf16*>(smem + lay.p);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  float* o_s = reinterpret_cast<float*>(smem + lay.o);
  float* t_s = reinterpret_cast<float*>(smem + lay.t);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* al_s = reinterpret_cast<float*>(smem + lay.al);
  bf16* qh_s = reinterpret_cast<bf16*>(smem + lay.qh);
  bf16* sh_s = reinterpret_cast<bf16*>(smem + lay.sh);

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;  // this warp's query rows within the tile
  const int C = a.C;
  const int ldqh = C + PADH;

  const long long base = (long long)b * a.bstride + (long long)h * a.hstride;
  load_tile(q_s, LDH, a.q + base + (long long)q0 * a.ld, a.ld, BM, HD);
  if constexpr (RELPOS) {
    const long long hb = ((long long)b * a.T + q0) * a.H * C + (long long)h * C;
    load_tile(qh_s, ldqh, a.qhat + hb, (long long)a.H * C, BM, C);
  }
  for (int i = threadIdx.x; i < BM * LDO; i += NT) o_s[i] = 0.f;
  for (int i = threadIdx.x; i < BM; i += NT) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  const float* bias = a.bias + (long long)b * a.T;
  __syncthreads();

  for (int kt = 0; kt < a.T; kt += BN) {
    load_tile(k_s, LDH, a.k + base + (long long)kt * a.ld, a.ld, BN, HD);
    load_tile(v_s, LDH, a.v + base + (long long)kt * a.ld, a.ld, BN, HD);
    __syncthreads();

    // scores for this warp's 16 rows x BN keys
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BN / 16];
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, q_s + r0 * LDH + kk, LDH);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, k_s + (j * 16) * LDH + kk, LDH);
        wmma::mma_sync(sacc[j], fa, fb, sacc[j]);
      }
    }
    if constexpr (RELPOS) {
      for (int cc = 0; cc < C; cc += CCH) {
        load_tile(sh_s, LDSH, a.shat + (long long)kt * C + cc, C, BN, CCH);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < CCH; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, qh_s + r0 * ldqh + cc + kk, ldqh);
#pragma unroll
          for (int j = 0; j < BN / 16; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
            wmma::load_matrix_sync(fb, sh_s + (j * 16) * LDSH + kk, LDSH);
            wmma::mma_sync(sacc[j], fa, fb, sacc[j]);
          }
        }
        __syncthreads();  // sh_s is rewritten by the next chunk
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      wmma::store_matrix_sync(s_s + r0 * LDS + j * 16, sacc[j], LDS, wmma::mem_row_major);
    __syncwarp();

    // online softmax over this tile, row by row; lane covers keys lane, lane+32
    const float b0 = bias[kt + lane];
    const float b1 = bias[kt + lane + 32];
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const float x0 = s_s[r * LDS + lane] * a.scale + b0;
      const float x1 = s_s[r * LDS + lane + 32] * a.scale + b1;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      const float l_tile = warp_sum(p0 + p1);
      p_s[r * LDP + lane] = __float2bfloat16(p0);
      p_s[r * LDP + lane + 32] = __float2bfloat16(p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        al_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + l_tile;
        m_s[r] = m_new;
      }
    }
    __syncwarp();

    // this tile's P.V for the warp's rows, then O = O * alpha + P.V
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[HD / 16];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(oacc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < BN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, p_s + r0 * LDP + kk, LDP);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, v_s + kk * LDH + j * 16, LDH);
        wmma::mma_sync(oacc[j], fa, fb, oacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      wmma::store_matrix_sync(t_s + r0 * LDO + j * 16, oacc[j], LDO, wmma::mem_row_major);
    __syncwarp();
    for (int idx = lane; idx < 16 * HD; idx += 32) {
      const int r = r0 + idx / HD;
      const int c = idx % HD;
      o_s[r * LDO + c] = o_s[r * LDO + c] * al_s[r] + t_s[r * LDO + c];
    }
    __syncthreads();  // k_s / v_s are rewritten by the next tile
  }

  const long long ob = (long long)b * a.out_bstride + (long long)h * a.out_hstride
                       + (long long)q0 * a.out_ld;
  for (int idx = threadIdx.x; idx < BM * HD; idx += NT) {
    const int r = idx / HD;
    const int c = idx % HD;
    a.out[ob + (long long)r * a.out_ld + c] = __float2bfloat16(o_s[r * LDO + c] / l_s[r]);
  }
}

// K4 (RELPOS = true)
template <bool RELPOS>
__global__ void __launch_bounds__(NT) flash_attention_kernel(AttnArgs a) {
  attention_body<RELPOS>(a);
}

template <bool RELPOS>
int launch(void (*kernel)(AttnArgs), const AttnArgs& a, int B, cudaStream_t st) {
  const SmemLayout lay(a.C, RELPOS);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.T / BM, a.H, B);
  kernel<<<grid, NT, lay.total, st>>>(a);
  return (int)cudaGetLastError();
}

// the (B, T, H*D) output of K4
void set_token_major_out(AttnArgs& a, void* out) {
  a.out = reinterpret_cast<bf16*>(out);
  a.out_ld = (long long)a.H * HD;
  a.out_bstride = (long long)a.T * a.H * HD;
  a.out_hstride = HD;
}

}  // namespace

extern "C" {

// K4. q_u, k, v, out (B, T, H*64) bf16; qhat (B, T, H*C) bf16; shat (T, C)
// bf16; bias (B, T) f32. T % 64 == 0, C % 64 == 0.
int cbx_flash_relpos(const void* q_u, const void* k, const void* v, const void* qhat,
                     const void* shat, const void* bias, void* out, int B, int T, int H,
                     int C, float scale, void* stream) {
  if (T % BM != 0 || C % CCH != 0 || C <= 0) return (int)cudaErrorInvalidValue;
  AttnArgs a{};
  a.q = reinterpret_cast<const bf16*>(q_u);
  a.k = reinterpret_cast<const bf16*>(k);
  a.v = reinterpret_cast<const bf16*>(v);
  a.ld = (long long)H * HD;
  a.bstride = (long long)T * H * HD;
  a.hstride = HD;
  a.bias = reinterpret_cast<const float*>(bias);
  a.qhat = reinterpret_cast<const bf16*>(qhat);
  a.shat = reinterpret_cast<const bf16*>(shat);
  a.T = T;
  a.H = H;
  a.C = C;
  a.scale = scale;
  set_token_major_out(a, out);
  return launch<true>(flash_attention_kernel<true>, a, B,
                      reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
