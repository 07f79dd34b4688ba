// The Mamba-2 decode update of T3's Granite backbone: one token a row
// through one Mamba layer's conv and recurrence, the state in place.
//
// Per row r and head h (H heads of P = 64 channels, one group of N = 128
// state channels, a depthwise causal conv of width KC = 4):
//   xBC  = silu(conv_b + sum_k conv_w[:, k] * [conv_state[:, 0..2], new][k])
//   x, B, C = split(xBC, [H * P, N, N])
//   dt   = softplus(dt_raw + dt_bias[h]);  dA = exp(dt * A[h])  (A = -exp(A_log))
//   s[p, n] = dA * s[p, n] + (dt * x[p]) * B[n]          (in place, fp32)
//   y[p] = sum_n s[p, n] * C[n] + D[h] * x[p]            (fp32 out)
// and the conv state moves on by one token: [s1, s2, new]. The gate, the
// norm and out_proj stay in PyTorch (models/t3/granite_hybrid.py), as does
// in_proj, whose output row (z, xBC, dt) the kernel reads in place.
//
// What bounds it: bytes. Each (row, head) reads and writes its P x N fp32
// state once (64 KiB), against 5 flops a state value: 0.6 flop/byte, far
// below Hopper's ~295 flop/byte ridge, so the state's traffic is the
// launch's time. At T3's 128 CFG rows x 64 heads that is 512 MiB a layer a
// step. Design: one 128-thread CTA a (row, head), H x R CTAs a launch (8192
// at 64 x 128, many waves over the 132 SMs). Each warp owns one state row p
// at a time, each lane one float4 of its 128 n: the 16 rows of a warp are
// loaded before any is used (16 float4 = 256 bytes in flight a thread, 32
// KiB a CTA), updated with one fma a value, stored back, and dotted with C
// by a 5-step shuffle. x, B and C (after the conv) sit in shared memory.
//
// The conv state of the x channels belongs to one head's CTA, which shifts
// it; B's and C's channels are read by all H CTAs of a row, so none may
// shift them until all have read them. Each CTA takes a ticket on its row's
// counter after its reads (the K1 combine's pattern, flash_decode.cu); the
// H-th to arrive shifts B's and C's channels from what it read and resets
// the counter. The counters (R int32) belong to the state tensor (the
// wrapper makes them once, zero) and are 0 between launches, so launches on
// one state run in order on the device, as its writes must anyway.
//
// Nothing reads a position or a step: a CUDA graph that captured a launch
// replays it at every decode step.

#include "common.cuh"

namespace {

constexpr int P = 64;          // head dim (Granite 4.0-H's mamba_d_head)
constexpr int N = 128;         // state channels (mamba_d_state), one group
constexpr int KC = 4;          // conv width (mamba_d_conv)
constexpr int THREADS = 128;   // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = P / WARPS;  // state rows a warp: 16

static_assert(N == 32 * 4, "one float4 of the state a lane a row");
static_assert(2 * N == 2 * THREADS && P <= THREADS, "the conv's thread layout");

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// PyTorch's softplus (beta 1, threshold 20)
__device__ __forceinline__ float softplus(float v) { return v > 20.f ? v : log1pf(expf(v)); }

// one channel's conv over [s0, s1, s2, new] with its bias, then SiLU
__device__ __forceinline__ float conv4(const float* w, float b, float s0, float s1, float s2,
                                       float nw) {
  float v = b;
  v = fmaf(w[0], s0, v);
  v = fmaf(w[1], s1, v);
  v = fmaf(w[2], s2, v);
  v = fmaf(w[3], nw, v);
  return silu(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssm_update_kernel(
    T* __restrict__ conv_state,        // this layer's (R, conv_dim, KC - 1)
    float* __restrict__ ssm,           // this layer's (R, H, P, N)
    const T* __restrict__ zxbcdt,      // (R, in_dim): z, xBC, dt
    const float* __restrict__ conv_w,  // (conv_dim, KC)
    const float* __restrict__ conv_b,  // (conv_dim,)
    const float* __restrict__ dt_bias, const float* __restrict__ A_neg,
    const float* __restrict__ Dskip,   // (H,) each
    float* __restrict__ y,             // (R, H * P)
    int H, int in_dim, int* __restrict__ tickets) {
  const int h = blockIdx.x, r = blockIdx.y, tid = threadIdx.x;
  const int d_inner = H * P, conv_dim = d_inner + 2 * N;
  __shared__ float xs[P];
  __shared__ __align__(16) float bs[N];
  __shared__ __align__(16) float cs[N];
  __shared__ int last;

  // the state's first loads, issued before the conv: they do not depend on it
  const int lane = tid & 31, warp = tid >> 5;
  float* st = ssm + ((long long)r * H + h) * P * N + 4 * lane;
  float4 s[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) s[i] = *reinterpret_cast<const float4*>(st + (warp + WARPS * i) * N);

  const T* in = zxbcdt + (long long)r * in_dim;
  T* cst = conv_state + (long long)r * conv_dim * (KC - 1);
  const float dt_raw = to_float(in[d_inner + conv_dim + h]);
  if (tid < P) {  // this head's x channels: read, convolved and shifted here
    const int c = h * P + tid;
    const float s0 = to_float(cst[3 * c]), s1 = to_float(cst[3 * c + 1]);
    const float s2 = to_float(cst[3 * c + 2]);
    const T nw = in[d_inner + c];
    xs[tid] = conv4(conv_w + KC * c, conv_b[c], s0, s1, s2, to_float(nw));
    cst[3 * c] = cst[3 * c + 1];
    cst[3 * c + 1] = cst[3 * c + 2];
    cst[3 * c + 2] = nw;
  }
  T keep[2][KC - 1];  // B's and C's channels tid and tid + THREADS: s1, s2, new
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = tid + k * THREADS, c = d_inner + j;
    const float s0 = to_float(cst[3 * c]);
    keep[k][0] = cst[3 * c + 1];
    keep[k][1] = cst[3 * c + 2];
    keep[k][2] = in[d_inner + c];
    const float v = conv4(conv_w + KC * c, conv_b[c], s0, to_float(keep[k][0]),
                          to_float(keep[k][1]), to_float(keep[k][2]));
    if (j < N) {
      bs[j] = v;
    } else {
      cs[j - N] = v;
    }
  }
  __syncthreads();  // every read of B's and C's conv state is done
  if (tid == 0) {
    const bool is_last = atomicAdd(tickets + r, 1) == H - 1;
    if (is_last) tickets[r] = 0;
    last = is_last;
  }
  __syncthreads();
  if (last) {  // every head of the row has read them: shift B's and C's channels
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = d_inner + tid + k * THREADS;
#pragma unroll
      for (int q = 0; q < KC - 1; ++q) cst[3 * c + q] = keep[k][q];
    }
  }

  const float dt = softplus(dt_raw + dt_bias[h]);
  const float dA = expf(dt * A_neg[h]);
  const float dskip = Dskip[h];
  const float4 b4 = reinterpret_cast<const float4*>(bs)[lane];
  const float4 c4 = reinterpret_cast<const float4*>(cs)[lane];
  float* yr = y + (long long)r * d_inner + h * P;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int p = warp + WARPS * i;
    const float dtx = dt * xs[p];
    float4 v = s[i];
    v.x = fmaf(dA, v.x, dtx * b4.x);
    v.y = fmaf(dA, v.y, dtx * b4.y);
    v.z = fmaf(dA, v.z, dtx * b4.z);
    v.w = fmaf(dA, v.w, dtx * b4.w);
    *reinterpret_cast<float4*>(st + p * N) = v;
    float part = v.x * c4.x + v.y * c4.y + v.z * c4.z + v.w * c4.w;
    part = warp_sum(part);
    if (lane == 0) yr[p] = part + dskip * xs[p];
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, of conv_state and zxbcdt. conv_state
// (R, conv_dim, 3) and ssm (R, H, 64, 128) fp32: one layer's, contiguous;
// zxbcdt (R, in_dim), in_dim = H*64 + conv_dim + H, conv_dim = H*64 + 256;
// conv_w (conv_dim, 4), conv_b (conv_dim,), dt_bias, A_neg (= -exp(A_log))
// and D (H,) fp32; y (R, H*64) fp32; tickets (R,) int32, zero, reused by
// every launch on one state. All device pointers.
int cbx_ssm_update(void* conv_state, void* ssm, const void* zxbcdt, int dtype, const void* conv_w,
                   const void* conv_b, const void* dt_bias, const void* A_neg, const void* D,
                   void* y, int R, int H, int in_dim, void* tickets, void* stream) {
  if (R <= 0 || R > 65535 || H <= 0 || in_dim != H * P + (H * P + 2 * N) + H) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(H, R);
  const float* w = reinterpret_cast<const float*>(conv_w);
  const float* b = reinterpret_cast<const float*>(conv_b);
  const float* dtb = reinterpret_cast<const float*>(dt_bias);
  const float* an = reinterpret_cast<const float*>(A_neg);
  const float* dd = reinterpret_cast<const float*>(D);
  float* s = reinterpret_cast<float*>(ssm);
  float* yy = reinterpret_cast<float*>(y);
  int* tk = reinterpret_cast<int*>(tickets);
  if (dtype == 1) {
    ssm_update_kernel<bf16><<<grid, THREADS, 0, st>>>(
        reinterpret_cast<bf16*>(conv_state), s, reinterpret_cast<const bf16*>(zxbcdt), w, b, dtb,
        an, dd, yy, H, in_dim, tk);
  } else if (dtype == 0) {
    ssm_update_kernel<float><<<grid, THREADS, 0, st>>>(
        reinterpret_cast<float*>(conv_state), s, reinterpret_cast<const float*>(zxbcdt), w, b,
        dtb, an, dd, yy, H, in_dim, tk);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
