// Hopper (sm_90a) kernel for attention with an online softmax (FlashAttention-2).
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas, and
// computes what it computes: per (b*h) and query row, softmax(q k^T * scale) v
// over the key columns c < Lk, causal rows keeping c <= row (no offset for
// Lq != Lk, the reference's convention), masked scores set to -1e30, the output
// normalised by the running sum with a guard for l > 0.  Inputs are upcast to
// f32; the output is written in the input type.
//
// The TPU kernel walks a sequential (b*h, q block, kv block) grid with VMEM
// tiles of up to 512 x 4096 and carries (max, sum, accumulator) in scratch.
// Here:
//   * one CTA per (64-row q tile, b*h); it loops over 64-row kv tiles up to the
//     diagonal (causal) and carries max, sum and the accumulator in registers;
//     the tiling differs from the TPU's, and an online softmax gives the same
//     result for any tiling, up to rounding;
//   * 256 threads as 16 x 16; a thread owns rows ty + 16i (i < 4) of the tile,
//     score columns tx + 16j (j < 4) and output columns tx + 16j (j < D/16);
//     row maxima and sums are reduced over the 16 threads of a row by shuffles;
//   * the head width D (80 for Zamba2) is a loop bound, not a padded 128:
//     q, k, v and the probabilities sit in shared memory in f32, k's rows
//     padded to an odd stride so a warp's reads hit distinct banks.
//
// What bounds it on an H100: at the serve shape (b*h = 256, L = 1000, D = 80,
// bf16, causal) a launch moves 164 MB and does ~41 GFLOP, so the card could do
// it in ~0.05 ms (bytes over 3.35 TB/s; the bf16 tensor cores' 989 TFLOP/s
// would take 0.04 ms).  This first version computes the products in f32 on the
// CUDA cores from shared memory, so the f32 rate (67 TFLOP/s) is its ceiling;
// tensor cores (mma/wgmma in bf16), TMA and warp specialisation are later work.
//
// The C entry point launches on the caller's stream, does not synchronise and
// returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // key rows per tile
constexpr int MAX_D = 128;     // head width the accumulator registers hold
constexpr int NJ = MAX_D / 16; // output columns per thread
constexpr int THREADS = 256;
constexpr int LDP = BK + 1;    // padded rows of the probability tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int D) {
  const int ldk = D | 1;
  return (size_t)(BQ * D + BK * ldk + BK * D + BQ * LDP) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int Lq, int Lk, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int ldk = D | 1;
  float* qs = smem;            // [BQ][D]    q * scale
  float* ks = qs + BQ * D;     // [BK][ldk]
  float* vs = ks + BK * ldk;   // [BK][D]
  float* ps = vs + BK * D;     // [BQ][LDP]  probabilities of the current kv tile

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int qrows = min(BQ, Lq - q0);
  const T* qb = q + ((size_t)bh * Lq + q0) * D;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;
  T* ob = o + ((size_t)bh * Lq + q0) * D;

  for (int e = tid; e < BQ * D; e += THREADS)
    qs[e] = e / D < qrows ? to_f32(qb[e]) * scale : 0.f;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (Lk + BK - 1) / BK;
  // causal: skip kv tiles strictly above the diagonal band of this q tile
  const int kend = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * BK;
    const int krows = min(BK, Lk - k0);
    __syncthreads();  // the previous tile's reads of ks, vs and ps are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool in = r < krows;
      ks[r * ldk + c] = in ? to_f32(kb[(size_t)k0 * D + e]) : 0.f;
      vs[e] = in ? to_f32(vb[(size_t)k0 * D + e]) : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
    for (int d = 0; d < D; ++d) {
      float ra[4], rb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ra[i] = qs[(ty + 16 * i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) rb[j] = ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(ra[i], rb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < Lk && (!causal || row >= col);
        s[i][j] = keep ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes tx = 0..15 of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_cur);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_cur);
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_cur;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int r = 0; r < BK; ++r) {
      float pa[4], vr[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(ty + 16 * i) * LDP + r];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        vr[j] = c < D ? vs[r * D + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], vr[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float norm = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (r < qrows && c < D) ob[(size_t)r * D + c] = from_f32<T>(acc[i][j] * norm);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int Lq, int Lk,
           int D, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + BQ - 1) / BQ, BH);
  flash_kernel<T><<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                   (T*)o, Lq, Lk, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q [BH, Lq, D], k and v [BH, Lk, D], o [BH, Lq, D], all of one type:
// dtype 0 = f32, 1 = bf16.  D <= 128, BH <= 65535.
int flash_attention(const void* q, const void* k, const void* v, void* o, int BH, int Lq,
                    int Lk, int D, float scale, int causal, int dtype, void* stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, BH, Lq, Lk, D, scale, causal,
                                 (cudaStream_t)stream);
  return launch<float>(q, k, v, o, BH, Lq, Lk, D, scale, causal, (cudaStream_t)stream);
}

}  // extern "C"
