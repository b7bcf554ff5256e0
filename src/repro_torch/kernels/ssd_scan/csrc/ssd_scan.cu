// Hopper (sm_90a) kernel for the chunked gated linear recurrence (SSD/GLA/WKV).
//
// Replaces repro/kernels/ssd_scan/kernel.py::chunked_scan_pallas.  Per (b*h):
//
//     S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T        (w_t <= 0, the log-decay)
//     y_t = S_t^T q_t   (inclusive: Mamba2/GLA)    y_t = S_{t-1}^T q_t   (exclusive: RWKV)
//
// with the final state S_L written out.  The TPU kernel takes one chunk of Q rows
// per grid step, forms the masked Q x Q score block in VMEM and carries S in
// scratch across the sequential grid.  Here the grid runs in parallel, so:
//
//   * one CTA per (b*h, tile of VT state columns): the state's columns are
//     independent, so a CTA carries its K x VT slice of S in shared memory over
//     the whole sequence, and the serve shape (b*h = 320, V = 128) gives 640 CTAs;
//   * the sequence is walked in tiles of TILE = 64 rows with S carried from tile
//     to tile, and the kernel takes no chunk: the recurrence is the same function
//     under any chunking (the psum feedback makes it exact), and the reference's
//     512-row serving chunk would need a 512 x 512 f32 score block (1 MB), more
//     than a CTA's 227 KB.  The tile also bounds every exponent: with the op's
//     clamp w >= -0.25, exp(-cumsum) over 64 rows stays within e^16, the bound
//     the clamp was written for, where exp(-cumsum) over a 512-row chunk would
//     reach e^128 and overflow f32.  The last tile's rows past L load as zeros;
//   * per tile: c = cumsum(w) along the tile, qd = q*exp(c) (exclusive: c - w),
//     kn = k*exp(-c), ke = k*exp(c_end - c); scores A = (qd kn^T) masked to
//     s <= t (s < t); y = A v + qd S; S = S*exp(c_end) + ke^T v.  Four 64 x 64
//     (x 64) products from shared memory, each thread a 4 x 4 register block.
//
// What bounds it on an H100: at the serve shape (b*h 320, L 1000) a launch moves
// ~0.6 GB (q, k, w, v, y in f32) and needs ~14.4 GFLOP of f32 products (the
// causal half of each tile's scores and A v, and the state's two K x V products
// per row), so on paper it is bound by the 67 TFLOP/s of f32 outside the tensor
// cores (0.22 ms) before the 3.35 TB/s of memory (0.18 ms).  This first version
// runs the products on the CUDA cores from shared memory, forms each tile's full
// 64 x 64 score square and masks it, and recomputes each tile's scores in both
// CTAs of a b*h; tensor cores (TF32 or split bf16) are later work.
//
// The C entry point launches on the caller's stream, does not synchronise and
// returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;        // sequence rows per tile
constexpr int MAX_K = 64;       // state rows (key width) a CTA holds
constexpr int VT = 64;          // state columns per CTA
constexpr int THREADS = 256;    // 16 x 16 threads, each a 4 x 4 block of a 64 x 64 product
constexpr int LDK = MAX_K + 1;  // padded rows of the [TILE][K] buffers (no bank conflicts)
constexpr int LDT = TILE + 1;   // padded rows of the score tile
constexpr int SMEM_FLOATS = 3 * TILE * LDK + TILE * LDT + TILE * VT + MAX_K * VT + MAX_K;

__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ sf,
            int L, int K, int V, int inclusive) {
  extern __shared__ float smem[];
  float* qd = smem;                 // [TILE][LDK]  q, then q * exp(c)
  float* kn = qd + TILE * LDK;      // [TILE][LDK]  k, then k * exp(-c)
  float* ke = kn + TILE * LDK;      // [TILE][LDK]  w, then c, then k * exp(c_end - c)
  float* at = ke + TILE * LDK;      // [TILE][LDT]  masked scores
  float* vt = at + TILE * LDT;      // [TILE][VT]   v tile
  float* st = vt + TILE * VT;       // [MAX_K][VT]  state slice
  float* tot = st + MAX_K * VT;     // [MAX_K]      c_end

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, v0 = blockIdx.x * VT;
  const int vw = min(VT, V - v0);
  const float* qb = q + (size_t)bh * L * K;
  const float* kb = k + (size_t)bh * L * K;
  const float* wb = w + (size_t)bh * L * K;
  const float* vb = v + (size_t)bh * L * V + v0;
  float* yb = y + (size_t)bh * L * V + v0;

  for (int e = tid; e < MAX_K * VT; e += THREADS) {
    const int r = e / VT, c = e % VT;
    st[e] = (r < K && c < vw) ? s0[(size_t)bh * K * V + (size_t)r * V + v0 + c] : 0.f;
  }

  for (int t0 = 0; t0 < L; t0 += TILE) {
    const int rows = min(TILE, L - t0);
    // 1. the tile's q, k, w and v; rows past L and columns past K load as 0,
    //    which leaves the state unchanged (exp(0) = 1, k = 0)
    for (int e = tid; e < TILE * MAX_K; e += THREADS) {
      const int r = e / MAX_K, c = e % MAX_K;
      const bool in = r < rows && c < K;
      const size_t g = (size_t)(t0 + r) * K + c;
      qd[r * LDK + c] = in ? qb[g] : 0.f;
      kn[r * LDK + c] = in ? kb[g] : 0.f;
      ke[r * LDK + c] = in ? wb[g] : 0.f;
    }
    for (int e = tid; e < TILE * VT; e += THREADS) {
      const int r = e / VT, c = e % VT;
      vt[e] = (r < rows && c < vw) ? vb[(size_t)(t0 + r) * V + c] : 0.f;
    }
    __syncthreads();

    // 2. cumulative log-decay along the tile, one thread per state row
    if (tid < MAX_K) {
      float c = 0.f;
      for (int r = 0; r < TILE; ++r) {
        const float wr = ke[r * LDK + tid];
        c += wr;
        qd[r * LDK + tid] *= expf(inclusive ? c : c - wr);
        ke[r * LDK + tid] = c;
      }
      tot[tid] = c;
    }
    __syncthreads();

    // 3. key factors: k * exp(-c) for the scores, k * exp(c_end - c) for the state
    for (int e = tid; e < TILE * MAX_K; e += THREADS) {
      const int r = e / MAX_K, c = e % MAX_K;
      const float kk = kn[r * LDK + c], cs = ke[r * LDK + c];
      kn[r * LDK + c] = kk * expf(-cs);
      ke[r * LDK + c] = kk * expf(tot[c] - cs);
    }
    __syncthreads();

    // 4. scores at[t][s] = qd[t] . kn[s], kept for s <= t (s < t exclusive)
    {
      float acc[4][4] = {};
      for (int kk = 0; kk < K; ++kk) {
        float ra[4], rb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ra[i] = qd[(ty + 16 * i) * LDK + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) rb[j] = kn[(tx + 16 * j) * LDK + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          const bool keep = inclusive ? s <= t : s < t;
          at[t * LDT + s] = keep ? acc[i][j] : 0.f;
        }
    }
    __syncthreads();

    // 5. y = at @ vt (within the tile) + qd @ st (from the carried state)
    {
      float acc[4][4] = {};
      for (int s = 0; s < TILE; ++s) {
        float ra[4], rb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ra[i] = at[(ty + 16 * i) * LDT + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) rb[j] = vt[s * VT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
      }
      for (int kk = 0; kk < K; ++kk) {
        float ra[4], rb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ra[i] = qd[(ty + 16 * i) * LDK + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) rb[j] = st[kk * VT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, c = tx + 16 * j;
          if (t < rows && c < vw) yb[(size_t)(t0 + t) * V + c] = acc[i][j];
        }
    }
    __syncthreads();  // every read of st above is done before st changes

    // 6. st = st * exp(c_end) + ke^T @ vt; each thread owns its 4 x 4 block of st
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = expf(tot[ty + 16 * i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = st[(ty + 16 * i) * VT + tx + 16 * j] * d;
      }
      for (int s = 0; s < TILE; ++s) {
        float ra[4], rb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ra[i] = ke[s * LDK + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) rb[j] = vt[s * VT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[(ty + 16 * i) * VT + tx + 16 * j] = acc[i][j];
    }
    __syncthreads();
  }

  for (int e = tid; e < MAX_K * VT; e += THREADS) {
    const int r = e / VT, c = e % VT;
    if (r < K && c < vw) sf[(size_t)bh * K * V + (size_t)r * V + v0 + c] = st[e];
  }
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// q, k, w [BH, L, K] f32, v [BH, L, V] f32, s0 [BH, K, V] f32 -> y [BH, L, V] f32,
// sf [BH, K, V] f32; K <= 64, BH <= 65535.
int ssd_scan(const void* q, const void* k, const void* v, const void* w, const void* s0,
             void* y, void* sf, int BH, int L, int K, int V, int inclusive, void* stream) {
  const size_t smem = (size_t)SMEM_FLOATS * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((V + VT - 1) / VT, BH);
  scan_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)w, (const float*)s0,
      (float*)y, (float*)sf, L, K, V, inclusive);
  return (int)cudaGetLastError();
}

}  // extern "C"
