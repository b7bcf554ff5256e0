// Hopper (sm_90a) kernels for attention with an online softmax (FlashAttention-2).
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas, and
// computes what it computes: per (b*h) and query row, softmax(q k^T * scale) v
// over the key columns c < Lk, causal rows keeping c <= row (no offset for
// Lq != Lk, the reference's convention), masked scores set to -1e30, the output
// normalised by the running sum with a guard for l > 0.  The output is written
// in the input type.  The TPU kernel walks a sequential (b*h, q block, kv block)
// grid with VMEM tiles of up to 512 x 4096 and carries (max, sum, accumulator)
// in scratch; here a CTA takes one 64-row query tile of one b*h and loops over
// 64-row kv tiles up to the diagonal (causal), carrying the three in registers.
// An online softmax gives the same result for any tiling, up to rounding.
//
// What bounds it on an H100 (SXM, 700 W): at the serve shape (b*h 256,
// L 1000, D 80, bf16, causal) a launch must move 164 MB (q, k, v, o once:
// 0.049 ms at 3.35 TB/s) and do 41 GFLOP of unmasked products (0.041 ms at the
// 989 TFLOP/s of the bf16 tensor cores), so bytes bound it, and only a kernel
// whose products run on the tensor cores can come near.  Next to the products,
// the softmax's per-score work on the CUDA cores (mask, max, exp2, sum) is what
// a D of 80 leaves little room to hide.
//
// bf16 (flash_kernel_mma, the serving path), FlashAttention-2 on mma.sync:
//   * 4 warps, each owning 16 query rows; Q is loaded once by cp.async and kept
//     in registers as ldmatrix A-fragments for the whole CTA;
//   * K and V tiles arrive by cp.async (16-byte copies, ragged rows zero-filled)
//     into a double-buffered ring, so tile j+1 loads while tile j computes;
//   * shared-memory rows are padded to D + 8 elements (176 bytes at D = 80), so
//     the 8 rows an ldmatrix reads fall in distinct banks;
//   * S = Q K^T by mma.sync.m16n8k16 bf16 -> f32: D = 80 is 5 k-steps of 16;
//   * the softmax stays in f32 registers: the mask is applied only on the tiles
//     that need it (the ragged last one and those the causal diagonal crosses),
//     row max and sum by quad shuffles, p = exp2(s * scale * log2(e) - m') as
//     one FFMA and one ex2.approx.ftz (a p below 2^-126 becomes 0);
//   * P goes from the S accumulators straight into bf16 A-fragments (no trip
//     through shared memory), rounded to bf16 as scaled_dot_product_attention
//     does (the row sums use f32 P); V's B-fragments come from ldmatrix.trans,
//     and D = 80 is 10 n-tiles of 8, so no output column is computed for nothing;
//   * on the diagonal tile a warp skips the 8-column n-tiles above its last row
//     (and past Lk), in both products;
//   * the grid puts b*h on x and the query tiles, last (heaviest under the
//     causal mask) first, on y, so the long tiles start first.  Masked scores
//     are -inf here; every row below Lq keeps column 0 of the first tile, so no
//     row is masked whole and the result is the reference's -1e30 convention.
//
// f32 (flash_kernel): the products stay in f32 on the CUDA cores, so f32 inputs
// keep f32 accuracy (the f32 rate, 67 TFLOP/s, is its ceiling).  256 threads as
// 16 x 16, a thread owning rows ty + 16i (i < 4) and score columns tx + 16j
// (j < 4); q, k, v and the probabilities sit in shared memory in f32.  The
// type of the inputs chooses the kernel.
//
// The C entry point launches on the caller's stream, does not synchronise and
// returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // key rows per tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- f32 kernel

constexpr int MAX_D = 128;     // head width the f32 accumulator registers hold
constexpr int NJ = MAX_D / 16; // output columns per thread
constexpr int THREADS = 256;
constexpr int LDP = BK + 1;    // padded rows of the probability tile

size_t smem_bytes_f32(int D) {
  const int ldk = D | 1;
  return (size_t)(BQ * D + BK * ldk + BK * D + BQ * LDP) * sizeof(float);
}

__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int Lq, int Lk, int D,
             float scale, int causal) {
  extern __shared__ float smem[];
  const int ldk = D | 1;
  float* qs = smem;            // [BQ][D]    q * scale
  float* ks = qs + BQ * D;     // [BK][ldk]
  float* vs = ks + BK * ldk;   // [BK][D]
  float* ps = vs + BK * D;     // [BQ][LDP]  probabilities of the current kv tile

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int qrows = min(BQ, Lq - q0);
  const float* qb = q + ((size_t)bh * Lq + q0) * D;
  const float* kb = k + (size_t)bh * Lk * D;
  const float* vb = v + (size_t)bh * Lk * D;
  float* ob = o + ((size_t)bh * Lq + q0) * D;

  for (int e = tid; e < BQ * D; e += THREADS) qs[e] = e / D < qrows ? qb[e] * scale : 0.f;

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
      ks[r * ldk + c] = in ? kb[(size_t)k0 * D + e] : 0.f;
      vs[e] = in ? vb[(size_t)k0 * D + e] : 0.f;
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
      if (r < qrows && c < D) ob[(size_t)r * D + c] = acc[i][j] * norm;
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int BH, int Lq, int Lk,
               int D, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes_f32(D);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + BQ - 1) / BQ, BH);
  flash_kernel<<<grid, THREADS, smem, stream>>>((const float*)q, (const float*)k,
                                                (const float*)v, (float*)o, Lq, Lk, D, scale,
                                                causal);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- bf16 kernel

constexpr int MMA_THREADS = 128;  // four warps, 16 query rows each
// 2^x by the MUFU unit, results below 2^-126 flushed to 0 (a probability that
// small cannot move an f32 sum that holds the row maximum's 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy; bytes past src_bytes (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one bf16x2 register, x0 in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_kernel_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Lq,
                 int Lk, float scale_log2, int causal) {
  constexpr int LDS = D + 8;  // padded row stride (elements) of every tile
  constexpr int KS = D / 16;  // k-steps of Q K^T
  constexpr int NO = D / 8;   // n-tiles of the output
  constexpr int CH = D / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LDS]
  __nv_bfloat16* ks = qs + BQ * LDS;                               // [2][BK][LDS]
  __nv_bfloat16* vs = ks + 2 * BK * LDS;                           // [2][BK][LDS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int qrows = min(BQ, Lq - q0);
  const __nv_bfloat16* qb = q + ((size_t)bh * Lq + q0) * D;
  const __nv_bfloat16* kb = k + (size_t)bh * Lk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Lk * D;
  __nv_bfloat16* ob = o + ((size_t)bh * Lq + q0) * D;

  const int nk = (Lk + BK - 1) / BK;
  // causal: kv tiles up to the one holding this q tile's last row
  const int kend = causal ? min(nk, (q0 + qrows - 1) / BK + 1) : nk;

  for (int c = tid; c < BQ * CH; c += MMA_THREADS) {
    const int r = c / CH, cc = c % CH;
    cp_async16(qs + r * LDS + cc * 8, qb + (size_t)min(r, qrows - 1) * D + cc * 8,
               r < qrows ? 16 : 0);
  }
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * BK, krows = min(BK, Lk - k0);
    __nv_bfloat16* kd = ks + buf * BK * LDS;
    __nv_bfloat16* vd = vs + buf * BK * LDS;
    for (int c = tid; c < BK * CH; c += MMA_THREADS) {
      const int r = c / CH, cc = c % CH;
      const size_t off = (size_t)(k0 + min(r, krows - 1)) * D + cc * 8;
      const int n = r < krows ? 16 : 0;
      cp_async16(kd + r * LDS + cc * 8, kb + off, n);
      cp_async16(vd + r * LDS + cc * 8, vb + off, n);
    }
  };
  if (kend > 0) load_kv(0, 0);
  cp_async_commit();

  const int r0 = q0 + warp * 16;            // this warp's first query row
  const int row0 = r0 + g, row1 = r0 + g + 8;
  const bool active = r0 < Lq;              // warps past the last row only sync
  uint32_t qf[KS][4];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // running max of the raw scores and partial sums of rows g and g + 8
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < kend; ++kt) {
    if (kt + 1 < kend) load_kv(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile kt have landed
    __syncthreads();
    const __nv_bfloat16* kts = ks + (kt & 1) * BK * LDS;
    const __nv_bfloat16* vts = vs + (kt & 1) * BK * LDS;
    const int k0 = kt * BK;
    if (active) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                  kk * 16 + (lane >> 4) * 8);
      }
      // n-tiles of 8 keys this warp needs: keys < Lk and, causal, <= its last row
      int nt_end = min(8, (Lk - k0 + 7) / 8);
      if (causal) nt_end = min(nt_end, (r0 + 15 - k0) / 8 + 1);
      // only the ragged last tile and the tiles the causal diagonal crosses mask
      const bool masked = k0 + BK > Lk || (causal && k0 + BK - 1 > r0);

      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (2 * np < nt_end) {
            uint32_t b[4];
            ldmatrix_x4(b, kts + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDS + kk * 16 +
                               ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
            if (2 * np + 1 < nt_end) mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
          }
        }
      }

      // masked scores -> -inf (exp2 gives 0), row maxima over the quad
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (masked) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + nt * 8 + 2 * t + (e & 1);
            const bool keep = nt < nt_end && col < Lk && (!causal || col <= (e < 2 ? row0 : row1));
            s[nt][e] = keep ? s[nt][e] : __uint_as_float(0xff800000u);  // -inf
          }
        }
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f((m0 - mn0) * scale_log2), al1 = exp2f((m1 - mn1) * scale_log2);
      m0 = mn0;
      m1 = mn1;
      // p = exp(scale * (s - m)) as one FFMA and one exp2
      const float ms0 = mn0 * scale_log2, ms1 = mn1 * scale_log2;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = exp2_ftz(fmaf(s[nt][0], scale_log2, -ms0));
        s[nt][1] = exp2_ftz(fmaf(s[nt][1], scale_log2, -ms0));
        s[nt][2] = exp2_ftz(fmaf(s[nt][2], scale_log2, -ms1));
        s[nt][3] = exp2_ftz(fmaf(s[nt][3], scale_log2, -ms1));
        rs0 += s[nt][0] + s[nt][1];
        rs1 += s[nt][2] + s[nt][3];
      }
      l0 = l0 * al0 + rs0;  // per-thread partial sums; the quad is summed at the end
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][0] *= al0;
        acc[j][1] *= al0;
        acc[j][2] *= al1;
        acc[j][3] *= al1;
      }

      // P as bf16 A-fragments: the S accumulators of n-tiles 2kj, 2kj+1 are the
      // A-fragment of PV's k-step kj (keys 16kj .. 16kj+15).  Packing all four
      // here, before the PV loop, frees the 32 score registers early.
      uint32_t pa[4][4];
#pragma unroll
      for (int kj = 0; kj < 4; ++kj) {
        pa[kj][0] = pack_bf16(s[2 * kj][0], s[2 * kj][1]);
        pa[kj][1] = pack_bf16(s[2 * kj][2], s[2 * kj][3]);
        pa[kj][2] = pack_bf16(s[2 * kj + 1][0], s[2 * kj + 1][1]);
        pa[kj][3] = pack_bf16(s[2 * kj + 1][2], s[2 * kj + 1][3]);
      }
      // O += P V
#pragma unroll
      for (int kj = 0; kj < 4; ++kj) {
        if (2 * kj < nt_end) {
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vts + (kj * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDS +
                                     dp * 16 + (lane >> 4) * 8);
            mma_bf16(acc[2 * dp], pa[kj], b[0], b[1]);
            mma_bf16(acc[2 * dp + 1], pa[kj], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with buffer kt & 1 before it is refilled
  }

  // normalise; stage the tile in qs (Q lives in registers) and store 16 bytes a lane
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float n0 = l0 > 0.f ? 1.f / l0 : 0.f, n1 = l1 > 0.f ? 1.f / l1 : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  __nv_bfloat16* os = qs + warp * 16 * LDS;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(os + g * LDS + j * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[j][0] * n0, acc[j][1] * n0);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * LDS + j * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[j][2] * n1, acc[j][3] * n1);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, cc = c % CH;
    if (warp * 16 + r < qrows)
      *reinterpret_cast<uint4*>(ob + (size_t)(warp * 16 + r) * D + cc * 8) =
          *reinterpret_cast<const uint4*>(os + r * LDS + cc * 8);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int BH, int Lq, int Lk,
               float scale, int causal, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 4 * BK) * (D + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel_mma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Lq + BQ - 1) / BQ);
  flash_kernel_mma<D><<<grid, MMA_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, Lq, Lk, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, int BH, int Lq, int Lk,
                int D, float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_mma<16>(q, k, v, o, BH, Lq, Lk, scale, causal, stream);
    case 32: return launch_mma<32>(q, k, v, o, BH, Lq, Lk, scale, causal, stream);
    case 48: return launch_mma<48>(q, k, v, o, BH, Lq, Lk, scale, causal, stream);
    case 64: return launch_mma<64>(q, k, v, o, BH, Lq, Lk, scale, causal, stream);
    case 80: return launch_mma<80>(q, k, v, o, BH, Lq, Lk, scale, causal, stream);
    case 96: return launch_mma<96>(q, k, v, o, BH, Lq, Lk, scale, causal, stream);
    case 112: return launch_mma<112>(q, k, v, o, BH, Lq, Lk, scale, causal, stream);
    case 128: return launch_mma<128>(q, k, v, o, BH, Lq, Lk, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q [BH, Lq, D], k and v [BH, Lk, D], o [BH, Lq, D], all of one type:
// dtype 0 = f32 (D <= 128, BH <= 65535), 1 = bf16 (D a multiple of 16 up to
// 128, ceil(Lq / 64) <= 65535).
int flash_attention(const void* q, const void* k, const void* v, void* o, int BH, int Lq,
                    int Lk, int D, float scale, int causal, int dtype, void* stream) {
  if (dtype == 1)
    return launch_bf16(q, k, v, o, BH, Lq, Lk, D, scale, causal, (cudaStream_t)stream);
  return launch_f32(q, k, v, o, BH, Lq, Lk, D, scale, causal, (cudaStream_t)stream);
}

}  // extern "C"
