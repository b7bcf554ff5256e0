// Hopper (sm_90a) kernel for the chunked gated linear recurrence (SSD/GLA/WKV).
//
// Replaces repro/kernels/ssd_scan/kernel.py::chunked_scan_pallas.  Per (b*h):
//
//     S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T        (w_t <= 0, the log-decay)
//     y_t = S_t^T q_t   (inclusive: Mamba2/GLA)    y_t = S_{t-1}^T q_t   (exclusive: RWKV)
//
// with the final state S_L written out.  The TPU kernel takes one chunk of Q rows
// per grid step, forms the masked Q x Q score block in VMEM and carries S in
// scratch across the sequential grid.  Here one CTA per b*h (and per 128 state
// columns, one at V <= 128) walks the sequence in tiles of TILE = 64 rows and
// carries its K x 128 slice of S in shared memory from tile to tile.  The
// recurrence is the same function under any chunking (the psum feedback makes it
// exact), and the 64-row tile bounds every exponent: with the op's clamp
// w >= -0.25, exp(-cumsum) over 64 rows stays within e^16.  The last tile's rows
// past L load as zeros, which leave the state unchanged.  Per tile, with
// c = cumsum(w) along the tile: qd = q*exp(c) (exclusive: c - w), kn = k*exp(-c),
// ke = k*exp(c_end - c); scores A = (qd kn^T) masked to s <= t (s < t);
// y = A v + qd S; S = S*exp(c_end) + ke^T v.
//
// What bounds it on an H100 (SXM, 700 W): at the serve shape (b*h 320, L 1000,
// K 64, V 128) a launch must move 0.59 GB (q, k, w, v, y, s0, S_L in f32 once:
// 0.18 ms at 3.35 TB/s) and do 14.4 GFLOP (the causal half of each tile's scores
// and A v, and the state's two K x V products per row): 0.22 ms at the 67 TFLOP/s
// of f32 outside the tensor cores, 0.087 ms as 3xTF32 on the tensor cores
// (3 x 14.4 GFLOP at 495 TFLOP/s).  Plain TF32 would be 3x cheaper but keeps 10
// bits of mantissa, and misses the 2e-4 the scan is held to.  What holds it
// above those bounds is the sequence: a b*h is 16 dependent tiles, so a CTA
// can overlap only the next tile's loads with this tile's work, and 320 CTAs
// of one per SM run in three waves on 132 SMs.  The design:
//   * every product on the tensor cores, mma.sync.m16n8k8 TF32 in the 3xTF32
//     split: x = hi + lo, each rounded to TF32 to nearest (the rounding of
//     cvt.rna.tf32.f32, done here in two integer operations), and
//     a*b = a_lo*b_hi + a_hi*b_lo + a_hi*b_hi accumulated in
//     f32, which keeps ~f32 accuracy; qd, an operand of 24 warps' products, is
//     split once when it is formed;
//   * one CTA of 16 warps covers all 128 state columns, so a b*h's scores are
//     computed once;
//   * only the causal part of the score tile: the 8-wide column blocks at or
//     below the diagonal of each 16-row block (20 of 32), and A v reads only
//     those blocks;
//   * the cumsum runs on all 512 threads: each takes 8 rows of one column, and
//     the eight partial sums of a column are combined through shared memory;
//   * the state update folds the decay: S = exp(c_end) * (S + kn^T v), which
//     reuses kn = k*exp(-c) and saves forming ke (one exp per element);
//   * the next tile's q, k, w and v arrive by cp.async (16-byte copies, ragged
//     rows zero-filled) while this tile computes (v double-buffered);
//   * shared-memory row strides (68 and 136 floats) make the fragment reads
//     conflict-free (kn read transposed: 2-way).
// 225.5 KB of shared memory: one CTA per SM.
//
// The C entry point launches on the caller's stream, does not synchronise and
// returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;       // sequence rows per tile
constexpr int KP = 64;         // key width the CTA holds (columns past K are zeros)
constexpr int VT = 128;        // state columns per CTA
constexpr int THREADS = 512;   // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int SEGS = THREADS / KP;      // row segments of the cumsum
constexpr int SEG_ROWS = TILE / SEGS;   // rows per segment
constexpr int LDQ = KP + 4;    // qd, kn, scores: row-major fragment reads
constexpr int LDV = VT + 8;    // v and the state: read down the rows
constexpr int RAW = TILE * KP; // q, k, w as loaded
constexpr int QD = 0, KN = QD + TILE * LDQ, SC = KN + TILE * LDQ, ST = SC + TILE * LDQ,
              VB = ST + KP * LDV, RQ = VB + 2 * TILE * LDV, RK = RQ + RAW, RW = RK + RAW,
              SEG = RW + RAW, TOT = SEG + SEGS * KP, QL = TOT + KP,
              SMEM_FLOATS = QL + TILE * LDQ;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16-byte global -> shared copy; bytes past src_bytes (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// f32 -> TF32 rounded to nearest, ties away from zero, as cvt.rna.tf32.f32 does for
// finite x: add half of the 13 dropped mantissa bits' weight, then clear them
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c += a b at ~f32 accuracy (3xTF32): the small terms first
__device__ __forceinline__ void mma_3x(float (&c)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                       const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4), split into hi and lo.
// A (16 x 8) from a row-major tile: A[m][k] = p[m * ld + k]
__device__ __forceinline__ void frag_a(const float* p, int ld, int g, int t, uint32_t (&h)[4],
                                       uint32_t (&l)[4]) {
  split(p[g * ld + t], h[0], l[0]);
  split(p[(g + 8) * ld + t], h[1], l[1]);
  split(p[g * ld + t + 4], h[2], l[2]);
  split(p[(g + 8) * ld + t + 4], h[3], l[3]);
}
// A (16 x 8) from the transpose of a row-major tile: A[m][k] = p[k * ld + m]
__device__ __forceinline__ void frag_at(const float* p, int ld, int g, int t, uint32_t (&h)[4],
                                        uint32_t (&l)[4]) {
  split(p[t * ld + g], h[0], l[0]);
  split(p[t * ld + g + 8], h[1], l[1]);
  split(p[(t + 4) * ld + g], h[2], l[2]);
  split(p[(t + 4) * ld + g + 8], h[3], l[3]);
}
// B (8 x 8) from a row-major k x n tile: B[k][n] = p[k * ld + n]
__device__ __forceinline__ void frag_b(const float* p, int ld, int g, int t, uint32_t (&h)[2],
                                       uint32_t (&l)[2]) {
  split(p[t * ld + g], h[0], l[0]);
  split(p[(t + 4) * ld + g], h[1], l[1]);
}
// B (8 x 8) from a row-major n x k tile: B[k][n] = p[n * ld + k]
__device__ __forceinline__ void frag_bt(const float* p, int ld, int g, int t, uint32_t (&h)[2],
                                        uint32_t (&l)[2]) {
  split(p[g * ld + t], h[0], l[0]);
  split(p[g * ld + t + 4], h[1], l[1]);
}

__global__ void __launch_bounds__(THREADS, 1)
scan_kernel_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ sf,
                   int L, int K, int V, int inclusive) {
  extern __shared__ __align__(16) float smem[];
  float* qd = smem + QD;    // [TILE][LDQ]  q * exp(c), TF32 hi part
  float* ql = smem + QL;    // [TILE][LDQ]  its lo part
  float* kn = smem + KN;    // [TILE][LDQ]  k * exp(-c)
  float* sc = smem + SC;    // [TILE][LDQ]  masked scores (causal blocks only)
  float* st = smem + ST;    // [KP][LDV]    the state slice
  float* vbuf = smem + VB;  // [2][TILE][LDV]
  float* rq = smem + RQ;    // [TILE][KP]   the next tile's q, k, w as loaded
  float* rk = smem + RK;
  float* rw = smem + RW;
  float* seg = smem + SEG;  // [SEGS][KP]   partial sums of w per segment of rows
  float* etot = smem + TOT; // [KP]         exp(c_end)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, v0 = blockIdx.x * VT;
  const int vw = min(VT, V - v0);
  const float* qb = q + (size_t)b * L * K;
  const float* kb = k + (size_t)b * L * K;
  const float* wb = w + (size_t)b * L * K;
  const float* vb = v + (size_t)b * L * V + v0;
  float* yb = y + (size_t)b * L * V + v0;
  const int ntiles = (L + TILE - 1) / TILE;

  auto load_qkw = [&](int it) {
    const int t0 = it * TILE, rows = min(TILE, L - t0);
    for (int c = tid; c < TILE * (KP / 4); c += THREADS) {
      const int r = c >> 4, cc = c & 15;
      const bool in = r < rows && cc * 4 < K;
      const size_t off = in ? (size_t)(t0 + r) * K + cc * 4 : 0;
      const int n = in ? 16 : 0;
      cp_async16(rq + r * KP + cc * 4, qb + off, n);
      cp_async16(rk + r * KP + cc * 4, kb + off, n);
      cp_async16(rw + r * KP + cc * 4, wb + off, n);
    }
    cp_async_commit();
  };
  auto load_v = [&](int it) {
    const int t0 = it * TILE, rows = min(TILE, L - t0);
    float* vdst = vbuf + (it & 1) * TILE * LDV;
    for (int c = tid; c < TILE * (VT / 4); c += THREADS) {
      const int r = c >> 5, cc = c & 31;
      const bool in = r < rows && cc * 4 < vw;
      const size_t off = in ? (size_t)(t0 + r) * V + cc * 4 : 0;
      cp_async16(vdst + r * LDV + cc * 4, vb + off, in ? 16 : 0);
    }
    cp_async_commit();
  };
  // A fragment (16 x 8) of qd at element off, already split into hi and lo
  auto frag_qd = [&](int off, uint32_t (&h)[4], uint32_t (&l)[4]) {
    const int i0 = off + g * LDQ + t, i1 = i0 + 8 * LDQ;
    h[0] = __float_as_uint(qd[i0]);
    l[0] = __float_as_uint(ql[i0]);
    h[1] = __float_as_uint(qd[i1]);
    l[1] = __float_as_uint(ql[i1]);
    h[2] = __float_as_uint(qd[i0 + 4]);
    l[2] = __float_as_uint(ql[i0 + 4]);
    h[3] = __float_as_uint(qd[i1 + 4]);
    l[3] = __float_as_uint(ql[i1 + 4]);
  };

  for (int e = tid; e < KP * VT; e += THREADS) {
    const int r = e / VT, c = e % VT;
    st[r * LDV + c] = (r < K && c < vw) ? s0[(size_t)b * K * V + (size_t)r * V + v0 + c] : 0.f;
  }
  if (ntiles > 0) {
    load_qkw(0);
    load_v(0);
  }

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * TILE, rows = min(TILE, L - t0);
    const float* vt = vbuf + (it & 1) * TILE * LDV;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; the last tile's state is written
    if (it + 1 < ntiles) load_v(it + 1);  // into the buffer tile it - 1 used

    // 1. cumulative log-decay: thread (column c, segment sg) sums SEG_ROWS rows,
    //    the segments of a column are combined, then the factors are formed
    const int c = tid & (KP - 1), sg = tid / KP;
    {
      float part = 0.f;
#pragma unroll
      for (int r = 0; r < SEG_ROWS; ++r) part += rw[(sg * SEG_ROWS + r) * KP + c];
      seg[sg * KP + c] = part;
    }
    __syncthreads();
    {
      float pre = 0.f, total = 0.f;
#pragma unroll
      for (int s = 0; s < SEGS; ++s) {
        const float x = seg[s * KP + c];
        if (s < sg) pre += x;
        total += x;
      }
      if (sg == 0) etot[c] = expf(total);
      float cum = pre;
#pragma unroll
      for (int r = 0; r < SEG_ROWS; ++r) {
        const int row = sg * SEG_ROWS + r;
        const float wr = rw[row * KP + c];
        cum += wr;
        uint32_t h, l;  // qd is split once here: it is an A operand of 24 warps' products
        split(rq[row * KP + c] * expf(inclusive ? cum : cum - wr), h, l);
        qd[row * LDQ + c] = __uint_as_float(h);
        ql[row * LDQ + c] = __uint_as_float(l);
        kn[row * LDQ + c] = rk[row * KP + c] * expf(-cum);
      }
    }
    __syncthreads();  // the raw buffers are free, the factors are in place
    if (it + 1 < ntiles) load_qkw(it + 1);

    // 2. scores: 16-row block rb needs the 8-column blocks nt < 2rb + 2; the 20
    //    (rb, nt) blocks are dealt round-robin to the warps.  Two accumulators
    //    (even and odd k-steps) keep two mma chains in flight.
    for (int u = warp; u < 20; u += WARPS) {
      const int rb = u < 2 ? 0 : u < 6 ? 1 : u < 12 ? 2 : 3;
      const int nt = u - rb * (rb + 1);
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KP / 8; ks += 2) {
        uint32_t ah[4], al[4], bh[2], bl[2], ah1[4], al1[4], bh1[2], bl1[2];
        frag_qd(rb * 16 * LDQ + ks * 8, ah, al);
        frag_bt(kn + nt * 8 * LDQ + ks * 8, LDQ, g, t, bh, bl);
        frag_qd(rb * 16 * LDQ + ks * 8 + 8, ah1, al1);
        frag_bt(kn + nt * 8 * LDQ + ks * 8 + 8, LDQ, g, t, bh1, bl1);
        mma_3x(c0, ah, al, bh, bl);
        mma_3x(c1, ah1, al1, bh1, bl1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rb * 16 + g + (e >> 1) * 8, col = nt * 8 + 2 * t + (e & 1);
        const bool keep = inclusive ? col <= row : col < row;
        sc[row * LDQ + col] = keep ? c0[e] + c1[e] : 0.f;
      }
    }
    __syncthreads();

    // 3. y = A v + qd S: warp takes row blocks {rp, 3 - rp} (equal causal work)
    //    and 16 columns
    {
      const int rp = warp & 1, n0 = (warp >> 1) * 16;
      float acc[2][2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rb = i == 0 ? rp : 3 - rp;
#pragma unroll
        for (int ks = 0; ks < TILE / 8; ++ks) {
          if (ks < 2 * rb + 2) {
            uint32_t ah[4], al[4];
            frag_a(sc + rb * 16 * LDQ + ks * 8, LDQ, g, t, ah, al);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (n0 + j * 8 < vw) {
                uint32_t bh[2], bl[2];
                frag_b(vt + ks * 8 * LDV + n0 + j * 8, LDV, g, t, bh, bl);
                mma_3x(acc[i][j], ah, al, bh, bl);
              }
            }
          }
        }
      }
#pragma unroll
      for (int ks = 0; ks < KP / 8; ++ks) {
        uint32_t ah0[4], al0[4], ah1[4], al1[4];
        frag_qd(rp * 16 * LDQ + ks * 8, ah0, al0);
        frag_qd((3 - rp) * 16 * LDQ + ks * 8, ah1, al1);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (n0 + j * 8 < vw) {
            uint32_t bh[2], bl[2];
            frag_b(st + ks * 8 * LDV + n0 + j * 8, LDV, g, t, bh, bl);
            mma_3x(acc[0][j], ah0, al0, bh, bl);
            mma_3x(acc[1][j], ah1, al1, bh, bl);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ra = (i == 0 ? rp : 3 - rp) * 16 + g, rc = ra + 8;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + j * 8 + 2 * t;
          if (col < vw) {
            if (ra < rows)
              *reinterpret_cast<float2*>(yb + (size_t)(t0 + ra) * V + col) =
                  make_float2(acc[i][j][0], acc[i][j][1]);
            if (rc < rows)
              *reinterpret_cast<float2*>(yb + (size_t)(t0 + rc) * V + col) =
                  make_float2(acc[i][j][2], acc[i][j][3]);
          }
        }
      }
    }

    // 4. S = exp(c_end) * (S + kn^T v), which is S * exp(c_end) + ke^T v with
    //    ke = k * exp(c_end - c): warp takes 16 state rows and 32 columns; the
    //    new state is written after every read of the old one
    {
      const int mb = warp & 3, n0 = (warp >> 2) * 32;
      const int ra = mb * 16 + g, rc = ra + 8;
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + j * 8 + 2 * t;
        acc[j][0] = st[ra * LDV + col];
        acc[j][1] = st[ra * LDV + col + 1];
        acc[j][2] = st[rc * LDV + col];
        acc[j][3] = st[rc * LDV + col + 1];
      }
      if (mb * 16 < K) {
#pragma unroll
        for (int ks = 0; ks < TILE / 8; ++ks) {
          uint32_t ah[4], al[4];
          frag_at(kn + ks * 8 * LDQ + mb * 16, LDQ, g, t, ah, al);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (n0 + j * 8 < vw) {
              uint32_t bh[2], bl[2];
              frag_b(vt + ks * 8 * LDV + n0 + j * 8, LDV, g, t, bh, bl);
              mma_3x(acc[j], ah, al, bh, bl);
            }
          }
        }
      }
      const float da = etot[ra], dc = etot[rc];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + j * 8 + 2 * t;
        st[ra * LDV + col] = acc[j][0] * da;
        st[ra * LDV + col + 1] = acc[j][1] * da;
        st[rc * LDV + col] = acc[j][2] * dc;
        st[rc * LDV + col + 1] = acc[j][3] * dc;
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < KP * VT; e += THREADS) {
    const int r = e / VT, c = e % VT;
    if (r < K && c < vw) sf[(size_t)b * K * V + (size_t)r * V + v0 + c] = st[r * LDV + c];
  }
}


}  // namespace

extern "C" {

const char* ssd_scan_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// q, k, w [BH, L, K] f32, v [BH, L, V] f32, s0 [BH, K, V] f32 -> y [BH, L, V] f32,
// sf [BH, K, V] f32; K <= 64 and V multiples of 4 (16-byte rows), BH <= 65535.
int ssd_scan(const void* q, const void* k, const void* v, const void* w, const void* s0,
             void* y, void* sf, int BH, int L, int K, int V, int inclusive, void* stream) {
  const size_t smem = (size_t)SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(scan_kernel_tf32x3,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((V + VT - 1) / VT, BH);
  scan_kernel_tf32x3<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)w, (const float*)s0,
      (float*)y, (float*)sf, L, K, V, inclusive);
  return (int)cudaGetLastError();
}

}  // extern "C"
