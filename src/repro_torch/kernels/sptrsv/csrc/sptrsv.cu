// Hopper (sm_90a) kernels executing a compiled SpTRSV VLIW instruction stream.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * sptrsv_resident  <- repro/kernels/sptrsv/kernel.py::sptrsv_pallas
//   * sptrsv_blocked   <- repro/kernels/sptrsv/kernel.py::sptrsv_pallas_blocked
// Both compute what that file's `_exec_cycle` computes, cycle by cycle.
//
// What bounds them on this card: neither bytes nor operations.  A solve
// moves ~8 B per lane-cycle of instruction stream plus x and b once, and
// does 2 flops per non-zero and column; both bounds are microseconds.  The
// time goes to the dependency chain: cycle t+1 may read a row that cycle t
// finalized, so every cycle ends in a CTA-wide barrier and the solve costs
// (emitted cycles) x (latency of one cycle).  The design shortens that
// latency:
//   * one CTA per tile of `bt` RHS columns, one thread per (lane, column);
//     the default bt=1 gives 64-thread CTAs (two warps per barrier) and
//     spreads the columns over the SMs;
//   * the per-thread psum feedback lives in a register, the psum register
//     file in shared memory (private to its thread, so it needs no barrier;
//     laid out slot-major so a warp's accesses never share a bank);
//   * each thread streams its lane's instruction words and values through
//     registers GROUP cycles ahead of use, so the stream's device-memory
//     latency stays off the chain;
//   * b never sits on the chain either: x rows start out holding b, and a
//     FINAL reads b[src] from its own row before overwriting it.  This is
//     exact because a row is read by EDGE lanes only after its FINAL (the
//     scheduler's guarantee) and finalized exactly once;
//   * x lives in shared memory: the whole padded vector in the resident
//     kernel where it fits (else in device memory, where it stays in L2),
//     a ring of `window` rows in the blocked kernel.
//
// Synchronisation: an EDGE only reads rows finalized in an earlier cycle and
// FINAL rows are distinct within a cycle, so one __syncthreads() per cycle,
// between cycle t's writes and cycle t+1's reads, is all that is needed.
//
// Row-blocked sweep (sptrsv_blocked).  Cycle block g touches only rows
// [g*stride, g*stride + window) (checked on the host from the program's row
// envelope).  Row r lives in ring slot r % window.  At boundary g-1 -> g the
// rows [(g-1)*stride, g*stride) retire: each is written to x in device memory
// and its slot is refilled with b of row r + window, the row entering the
// window in that slot.  The flush reads a slot before the refill writes it,
// in the same thread, and a barrier closes the boundary, which is the
// flush-before-reuse order of the TPU kernel.  The TPU kernel's shift copy
// disappears (a ring needs none) and so does its x refill: it copies rows
// that lie beyond every earlier window, which no FINAL can have written yet,
// so what it brings in is never read.  After the last block the whole window
// is flushed.
//
// The C entry points launch on the caller's stream, do not synchronise and
// return cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int OP_EDGE = 1;
constexpr int OP_FINAL = 2;
constexpr int PS_RESET = 1;
constexpr int PS_LOAD = 2;
constexpr int PS_STORE_RESET = 3;
constexpr int PS_SWAP = 4;

// packed word layout (repro_torch/core/program.py)
constexpr int SRC_BITS = 18;
constexpr int SRC_MASK = (1 << SRC_BITS) - 1;
constexpr int OP_MASK = 3;
constexpr int CTL_SHIFT = 2;
constexpr int CTL_MASK = 7;
constexpr int SLOT_SHIFT = 5;
constexpr int SLOT_MASK = 255;

constexpr int GROUP = 16;         // cycles of words a thread holds ahead of use
constexpr int MAX_THREADS = 256;  // P * bt

template <int PLANES>
struct Word {
  int w[PLANES];
  float v;
};

template <int PLANES>
__device__ __forceinline__ void load_word(Word<PLANES>& wd, const int* __restrict__ instr,
                                          const float* __restrict__ vals, int t, int T, int P,
                                          int lane) {
  if (t < T) {
#pragma unroll
    for (int k = 0; k < PLANES; ++k) wd.w[k] = __ldg(instr + ((size_t)t * PLANES + k) * P + lane);
    wd.v = __ldg(vals + (size_t)t * P + lane);
  } else {
#pragma unroll
    for (int k = 0; k < PLANES; ++k) wd.w[k] = 0;
    wd.v = 0.f;
  }
}

// x rows of the resident kernel: the whole padded vector, in shared memory
// (stride bt) or in device memory (stride B), pre-offset to this column.
struct VectorRows {
  float* base;
  int stride;
  __device__ __forceinline__ float* row(int r) const { return base + (size_t)r * stride; }
  __device__ __forceinline__ void at_cycle(int) {}
};

// x rows of the blocked kernel: a ring of `window` rows in shared memory.
struct RingRows {
  float* ring;               // ring[slot * bt + c], whole tile
  float* x;                  // device memory, [n_hbm, B]
  const float* __restrict__ b;
  int c, bt, col0, B;
  int window, stride, cycles_per_block;
  int base, base_mod, next_boundary;

  __device__ __forceinline__ float* row(int r) const {
    int s = base_mod + (r - base);
    if (s >= window) s -= window;
    return ring + (size_t)s * bt + c;
  }

  // flush the `rows` rows from `base` on to x; refill=true also loads b of
  // the row `window` further on into each freed slot
  __device__ void retire(int rows, bool refill) {
    const int nthreads = blockDim.x;
    for (int e = threadIdx.x; e < rows * bt; e += nthreads) {
      const int r = base + e / bt;
      const int cc = e % bt;
      int s = base_mod + (r - base);
      if (s >= window) s -= window;
      float* slot = ring + (size_t)s * bt + cc;
      x[(size_t)r * B + col0 + cc] = *slot;
      if (refill) *slot = __ldg(b + (size_t)(r + window) * B + col0 + cc);
    }
  }

  __device__ __forceinline__ void at_cycle(int t) {
    if (t != next_boundary) return;  // uniform across the CTA
    retire(stride, true);
    base += stride;
    base_mod += stride;
    if (base_mod >= window) base_mod -= window;
    next_boundary += cycles_per_block;
    __syncthreads();
  }
};

template <int PLANES, class Rows>
__device__ __forceinline__ void exec_cycle(const Word<PLANES>& wd, float& fb, float* rf,
                                           int rf_stride, const Rows& rows) {
  int src, rest;
  if (PLANES == 1) {
    src = wd.w[0] & SRC_MASK;
    rest = wd.w[0] >> SRC_BITS;
  } else {
    src = wd.w[0];
    rest = wd.w[PLANES - 1];
  }
  const int op = rest & OP_MASK;
  const int ct = (rest >> CTL_SHIFT) & CTL_MASK;
  float* slot = rf + ((rest >> SLOT_SHIFT) & SLOT_MASK) * rf_stride;

  // psum mux: the slot is read before the store, and the store writes the
  // old feedback
  float pv = fb;
  switch (ct) {
    case PS_RESET: pv = 0.f; break;
    case PS_LOAD: pv = *slot; break;
    case PS_STORE_RESET: *slot = fb; pv = 0.f; break;
    case PS_SWAP: { const float s = *slot; *slot = fb; pv = s; break; }
    default: break;
  }
  // no contraction into an FMA: the plain PyTorch version rounds the
  // product and the sum separately, and so does this
  if (op == OP_EDGE) {
    pv = __fadd_rn(pv, __fmul_rn(wd.v, *rows.row(src)));
  } else if (op == OP_FINAL) {
    float* xr = rows.row(src);  // still holds b[src]
    *xr = __fmul_rn(__fsub_rn(*xr, pv), wd.v);
  }
  fb = pv;
}

// The cycle loop shared by both kernels: words for the next GROUP cycles
// load into registers while the current GROUP executes.
template <int PLANES, class Rows>
__device__ __forceinline__ void run_stream(const int* __restrict__ instr,
                                           const float* __restrict__ vals, int T, int P,
                                           int lane, float* rf, int rf_stride, Rows& rows) {
  float fb = 0.f;
  Word<PLANES> cur[GROUP], nxt[GROUP];
#pragma unroll
  for (int k = 0; k < GROUP; ++k) load_word(cur[k], instr, vals, k, T, P, lane);
  for (int t0 = 0; t0 < T; t0 += GROUP) {
#pragma unroll
    for (int k = 0; k < GROUP; ++k) load_word(nxt[k], instr, vals, t0 + GROUP + k, T, P, lane);
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const int t = t0 + k;
      if (t < T) {  // uniform across the CTA
        rows.at_cycle(t);
        exec_cycle<PLANES>(cur[k], fb, rf, rf_stride, rows);
        __syncthreads();
      }
    }
#pragma unroll
    for (int k = 0; k < GROUP; ++k) cur[k] = nxt[k];
  }
}

// rf: num_slots floats per thread, slot-major
__device__ __forceinline__ float* init_rf(float* smem, int num_slots) {
  for (int s = 0; s < num_slots; ++s) smem[s * blockDim.x + threadIdx.x] = 0.f;
  return smem + threadIdx.x;
}

template <int PLANES>
__global__ void __launch_bounds__(MAX_THREADS)
resident_kernel(const int* __restrict__ instr, const float* __restrict__ vals,
                const float* __restrict__ b, float* x, int T, int P, int n_rows, int B,
                int num_slots, int bt, int x_in_smem) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % P;
  const int c = threadIdx.x / P;
  const int col0 = blockIdx.x * bt;
  float* rf = init_rf(smem, num_slots);
  float* xs = smem + (size_t)num_slots * blockDim.x;

  // x starts out as b
  for (int e = threadIdx.x; e < n_rows * bt; e += blockDim.x) {
    const size_t g = (size_t)(e / bt) * B + col0 + e % bt;
    if (x_in_smem) xs[e] = __ldg(b + g); else x[g] = __ldg(b + g);
  }
  __syncthreads();

  VectorRows rows{x_in_smem ? xs + c : x + col0 + c, x_in_smem ? bt : B};
  run_stream<PLANES>(instr, vals, T, P, lane, rf, blockDim.x, rows);

  if (x_in_smem) {
    for (int e = threadIdx.x; e < n_rows * bt; e += blockDim.x)
      x[(size_t)(e / bt) * B + col0 + e % bt] = xs[e];
  }
}

template <int PLANES>
__global__ void __launch_bounds__(MAX_THREADS)
blocked_kernel(const int* __restrict__ instr, const float* __restrict__ vals,
               const float* __restrict__ b, float* x, int T, int P, int B, int num_slots,
               int bt, int window, int stride, int cycles_per_block) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % P;
  const int c = threadIdx.x / P;
  const int col0 = blockIdx.x * bt;
  float* rf = init_rf(smem, num_slots);
  float* ring = smem + (size_t)num_slots * blockDim.x;

  // window 0 holds b of rows [0, window)
  for (int e = threadIdx.x; e < window * bt; e += blockDim.x)
    ring[e] = __ldg(b + (size_t)(e / bt) * B + col0 + e % bt);
  __syncthreads();

  RingRows rows{ring, x, b, c, bt, col0, B, window, stride, cycles_per_block,
                0, 0, cycles_per_block};
  run_stream<PLANES>(instr, vals, T, P, lane, rf, blockDim.x, rows);

  // last window: every row still in the ring is final
  rows.retire(window, false);
}

size_t rf_bytes(int num_slots, int threads) { return (size_t)num_slots * threads * sizeof(float); }

template <class K>
cudaError_t launch_prep(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

const char* sptrsv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// instr [T, planes, P] int32, vals [T, P] f32, b and x [n_rows, B] f32;
// one CTA of P*bt threads per bt columns.
int sptrsv_resident(const void* instr, const void* vals, const void* b, void* x, int T,
                    int planes, int P, int n_rows, int B, int num_slots, int bt, int x_in_smem,
                    void* stream) {
  const int threads = P * bt;
  const size_t smem = rf_bytes(num_slots, threads) +
                      (x_in_smem ? (size_t)n_rows * bt * sizeof(float) : 0);
  const dim3 grid(B / bt);
  cudaError_t err;
  if (planes == 1) {
    err = launch_prep(resident_kernel<1>, smem);
    if (err != cudaSuccess) return (int)err;
    resident_kernel<1><<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const int*)instr, (const float*)vals, (const float*)b, (float*)x, T, P, n_rows, B,
        num_slots, bt, x_in_smem);
  } else {
    err = launch_prep(resident_kernel<2>, smem);
    if (err != cudaSuccess) return (int)err;
    resident_kernel<2><<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const int*)instr, (const float*)vals, (const float*)b, (float*)x, T, P, n_rows, B,
        num_slots, bt, x_in_smem);
  }
  return (int)cudaGetLastError();
}

// b and x [n_hbm, B] f32 with n_hbm = (T / cycles_per_block - 1) * stride + window.
int sptrsv_blocked(const void* instr, const void* vals, const void* b, void* x, int T,
                   int planes, int P, int B, int num_slots, int bt, int window, int stride,
                   int cycles_per_block, void* stream) {
  const int threads = P * bt;
  const size_t smem = rf_bytes(num_slots, threads) + (size_t)window * bt * sizeof(float);
  const dim3 grid(B / bt);
  cudaError_t err;
  if (planes == 1) {
    err = launch_prep(blocked_kernel<1>, smem);
    if (err != cudaSuccess) return (int)err;
    blocked_kernel<1><<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const int*)instr, (const float*)vals, (const float*)b, (float*)x, T, P, B, num_slots,
        bt, window, stride, cycles_per_block);
  } else {
    err = launch_prep(blocked_kernel<2>, smem);
    if (err != cudaSuccess) return (int)err;
    blocked_kernel<2><<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const int*)instr, (const float*)vals, (const float*)b, (float*)x, T, P, B, num_slots,
        bt, window, stride, cycles_per_block);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
