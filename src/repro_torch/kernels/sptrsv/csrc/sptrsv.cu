// Hopper (sm_90a) kernels executing a compiled SpTRSV VLIW instruction stream.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * sptrsv_resident  <- repro/kernels/sptrsv/kernel.py::sptrsv_pallas
//   * sptrsv_blocked   <- repro/kernels/sptrsv/kernel.py::sptrsv_pallas_blocked
// Both compute what that file's `_exec_cycle` computes, cycle by cycle.
//
// What bounds them on this card: neither bytes nor operations.  A solve
// moves ~8 B per lane-cycle of instruction stream plus x and b once, and
// does 2 flops per non-zero and column; both bounds are microseconds.  Cycle
// t+1 may read a row that cycle t finalized, so the solve is a dependent
// chain of emitted cycles and costs (emitted cycles) x (latency of one
// cycle).  Tensor cores, wgmma and clusters have nothing to offer such a
// chain; the design shortens the cycle instead:
//
//   * One warp per RHS column.  Thread t of the warp owns the LPT adjacent
//     lanes [t*LPT, t*LPT + LPT) of the P lanes (LPT = 1, 2, 4, 8 for
//     P <= 32, 64, 128, 256; threads past P run NOP words).  A cycle's
//     FINAL writes reach the next cycle's reads through __syncwarp(), which
//     orders shared and global memory among the warp's threads: no CTA
//     barrier anywhere in the cycle loop.  A CTA holds `cols_per_cta` such
//     warps, one column each, that never wait on each other.  A thread's
//     lanes are independent within a cycle, which gives it ILP.
//   * A branch-free cycle.  Every field is decoded first; the psum slot and
//     the x row that the word names are always loaded (NOP and padding
//     words name row 0 and slot 0); the psum mux is selects; the slot and x
//     stores are predicated.  No FMA contraction (__fmul_rn, __fadd_rn,
//     __fsub_rn), so the kernels round exactly like their plain twins.
//   * Software-pipelined: while cycle t's x load is in flight, the words
//     of t+3 are loaded, those of t+2 decoded into shared addresses and
//     flags, and the psum slot of t+1 read, so after each __syncwarp only
//     the x load, two flops, the store and the next __syncwarp remain on
//     the chain.  Shared memory is addressed through 32-bit addresses
//     computed once, and a CTA holds at most 8 warps so a thread may use
//     255 registers: with fewer, ptxas re-derives bases every cycle.
//     What is left bounds the kernels: the chain and the shared-memory
//     accesses queued around it, not the instruction count (halving the
//     lanes a thread saved ~5 of ~115 SM clocks a cycle on the FEM band;
//     see the lane-compacted stream below for what did).
//   * The instruction stream enters shared memory by cp.async: each thread
//     copies its own lanes' words and values (LPT*4 bytes per plane and
//     cycle) into a per-warp ring, CHUNK cycles per commit group, LEAD
//     chunks ahead of use, so no cross-thread hand-off is needed and the
//     device-memory latency of the stream stays off the chain.
//   * b never sits on the chain: x rows start out holding b, and a FINAL
//     reads b[src] from its own row before overwriting it.  This is exact
//     because a row is read by EDGE lanes only after its FINAL (the
//     scheduler's guarantee) and finalized exactly once.
//   * The psum register file lives in shared memory, private to its lane,
//     laid out [slot][k][thread] so a warp's accesses never share a bank.
//   * x lives in shared memory: the whole padded vector in the resident
//     kernel where it fits, else a slot file (below), else device memory
//     (where it stays in L2, and each cycle's x loads wait on an L2 round
//     trip: ~417 SM clocks a cycle on a DAG of 85,392 rows, 3.5x the
//     shared-memory cycle); a ring of rows in the blocked kernel.
//
// Row-blocked sweep (sptrsv_blocked).  Cycle block g touches only rows
// [g*stride, g*stride + window) (checked on the host from the program's row
// envelope).  A block is a whole number of CHUNKs, so its boundary runs at
// the top of a chunk and the unrolled cycles carry no test; the wrapper
// pads blocks of other lengths with NOP cycles, which change no state.
// Row r lives in ring slot r & (ring_rows - 1), with ring_rows
// the power of two >= window, so a word's ring slot is one AND of its src
// field, decoded with the rest of the word before the sync (the window's
// rows are distinct modulo ring_rows).  At boundary g-1 -> g the rows
// [(g-1)*stride, g*stride) retire to x in device memory, and then the rows
// entering the window, [(g-1)*stride + window, g*stride + window), take
// their b from a per-warp staging area that cp.async filled during block
// g-1: a boundary costs shared-memory copies and two __syncwarp()s, not a
// device-memory round trip.  The TPU kernel's shift copy disappears (a
// ring needs none) and so does its x refill: it copies rows that lie
// beyond every earlier window, which no FINAL can have written yet, so
// what it brings in is never read.  After the last block the whole window
// is flushed.
//
// Slot file (resident_kernel_slotted).  A DAG too large for shared memory,
// whose hubs leave no row window, still has few rows live at once: on the
// 85,392-row circuit at most ~3,200 of them are between their FINAL and
// their last read.  The host (kernels/sptrsv/ops.py plan_slots) gives each
// row a slot for the chunks from the copy of its b to its last read, and
// rewrites the words to name slots; a slot goes to a new row only in a
// chunk after its last occupant's last read.  So run_stream runs as with x
// in shared memory, over SmemRows of the slots, and a hook at each chunk's
// top moves rows in and out:
//   * its flush list reads x of rows final in earlier chunks from their
//     slots and writes it to device memory (stores that no cycle waits on);
//   * a __syncwarp, so those reads come before any refill's write and the
//     refills issued LEAD chunks before have landed for every thread;
//   * its refill list starts the cp.async of b of rows whose FINAL lies
//     LEAD chunks or more ahead, into their slots.
// The lists ((slot, row) pairs, SLOT_LIST a thread and list a chunk, row -1
// unused) reach a per-warp list ring by cp.async LEAD chunks ahead, each
// thread its own entries, as the stream does, so the chunk top waits on no
// device-memory load.  Rows whose FINAL comes before chunk LEAD are copied
// before the loop, and rows final in the last chunk are written after it.
// On the 85,392-row circuit a cycle takes ~76 ns, against ~58 ns for the
// same words over x already in shared memory and ~209 ns with x in device
// memory; the ~18 ns are the chunk top's shared loads and copies, which the
// next cycle's x loads queue behind or wait on.  Neither the flush's global
// stores nor the hook's __syncwarp cost a measurable time; holding the
// entries and the flushed x in registers a chunk top ahead cost more
// (~82-84 ns a cycle) than it saved.
// Words, lane order and rounding are those of the other resident kernels,
// so x is bit for bit theirs.
//
// Lane-compacted stream (blocked kernel only).  A program's cycles may hold
// few live words (op or psum control not 0): on the FEM band at P = 64 no
// cycle holds more than 28, and 83% of the lanes are NOPs.  Staging
// (kernels/sptrsv/ops.py) then packs each cycle's live words into the
// first of W = 32 * LPT slots, W the smallest that holds the busiest cycle
// and below P, so each thread runs LPT(W) words a cycle instead of LPT(P).
// A compacted word has two planes: the row, and the upper field with the
// word's original lane above it ([lane : 8] from bit 13); padding slots are
// zero words (NOPs of lane 0, which change nothing).
//   * A lane's words land on different threads from cycle to cycle, so its
//     state is kept by lane in shared memory: the psum file
//     [num_slots][lanes] (a word's slot at slot * lanes + lane) and the
//     feedback fb[lanes], besides one zero word.
//   * The decode picks the address of the word's psum input (its slot, its
//     lane's fb, or the zero word), so after each __syncwarp the cycle
//     loads two words side by side, the x row and that input, and the mux
//     leaves the chain.  The slot of t + 1 is no longer read a cycle ahead:
//     a lane may store a slot at t from one thread and load it at t + 1 on
//     another (the band's program does so 3 times), and only the
//     __syncwarp orders the two.
//   * The ring takes the stream by 16-byte copies spread over the warp.
//     Each thread's 4-byte copies of its own lanes (as run_stream does)
//     took a third of a cycle on the band's program on an H100 (~34 of
//     ~111 SM clocks); narrower lanes alone saved ~5.
// Rounding and each lane's program order are unchanged, so x is bit for bit
// that of the uncompacted stream.
//
// The C entry points launch on the caller's stream, do not synchronise and
// return cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned OP_EDGE = 1;
constexpr unsigned OP_FINAL = 2;
// The psum control (ctl 0 keep, 1 RESET, 2 LOAD, 3 STORE_RESET, 4 SWAP) as
// one nibble per ctl value: bit 0 pv = 0, bit 1 pv = slot, bit 2 slot = old
// feedback.  A word's nibble is CT_LUT >> (4 * ctl), and 4 * ctl is the
// control bits of the word's upper field masked in place.
constexpr unsigned F_ZERO = 1, F_SLOT = 2, F_STORE = 4;
constexpr unsigned CT_LUT = (F_ZERO << 4) | (F_SLOT << 8) | ((F_ZERO | F_STORE) << 12) |
                            ((F_SLOT | F_STORE) << 16);

// packed word layout (repro_torch/core/program.py)
constexpr int SRC_BITS = 18;
constexpr unsigned SRC_MASK = (1u << SRC_BITS) - 1;
// a compacted word's lane, above the 13-bit upper field (kernel.py LANE_SHIFT)
constexpr int LANE_SHIFT = 13;

constexpr int CHUNK = 8;  // cycles per cp.async group and unrolled loop body
constexpr int SLOT_LIST = 4;  // a thread's (slot, row) entries of a chunk's list (kernel.py)

// Everything that depends on the lanes per thread; kernel.py mirrors it.
template <int LPT>
struct Lanes {
  static constexpr int PP = 32 * LPT;              // lanes per warp row
  static constexpr int LEAD = LPT <= 2 ? 4 : 2;  // chunks in flight
  static constexpr int RING = (LEAD + 1) * CHUNK;  // cycles in the ring
  // columns per CTA: at most 256 threads, so a thread may use 255 registers
  static constexpr int MAX_WARPS = LPT <= 2 ? 8 : 16 / LPT;
};

// ------------------------------------------------- shared memory by address
// Shared memory is addressed through 32-bit shared-window byte addresses
// computed once, so that per-cycle offsets fold into the instructions.
// Every access is a volatile asm with a memory clobber: shared accesses
// keep their program order, which the cycle's ordering relies on.
__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float lds_f32(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}

// store v at a when `on` is not 0 (a predicated store, no branch)
__device__ __forceinline__ void sts_f32_if(unsigned on, unsigned a, float v) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %0, 0;\n\t@q st.shared.f32 [%1], %2;\n\t}" ::"r"(on),
      "r"(a), "f"(v)
      : "memory");
}

template <int LPT>
__device__ __forceinline__ void lds_words(unsigned a, uint32_t (&out)[LPT]) {
  if constexpr (LPT == 1) {
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(out[0]) : "r"(a) : "memory");
  } else if constexpr (LPT == 2) {
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(out[0]), "=r"(out[1])
                 : "r"(a)
                 : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < LPT; i += 4)
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(out[i]), "=r"(out[i + 1]), "=r"(out[i + 2]), "=r"(out[i + 3])
                   : "r"(a + 4 * i)
                   : "memory");
  }
}

// ---------------------------------------------------------------- cp.async
template <int BYTES>
__device__ __forceinline__ void cp_async(unsigned dst, const uint32_t* src, bool valid) {
  if constexpr (BYTES > 16) {
    cp_async<16>(dst, src, valid);
    cp_async<BYTES - 16>(dst + 16, src + 4, valid);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(valid ? BYTES : 0)
                 : "memory");
  }
}

// a 4-byte cp.async when `on` is not 0 (predicated: no write otherwise)
__device__ __forceinline__ void cp_async4_if(unsigned on, unsigned dst, const float* src) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %0, 0;\n\t@q cp.async.ca.shared.global [%1], [%2], "
      "4;\n\t}" ::"r"(on),
      "r"(dst), "l"(src)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------ the stream's words
// One cycle's words of one thread: PLANES packed words and a value per lane.
template <int PLANES, int LPT>
struct Raw {
  uint32_t w[PLANES][LPT];
  uint32_t v[LPT];
};

// The per-warp ring of the instruction stream: RING cycle rows of
// [PLANES words + 1 value][PP lanes], filled CHUNK rows at a time.
template <int PLANES, int LPT>
struct Stream {
  static constexpr int PP = Lanes<LPT>::PP;
  static constexpr int ROW = (PLANES + 1) * PP * 4;  // bytes per cycle row
  static constexpr int SLOT = CHUNK * ROW;           // bytes per chunk
  const uint32_t* instr;                             // [T, PLANES, P]
  const uint32_t* vals;                              // [T, P]
  unsigned ring;  // shared address of this thread's lanes in ring row 0
  int T, P, t;

  // Cycles past T and lanes past P are copied as zero words.
  __device__ __forceinline__ void copy_chunk(int chunk, int slot) const {
    const unsigned dst = ring + slot * SLOT;
    const bool lane_ok = t * LPT < P;
    const int c0 = chunk * CHUNK;
    if (lane_ok && c0 + CHUNK <= T) {  // the whole chunk: no predicates
      const uint32_t* wi = instr + (size_t)c0 * PLANES * P + t * LPT;
      const uint32_t* wv = vals + (size_t)c0 * P + t * LPT;
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
#pragma unroll
        for (int j = 0; j < PLANES; ++j)
          cp_async<4 * LPT>(dst + u * ROW + j * PP * 4, wi + (u * PLANES + j) * P, true);
        cp_async<4 * LPT>(dst + u * ROW + PLANES * PP * 4, wv + u * P, true);
      }
      return;
    }
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      const int c = c0 + u;
      const bool ok = lane_ok && c < T;
      const size_t ci = ok ? (size_t)c : 0;
      const int li = ok ? t * LPT : 0;
#pragma unroll
      for (int j = 0; j < PLANES; ++j)
        cp_async<4 * LPT>(dst + u * ROW + j * PP * 4, instr + (ci * PLANES + j) * P + li, ok);
      cp_async<4 * LPT>(dst + u * ROW + PLANES * PP * 4, vals + ci * P + li, ok);
    }
  }

  // the words of the cycle row at shared address `row` (this thread's lanes)
  __device__ __forceinline__ void load(unsigned row, Raw<PLANES, LPT>& r) const {
#pragma unroll
    for (int j = 0; j < PLANES; ++j) lds_words<LPT>(row + j * PP * 4, r.w[j]);
    lds_words<LPT>(row + PLANES * PP * 4, r.v);
  }
};

// ------------------------------------------------------------ x rows
// The whole padded vector of one column in shared memory (resident), or a
// ring of rows (blocked): a word names the row at xs + 4 * (src & mask).
struct SmemRows {
  using Addr = unsigned;
  unsigned xs;  // shared address of row 0
  unsigned mask;
  __device__ __forceinline__ Addr addr(uint32_t src) const { return xs + ((src & mask) << 2); }
  __device__ __forceinline__ float load(Addr a) const { return lds_f32(a); }
  __device__ __forceinline__ void store_if(unsigned on, Addr a, float v) const {
    sts_f32_if(on, a, v);
  }
};

// The whole padded vector of one column in device memory, row stride B.
struct GlobalRows {
  using Addr = float*;
  float* x;  // pre-offset to the column
  int B;
  unsigned mask;
  __device__ __forceinline__ Addr addr(uint32_t src) const { return x + (size_t)(src & mask) * B; }
  __device__ __forceinline__ float load(Addr a) const { return *a; }
  __device__ __forceinline__ void store_if(unsigned on, Addr a, float v) const {
    if (on) *a = v;
  }
};

// One cycle's decoded lanes of one thread.
template <int LPT, class Rows>
struct Dec {
  typename Rows::Addr x[LPT];  // the row the word names
  unsigned rf[LPT];            // shared address of the psum slot the word names
  float v[LPT];
  unsigned op[LPT];  // opcode
  unsigned f[LPT];   // F_* flags of the psum control
};

template <int PLANES, int LPT, class Rows>
__device__ __forceinline__ void decode(const Raw<PLANES, LPT>& r, Dec<LPT, Rows>& d,
                                       const Rows& rows, unsigned rf_t) {
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const uint32_t w0 = r.w[0][k];
    // the upper field [op : 2][ctl : 3][slot : 8]; bit 31 of a word is 0
    const uint32_t rest = PLANES == 1 ? (w0 >> SRC_BITS) : r.w[PLANES - 1][k];
    d.x[k] = rows.addr(w0);
    d.rf[k] = rf_t + (rest >> 5) * (Lanes<LPT>::PP * 4) + k * 128;
    d.v[k] = __uint_as_float(r.v[k]);
    d.op[k] = rest & 3u;
    d.f[k] = CT_LUT >> (rest & 0x1Cu);
  }
}

struct NoBoundary {
  __device__ __forceinline__ void at_chunk(int) {}
};

// The cycle loop shared by both kernels.  Chunk cc's words sit in ring slot
// cc % (LEAD + 1); at the top of chunk cc the copy of chunk cc + LEAD is
// issued into the slot chunk cc - 1 held, and the wait leaves LEAD - 1
// groups in flight, so chunks <= cc + 1 have landed (cycle t loads the
// words of t + 3).  Chunks past the stream are copied too, as zero words
// (NOPs naming row 0 and slot 0), so the look-ahead never decodes a word
// that was not written.  `hook.at_chunk` runs the blocked kernel's
// boundaries.
//
// Cycle t holds the decoded lanes of t and t + 1 and the words of t + 2:
// it reads its x rows first (the chain), stores its psum slot and reads
// the slot of t + 1 (so that load has a whole cycle to return), loads the
// words of t + 3 and decodes those of t + 2, then computes, stores x and
// ends in __syncwarp().
template <int PLANES, int LPT, class Rows, class Hook>
__device__ __forceinline__ void run_stream(const Stream<PLANES, LPT>& st, unsigned rf_t,
                                           const Rows& rows, int nch, Hook& hook) {
  using L = Lanes<LPT>;
  using S = Stream<PLANES, LPT>;
#pragma unroll 1
  for (int k = 0; k < L::LEAD; ++k) {
    st.copy_chunk(k, k);
    cp_async_commit();
  }
  cp_async_wait<L::LEAD - 1>();
  __syncwarp();  // also publishes the x set-up copies of every thread

  float fb[LPT], s[LPT];
  Raw<PLANES, LPT> raw;  // the words of t + 2
  Dec<LPT, Rows> cur, nxt;
  st.load(st.ring, raw);
  decode<PLANES, LPT>(raw, cur, rows, rf_t);
  st.load(st.ring + S::ROW, raw);
  decode<PLANES, LPT>(raw, nxt, rows, rf_t);
  st.load(st.ring + 2 * S::ROW, raw);
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    fb[k] = 0.f;
    s[k] = lds_f32(cur.rf[k]);
  }

  int slot = 0;  // ring slot of chunk cc
#pragma unroll 1
  for (int cc = 0; cc < nch; ++cc) {
    const int prev = slot == 0 ? L::LEAD : slot - 1;
    const int next = slot == L::LEAD ? 0 : slot + 1;
    st.copy_chunk(cc + L::LEAD, prev);
    cp_async_commit();
    cp_async_wait<L::LEAD - 1>();
    hook.at_chunk(cc);
    const unsigned here = st.ring + slot * S::SLOT;
    const unsigned there = st.ring + next * S::SLOT;
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      // the chain: this cycle's x rows, read after the last __syncwarp
      float xv[LPT], pv[LPT];
#pragma unroll
      for (int k = 0; k < LPT; ++k) xv[k] = rows.load(cur.x[k]);
      // off the chain: the psum mux, this cycle's slot store, the slot of
      // t + 1, the words of t + 3 and the decode of t + 2
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        pv[k] = (cur.f[k] & F_SLOT) ? s[k] : fb[k];
        pv[k] = (cur.f[k] & F_ZERO) ? 0.f : pv[k];
        sts_f32_if(cur.f[k] & F_STORE, cur.rf[k], fb[k]);
      }
#pragma unroll
      for (int k = 0; k < LPT; ++k) s[k] = lds_f32(nxt.rf[k]);
      Dec<LPT, Rows> dn;
      decode<PLANES, LPT>(raw, dn, rows, rf_t);
      st.load(u + 3 < CHUNK ? here + (u + 3) * S::ROW : there + (u + 3 - CHUNK) * S::ROW, raw);
      // no contraction into an FMA: the plain PyTorch version rounds the
      // product and the sum separately, and so does this
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const float e = __fadd_rn(pv[k], __fmul_rn(cur.v[k], xv[k]));
        const float f = __fmul_rn(__fsub_rn(xv[k], pv[k]), cur.v[k]);
        rows.store_if(cur.op[k] == OP_FINAL, cur.x[k], f);
        fb[k] = cur.op[k] == OP_EDGE ? e : pv[k];
      }
      cur = nxt;
      nxt = dn;
      __syncwarp();
    }
    slot = next;
  }
}

// Shared memory of a CTA of W warps, in 4-byte words: per warp the psum
// register file [num_slots][PP] and the stream ring [RING][(PLANES + 1) * PP]
// (`fixed` words, 16-byte aligned), then per warp its `x_words` x rows.
template <int PLANES, int LPT>
struct Layout {
  static constexpr int RING_WORDS = Lanes<LPT>::RING * (PLANES + 1) * Lanes<LPT>::PP;
  static __host__ __device__ int rf_words(int num_slots) { return num_slots * Lanes<LPT>::PP; }
  static __host__ __device__ int fixed(int num_slots) { return rf_words(num_slots) + RING_WORDS; }
};

// zero this thread's lanes of the psum file; their shared address
__device__ __forceinline__ unsigned zero_rf(float* rf, int words, int t) {
  for (int e = t; e < words; e += 32) rf[e] = 0.f;
  return saddr(rf + t);
}

// ------------------------------------------------ the lane-compacted stream
// Per warp: the psum file [num_slots][lanes], fb[lanes] and a zero word,
// padded to 16 bytes, then the stream ring of a 2-plane stream of PP slots.
template <int LPT>
struct CompactLayout {
  static __host__ __device__ int state_words(int num_slots, int lanes) {
    return (num_slots * lanes + lanes + 1 + 3) & ~3;
  }
  static __host__ __device__ int fixed(int num_slots, int lanes) {
    return state_words(num_slots, lanes) + Layout<2, LPT>::RING_WORDS;
  }
};

// A compacted stream's per-warp ring: LEAD + 1 chunk slots, each a chunk's
// words [CHUNK][2][PP] and then its values [CHUNK][PP] as they lie in device
// memory, filled by 16-byte copies spread over the warp's threads.  So a
// thread reads words that others copied, and the wait on the copies is
// followed by a __syncwarp().
template <int LPT>
struct CompactStream {
  static constexpr int PP = Lanes<LPT>::PP;
  static constexpr int WORDS = CHUNK * 2 * PP;     // words of a chunk's two planes
  static constexpr int SLOT = CHUNK * 3 * PP * 4;  // bytes per chunk slot
  const uint32_t* instr;                           // [T, 2, PP]
  const uint32_t* vals;                            // [T, PP]
  unsigned ring;  // shared address of the warp's ring
  unsigned mine;  // ring + this thread's slots' offset
  int nch, t;

  // chunks past the stream are copied as zero words
  __device__ __forceinline__ void copy_chunk(int chunk, int slot) const {
    const bool ok = chunk < nch;
    const size_t c = ok ? (size_t)chunk : 0;
    const unsigned dst = ring + slot * SLOT + 16 * t;
    const uint32_t* wi = instr + c * WORDS + 4 * t;
    const uint32_t* wv = vals + c * CHUNK * PP + 4 * t;
#pragma unroll
    for (int i = 0; i < WORDS / 128; ++i) cp_async<16>(dst + 512 * i, wi + 128 * i, ok);
#pragma unroll
    for (int i = 0; i < CHUNK * PP / 128; ++i)
      cp_async<16>(dst + 4 * WORDS + 512 * i, wv + 128 * i, ok);
  }

  // the words of cycle u of the chunk in ring slot `slot` (this thread's slots)
  __device__ __forceinline__ void load(int slot, int u, Raw<2, LPT>& r) const {
    const unsigned a = mine + slot * SLOT;
    lds_words<LPT>(a + u * 2 * PP * 4, r.w[0]);
    lds_words<LPT>(a + (u * 2 + 1) * PP * 4, r.w[1]);
    lds_words<LPT>(a + 4 * WORDS + u * PP * 4, r.v);
  }
};

// shared addresses of a warp's per-lane state
struct LaneState {
  unsigned rf;    // psum slot 0 of lane 0
  unsigned fb;    // fb[0]
  unsigned zero;  // a word that stays 0
  unsigned lanes;
};

// One cycle's decoded words of one thread, each of the lane it carries.
template <int LPT>
struct DecC {
  unsigned x[LPT];     // the row the word names
  unsigned rf[LPT];    // its lane's psum slot
  unsigned in[LPT];    // its psum input: the slot, its lane's fb or the zero word
  unsigned fb[LPT];    // its lane's fb
  float v[LPT];
  unsigned op[LPT];
  unsigned st[LPT];    // F_STORE: the slot takes the lane's fb
  unsigned live[LPT];  // op or psum control not 0: the word writes its lane's fb
};

template <int LPT>
__device__ __forceinline__ void decode_compact(const Raw<2, LPT>& r, DecC<LPT>& d,
                                               const SmemRows& rows, const LaneState& ls) {
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    // plane 1: [lane : 8][slot : 8][ctl : 3][op : 2]
    const uint32_t w1 = r.w[1][k];
    const unsigned lane = w1 >> LANE_SHIFT;
    const unsigned f = CT_LUT >> (w1 & 0x1Cu);
    d.x[k] = rows.addr(r.w[0][k]);
    d.rf[k] = ls.rf + ((((w1 >> 5) & 0xFFu) * ls.lanes + lane) << 2);
    d.fb[k] = ls.fb + (lane << 2);
    d.in[k] = (f & F_ZERO) ? ls.zero : (f & F_SLOT) ? d.rf[k] : d.fb[k];
    d.v[k] = __uint_as_float(r.v[k]);
    d.op[k] = w1 & 3u;
    d.st[k] = f & F_STORE;
    d.live[k] = w1 & 0x1Fu;
  }
}

// The blocked kernel's cycle loop over a compacted stream: run_stream's
// chunks, ring and look-ahead of words, with the per-lane state above.
// Cycle t reads its x rows and psum inputs (the chain), then the lanes' old
// fb for the slot stores, decodes t + 2, loads the words of t + 3, stores
// the slots, computes, stores x and fb and ends in __syncwarp().
template <int LPT, class Hook>
__device__ __forceinline__ void run_compact(const CompactStream<LPT>& st, const LaneState& ls,
                                            const SmemRows& rows, Hook& hook) {
  using L = Lanes<LPT>;
#pragma unroll 1
  for (int k = 0; k < L::LEAD; ++k) {
    st.copy_chunk(k, k);
    cp_async_commit();
  }
  cp_async_wait<L::LEAD - 1>();
  __syncwarp();  // also publishes the zeroed state and the x set-up copies

  Raw<2, LPT> raw;  // the words of t + 2
  DecC<LPT> cur, nxt;
  st.load(0, 0, raw);
  decode_compact<LPT>(raw, cur, rows, ls);
  st.load(0, 1, raw);
  decode_compact<LPT>(raw, nxt, rows, ls);
  st.load(0, 2, raw);

  int slot = 0;  // ring slot of chunk cc
#pragma unroll 1
  for (int cc = 0; cc < st.nch; ++cc) {
    const int prev = slot == 0 ? L::LEAD : slot - 1;
    const int next = slot == L::LEAD ? 0 : slot + 1;
    st.copy_chunk(cc + L::LEAD, prev);
    cp_async_commit();
    cp_async_wait<L::LEAD - 1>();
    __syncwarp();  // the other threads' copies of chunk cc + 1 too
    hook.at_chunk(cc);
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      // the chain: this cycle's x rows and psum inputs, side by side
      float xv[LPT], pv[LPT], old[LPT];
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        xv[k] = rows.load(cur.x[k]);
        pv[k] = lds_f32(cur.in[k]);
      }
      // off the chain: the fb a slot store takes, the decode of t + 2, the
      // words of t + 3, the slot stores (after the slot's load above)
#pragma unroll
      for (int k = 0; k < LPT; ++k) old[k] = lds_f32(cur.fb[k]);
      DecC<LPT> dn;
      decode_compact<LPT>(raw, dn, rows, ls);
      st.load(u + 3 < CHUNK ? slot : next, (u + 3) % CHUNK, raw);
#pragma unroll
      for (int k = 0; k < LPT; ++k) sts_f32_if(cur.st[k], cur.rf[k], old[k]);
      // no contraction into an FMA, as in run_stream
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const float e = __fadd_rn(pv[k], __fmul_rn(cur.v[k], xv[k]));
        const float f = __fmul_rn(__fsub_rn(xv[k], pv[k]), cur.v[k]);
        rows.store_if(cur.op[k] == OP_FINAL, cur.x[k], f);
        sts_f32_if(cur.live[k], cur.fb[k], cur.op[k] == OP_EDGE ? e : pv[k]);
      }
      cur = nxt;
      nxt = dn;
      __syncwarp();
    }
    slot = next;
  }
}

template <int PLANES, int LPT, bool X_IN_SMEM>
__global__ void __launch_bounds__(32 * Lanes<LPT>::MAX_WARPS)
resident_kernel(const uint32_t* __restrict__ instr, const uint32_t* __restrict__ vals,
                const float* __restrict__ b, float* x, int T, int P, int n_rows, int B,
                int num_slots) {
  extern __shared__ __align__(16) uint32_t smem[];
  using Lay = Layout<PLANES, LPT>;
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int col = blockIdx.x * nw + w;
  const int fixed = Lay::fixed(num_slots), rfw = Lay::rf_words(num_slots);
  uint32_t* base = smem + (size_t)w * fixed;
  const unsigned rf_t = zero_rf(reinterpret_cast<float*>(base), rfw, t);
  const Stream<PLANES, LPT> st{instr, vals, saddr(base + rfw) + 4 * LPT * t, T, P, t};
  const unsigned mask = PLANES == 1 ? SRC_MASK : 0xffffffffu;
  const int nch = (T + CHUNK - 1) / CHUNK;
  NoBoundary hook;

  if constexpr (X_IN_SMEM) {
    float* xs = reinterpret_cast<float*>(smem + (size_t)nw * fixed + (size_t)w * n_rows);
    // x starts out as b
    for (int r = t; r < n_rows; r += 32)
      cp_async<4>(saddr(xs + r), reinterpret_cast<const uint32_t*>(b + (size_t)r * B + col),
                  true);
    cp_async_commit();
    run_stream<PLANES, LPT>(st, rf_t, SmemRows{saddr(xs), mask}, nch, hook);
    __syncwarp();
    for (int r = t; r < n_rows; r += 32) x[(size_t)r * B + col] = xs[r];
  } else {
#pragma unroll 8
    for (int r = t; r < n_rows; r += 32) x[(size_t)r * B + col] = b[(size_t)r * B + col];
    run_stream<PLANES, LPT>(st, rf_t, GlobalRows{x + col, B, mask}, nch, hook);
  }
}

// ------------------------------------------------------------ the slot file
// The hook of resident_kernel_slotted (the head note): the per-warp list
// ring of LEAD + 1 chunk slots, each [refill, flush][32 threads][SLOT_LIST]
// (slot, row) pairs as they lie in device memory, and the chunk tops.
template <int LPT>
struct SlotFile {
  static constexpr int LEAD = Lanes<LPT>::LEAD;
  static constexpr int MINE = SLOT_LIST * 8;  // bytes of a thread's entries of one list
  static constexpr int LIST = 32 * MINE;      // bytes of one list
  static constexpr int SLOT = 2 * LIST;       // bytes of a chunk's two lists
  static constexpr int RING_WORDS = (LEAD + 1) * SLOT / 4;
  // shared words of one warp: the list ring, then the slots padded to 16 bytes
  static __host__ __device__ int words(int x_slots) { return RING_WORDS + ((x_slots + 3) & ~3); }

  const int* lists;  // [nch][2][32][SLOT_LIST][2], pre-offset to this thread's entries
  const float* b;    // pre-offset to the column, row stride B
  float* x;
  unsigned ring;  // shared address of this thread's entries in list-ring slot 0
  unsigned xs;    // shared address of slot 0
  int B, nch;
  int slot = 0;  // list-ring slot of chunk cc

  // this thread's entries of chunk `chunk`'s lists into list-ring slot `rs`
  __device__ __forceinline__ void copy(int chunk, int rs) const {
    if (chunk >= nch) return;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(lists) + (size_t)chunk * (SLOT / 4);
    cp_async<MINE>(ring + rs * SLOT, src, true);
    cp_async<MINE>(ring + rs * SLOT + LIST, src + LIST / 4, true);
  }

  __device__ __forceinline__ void at_chunk(int cc) {
    copy(cc + LEAD, slot == 0 ? LEAD : slot - 1);
    const unsigned here = ring + slot * SLOT;
    uint32_t re[2 * SLOT_LIST], fl[2 * SLOT_LIST];
    lds_words<2 * SLOT_LIST>(here, re);
    lds_words<2 * SLOT_LIST>(here + LIST, fl);
    float v[SLOT_LIST];
#pragma unroll
    for (int i = 0; i < SLOT_LIST; ++i) v[i] = lds_f32(xs + (fl[2 * i] << 2));
#pragma unroll
    for (int i = 0; i < SLOT_LIST; ++i) {
      const int row = (int)fl[2 * i + 1];
      if (row >= 0) x[(size_t)row * B] = v[i];
    }
    // the flushes' reads before any refill's write; the refills of chunk
    // cc - LEAD, landed for this thread at the wait, for every thread
    __syncwarp();
#pragma unroll
    for (int i = 0; i < SLOT_LIST; ++i) {
      const int row = (int)re[2 * i + 1];
      cp_async4_if(row >= 0, xs + (re[2 * i] << 2), b + (long long)row * B);
    }
    slot = slot == LEAD ? 0 : slot + 1;
  }
};

// The resident kernel with x in a slot file of x_slots slots: `prologue`
// (n_prologue pairs) is copied in before the first chunk, `lists` at the
// chunk tops, `tail` (n_tail pairs) written out after the last chunk.
template <int PLANES, int LPT>
__global__ void __launch_bounds__(32 * Lanes<LPT>::MAX_WARPS)
resident_kernel_slotted(const uint32_t* __restrict__ instr, const uint32_t* __restrict__ vals,
                        const float* __restrict__ b, float* x, int T, int P, int n_rows, int B,
                        int num_slots, int x_slots, const int* __restrict__ lists,
                        const int* __restrict__ prologue, int n_prologue,
                        const int* __restrict__ tail, int n_tail) {
  extern __shared__ __align__(16) uint32_t smem[];
  using Lay = Layout<PLANES, LPT>;
  using SF = SlotFile<LPT>;
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int col = blockIdx.x * nw + w;
  const int fixed = Lay::fixed(num_slots), rfw = Lay::rf_words(num_slots);
  uint32_t* base = smem + (size_t)w * fixed;
  const unsigned rf_t = zero_rf(reinterpret_cast<float*>(base), rfw, t);
  const Stream<PLANES, LPT> st{instr, vals, saddr(base + rfw) + 4 * LPT * t, T, P, t};
  const unsigned mask = PLANES == 1 ? SRC_MASK : 0xffffffffu;
  const int nch = (T + CHUNK - 1) / CHUNK;
  uint32_t* lring = smem + (size_t)nw * fixed + (size_t)w * SF::words(x_slots);
  const float* slots = reinterpret_cast<const float*>(lring + SF::RING_WORDS);
  const unsigned xs = saddr(slots);
  SF hook{lists + t * 2 * SLOT_LIST, b + col, x + col, saddr(lring) + SF::MINE * t, xs, B, nch};

  // b of the rows whose FINAL comes first, and the lists of chunks 0 to LEAD - 1
  for (int e = t; e < n_prologue; e += 32)
    cp_async<4>(xs + 4 * prologue[2 * e],
                reinterpret_cast<const uint32_t*>(b + (size_t)prologue[2 * e + 1] * B + col), true);
#pragma unroll 1
  for (int k = 0; k < SF::LEAD; ++k) hook.copy(k, k);
  cp_async_commit();
  if (t == 0) x[(size_t)(n_rows - 1) * B + col] = b[(size_t)(n_rows - 1) * B + col];  // padding
  run_stream<PLANES, LPT>(st, rf_t, SmemRows{xs, mask}, nch, hook);
  __syncwarp();
  for (int e = t; e < n_tail; e += 32) x[(size_t)tail[2 * e + 1] * B + col] = slots[tail[2 * e]];
}

// The blocked kernel's boundaries, at the top of the chunk that starts a
// cycle block.  `bstage` holds b of the rows entering at the next boundary.
struct Boundaries {
  float* ring;    // ring_rows x rows
  float* bstage;  // stride rows
  float* x;       // device memory, pre-offset to the column
  const float* b;
  int B, window, stride, blk_chunks, nblocks, t;
  unsigned mask;  // ring_rows - 1
  bool wait_all;  // a block is shorter than the stream's lead
  int g = 0;      // blocks begun

  // b of the rows entering at boundary g + 1, by cp.async
  __device__ __forceinline__ void prefetch(int g1) const {
    const int first = (g1 - 1) * stride + window;
    for (int e = t; e < stride; e += 32)
      cp_async<4>(saddr(bstage + e),
                  reinterpret_cast<const uint32_t*>(b + (size_t)(first + e) * B), true);
  }

  __device__ __forceinline__ void at_chunk(int cc) {
    if (cc != g * blk_chunks) return;  // uniform across the warp
    if (g > 0) {
      if (wait_all) asm volatile("cp.async.wait_all;\n" ::: "memory");
      const int base = (g - 1) * stride;
      for (int e = t; e < stride; e += 32) x[(size_t)(base + e) * B] = ring[(base + e) & mask];
      __syncwarp();  // every flush reads its slot before any refill writes
      for (int e = t; e < stride; e += 32) ring[(base + window + e) & mask] = bstage[e];
      __syncwarp();
    }
    ++g;
    if (g < nblocks) prefetch(g);
  }
};

// COMPACT: the stream is lane-compacted (PLANES 2, P = PP slots a cycle) over
// a program of `lanes` lanes.
template <int PLANES, int LPT, bool COMPACT>
__global__ void __launch_bounds__(32 * Lanes<LPT>::MAX_WARPS)
blocked_kernel(const uint32_t* __restrict__ instr, const uint32_t* __restrict__ vals,
               const float* __restrict__ b, float* x, int T, int P, int B, int num_slots,
               int window, int stride, int cycles_per_block, int ring_rows, int lanes) {
  extern __shared__ __align__(16) uint32_t smem[];
  using Lay = Layout<PLANES, LPT>;
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int col = blockIdx.x * nw + w;
  const int fixed =
      COMPACT ? CompactLayout<LPT>::fixed(num_slots, lanes) : Lay::fixed(num_slots);
  const int rfw = COMPACT ? CompactLayout<LPT>::state_words(num_slots, lanes)
                          : Lay::rf_words(num_slots);
  uint32_t* base = smem + (size_t)w * fixed;
  const unsigned rf_t = zero_rf(reinterpret_cast<float*>(base), rfw, t);
  float* ring = reinterpret_cast<float*>(smem + (size_t)nw * fixed +
                                         (size_t)w * (ring_rows + stride));
  float* bstage = ring + ring_rows;
  const unsigned mask = (unsigned)(ring_rows - 1) & (PLANES == 1 ? SRC_MASK : 0xffffffffu);
  const int blk_chunks = cycles_per_block / CHUNK;
  const int nblocks = T / cycles_per_block;

  // window 0 holds b of rows [0, window)
  for (int r = t; r < window; r += 32)
    cp_async<4>(saddr(ring + r), reinterpret_cast<const uint32_t*>(b + (size_t)r * B + col),
                true);
  Boundaries hook{ring, bstage, x + col, b + col, B, window, stride, blk_chunks, nblocks, t,
                  (unsigned)(ring_rows - 1), blk_chunks < Lanes<LPT>::LEAD};
  hook.at_chunk(0);  // block 0 begins: b of boundary 1 in flight
  cp_async_commit();
  if constexpr (COMPACT) {
    static_assert(PLANES == 2, "a compacted stream has two planes");
    // opaque to ptxas, which would otherwise re-derive them from the thread
    // index inside the cycle loop (~1% of the cycle on the band's program)
    unsigned rf = saddr(base), cring = saddr(base + rfw), xs = saddr(ring);
    asm volatile("" : "+r"(rf), "+r"(cring), "+r"(xs));
    const unsigned fb = rf + 4u * num_slots * lanes;
    run_compact<LPT>(CompactStream<LPT>{instr, vals, cring, cring + 4 * LPT * t, T / CHUNK, t},
                     LaneState{rf, fb, fb + 4u * lanes, (unsigned)lanes},
                     SmemRows{xs, mask}, hook);
  } else {
    const Stream<PLANES, LPT> st{instr, vals, saddr(base + rfw) + 4 * LPT * t, T, P, t};
    run_stream<PLANES, LPT>(st, rf_t, SmemRows{saddr(ring), mask}, T / CHUNK, hook);
  }

  // last window: every row still in the ring is final
  __syncwarp();
  const int last = (nblocks - 1) * stride;
  for (int e = t; e < window; e += 32)
    x[(size_t)(last + e) * B + col] = ring[(last + e) & (ring_rows - 1)];
}

int lanes_per_thread(int P) { return P <= 32 ? 1 : P <= 64 ? 2 : P <= 128 ? 4 : 8; }

template <int PLANES, int LPT>
size_t smem_bytes(int num_slots, int x_words, int bt) {
  return ((size_t)Layout<PLANES, LPT>::fixed(num_slots) + x_words) * 4 * bt;
}

template <class K>
cudaError_t launch_prep(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int PLANES, int LPT, bool XS>
cudaError_t resident(const void* instr, const void* vals, const void* b, void* x, int T, int P,
                     int n_rows, int B, int num_slots, int bt, cudaStream_t stream) {
  const size_t smem = smem_bytes<PLANES, LPT>(num_slots, XS ? n_rows : 0, bt);
  auto kernel = resident_kernel<PLANES, LPT, XS>;
  cudaError_t err = launch_prep(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B / bt, 32 * bt, smem, stream>>>((const uint32_t*)instr, (const uint32_t*)vals,
                                            (const float*)b, (float*)x, T, P, n_rows, B,
                                            num_slots);
  return cudaGetLastError();
}

template <int PLANES, int LPT>
cudaError_t resident_slotted(const void* instr, const void* vals, const void* b, void* x, int T,
                             int P, int n_rows, int B, int num_slots, int bt, int x_slots,
                             const void* lists, const void* prologue, int n_prologue,
                             const void* tail, int n_tail, cudaStream_t stream) {
  const size_t smem = smem_bytes<PLANES, LPT>(num_slots, SlotFile<LPT>::words(x_slots), bt);
  auto kernel = resident_kernel_slotted<PLANES, LPT>;
  cudaError_t err = launch_prep(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B / bt, 32 * bt, smem, stream>>>(
      (const uint32_t*)instr, (const uint32_t*)vals, (const float*)b, (float*)x, T, P, n_rows, B,
      num_slots, x_slots, (const int*)lists, (const int*)prologue, n_prologue, (const int*)tail,
      n_tail);
  return cudaGetLastError();
}

template <int PLANES, int LPT, bool COMPACT>
cudaError_t blocked(const void* instr, const void* vals, const void* b, void* x, int T, int P,
                    int B, int num_slots, int bt, int window, int stride, int cycles_per_block,
                    int ring_rows, int lanes, cudaStream_t stream) {
  const size_t fixed =
      COMPACT ? CompactLayout<LPT>::fixed(num_slots, lanes) : Layout<PLANES, LPT>::fixed(num_slots);
  const size_t smem = (fixed + ring_rows + stride) * 4 * bt;
  auto kernel = blocked_kernel<PLANES, LPT, COMPACT>;
  cudaError_t err = launch_prep(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B / bt, 32 * bt, smem, stream>>>((const uint32_t*)instr, (const uint32_t*)vals,
                                            (const float*)b, (float*)x, T, P, B, num_slots,
                                            window, stride, cycles_per_block, ring_rows, lanes);
  return cudaGetLastError();
}

#define SPTRSV_DISPATCH(PLANES_, LPT_, CALL)                            \
  switch ((PLANES_) * 16 + (LPT_)) {                                    \
    case 17: return (int)CALL(1, 1);                                    \
    case 18: return (int)CALL(1, 2);                                    \
    case 20: return (int)CALL(1, 4);                                    \
    case 24: return (int)CALL(1, 8);                                    \
    case 33: return (int)CALL(2, 1);                                    \
    case 34: return (int)CALL(2, 2);                                    \
    case 36: return (int)CALL(2, 4);                                    \
    case 40: return (int)CALL(2, 8);                                    \
    default: return (int)cudaErrorInvalidValue;                         \
  }

}  // namespace

extern "C" {

const char* sptrsv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// instr [T, planes, P] int32, vals [T, P] f32, b and x [n_rows, B] f32;
// one CTA of bt warps per bt columns, one warp per column.
int sptrsv_resident(const void* instr, const void* vals, const void* b, void* x, int T,
                    int planes, int P, int n_rows, int B, int num_slots, int bt, int x_in_smem,
                    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int lpt = lanes_per_thread(P);
#define SPTRSV_RESIDENT(PL, LP)                                                         \
  (x_in_smem ? resident<PL, LP, true>(instr, vals, b, x, T, P, n_rows, B, num_slots, bt, s) \
             : resident<PL, LP, false>(instr, vals, b, x, T, P, n_rows, B, num_slots, bt, s))
  SPTRSV_DISPATCH(planes, lpt, SPTRSV_RESIDENT)
#undef SPTRSV_RESIDENT
}

// The resident solve with x in a slot file of x_slots slots; lists
// [ceil(T / 8)][2][32][4][2], prologue [n_prologue][2] and tail [n_tail][2]
// int32 (slot, row) pairs (kernels/sptrsv/kernel.py SlotFile).
int sptrsv_resident_slotted(const void* instr, const void* vals, const void* b, void* x, int T,
                            int planes, int P, int n_rows, int B, int num_slots, int bt,
                            int x_slots, const void* lists, const void* prologue,
                            int n_prologue, const void* tail, int n_tail, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int lpt = lanes_per_thread(P);
#define SPTRSV_SLOTTED(PL, LP)                                                              \
  resident_slotted<PL, LP>(instr, vals, b, x, T, P, n_rows, B, num_slots, bt, x_slots, lists, \
                           prologue, n_prologue, tail, n_tail, s)
  SPTRSV_DISPATCH(planes, lpt, SPTRSV_SLOTTED)
#undef SPTRSV_SLOTTED
}

// b and x [n_hbm, B] f32 with n_hbm = (T / cycles_per_block - 1) * stride + window;
// cycles_per_block a multiple of CHUNK; ring_rows is the power of two >= window.
// `lanes` is the program's P: a stream of fewer slots (P = 32, 64 or 128, two
// planes) is lane-compacted.
int sptrsv_blocked(const void* instr, const void* vals, const void* b, void* x, int T,
                   int planes, int P, int B, int num_slots, int bt, int window, int stride,
                   int cycles_per_block, int ring_rows, int lanes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int lpt = lanes_per_thread(P);
#define SPTRSV_BLOCKED_AS(PL, LP, C)                                                      \
  blocked<PL, LP, C>(instr, vals, b, x, T, P, B, num_slots, bt, window, stride,           \
                     cycles_per_block, ring_rows, lanes, s)
  if (lanes != P) {
    if (planes != 2 || P != 32 * lpt || lanes < P) return (int)cudaErrorInvalidValue;
    switch (lpt) {
      case 1: return (int)SPTRSV_BLOCKED_AS(2, 1, true);
      case 2: return (int)SPTRSV_BLOCKED_AS(2, 2, true);
      case 4: return (int)SPTRSV_BLOCKED_AS(2, 4, true);
      default: return (int)cudaErrorInvalidValue;
    }
  }
#define SPTRSV_BLOCKED(PL, LP) SPTRSV_BLOCKED_AS(PL, LP, false)
  SPTRSV_DISPATCH(planes, lpt, SPTRSV_BLOCKED)
#undef SPTRSV_BLOCKED
#undef SPTRSV_BLOCKED_AS
}

}  // extern "C"
