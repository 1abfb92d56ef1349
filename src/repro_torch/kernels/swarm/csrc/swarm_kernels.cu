// Swarm kernels for Hopper (sm_90a): masked rarest-argmin + max-min
// water-filling, the two per-tick hot loops of the fleet engine.
//
// Plain C interface (extern "C", pointers and ints only), built by nvcc into
// a shared library and loaded with ctypes by kernel.py. Every entry point
// launches on the caller's stream, allocates nothing, and returns the
// cudaError_t of its launches (0 = success).
//
// Build flags that matter for exactness: -fmad=false, and never
// --use_fast_math (division must stay IEEE). The water-filling arithmetic
// also pins every rounding with __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn, so the result is bit-exact with the plain float32 version,
// which rounds each multiply and add on its own.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 256;

__device__ __forceinline__ int lane_id() { return threadIdx.x % kWarp; }

// --------------------------------------------------------------------------
// K1: masked rarest-argmin.
//
// Replaces repro/kernels/swarm/kernel.py _rarest_argmin_kernel /
// rarest_argmin_call. Per row: the lexicographic minimum of (availability,
// jitter, piece index) over the row's candidate pieces, or -1 when the row
// has none. The minimum is associative and commutative with the index as
// the last key, so any split of a row over lanes and any reduction tree
// returns the index the sequential reference returns. Availability and
// jitter are compared, never added (a float32 sum would round the jitter
// away).
//
// Bound: bytes. A row is read once, one compare an element. Two forms share
// a lane's running minimum and the reduction over a row's lanes:
//
// - dense: (k, P) bool candidates and (k, P) float32 jitter, float32
//   availability (the contract of the reference kernel). Consecutive rows
//   are one contiguous span, so a CTA stages its tile of R rows into shared
//   memory with 16-byte cp.async copies (the 16-byte granules that hold the
//   span: a granule never crosses a page, so the few bytes read past either
//   end are mapped), then 8 lanes reduce each row from there, where that
//   tile of 32 rows fits in 46 KB (P <= 287); wider rows are read from
//   device memory, a warp a row.
// - gathered (the fleet path): the state's have-matrix and jitter at a
//   padded row pitch (a multiple of 16), the int32 replica counts, the
//   swarm class, and the rows and the other stream's piece. The kernel
//   builds each row's candidates itself: not held, allowed on this stream,
//   not the other stream's piece, below P; nothing of size (k, P) is
//   written. 8 lanes a row, a warp keeps 8 rows in flight, each row's
//   spans unrolled so that its loads are in flight together.
//   Replica counts compare as int32: exact, and ordered as float32 orders
//   them below 2^24, which the state's constructor guarantees.

template <typename K>
__device__ __forceinline__ bool lex_less(K a1, float j1, int i1, K a2,
                                         float j2, int i2) {
  if (i1 < 0) return false;  // no candidate never wins
  if (i2 < 0) return true;
  if (a1 != a2) return a1 < a2;
  if (j1 != j2) return j1 < j2;
  return i1 < i2;
}

// A lane's running minimum; each lane offers its pieces in increasing
// index, so strictly-less keeps the lowest index on ties.
template <typename K>
struct Best {
  K a = K();
  float j = 0.0f;
  int i = -1;
  __device__ __forceinline__ void offer(K a2, float j2, int p) {
    if (i < 0 || a2 < a || (a2 == a && j2 < j)) {
      a = a2;
      j = j2;
      i = p;
    }
  }
  // the minimum over each aligned group of G lanes, in every lane of it;
  // every lane of the warp calls it
  template <int G>
  __device__ __forceinline__ void reduce() {
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2) {
      const K oa = __shfl_xor_sync(kFull, a, off);
      const float oj = __shfl_xor_sync(kFull, j, off);
      const int oi = __shfl_xor_sync(kFull, i, off);
      if (lex_less(oa, oj, oi, a, j, i)) {
        a = oa;
        j = oj;
        i = oi;
      }
    }
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Copies the 16-byte granules holding [g, g + nbytes) to smem (16-byte
// aligned); returns where byte g landed.
__device__ __forceinline__ const unsigned char* stage(unsigned char* smem,
                                                      const void* g,
                                                      size_t nbytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  const uintptr_t lo = a & ~uintptr_t(15);
  const size_t granules = (a + nbytes - lo + 15) / 16;
  for (size_t t = threadIdx.x; t < granules; t += blockDim.x) {
    cp_async16(smem + 16 * t, reinterpret_cast<const void*>(lo + 16 * t));
  }
  return smem + (a - lo);
}

// Shared-memory bytes of a staged dense tile of R rows of P pieces.
__host__ __device__ constexpr size_t dense_smem(int R, int P) {
  return ((static_cast<size_t>(R) * P * 4 + 31) / 16) * 16 +
         ((static_cast<size_t>(R) * P + 31) / 16) * 16 +
         static_cast<size_t>(P) * 4;
}
constexpr size_t kDenseSmem = 46 * 1024;

// Staged: 32 rows a CTA from shared memory, 8 lanes a row. Not staged: 8
// rows a CTA from device memory, a warp a row.
template <bool kStaged>
__global__ void __launch_bounds__(kBlock)
    rarest_dense_kernel(const uint8_t* __restrict__ cand,
                        const float* __restrict__ avail,
                        const float* __restrict__ jitter,
                        int32_t* __restrict__ out, int64_t k, int P) {
  constexpr int G = kStaged ? 8 : kWarp;
  constexpr int R = kBlock / G;
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int rows = static_cast<int>(k - row0 < R ? k - row0 : R);
  const int r = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const uint8_t* c = cand + row0 * P;
  const float* j = jitter + row0 * P;
  const float* av = avail;
  if (kStaged) {
    const size_t span = static_cast<size_t>(rows) * P;
    unsigned char* sj = smem;
    unsigned char* sc = sj + ((static_cast<size_t>(R) * P * 4 + 31) / 16) * 16;
    float* sa = reinterpret_cast<float*>(
        sc + ((static_cast<size_t>(R) * P + 31) / 16) * 16);
    j = reinterpret_cast<const float*>(stage(sj, j, span * 4));
    c = reinterpret_cast<const uint8_t*>(stage(sc, c, span));
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int p = threadIdx.x; p < P; p += blockDim.x) sa[p] = __ldg(avail + p);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    av = sa;
  }
  Best<float> best;
  if (r < rows) {
    const uint8_t* crow = c + static_cast<int64_t>(r) * P;
    const float* jrow = j + static_cast<int64_t>(r) * P;
    for (int p = g; p < P; p += G) {
      if (crow[p]) best.offer(av[p], jrow[p], p);
    }
  }
  best.template reduce<G>();
  if (r < rows && g == 0) out[row0 + r] = best.i;
}

// Stream modes of the gathered form (kernel.py SELECT_MODES)
enum SelectMode : int {
  kHttpFirst = 0,      // http stream, mode http_first: every piece
  kHttpSwarmFirst = 1, // http stream, swarm_first: origin-routed pieces
  kHttpFallback = 2,   // ... and swarm-routed ones nobody serves
  kSwarm = 3,          // swarm stream: swarm-routed pieces with a holder
};

// The replica count of piece p when the stream may take it, else -1.
__device__ __forceinline__ int piece_key(const int32_t* __restrict__ repl,
                                         const uint8_t* __restrict__ sc,
                                         int p, int mode) {
  const int n = __ldg(repl + p);
  const bool s = __ldg(sc + p) != 0;
  const bool ok = mode == kHttpFirst        ? true
                  : mode == kHttpSwarmFirst ? !s
                  : mode == kHttpFallback   ? (!s || n == 0)
                                            : (s && n > 0);
  return ok ? n : -1;
}

constexpr int kGatherLanes = 8;     // lanes a row
constexpr int kGatherUnroll = 2;    // rows a lane group keeps in flight
constexpr int kGatherRows = kBlock / kGatherLanes * kGatherUnroll;
constexpr int kGatherSpan = 4 * kGatherLanes;  // pieces a group reads at once
// the pieces' keys in shared memory: pitch ints (kernel.py MAX_PITCH)
constexpr int kMaxGatherSmem = 227 * 1024;

// Each CTA first writes every piece's key (its replica count where this
// stream may take it, else -1; -1 past P too) to shared memory, so a lane
// reads four keys with one 16-byte load. Lane g of a row's group takes the
// pieces 32 t + 4 g + e (e < 4) of each 128-piece span: a 4-byte have
// load, a float4 of jitter and an int4 of keys a step, the group's 8
// lanes on 32 consecutive pieces (conflict-free in shared memory).
__global__ void __launch_bounds__(kBlock)
    rarest_gathered_kernel(const uint8_t* __restrict__ have,
                           const float* __restrict__ jitter, int64_t pitch,
                           const int32_t* __restrict__ repl,
                           const uint8_t* __restrict__ sc,
                           const int64_t* __restrict__ rows,
                           const int64_t* __restrict__ other,
                           int32_t* __restrict__ out, int64_t k, int P,
                           int mode) {
  extern __shared__ __align__(16) int keys[];
  for (int p = threadIdx.x; p < pitch; p += blockDim.x) {
    keys[p] = p < P ? piece_key(repl, sc, p, mode) : -1;
  }
  const int g = threadIdx.x % kGatherLanes;
  const int grp = threadIdx.x / kGatherLanes;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kGatherRows;
  const long long* r64 = reinterpret_cast<const long long*>(rows);
  const long long* o64 = reinterpret_cast<const long long*>(other);
  int64_t idx[kGatherUnroll];
  int64_t row[kGatherUnroll];
  int oth[kGatherUnroll];
  Best<int> best[kGatherUnroll];
#pragma unroll
  for (int u = 0; u < kGatherUnroll; ++u) {
    idx[u] = i0 + u * (kBlock / kGatherLanes) + grp;
    const bool live = idx[u] < k;
    row[u] = live ? __ldg(r64 + idx[u]) : -1;
    oth[u] = live ? static_cast<int>(__ldg(o64 + idx[u])) : -1;
  }
  __syncthreads();
  // unrolled, so that a row's spans are in flight together
#pragma unroll 4
  for (int q = 4 * g; q < pitch; q += kGatherSpan) {
    uint32_t m[kGatherUnroll];
    float4 jv[kGatherUnroll];
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      if (row[u] < 0) continue;
      const int64_t at = row[u] * pitch + q;
      m[u] = __ldg(reinterpret_cast<const uint32_t*>(have + at));
      jv[u] = __ldg(reinterpret_cast<const float4*>(jitter + at));
    }
    const int4 kv = *reinterpret_cast<const int4*>(keys + q);
    const int kk[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      if (row[u] < 0) continue;
      const float jj[4] = {jv[u].x, jv[u].y, jv[u].z, jv[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool held = (m[u] >> (8 * e)) & 0xffu;
        if (!held && kk[e] >= 0 && q + e != oth[u]) {
          best[u].offer(kk[e], jj[e], q + e);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kGatherUnroll; ++u) {
    best[u].template reduce<kGatherLanes>();
    if (row[u] >= 0 && g == 0) out[idx[u]] = best[u].i;
  }
}

// --------------------------------------------------------------------------
// K2: max-min water-filling, one persistent launch.
//
// Replaces repro/kernels/swarm/kernel.py _waterfill_kernel / waterfill_call.
// Progressive filling over a flow table: every round counts the active
// flows per constraint (node uplink, node downlink, link slot), raises all
// active flows by delta = min(residual / count), and freezes the flows that
// touch a constraint saturated within 1e-6.
//
// Constraint layout: ncon = 2 * nn + nlp slots -- uplinks at [0, nn),
// downlinks at [nn, 2 nn), link slots at [2 nn, 2 nn + nlp); the last link
// slot is the infinite-capacity dummy that unlinked flows use.
//
// One cooperative launch runs the whole fixed point: blocks x SMs CTAs
// (as many as are co-resident), grid-stride loops, and a grid barrier
// between phases. Each round is two phases:
//   B: over the slots touched this round, d = (cap - alloc) / count, kept
//      for C, and the NaN-propagating minimum (an order-free atomicMin on
//      an order-preserving integer key, one a block);
//   C: over this round's active-flow list, rate += delta and the
//      saturation test; the flows that stay active are appended to the
//      next round's list (ping-pong) and counted there at once, their
//      slots' first increment from zero appending the slot to the next
//      touched list; over this round's touched slots, alloc += count *
//      delta and the count returns to zero.
// Round 0's list and counts come from an initial pass over the table.
// Every exit is decided on the device, from words all blocks read after
// the same barrier. Traffic scales with the active flows and the slots
// they touch, not with the table; nothing returns to the host between
// rounds.
//
// Bound: bytes -- each input read once and the rates written once; round
// by round, 16 bytes an active flow and 12 a touched slot. What holds it
// on the card: after the first rounds a round has a few hundred thousand
// flows, one or two a thread, each a chain of dependent loads and atomics
// (list, indices, d, counts, appends), so a round costs latency, not
// bytes; the two grid barriers a round are small beside it.
//
// Exact in any order: counts are integers, the minimum is order-free, the
// per-flow and per-slot updates are independent. An untouched slot is
// exactly what the reference leaves: its count 0 gives d = inf (never the
// minimum), alloc + 0 * delta == alloc (delta finite, >= 0; alloc >= +0),
// and it never saturates. An active flow's three slots were all counted
// this round, so its saturation test needs no count.
//
// Same-address atomics whose result is used queue at one L2 slice: the
// list sizes take one atomicAdd a block and loop iteration, and the dummy
// link slot, which every unlinked flow shares (6.8M on the largest
// main-path table), is tallied per block in shared memory, one atomic a
// block and phase.

// control words (kernel.py CTRL_WORDS)
enum Ctrl : int {
  kListN = 0,     // [2] active-flow list sizes
  kTouchedN = 2,  // [2] touched-slot list sizes
  kMinKey = 4,    // [2] the round's minimum as an ordered key
  kRounds = 6,    // rounds that found an active flow
  kCtrlWords = 8,
};

// float -> unsigned key whose unsigned order is the float order, NaN
// lowest (so an atomicMin propagates it, as numpy's and torch's min do)
__device__ __forceinline__ unsigned min_key(float d) {
  if (d != d) return 0u;
  const unsigned u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_min_key(unsigned key) {
  if (key == 0u) return CUDART_NAN_F;
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}
constexpr unsigned kInfKey = 0xff800000u;  // min_key(+inf)

struct WaterfillArgs {
  const int32_t* src;
  const int32_t* dst;
  const int32_t* lnk;
  const float* up;
  const float* dn;
  const float* lcap;
  int64_t nf;
  int nn, nlp, max_rounds;
  float* rate;
  int32_t* list[2];     // active flows, nf each
  int32_t* touched[2];  // touched slots, ncon each
  int* ncnt[2];         // counts, ncon each, zero on entry
  float* alloc;         // ncon, zero on entry
  float* dres;          // ncon
  int* active_out;      // 2 min(max_rounds, nf): active flows, touched slots
  unsigned* ctrl;       // kCtrlWords, zero on entry
};

__device__ __forceinline__ float slot_cap(const WaterfillArgs& a, int c) {
  return c < a.nn ? __ldg(a.up + c)
         : c < 2 * a.nn ? __ldg(a.dn + c - a.nn)
                        : __ldg(a.lcap + c - 2 * a.nn);
}

constexpr int kWarps = kBlock / kWarp;

// One loop iteration's appends of a block, staged in shared memory: the
// flow each thread keeps active (to the next active-flow list) and the
// slots whose count it took from zero (to the touched list). One atomicAdd
// a block and list reserves the room, not one a warp: an atomic whose
// result is used waits at its L2 slice behind every other on that address.
struct Appends {
  unsigned flows[kWarps];  // per warp, then its exclusive prefix
  unsigned slots[kWarps];
  unsigned flow_base, slot_base;
};

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << lane_id()) - 1;
}

// Every thread of the block calls it once an iteration, with the
// iteration's parity buffer of sh.
__device__ __forceinline__ void append_block(Appends& sh, int32_t* list,
                                             unsigned* nlist, int f,
                                             bool keep, int32_t* touched,
                                             unsigned* ntouched,
                                             const int (&c)[3],
                                             const bool (&fresh)[3]) {
  const int w = threadIdx.x / kWarp;
  const unsigned mf = __ballot_sync(kFull, keep);
  unsigned ms[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) ms[j] = __ballot_sync(kFull, fresh[j]);
  if (lane_id() == 0) {
    sh.flows[w] = __popc(mf);
    sh.slots[w] = __popc(ms[0]) + __popc(ms[1]) + __popc(ms[2]);
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    unsigned* per = threadIdx.x == 0 ? sh.flows : sh.slots;
    unsigned total = 0;
    for (int i = 0; i < kWarps; ++i) {
      const unsigned n = per[i];
      per[i] = total;
      total += n;
    }
    unsigned* counter = threadIdx.x == 0 ? nlist : ntouched;
    const unsigned base = total ? atomicAdd(counter, total) : 0u;
    (threadIdx.x == 0 ? sh.flow_base : sh.slot_base) = base;
  }
  __syncthreads();
  if (keep) list[sh.flow_base + sh.flows[w] + __popc(mf & lanes_below())] = f;
  unsigned at = sh.slot_base + sh.slots[w];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (fresh[j]) touched[at + __popc(ms[j] & lanes_below())] = c[j];
    at += __popc(ms[j]);
  }
}

// Counts slot c for the lanes with act: lanes on one slot add once, and
// the lane that took the count from zero gets fresh. The dummy slot goes
// to the block's tally instead.
__device__ __forceinline__ bool count_slot(int* ncnt, int c, bool act,
                                           int dummy, int* tally) {
  const bool hot = act && c == dummy;
  const unsigned nhot = __popc(__ballot_sync(kFull, hot));
  if (nhot && lane_id() == 0) atomicAdd(tally, static_cast<int>(nhot));
  const bool cold = act && !hot;
  const unsigned mask = __ballot_sync(kFull, cold);
  bool fresh = false;
  if (cold) {
    const unsigned peers = __match_any_sync(mask, c);
    if (lane_id() == __ffs(peers) - 1) {
      fresh = atomicAdd(ncnt + c, __popc(peers)) == 0;
    }
  }
  return fresh;
}

// Counts a flow's three slots and appends it and its fresh slots. Every
// thread of the block calls it once an iteration.
__device__ __forceinline__ void count_flow(Appends& sh, int* ncnt,
                                           int32_t* list, unsigned* nlist,
                                           int32_t* touched,
                                           unsigned* ntouched, int f,
                                           bool keep, const int (&c)[3],
                                           int dummy, int* tally) {
  bool fresh[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) fresh[j] = count_slot(ncnt, c[j], keep, dummy, tally);
  append_block(sh, list, nlist, f, keep, touched, ntouched, c, fresh);
}

// The block's dummy-slot tally into its count: one atomic a block and
// phase. Every thread of the block calls it.
__device__ __forceinline__ void flush_tally(int* ncnt, int32_t* touched,
                                            unsigned* ntouched, int dummy,
                                            int* tally) {
  __syncthreads();
  if (threadIdx.x == 0 && *tally) {
    if (atomicAdd(ncnt + dummy, *tally) == 0) {
      touched[atomicAdd(ntouched, 1u)] = dummy;
    }
    *tally = 0;
  }
}

// At least 6 CTAs a SM (40 registers): 792 co-resident CTAs. A late
// round's flows are latency chains (list -> indices -> d -> counts ->
// appends), so more threads in flight beat more registers; at 8 a SM
// ptxas spills.
__global__ void __launch_bounds__(kBlock, 6)
    waterfill_kernel(const WaterfillArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Appends sh[2];
  __shared__ unsigned wmin[kWarps];
  __shared__ int tally;
  const int nn = a.nn;
  const int dummy = 2 * nn + a.nlp - 1;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  unsigned* ctrl = a.ctrl;
  if (threadIdx.x == 0) tally = 0;
  __syncthreads();

  // round 0's list and counts: every flow but padding (pre-frozen at 0);
  // block-uniform loops, as the appends need
  int it = 0;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kBlock;
       base < a.nf; base += nthreads, ++it) {
    const int64_t f = base + threadIdx.x;
    int c[3] = {0, 0, 0};
    bool act = false;
    if (f < a.nf) {
      a.rate[f] = 0.0f;
      const int s = __ldg(a.src + f);
      act = s >= 0;
      if (act) {
        c[0] = s;
        c[1] = nn + __ldg(a.dst + f);
        c[2] = 2 * nn + __ldg(a.lnk + f);
      }
    }
    count_flow(sh[it & 1], a.ncnt[0], a.list[0], ctrl + kListN, a.touched[0],
               ctrl + kTouchedN, static_cast<int>(f), act, c, dummy, &tally);
  }
  flush_tally(a.ncnt[0], a.touched[0], ctrl + kTouchedN, dummy, &tally);
  if (tid == 0) ctrl[kMinKey] = ctrl[kMinKey + 1] = kInfKey;
  grid.sync();

  int rounds = 0;
  for (int r = 0; r < a.max_rounds; ++r) {
    const int p = r & 1, q = p ^ 1;
    const unsigned n_act = __ldcg(ctrl + kListN + p);
    if (n_act == 0) break;  // every flow frozen
    rounds = r + 1;
    const unsigned n_touched = __ldcg(ctrl + kTouchedN + p);
    const int32_t* list = a.list[p];
    const int32_t* touched = a.touched[p];
    int* ncnt = a.ncnt[p];
    if (tid == 0) {
      a.active_out[2 * r] = static_cast<int>(n_act);
      a.active_out[2 * r + 1] = static_cast<int>(n_touched);
      // next round's words: last read before the barrier that ended r - 1
      ctrl[kListN + q] = 0;
      ctrl[kTouchedN + q] = 0;
      ctrl[kMinKey + q] = kInfKey;
    }

    // B: each touched slot's d, and the minimum
    unsigned key = kInfKey;
    for (int64_t i = tid; i < n_touched; i += nthreads) {
      const int c = __ldcg(touched + i);
      const float d =
          __fdiv_rn(__fsub_rn(slot_cap(a, c), __ldcg(a.alloc + c)),
                    __int2float_rn(__ldcg(ncnt + c)));
      a.dres[c] = d;
      key = min(key, min_key(d));
    }
    key = __reduce_min_sync(kFull, key);
    if (lane_id() == 0) wmin[threadIdx.x / kWarp] = key;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) key = min(key, wmin[w]);
      if (key != kInfKey) atomicMin(ctrl + kMinKey + p, key);
    }
    grid.sync();
    const float m = from_min_key(__ldcg(ctrl + kMinKey + p));
    if (!isfinite(m)) break;  // the reference stops before updating
    const float delta = (0.0f > m) ? 0.0f : m;  // max(delta, 0)
    const float tol = __fadd_rn(delta, 1e-6f);  // saturation tolerance

    // C: the active flows, then this round's slots
    for (int64_t base = static_cast<int64_t>(blockIdx.x) * kBlock;
         base < n_act; base += nthreads, ++it) {
      const int64_t i = base + threadIdx.x;
      int f = 0;
      int c[3] = {0, 0, 0};
      bool stay = false;
      if (i < n_act) {
        f = __ldcg(list + i);
        c[0] = __ldg(a.src + f);
        c[1] = nn + __ldg(a.dst + f);
        c[2] = 2 * nn + __ldg(a.lnk + f);
        a.rate[f] = __fadd_rn(__ldcg(a.rate + f), delta);
        stay = !(__ldcg(a.dres + c[0]) <= tol ||
                 __ldcg(a.dres + c[1]) <= tol ||
                 __ldcg(a.dres + c[2]) <= tol);
      }
      count_flow(sh[it & 1], a.ncnt[q], a.list[q], ctrl + kListN + q,
                 a.touched[q], ctrl + kTouchedN + q, f, stay, c, dummy,
                 &tally);
    }
    flush_tally(a.ncnt[q], a.touched[q], ctrl + kTouchedN + q, dummy, &tally);
    for (int64_t i = tid; i < n_touched; i += nthreads) {
      const int c = __ldcg(touched + i);
      const int n = __ldcg(ncnt + c);
      a.alloc[c] =
          __fadd_rn(__ldcg(a.alloc + c), __fmul_rn(__int2float_rn(n), delta));
      ncnt[c] = 0;  // ready to count the round after next
    }
    grid.sync();
    if (__ldcg(ctrl + kListN + q) == n_act) break;  // nothing saturated
  }
  if (tid == 0) ctrl[kRounds] = static_cast<unsigned>(rounds);
}

}  // namespace

extern "C" {

const char* swarm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1, dense form: cand (k, P) bool, avail (P,) float32, jitter (k, P)
// float32, out (k,) int32.
int rarest_argmin_launch(const void* cand, const void* avail,
                         const void* jitter, void* out, int64_t k, int P,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(cand);
  const float* a = static_cast<const float*>(avail);
  const float* j = static_cast<const float*>(jitter);
  int32_t* o = static_cast<int32_t*>(out);
  // a staged tile of 32 rows where it fits, else a warp a row
  if (dense_smem(32, P) <= kDenseSmem) {
    const unsigned blocks = static_cast<unsigned>((k + 31) / 32);
    rarest_dense_kernel<true>
        <<<blocks, kBlock, dense_smem(32, P), s>>>(c, a, j, o, k, P);
  } else {
    const unsigned blocks = static_cast<unsigned>((k + 7) / 8);
    rarest_dense_kernel<false><<<blocks, kBlock, 0, s>>>(c, a, j, o, k, P);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1, gathered form: have (n, pitch) bool and jitter (n, pitch) float32,
// 16-byte aligned, pitch a multiple of 16 >= P; repl (P,) int32, sc (P,)
// bool; rows (k,) int64 in [0, n), other (k,) int64 in [-1, P); out (k,)
// int32; mode a SelectMode.
int select_rows_launch(const void* have, const void* jitter, int64_t pitch,
                       const void* repl, const void* sc, const void* rows,
                       const void* other, void* out, int64_t k, int P,
                       int mode, void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((k + kGatherRows - 1) / kGatherRows);
  const size_t smem = static_cast<size_t>(pitch) * sizeof(int);
  if (smem > kMaxGatherSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rarest_gathered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rarest_gathered_kernel<<<blocks, kBlock, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(have), static_cast<const float*>(jitter),
      pitch, static_cast<const int32_t*>(repl),
      static_cast<const uint8_t*>(sc), static_cast<const int64_t*>(rows),
      static_cast<const int64_t*>(other), static_cast<int32_t*>(out), k, P,
      mode);
  return static_cast<int>(cudaGetLastError());
}

// K2: the whole fixed point in one cooperative launch. Scratch (device,
// caller-allocated): lists (2 nf ints), touched (2 ncon ints), ncnt (2 ncon
// ints, zero), alloc (ncon floats, zero), dres (ncon floats), active_out
// (2 min(max_rounds, nf) ints: each round's active flows and touched
// slots), ctrl
// (kCtrlWords, zero; ctrl[kRounds] receives the rounds). *grid_out
// receives the CTAs launched. A grid too large to be co-resident fails
// the launch (cudaErrorCooperativeLaunchTooLarge), never runs partly.
int waterfill_launch(const void* src, const void* dst, const void* lnk,
                     const void* up, const void* dn, const void* lcap,
                     int64_t nf, int nn, int nlp, int max_rounds, void* rate,
                     void* lists, void* touched, void* ncnt, void* alloc,
                     void* dres, void* active_out, void* ctrl, int* grid_out,
                     void* stream) {
  const int ncon = 2 * nn + nlp;
  WaterfillArgs a;
  a.src = static_cast<const int32_t*>(src);
  a.dst = static_cast<const int32_t*>(dst);
  a.lnk = static_cast<const int32_t*>(lnk);
  a.up = static_cast<const float*>(up);
  a.dn = static_cast<const float*>(dn);
  a.lcap = static_cast<const float*>(lcap);
  a.nf = nf;
  a.nn = nn;
  a.nlp = nlp;
  a.max_rounds = max_rounds;
  a.rate = static_cast<float*>(rate);
  a.list[0] = static_cast<int32_t*>(lists);
  a.list[1] = a.list[0] + nf;
  a.touched[0] = static_cast<int32_t*>(touched);
  a.touched[1] = a.touched[0] + ncon;
  a.ncnt[0] = static_cast<int*>(ncnt);
  a.ncnt[1] = a.ncnt[0] + ncon;
  a.alloc = static_cast<float*>(alloc);
  a.dres = static_cast<float*>(dres);
  a.active_out = static_cast<int*>(active_out);
  a.ctrl = static_cast<unsigned*>(ctrl);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, waterfill_kernel, kBlock, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid_out = per_sm * sms;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(waterfill_kernel), dim3(per_sm * sms),
      dim3(kBlock), params, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
