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

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// --------------------------------------------------------------------------
// K1: masked rarest-argmin.
//
// Replaces repro/kernels/swarm/kernel.py _rarest_argmin_kernel /
// rarest_argmin_call. Per row r of a (k, P) candidate mask: the
// lexicographic minimum of (avail[p], jitter[r, p], p) over the candidate
// pieces, or -1 when the row has none.
//
// Bound: bytes. Each row reads P mask bytes and P jitter floats once; there
// is one compare per element. One warp per row, lanes stride the pieces
// (neighbouring lanes on neighbouring addresses), then a shuffle reduction
// of the triple. The lexicographic minimum is associative and commutative
// with the index as the last key, so any reduction tree returns the index
// the sequential reference returns. Availability and jitter are compared,
// never added (a float32 sum would round the jitter away).

__device__ __forceinline__ bool lex_less(float a1, float j1, int i1,
                                         float a2, float j2, int i2) {
  if (i1 < 0) return false;  // no candidate never wins
  if (i2 < 0) return true;
  if (a1 != a2) return a1 < a2;
  if (j1 != j2) return j1 < j2;
  return i1 < i2;
}

__global__ void rarest_argmin_kernel(const uint8_t* __restrict__ cand,
                                     const float* __restrict__ avail,
                                     const float* __restrict__ jitter,
                                     int32_t* __restrict__ out,
                                     int64_t k, int P) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= k) return;  // uniform across the warp: one warp per row
  const int64_t base = row * static_cast<int64_t>(P);
  float ba = CUDART_INF_F, bj = CUDART_INF_F;
  int bi = -1;
  // increasing p within a lane: strictly-less keeps the lowest index on ties
  for (int p = lane; p < P; p += kWarp) {
    if (cand[base + p]) {
      const float a = __ldg(avail + p);
      const float j = jitter[base + p];
      if (bi < 0 || a < ba || (a == ba && j < bj)) {
        ba = a;
        bj = j;
        bi = p;
      }
    }
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float oa = __shfl_down_sync(kFull, ba, off);
    const float oj = __shfl_down_sync(kFull, bj, off);
    const int oi = __shfl_down_sync(kFull, bi, off);
    if (lex_less(oa, oj, oi, ba, bj, bi)) {
      ba = oa;
      bj = oj;
      bi = oi;
    }
  }
  if (lane == 0) out[row] = bi;
}

// --------------------------------------------------------------------------
// K2: max-min water-filling.
//
// Replaces repro/kernels/swarm/kernel.py _waterfill_kernel / waterfill_call.
// Progressive filling over a flow table: every round counts the active
// flows per constraint (node uplink, node downlink, link slot), raises all
// active flows by delta = min(residual / count), and freezes the flows that
// touch a constraint saturated within 1e-6.
//
// The rounds are sequential; inside a round everything is exact in any
// order (integer counts by atomics, a min, elementwise updates), so each
// round is a few grid launches and the host loop stops on 4-byte flags.
// Each round reads every flow's frozen flag, the indices and rate of the
// active flows, and the constraint vectors; the host loop reports each
// round's active-flow count, which is what that traffic depends on.
//
// Constraint layout: one vector of ncon = 2 * nn + nlp slots -- uplinks at
// [0, nn), downlinks at [nn, 2 nn), link slots at [2 nn, 2 nn + nlp); the
// last link slot is the infinite-capacity dummy that unlinked flows use.

constexpr int kBlock = 256;

// flags[0]: active flows this round; flags[1]: delta finite (updates
// ran); flags[2]: some flow froze this round.

__device__ __forceinline__ void warp_count(int* ncnt, int idx, bool act) {
  // lanes that hit the same slot add once (hot slots: the origin node, the
  // dummy link slot that every unlinked flow shares)
  const unsigned mask = __ballot_sync(kFull, act);
  if (!act) return;
  const unsigned peers = __match_any_sync(mask, idx);
  if ((threadIdx.x % kWarp) == __ffs(peers) - 1) {
    atomicAdd(ncnt + idx, __popc(peers));
  }
}

__global__ void wf_count(const int32_t* __restrict__ src,
                         const int32_t* __restrict__ dst,
                         const int32_t* __restrict__ lnk,
                         const uint8_t* __restrict__ frozen, int64_t nf,
                         int nn, int* __restrict__ ncnt,
                         int* __restrict__ flags) {
  const int64_t f = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool act = f < nf && !frozen[f];
  warp_count(ncnt, act ? src[f] : 0, act);
  warp_count(ncnt, act ? nn + dst[f] : 0, act);
  warp_count(ncnt, act ? 2 * nn + lnk[f] : 0, act);
  const unsigned n_act = __popc(__ballot_sync(kFull, act));
  if (n_act && (threadIdx.x % kWarp) == 0) atomicAdd(flags, int(n_act));
}

// NaN-propagating min, as numpy's and torch's min reductions are
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__global__ void wf_delta(const float* __restrict__ cap,
                         const float* __restrict__ alloc,
                         const int* __restrict__ ncnt, int ncon,
                         float* __restrict__ dres,
                         float* __restrict__ partial) {
  __shared__ float smin[kBlock / kWarp];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  float d = CUDART_INF_F;
  if (c < ncon) {
    const int n = ncnt[c];
    if (n > 0) d = __fdiv_rn(__fsub_rn(cap[c], alloc[c]), __int2float_rn(n));
    dres[c] = d;
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    d = nan_min(d, __shfl_down_sync(kFull, d, off));
  }
  if (threadIdx.x % kWarp == 0) smin[threadIdx.x / kWarp] = d;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = smin[0];
    for (int w = 1; w < kBlock / kWarp; ++w) m = nan_min(m, smin[w]);
    partial[blockIdx.x] = m;
  }
}

__global__ void wf_reduce(const float* __restrict__ partial, int npart,
                          float* __restrict__ scal, int* __restrict__ flags) {
  __shared__ float smin[1024 / kWarp];
  float d = CUDART_INF_F;
  for (int i = threadIdx.x; i < npart; i += blockDim.x) {
    d = nan_min(d, partial[i]);
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    d = nan_min(d, __shfl_down_sync(kFull, d, off));
  }
  if (threadIdx.x % kWarp == 0) smin[threadIdx.x / kWarp] = d;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = smin[0];
    for (int w = 1; w < static_cast<int>(blockDim.x) / kWarp; ++w) {
      m = nan_min(m, smin[w]);
    }
    const bool ok = isfinite(m);
    const float delta = (0.0f > m) ? 0.0f : m;  // max(delta, 0)
    scal[0] = delta;
    scal[1] = __fadd_rn(delta, 1e-6f);  // saturation tolerance
    flags[1] = ok ? 1 : 0;
  }
}

__global__ void wf_apply_flows(const int32_t* __restrict__ src,
                               const int32_t* __restrict__ dst,
                               const int32_t* __restrict__ lnk, int64_t nf,
                               int nn, const int* __restrict__ ncnt,
                               const float* __restrict__ dres,
                               const float* __restrict__ scal,
                               uint8_t* __restrict__ frozen,
                               float* __restrict__ rate,
                               int* __restrict__ flags) {
  if (!flags[1]) return;  // uniform: the reference breaks before updating
  const int64_t f = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool newly = false;
  if (f < nf && !frozen[f]) {
    const float delta = scal[0];
    const float tol = scal[1];
    rate[f] = __fadd_rn(rate[f], delta);
    const int cu = src[f], cd = nn + dst[f], cl = 2 * nn + lnk[f];
    newly = (dres[cu] <= tol && ncnt[cu] > 0) ||
            (dres[cd] <= tol && ncnt[cd] > 0) ||
            (dres[cl] <= tol && ncnt[cl] > 0);
    if (newly) frozen[f] = 1;
  }
  if (__any_sync(kFull, newly) && (threadIdx.x % kWarp) == 0) flags[2] = 1;
}

__global__ void wf_apply_cons(int ncon, int* __restrict__ ncnt,
                              const float* __restrict__ scal,
                              float* __restrict__ alloc,
                              const int* __restrict__ flags) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncon) return;
  if (flags[1]) {
    alloc[c] = __fadd_rn(alloc[c], __fmul_rn(__int2float_rn(ncnt[c]), scal[0]));
  }
  ncnt[c] = 0;  // counts restart from zero next round
}

__global__ void wf_init(const int32_t* __restrict__ src, int64_t nf,
                        uint8_t* __restrict__ frozen,
                        float* __restrict__ rate) {
  const int64_t f = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (f >= nf) return;
  frozen[f] = src[f] < 0 ? 1 : 0;  // padding flows pre-frozen at rate 0
  rate[f] = 0.0f;
}

}  // namespace

extern "C" {

const char* swarm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int rarest_argmin_launch(const void* cand, const void* avail,
                         const void* jitter, void* out, int64_t k, int P,
                         void* stream) {
  const int rows_per_block = kBlock / kWarp;
  const int64_t blocks = (k + rows_per_block - 1) / rows_per_block;
  rarest_argmin_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cand), static_cast<const float*>(avail),
      static_cast<const float*>(jitter), static_cast<int32_t*>(out), k, P);
  return static_cast<int>(cudaGetLastError());
}

// Runs the whole fixed point. Scratch (all device, caller-allocated):
// frozen (nf bytes), ncnt (ncon ints, zeroed by the caller), alloc (ncon
// floats, zeroed), dres (ncon floats), partial (ceil(ncon / 256) floats),
// scal (2 floats), flags (3 ints). cap holds the ncon capacities in the
// constraint layout above. *rounds_out receives the rounds that found an
// active flow; active_out (host, max_rounds entries, or null) receives
// each such round's active-flow count.
int waterfill_launch(const void* src, const void* dst, const void* lnk,
                     const void* cap, int64_t nf, int nn, int nlp,
                     int max_rounds, void* rate, void* frozen, void* ncnt,
                     void* alloc, void* dres, void* partial, void* scal,
                     void* flags, int* rounds_out, int64_t* active_out,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncon = 2 * nn + nlp;
  const unsigned fblocks = static_cast<unsigned>((nf + kBlock - 1) / kBlock);
  const int cblocks = (ncon + kBlock - 1) / kBlock;
  const int32_t* s_ = static_cast<const int32_t*>(src);
  const int32_t* d_ = static_cast<const int32_t*>(dst);
  const int32_t* l_ = static_cast<const int32_t*>(lnk);
  uint8_t* fz = static_cast<uint8_t*>(frozen);
  float* rt = static_cast<float*>(rate);
  int* nc = static_cast<int*>(ncnt);
  float* al = static_cast<float*>(alloc);
  float* dr = static_cast<float*>(dres);
  float* pa = static_cast<float*>(partial);
  float* sc = static_cast<float*>(scal);
  int* fl = static_cast<int*>(flags);
  *rounds_out = 0;
  wf_init<<<fblocks, kBlock, 0, s>>>(s_, nf, fz, rt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int it = 0; it < max_rounds; ++it) {
    err = cudaMemsetAsync(fl, 0, 3 * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    wf_count<<<fblocks, kBlock, 0, s>>>(s_, d_, l_, fz, nf, nn, nc, fl);
    wf_delta<<<cblocks, kBlock, 0, s>>>(static_cast<const float*>(cap), al,
                                        nc, ncon, dr, pa);
    wf_reduce<<<1, 1024, 0, s>>>(pa, cblocks, sc, fl);
    wf_apply_flows<<<fblocks, kBlock, 0, s>>>(s_, d_, l_, nf, nn, nc, dr, sc,
                                              fz, rt, fl);
    wf_apply_cons<<<cblocks, kBlock, 0, s>>>(ncon, nc, sc, al, fl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    int h[3];
    err = cudaMemcpyAsync(h, fl, sizeof(h), cudaMemcpyDeviceToHost, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaStreamSynchronize(s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!h[0]) break;  // every flow frozen
    if (active_out) active_out[*rounds_out] = h[0];
    *rounds_out += 1;
    if (!h[1] || !h[2]) break;  // delta not finite / nothing saturated
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
