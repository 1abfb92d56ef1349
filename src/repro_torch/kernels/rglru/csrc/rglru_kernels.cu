// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// from h_{-1} = h0, the full trajectory h of shape (B, S, W).
//
// Replaces repro/kernels/rglru/kernel.py _rglru_kernel / rglru_scan_bsw,
// the Pallas kernel that carries h in VMEM scratch across sequential time
// blocks and steps through each block with a fori_loop of width-wide VPU
// ops. It computes what that kernel computes, in its (B, S, W) layout:
// float32 a, b and h0 (h0 may be absent: zeros), float32 output.
//
// Bound: bytes. Each element of a and b is read once and each h written
// once, 12 bytes for one multiply and one add. At the serving prefill (B 4,
// S 4608, W 2560) that is 566 MB, 0.169 ms at 3.35 TB/s. The chain itself
// is not what binds: a step is one multiply and one add (about 8 cycles
// of dependent latency), 4,608 steps about 37k cycles, some 21 us, an
// eighth of the bytes bound. What held the replaced design back (below)
// was how few bytes it kept in flight.
//
// The ring kernel (rglru_scan_kernel, the one ops.rglru_scan launches, and
// its gradient too: the backward is the same recurrence on the inputs
// reversed in time, see ops.py).
// One CTA is one warp and owns one batch row and kLanes = 32 channels: one
// lane a channel, one 128-byte line a time step. It streams tiles of
// kSteps = 32 steps x 32 channels of a and b through a ring of kStages = 8
// stages in shared memory (2 x 8 x 32 x 32 x 4 B = 64 KB, dynamic), filled
// by cp.async at 4-byte granularity (every W, aligned or not: one route
// for every shape) with one commit group a tile. Each lane copies its own
// channel's column and walks it, so no lane waits for another: a lane's
// cp.async.wait_group is all the synchronisation there is. While tile g is
// walked, tiles g+1 .. g+7 are in flight: 7 x 8 KB = 56 KB a CTA. At the
// serving shape there are 80 x 4 = 320 CTAs, all resident (three fit an
// SM by shared memory), so an SM keeps about 2.4 x 56 KB = 136 KB of loads
// in flight, where Little's law at 3.35 TB/s over 132 SMs and about a
// microsecond of loaded latency asks for some 20 KB. h goes out with plain
// coalesced stores, one 128-byte line a step. The ragged time edge (s %
// kSteps) and channel edge (w % 32) are masked in the kernel.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md keeps
// the runs): at the serving shape 0.25 ms one launch at a time (two thirds
// of the bytes bound; the wrapper's host time is in it) and 0.21-0.22 ms
// over ten launches back to back (78-81 %), against 0.44 ms back to back
// for the replaced design; a torch.add of the same bytes takes 0.19
// ms. More stages, or longer or shorter tiles, were no faster,
// and the same ring with the recurrence taken out (out = a + b) took as
// long: what is left is the access pattern (one 128-byte line a CTA a
// step, rows 4W bytes apart), not the chain and not the bytes in flight.
// Filling the ring 16 bytes a copy was slower, so one 4-byte route takes
// every W.
//
// The design it replaced, one thread a (batch, channel) chain with 16
// steps of loads in registers, kept at most about 10 KB in flight an SM
// (32-39 % of the bound); PERF.md keeps its paired times.
//
// Rounding is pinned: each step is __fadd_rn(__fmul_rn(a, h), b),
// the product rounded and then the sum, never one fused multiply-add, in
// time order. The plain version (ref.py) computes a * h and then + b as
// two separately rounded tensor operations, so the kernel equals it bit
// for bit on the card; nothing is re-associated.
//
// Plain C interface (extern "C", pointers and integers only), built by
// nvcc into a shared library and loaded with ctypes by kernel.py. The entry
// point launches on the caller's stream, allocates nothing, and returns the
// cudaError_t of its launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

__device__ __forceinline__ float rglru_step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// ------------------------------------------------------------------ ring

constexpr int kLanes = 32;   // channels a CTA, one lane each
constexpr int kSteps = 32;   // time steps a tile
constexpr int kStages = 8;   // tiles in the ring
constexpr int kStageFloats = 2 * kSteps * kLanes;             // a, then b
constexpr int kRingBytes = kStages * kStageFloats * sizeof(float);
static_assert(kRingBytes <= 232448, "inside a block's shared memory");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kLanes)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int64_t s, int64_t w) {
  extern __shared__ float ring[];  // [kStages][a, b][kSteps][kLanes]
  const int lane = threadIdx.x;
  const int64_t ch = static_cast<int64_t>(blockIdx.x) * kLanes + lane;
  if (ch >= w) return;  // no lane reads another's column
  const int64_t base = static_cast<int64_t>(blockIdx.y) * s * w + ch;
  const float* ap = a + base;
  const float* bp = b + base;
  float* op = out + base;
  float h = h0 != nullptr ? h0[static_cast<int64_t>(blockIdx.y) * w + ch]
                          : 0.f;
  float* column = ring + lane;
  const int64_t tiles = (s + kSteps - 1) / kSteps;

  // This lane's column of tile `tile` into its stage; steps past s are
  // not copied (and not read).
  auto fill = [&](int64_t tile) {
    float* st = column + (tile % kStages) * kStageFloats;
    const int64_t t0 = tile * kSteps;
    const int64_t left = s - t0;
    const float* ga = ap + t0 * w;
    const float* gb = bp + t0 * w;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (u < left) {
        cp_async4(st + u * kLanes, ga);
        cp_async4(st + (kSteps + u) * kLanes, gb);
      }
      ga += w;
      gb += w;
    }
  };

  // One commit group a tile, empty past the last, so that wait_group
  // counts tiles.
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < tiles) fill(p);
    cp_async_commit();
  }
  for (int64_t g = 0; g < tiles; ++g) {
    // the stage of tile g - 1, walked by this lane in the last iteration
    if (g + kStages - 1 < tiles) fill(g + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile g has landed
    const float* st = column + (g % kStages) * kStageFloats;
    const int64_t t0 = g * kSteps;
    float* o = op + t0 * w;
    if (t0 + kSteps <= s) {
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        h = rglru_step(st[u * kLanes], h, st[(kSteps + u) * kLanes]);
        *o = h;
        o += w;
      }
    } else {
      for (int u = 0; u < s - t0; ++u) {
        h = rglru_step(st[u * kLanes], h, st[(kSteps + u) * kLanes]);
        *o = h;
        o += w;
      }
    }
  }
}

bool valid(int64_t batch, int64_t s, int64_t w) {
  return batch >= 1 && batch <= 65535 && s >= 1 && w >= 1;
}

// The ring's dynamic shared memory is over the 48 KB a launch may take by
// default: raise the kernel's limit once a device (the current one), not
// before every launch.
constexpr int kMaxDevices = 64;
std::atomic<bool> ring_smem_allowed[kMaxDevices];

cudaError_t allow_ring_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && ring_smem_allowed[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(rglru_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRingBytes);
  if (err == cudaSuccess && known)
    ring_smem_allowed[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

extern "C" {

const char* rglru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The ring kernel's constants, for callers that report its geometry:
// lanes (channels a CTA), steps a tile, stages, ring bytes.
void rglru_scan_config(int64_t* out) {
  out[0] = kLanes;
  out[1] = kSteps;
  out[2] = kStages;
  out[3] = kRingBytes;
}

// a, b, out: (batch, s, w) float32, contiguous; h0: (batch, w) float32,
// contiguous, or null for zeros. batch in [1, 65535], s >= 1, w >= 1.
// Returns cudaErrorInvalidValue for anything else. The ring kernel.
int rglru_scan_launch(const void* a, const void* b, const void* h0,
                      void* out, int64_t batch, int64_t s, int64_t w,
                      void* stream) {
  if (!valid(batch, s, w)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_ring_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((w + kLanes - 1) / kLanes),
                  static_cast<unsigned>(batch));
  rglru_scan_kernel<<<grid, kLanes, kRingBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), s, w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
