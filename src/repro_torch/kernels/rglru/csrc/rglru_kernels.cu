// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// from h_{-1} = h0, the full trajectory h of shape (B, S, W).
//
// Replaces repro/kernels/rglru/kernel.py _rglru_kernel / rglru_scan_bsw,
// the Pallas kernel that carries h in VMEM scratch across sequential time
// blocks and steps through each block with a fori_loop of width-wide VPU
// ops. It computes what that kernel computes, in its (B, S, W) layout:
// float32 a, b and h0 (h0 may be absent: zeros), float32 output.
//
// Design for the card, not block by block from the TPU. The time blocks
// exist there because of VMEM and mean nothing here: one thread owns one
// (batch, channel) pair and walks the whole sequence with h in a register,
// neighbouring threads on neighbouring channels so that every load and
// store of a warp is one coalesced 128-byte line. The loop is unrolled by
// kUnroll, with all of a group's loads issued before its first dependent
// step, so kUnroll pairs of loads are in flight while the chain of
// multiply-adds waits on them. Nothing carries between blocks, so there is
// no second pass and no scratch.
//
// Rounding is pinned: each step is __fadd_rn(__fmul_rn(a, h), b), the
// product rounded and then the sum, never one fused multiply-add. The
// plain version (ref.py) computes a * h and then + b as two separately
// rounded tensor operations, so the kernel equals it bit for bit on the
// card.
//
// Bound: bytes. Each element of a and b is read once and each h written
// once, 12 bytes for one multiply and one add. At the serving prefill (B 4,
// S 4608, W 2560) that is 566 MB, 0.17 ms at 3.35 TB/s. But that shape has
// only B * W = 10,240 independent chains, one warp per 32 channels, 320
// warps on 132 SMs: latency, not bandwidth, sets this design's time. A
// chunked two-pass scan (per-chunk products and sums, a carry pass, then a
// fix-up) spreads the sequence over more threads and is later work.
//
// Plain C interface (extern "C", pointers and integers only), built by
// nvcc into a shared library and loaded with ctypes by kernel.py. The entry
// point launches on the caller's stream, allocates nothing, and returns
// the cudaError_t of its launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // channels a block: 160 blocks at W 2560, B 4
constexpr int kUnroll = 16;    // time steps whose loads are issued together

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int64_t s, int64_t w) {
  const int64_t ch = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (ch >= w) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * s * w + ch;
  const float* ap = a + base;
  const float* bp = b + base;
  float* op = out + base;
  float h = h0 != nullptr ? h0[static_cast<int64_t>(blockIdx.y) * w + ch]
                          : 0.f;
  int64_t t = 0;
  for (; t + kUnroll <= s; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = __ldg(ap + (t + u) * w);
      bv[u] = __ldg(bp + (t + u) * w);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      op[(t + u) * w] = h;
    }
  }
  for (; t < s; ++t) {
    h = __fadd_rn(__fmul_rn(__ldg(ap + t * w), h), __ldg(bp + t * w));
    op[t * w] = h;
  }
}

}  // namespace

extern "C" {

const char* rglru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a, b, out: (batch, s, w) float32, contiguous; h0: (batch, w) float32,
// contiguous, or null for zeros. batch in [1, 65535], s >= 1, w >= 1.
// Returns cudaErrorInvalidValue for anything else.
int rglru_scan_launch(const void* a, const void* b, const void* h0,
                      void* out, int64_t batch, int64_t s, int64_t w,
                      void* stream) {
  if (batch < 1 || batch > 65535 || s < 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((w + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), s, w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
