// Mamba-2 chunked SSD (state-space duality) forward for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd/kernel.py _ssd_kernel / ssd_chunked_bhsp, the
// Pallas kernel whose grid walks (batch, head, chunk) with the chunk axis
// sequential and the (P, N) float32 state in VMEM scratch. Per chunk of Q
// rows, with a = dt * a_neg and acum its running sum inside the chunk:
//
//   y     = ((C B^T) . L) (x dt) + exp(acum) . (C h_prev^T)
//   h     = h_prev * exp(acum[-1]) + ((x dt) . exp(acum[-1] - acum))^T B
//   L_ij  = exp(acum_i - acum_j) for i >= j, else 0
//
// one B/C group shared by every head. Two things the Pallas kernel does not
// do, because the model's ssd_chunked (repro/models/ssd.py:50) does: it
// starts from an optional initial state h0 (zeros when absent), and it
// writes the final state h_last out, which decode needs. Ragged sequences
// need no padding copy: rows past the end of the sequence are staged as
// dt = 0, x = B = C = 0, exactly the reference's padded rows, so they add
// nothing and decay nothing and h_last is the reference's.
//
// Design for the card, not block by block from the TPU. Blocks cannot carry
// scratch from one to the next, so one CTA of 256 threads owns one (batch,
// head) pair and loops over the chunks itself, the state h (up to 64 x 128
// float32) resident in shared memory for the whole sequence. Per chunk it
// stages dt, x, B and C in shared memory (widening bfloat16 to float32 as
// it loads, in registers: there is no float32 copy of the inputs), scans
// acum in one thread (64 adds), then runs three products as 16 x 16 thread
// tiles with register blocking: the masked scores C B^T . L (each thread
// a 4 x 4 block, L applied as the scores leave registers), y from the
// scores and from C h_prev^T (4 x 4 each), and the state update (4 x 8 of
// h a thread). Shared rows are padded (stride N + 1, Q + 1) so that the
// threads of a warp read distinct banks or one broadcast word.
//
// The compile-time extents are the largest shapes taken, Q <= 64, P <= 64,
// N <= 128 (the mamba2 configuration's chunk, head_dim and ssm_state):
// smaller shapes are zero-padded in shared memory, which changes nothing
// above. Shared memory is 133,120 bytes, above the 48 KB default, so the
// launch opts in with cudaFuncSetAttribute(MaxDynamicSharedMemorySize) and
// a refused opt-in or launch is returned to the caller.
//
// Bound: operations. Per (batch, head, chunk) of Q live rows the products
// on the causal triangle take Q (Q + 1) N (C B^T) + Q (Q + 1) P (the scores
// times x dt) + 2 Q P N (C h_prev^T) + 2 Q P N (the state update) flops,
// 2.9 MFLOP at Q = P = 64, N = 128; at the mamba2 prefill (B 4, H 64,
// S 4600: 72 chunks) 53.3 GFLOP a launch. C B^T multiplies bf16 operands,
// whose products the bf16 tensor cores (989 TFLOP/s) form exactly: 9.8
// GFLOP, 0.01 ms; the rest take a float32 operand, 43.5 GFLOP at the
// 67 TFLOP/s float32 rate outside the tensor cores: 0.66 ms in all,
// against 0.14 ms for its bytes. Arithmetic is float32 FMA on the SIMT
// pipes: the contract is 1e-4 in float32, which TF32 tensor cores (ten
// mantissa bits) would not hold. With one CTA of 8 warps a (batch, head)
// there are 256 CTAs, two waves on 132 SMs, and a 4 x 4 tile reads 8
// shared-memory words for its 16 FMAs: the kernel is bound by shared-memory
// traffic and by occupancy, not by the FMA pipes. Tensor-core
// products (bf16 or 3xTF32 split for the float32 contract) and more CTAs a
// sequence (a chunk-parallel pass, then the short inter-chunk scan) are
// later work.
//
// Plain C interface (extern "C", pointers and integers only), built by
// nvcc into a shared library and loaded with ctypes by kernel.py. The entry
// point launches on the caller's stream, allocates nothing, and returns
// the cudaError_t of its launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 16;             // a tile's threads along each side
constexpr int kQ = 64;             // chunk rows (compile-time extent)
constexpr int kP = 64;             // head dim
constexpr int kN = 128;            // state dim
constexpr int kLdN = kN + 1;       // row stride of B, C and h (floats)
constexpr int kLdQ = kQ + 1;       // row stride of the scores
constexpr int kRQ = kQ / kT;       // rows of a thread's tile: ty + 16 r
constexpr int kRP = kP / kT;       // head-dim columns of a thread: tx + 16 c
constexpr int kRN = kN / kT;       // state columns of a thread: tx + 16 c
static_assert(kT * kT == kThreads, "16 x 16 thread tiles");

// shared memory, in floats
constexpr int kOffH = 0;                    // h       [kP][kLdN]
constexpr int kOffB = kOffH + kP * kLdN;    // B       [kQ][kLdN]
constexpr int kOffC = kOffB + kQ * kLdN;    // C       [kQ][kLdN]
constexpr int kOffX = kOffC + kQ * kLdN;    // x * dt  [kQ][kP]
constexpr int kOffS = kOffX + kQ * kP;      // scores  [kQ][kLdQ]
constexpr int kOffV = kOffS + kQ * kLdQ;    // dt, acum, exp(acum), decay
constexpr int kFloats = kOffV + 4 * kQ;
constexpr size_t kBytes = kFloats * sizeof(float);

enum Dtype : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x: (batch, heads, s, p) at strides (x_sb, x_sh, x_ss, 1); dt likewise
// without p; B, C: (batch, s, n) at (sb, ss, 1); a_neg: (heads,); h0, h_last:
// (batch, heads, p, n) contiguous; y: (batch, s, heads, p) contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a_neg, const T* __restrict__ bm,
                 const T* __restrict__ cm, const float* __restrict__ h0,
                 float* __restrict__ y, float* __restrict__ h_last, int heads,
                 int s, int p, int n, int q, int64_t x_sb, int64_t x_sh,
                 int64_t x_ss, int64_t dt_sb, int64_t dt_sh, int64_t dt_ss,
                 int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss) {
  extern __shared__ float smem[];
  float* hs = smem + kOffH;
  float* bs = smem + kOffB;
  float* cs = smem + kOffC;
  float* xs = smem + kOffX;
  float* ss = smem + kOffS;
  float* dts = smem + kOffV;
  float* acum = dts + kQ;
  float* eacum = acum + kQ;
  float* decay = eacum + kQ;

  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % kT;
  const int ty = tid / kT;
  const float an = a_neg[hi];
  const int64_t bh = static_cast<int64_t>(bi) * heads + hi;

  for (int i = tid; i < kP * kN; i += kThreads) {
    const int pp = i / kN, nn = i % kN;
    hs[pp * kLdN + nn] = (h0 != nullptr && pp < p && nn < n)
                             ? h0[(bh * p + pp) * n + nn] : 0.f;
  }
  const T* xb = x + bi * x_sb + hi * x_sh;
  const float* dtb = dt + bi * dt_sb + hi * dt_sh;
  const T* bb = bm + bi * b_sb;
  const T* cb = cm + bi * c_sb;
  float* yb = y + (static_cast<int64_t>(bi) * s * heads + hi) * p;
  const int64_t y_ss = static_cast<int64_t>(heads) * p;

  for (int c0 = 0; c0 < s; c0 += q) {
    const int len = min(q, s - c0);  // rows of this chunk inside the sequence
    __syncthreads();  // the last chunk's reads of the staged tiles are done

    // ---- stage dt, B, C and x (zeros past len and past p, n)
    if (tid < kQ) dts[tid] = tid < len ? dtb[(c0 + tid) * dt_ss] : 0.f;
    for (int i = tid; i < kQ * kN; i += kThreads) {
      const int t = i / kN, nn = i % kN;
      const bool live = t < len && nn < n;
      bs[t * kLdN + nn] = live ? to_f32(bb[(c0 + t) * b_ss + nn]) : 0.f;
      cs[t * kLdN + nn] = live ? to_f32(cb[(c0 + t) * c_ss + nn]) : 0.f;
    }
    for (int i = tid; i < kQ * kP; i += kThreads) {
      const int t = i / kP, pp = i % kP;
      xs[i] = (t < len && pp < p) ? to_f32(xb[(c0 + t) * x_ss + pp]) : 0.f;
    }
    __syncthreads();

    // ---- acum = cumsum(dt * a_neg) (the product rounded, then the sum);
    //      x * dt in place
    if (tid == 0) {
      float run = 0.f;
      for (int t = 0; t < kQ; ++t) {
        run = __fadd_rn(run, __fmul_rn(dts[t], an));
        acum[t] = run;
      }
    }
    for (int i = tid; i < kQ * kP; i += kThreads) {
      xs[i] = __fmul_rn(xs[i], dts[i / kP]);
    }
    __syncthreads();
    if (tid < kQ) {
      eacum[tid] = expf(acum[tid]);
      decay[tid] = expf(acum[kQ - 1] - acum[tid]);
    }

    // ---- scores = (C B^T) . L, rows i = ty + 16 r, columns j = tx + 16 c
    {
      float acc[kRQ][kRQ];
#pragma unroll
      for (int r = 0; r < kRQ; ++r)
#pragma unroll
        for (int c = 0; c < kRQ; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        float cv[kRQ], bv[kRQ];
#pragma unroll
        for (int r = 0; r < kRQ; ++r) cv[r] = cs[(ty + kT * r) * kLdN + k];
#pragma unroll
        for (int c = 0; c < kRQ; ++c) bv[c] = bs[(tx + kT * c) * kLdN + k];
#pragma unroll
        for (int r = 0; r < kRQ; ++r)
#pragma unroll
          for (int c = 0; c < kRQ; ++c)
            acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kRQ; ++r) {
        const int i = ty + kT * r;
#pragma unroll
        for (int c = 0; c < kRQ; ++c) {
          const int j = tx + kT * c;
          ss[i * kLdQ + j] =
              i >= j ? acc[r][c] * expf(acum[i] - acum[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = scores (x dt) + exp(acum) . (C h_prev^T), rows i = ty + 16 r,
    //      head-dim columns pp = tx + 16 c
    {
      float yd[kRQ][kRP], yo[kRQ][kRP];
#pragma unroll
      for (int r = 0; r < kRQ; ++r)
#pragma unroll
        for (int c = 0; c < kRP; ++c) yd[r][c] = yo[r][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < len; ++j) {
        float sv[kRQ], xv[kRP];
#pragma unroll
        for (int r = 0; r < kRQ; ++r) sv[r] = ss[(ty + kT * r) * kLdQ + j];
#pragma unroll
        for (int c = 0; c < kRP; ++c) xv[c] = xs[j * kP + tx + kT * c];
#pragma unroll
        for (int r = 0; r < kRQ; ++r)
#pragma unroll
          for (int c = 0; c < kRP; ++c) yd[r][c] = fmaf(sv[r], xv[c], yd[r][c]);
      }
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        float cv[kRQ], hv[kRP];
#pragma unroll
        for (int r = 0; r < kRQ; ++r) cv[r] = cs[(ty + kT * r) * kLdN + k];
#pragma unroll
        for (int c = 0; c < kRP; ++c) hv[c] = hs[(tx + kT * c) * kLdN + k];
#pragma unroll
        for (int r = 0; r < kRQ; ++r)
#pragma unroll
          for (int c = 0; c < kRP; ++c) yo[r][c] = fmaf(cv[r], hv[c], yo[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kRQ; ++r) {
        const int i = ty + kT * r;
        if (i >= len) continue;
        float* yrow = yb + (c0 + i) * y_ss;
#pragma unroll
        for (int c = 0; c < kRP; ++c) {
          const int pp = tx + kT * c;
          if (pp < p) yrow[pp] = yd[r][c] + eacum[i] * yo[r][c];
        }
      }
    }
    __syncthreads();  // every read of h_prev is done before h changes

    // ---- h = h_prev * exp(acum[-1]) + ((x dt) . decay)^T B, rows
    //      pp = ty + 16 r, state columns nn = tx + 16 c
    {
      float st[kRP][kRN];
#pragma unroll
      for (int r = 0; r < kRP; ++r)
#pragma unroll
        for (int c = 0; c < kRN; ++c) st[r][c] = 0.f;
#pragma unroll 2
      for (int j = 0; j < len; ++j) {
        const float dj = decay[j];
        float xv[kRP], bv[kRN];
#pragma unroll
        for (int r = 0; r < kRP; ++r) xv[r] = xs[j * kP + ty + kT * r] * dj;
#pragma unroll
        for (int c = 0; c < kRN; ++c) bv[c] = bs[j * kLdN + tx + kT * c];
#pragma unroll
        for (int r = 0; r < kRP; ++r)
#pragma unroll
          for (int c = 0; c < kRN; ++c) st[r][c] = fmaf(xv[r], bv[c], st[r][c]);
      }
      const float chunk_decay = expf(acum[kQ - 1]);
#pragma unroll
      for (int r = 0; r < kRP; ++r)
#pragma unroll
        for (int c = 0; c < kRN; ++c) {
          float& hv = hs[(ty + kT * r) * kLdN + tx + kT * c];
          hv = hv * chunk_decay + st[r][c];
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < p * n; i += kThreads) {
    const int pp = i / n, nn = i % n;
    h_last[bh * p * n + i] = hs[pp * kLdN + nn];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_neg, const void* bm,
           const void* cm, const void* h0, void* y, void* h_last, int batch,
           int heads, int s, int p, int n, int q, int64_t x_sb, int64_t x_sh,
           int64_t x_ss, int64_t dt_sb, int64_t dt_sh, int64_t dt_ss,
           int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,
           cudaStream_t stream) {
  auto kernel = ssd_chunk_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads, batch);
  kernel<<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_neg), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_last), heads, s, p, n, q,
      x_sb, x_sh, x_ss, dt_sb, dt_sh, dt_ss, b_sb, b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (batch, heads, s, p) of `dtype` (0 float32, 1 bfloat16) at element
// strides (x_sb, x_sh, x_ss) with p contiguous; dt: (batch, heads, s)
// float32 at (dt_sb, dt_sh, dt_ss); a_neg: (heads,) float32; B, C: (batch,
// s, n) of `dtype` at (b_sb, b_ss), (c_sb, c_ss) with n contiguous; h0: null
// (zeros) or (batch, heads, p, n) float32 contiguous. Writes y (batch, s,
// heads, p) and h_last (batch, heads, p, n), float32 contiguous. Needs
// 1 <= q <= 64, 1 <= p <= 64, 1 <= n <= 128, s >= 1, batch <= 65535;
// returns cudaErrorInvalidValue for anything else.
int ssd_launch(const void* x, const void* dt, const void* a_neg,
               const void* bm, const void* cm, const void* h0, void* y,
               void* h_last, int dtype, int batch, int heads, int s, int p,
               int n, int q, int64_t x_sb, int64_t x_sh, int64_t x_ss,
               int64_t dt_sb, int64_t dt_sh, int64_t dt_ss, int64_t b_sb,
               int64_t b_ss, int64_t c_sb, int64_t c_ss, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || s < 1 || p < 1 || p > kP ||
      n < 1 || n > kN || q < 1 || q > kQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(x, dt, a_neg, bm, cm, h0, y, h_last, batch, heads,
                           s, p, n, q, x_sb, x_sh, x_ss, dt_sb, dt_sh, dt_ss,
                           b_sb, b_ss, c_sb, c_ss, st);
    case kBF16:
      return launch<__nv_bfloat16>(x, dt, a_neg, bm, cm, h0, y, h_last, batch,
                                   heads, s, p, n, q, x_sb, x_sh, x_ss, dt_sb,
                                   dt_sh, dt_ss, b_sb, b_ss, c_sb, c_ss, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
