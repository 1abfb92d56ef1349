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
// nothing and decay nothing and h_last is the reference's. The compile-time
// extents are the largest shapes taken, Q <= 64, P <= 64, N <= 128 (the
// mamba2 configuration's chunk, head_dim and ssm_state); smaller shapes are
// zero-padded in shared memory, which changes nothing above.
//
// Two routes, chosen by dtype in ssd_launch, which reports the one it took.
//
// bfloat16: tensor cores (namespace tc), the serving path's route. The
// contract is float32's (1e-4 of the plain version, relative L2 under 3e-5
// on the card), so every product is arranged to have one operand that is
// exactly bf16 (x, B or C) and the float32 operand is split in bf16 terms:
//   S     = C B^T                           bf16 x bf16, exact products
//   y     = (S . L . dt_j) x + exp(acum) . (C h_prev^T)
//   dH    = (x . w)^T B,  w_j = dt_j exp(acum[-1] - acum_j)
// with each float32 operand (S . L . dt_j, x . w and h_prev) taken as three
// bf16 terms, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid),
// all through mma.sync m16n8k16 into one float32 accumulator (as K4 splits
// its probabilities): about 24 bits of each operand. hi alone (8 bits)
// misses the band by two orders of magnitude; hi and mid (16 bits) hold it,
// but on 16 heads of one serving sequence the worst element of y then takes
// over a quarter of the elementwise 1e-4, and under a tenth with three
// (tests/test_torch_ssd.py rehearses the arithmetic on the CPU). The
// tensor cores round each mma's sum at its accumulator's scale, so the
// chunk's state update dH is summed in accumulators of its own and added to
// h once a chunk: mma straight into h rounds at h's scale eight times a
// chunk, which on the card took the worst y element of one serving
// sequence several times as far from the plain version as the same
// arithmetic in plain torch (PERF.md).
//
// A CTA of 4 warps owns one (batch, head) pair and walks its chunks in
// order; warp w owns rows [16 w, 16 w + 16) of S, the head-dim columns
// [16 w, 16 w + 16) of y, and the rows [16 w, 16 w + 16) of h, which stay in
// its registers (64 floats a thread) for the whole sequence: the
// accumulator layout of h is the B-operand layout of C h^T, so h goes into
// the tensor cores without shared memory. S . L . dt is shared through
// shared memory in float32 and split as each warp reads it. Each chunk's
// x, B, C and dt come in through a two-stage cp.async ring (chunk i + 1
// loads while chunk i multiplies), rows padded by 16 bytes so that
// ldmatrix reads distinct banks, rows past the end zero-filled by the
// copy's src-size. acum is a warp-shuffle scan. 110,080 bytes of shared
// memory a CTA: two CTAs an SM, so the 256 sequences of the mamba2 prefill
// (B 4, H 64) fill 264 CTA slots on 132 SMs in one wave. A batch of one
// fills a quarter of them (ROADMAP).
//
// Bound: bytes. x, B, C (bf16) and dt read once, y and h_last (float32)
// written once: 474 MB at the mamba2 prefill, 0.142 ms at 3.35 TB/s. The
// products on the causal triangle of each chunk count Q (Q + 1) N (C B^T)
// + Q (Q + 1) P (S x) + 2 Q P N (C h_prev^T) + 2 Q P N (the state update),
// 53.3 GFLOP, 0.054 ms at the bf16 tensor-core rate: the split's further
// passes are not counted, as K4's are not. On the card it takes several
// times the bound (PERF.md). Builds with the products, and then
// also the loads, left out kept a large share of that time in the loop's
// scans, exponentials and barriers: latency with 8 warps an SM holds it,
// more than the bytes or the tensor cores.
//
// float32: SIMT (namespace simt), the reference arithmetic of the float32
// model checks and the design that the tensor-core route replaced for
// bfloat16. One CTA of 256 threads owns one (batch, head) pair and loops
// over the chunks itself, the state h (up to 64 x 128 float32) resident in
// shared memory for the whole sequence. Per chunk it stages dt, x, B and C
// in shared memory, scans acum in one thread (64 adds), then runs three
// products as 16 x 16 thread tiles with register blocking: the masked
// scores C B^T . L (each thread a 4 x 4 block, L applied as the scores
// leave registers), y from the scores and from C h_prev^T (4 x 4 each), and
// the state update (4 x 8 of h a thread). Shared rows are padded (stride
// N + 1, Q + 1) so that the threads of a warp read distinct banks or one
// broadcast word. Shared memory is 133,120 bytes, so one CTA fits an SM:
// 256 CTAs at the mamba2 prefill, two waves on 132 SMs, and a 4 x 4 tile
// reads 8 shared-memory words for its 16 FMAs: shared-memory traffic and
// occupancy bound it, not the FMA pipes (TF32 tensor cores, ten mantissa
// bits, would not hold the float32 contract).
//
// Plain C interface (extern "C", pointers and integers only), built by
// nvcc into a shared library and loaded with ctypes by kernel.py. The entry
// point launches on the caller's stream, allocates nothing, reports which
// route it launched, and returns the cudaError_t of its launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Dtype : int { kF32 = 0, kBF16 = 1 };
enum Route : int { kSimt = 0, kTensorCore = 1 };

// Strides and extents of one call. x: (batch, heads, s, p) at element
// strides (x_sb, x_sh, x_ss, 1); dt likewise without p; B, C: (batch, s, n)
// at (sb, ss, 1); a_neg: (heads,); h0, h_last: (batch, heads, p, n)
// contiguous; y: (batch, s, heads, p) contiguous.
struct Shape {
  int batch, heads, s, p, n, q;
  int64_t x_sb, x_sh, x_ss, dt_sb, dt_sh, dt_ss, b_sb, b_ss, c_sb, c_ss;
};

// ------------------------------------------------------------------ simt

namespace simt {

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

// x: (batch, heads, s, p) at strides (x_sb, x_sh, x_ss, 1); dt likewise
// without p; B, C: (batch, s, n) at (sb, ss, 1); a_neg: (heads,); h0, h_last:
// (batch, heads, p, n) contiguous; y: (batch, s, heads, p) contiguous.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a_neg, const float* __restrict__ bm,
                 const float* __restrict__ cm, const float* __restrict__ h0,
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
  const float* xb = x + bi * x_sb + hi * x_sh;
  const float* dtb = dt + bi * dt_sb + hi * dt_sh;
  const float* bb = bm + bi * b_sb;
  const float* cb = cm + bi * c_sb;
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
      bs[t * kLdN + nn] = live ? bb[(c0 + t) * b_ss + nn] : 0.f;
      cs[t * kLdN + nn] = live ? cb[(c0 + t) * c_ss + nn] : 0.f;
    }
    for (int i = tid; i < kQ * kP; i += kThreads) {
      const int t = i / kP, pp = i % kP;
      xs[i] = (t < len && pp < p) ? xb[(c0 + t) * x_ss + pp] : 0.f;
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

int launch(const void* x, const void* dt, const void* a_neg, const void* bm,
           const void* cm, const void* h0, void* y, void* h_last,
           const Shape& sh, cudaStream_t stream, int* route) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sh.heads, sh.batch);
  ssd_chunk_kernel<<<grid, kThreads, kBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_neg), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_last), sh.heads, sh.s,
      sh.p, sh.n, sh.q, sh.x_sb, sh.x_sh, sh.x_ss, sh.dt_sb, sh.dt_sh,
      sh.dt_ss, sh.b_sb, sh.b_ss, sh.c_sb, sh.c_ss);
  err = cudaGetLastError();
  if (err == cudaSuccess) *route = kSimt;
  return static_cast<int>(err);
}

}  // namespace simt

// ------------------------------------------------------------------ tc

namespace tc {

using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;          // warp w: rows / columns [16 w, 16 w + 16)
constexpr int kThreads = 32 * kWarps;
constexpr int kQ = 64;             // chunk rows (compile-time extent)
constexpr int kP = 64;             // head dim
constexpr int kN = 128;            // state dim
constexpr int kStages = 2;         // chunks in flight
constexpr int kLdX = kP + 8;       // bf16 a shared row of x: 16 bytes pad
constexpr int kLdB = kN + 8;       // of B and C
constexpr int kLdS = kQ + 8;       // float32 a shared row of S . L . dt
static_assert(16 * kWarps == kQ && 16 * kWarps == kP, "a warp a 16-row slab");

// Shared memory of the chunk kernel, in bytes: kStages stages of x, B, C
// and dt; S . L . dt (float32); each warp's acum, exp(acum) and w.
struct Smem {
  static constexpr int kX = kQ * kLdX * 2;
  static constexpr int kB = kQ * kLdB * 2;
  static constexpr int kOffB = kX;
  static constexpr int kOffC = kOffB + kB;
  static constexpr int kOffDt = kOffC + kB;
  static constexpr int kStage = kOffDt + kQ * 4;
  static constexpr int kS = kQ * kLdS * 4;
  static constexpr int kOffS = kStages * kStage;
  static constexpr int kOffRows = kOffS + kS;
  static constexpr int kBytes = kOffRows + kWarps * 3 * kQ * 4;
};
static_assert(Smem::kBytes <= 232448 / 2 - 1024, "two CTAs an SM");

// One launch's arguments; h0 null for zeros.
struct Args {
  const bf16* x;
  const float* dt;
  const float* a_neg;
  const bf16* bm;
  const bf16* cm;
  const float* h0;
  float* y;
  float* h_last;
  Shape sh;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) b (16 x 8, col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Two float32 values as three bf16 pairs with hi + mid + lo = the values
// to about 24 bits: hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
// mid).
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Rows [0, kQ) of a (rows, kCols) bf16 tile whose row r starts at src + r *
// stride into shared memory (pitch kCols + 8), 16-byte cp.async copies
// (tc::launch checked that width, the stride and the pointer allow them);
// rows at or past `avail` and columns at or past `width` are zero-filled by
// the copy's src-size.
template <int kCols>
__device__ __forceinline__ void load_rows(unsigned char* dst, const bf16* src,
                                          int64_t stride, int avail,
                                          int width) {
  constexpr int kLd = kCols + 8;
  constexpr int kChunks = kCols / 8;
  const uint32_t d = smem_addr(dst);
#pragma unroll
  for (int it = 0; it < kQ * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < avail && 8 * c < width;
    const bf16* g = ok ? src + r * stride + 8 * c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     d + (r * kLd + 8 * c) * 2),
                 "l"(g), "r"(ok ? 16 : 0));
  }
}

// One CTA a (batch, head), heads fastest (the heads of one batch read the
// same B and C while they are in L2): y chunk by chunk from h0 (or zeros),
// then h_last. In the mma layouts lane t holds rows t / 4 and t / 4 + 8 and
// columns 2 (t % 4) and 2 (t % 4) + 1 of each 8-wide n-tile.
__global__ void __launch_bounds__(kThreads, 2) chunk_kernel(const Args a) {
  using L = Smem;
  const Shape& sh = a.sh;
  extern __shared__ uint4 smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  const int head = blockIdx.x % sh.heads;
  const int bi = blockIdx.x / sh.heads;
  const int64_t bh = static_cast<int64_t>(bi) * sh.heads + head;
  const float an = a.a_neg[head];
  const int nc = (sh.s + sh.q - 1) / sh.q;

  const bf16* xb = a.x + bi * sh.x_sb + head * sh.x_sh;
  const float* dtb = a.dt + bi * sh.dt_sb + head * sh.dt_sh;
  const bf16* bb = a.bm + bi * sh.b_sb;
  const bf16* cb = a.cm + bi * sh.c_sb;

  // chunk i into stage i % kStages
  auto load = [&](int i) {
    if (i >= nc) return;
    const int c0 = i * sh.q;
    const int avail = min(sh.q, sh.s - c0);
    unsigned char* st = smem + (i % kStages) * L::kStage;
    load_rows<kP>(st, xb + c0 * sh.x_ss, sh.x_ss, avail, sh.p);
    load_rows<kN>(st + L::kOffB, bb + c0 * sh.b_ss, sh.b_ss, avail, sh.n);
    load_rows<kN>(st + L::kOffC, cb + c0 * sh.c_ss, sh.c_ss, avail, sh.n);
    const uint32_t d = smem_addr(st + L::kOffDt);
    for (int t = threadIdx.x; t < kQ; t += kThreads) {
      const bool ok = t < avail;
      const float* src = ok ? dtb + (c0 + t) * sh.dt_ss : dtb;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       d + 4 * t),
                   "l"(src), "r"(ok ? 4 : 0));
    }
  };

  // this lane's rows of h: p = 16 warp + g (e 0, 1) and + 8 (e 2, 3);
  // state columns 8 nt + 2 t4 (+ 1)
  const int prow = 16 * warp + g;
  const int64_t tile = static_cast<int64_t>(sh.p) * sh.n;
  float h[kN / 8][4];
  const float* hin = a.h0 != nullptr ? a.h0 + bh * tile : nullptr;
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = prow + 8 * (e / 2), nn = 8 * nt + 2 * t4 + e % 2;
      h[nt][e] = hin != nullptr && pp < sh.p && nn < sh.n ? hin[pp * sh.n + nn]
                                                          : 0.f;
    }

  float* rows = reinterpret_cast<float*>(smem + L::kOffRows) + warp * 3 * kQ;
  float* acum = rows;        // acum_i
  float* eacum = rows + kQ;  // exp(acum_i)
  float* wj = rows + 2 * kQ; // dt_j exp(acum[-1] - acum_j)

  load(0);
  cp_async_commit();
  for (int i = 0; i < nc; ++i) {
    cp_async_wait_all();  // chunk i has landed (this thread's copies)
    __syncthreads();      // everyone's, and everyone is done with i - 1
    load(i + 1);          // into the stage that chunk i - 1 held
    cp_async_commit();
    const int c0 = i * sh.q;
    const int avail = min(sh.q, sh.s - c0);
    unsigned char* st = smem + (i % kStages) * L::kStage;
    const uint32_t sx = smem_addr(st);
    const uint32_t sb = sx + L::kOffB;
    const float* dts = reinterpret_cast<const float*>(st + L::kOffDt);

    // acum = cumsum(dt * a_neg), each warp its own copy: lane t holds rows
    // 2 t and 2 t + 1
    const float a0 = __fmul_rn(dts[2 * lane], an);
    const float a1 = __fmul_rn(dts[2 * lane + 1], an);
    float incl = __fadd_rn(a0, a1);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, v);
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
    const float ac0 = __fadd_rn(excl, a0);
    const float ac1 = __fadd_rn(ac0, a1);
    const float last = __shfl_sync(kFull, ac1, 31);
    acum[2 * lane] = ac0;
    acum[2 * lane + 1] = ac1;
    wj[2 * lane] = dts[2 * lane] * expf(last - ac0);
    wj[2 * lane + 1] = dts[2 * lane + 1] * expf(last - ac1);
    eacum[2 * lane] = expf(ac0);
    eacum[2 * lane + 1] = expf(ac1);
    __syncwarp();

    {
      const uint32_t sc = sx + L::kOffC;
      float* sl = reinterpret_cast<float*>(smem + L::kOffS);
      // ---- S = C B^T on and below the diagonal, rows [16 warp, + 16):
      //      n-tiles of 8 columns up to the diagonal block
      {
        float acc[kQ / 8][4];
#pragma unroll
        for (int nt = 0; nt < kQ / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(af, sc + ((16 * warp + lane % 16) * kLdB + 16 * kk +
                                8 * (lane / 16)) * 2);
#pragma unroll
          for (int np = 0; np < kQ / 16; ++np) {
            if (np <= warp) {
              uint32_t bk[4];
              ldmatrix_x4(bk, sb + ((16 * np + lane % 8 + 8 * (lane / 16)) *
                                        kLdB + 16 * kk + 8 * ((lane / 8) % 2)) *
                                       2);
              mma(acc[2 * np], af, bk[0], bk[1]);
              mma(acc[2 * np + 1], af, bk[2], bk[3]);
            }
          }
        }
        // S . L . dt_j (zero above the diagonal) to shared memory; rows 72
        // floats apart, so a half-warp's float2 stores and loads hit 32
        // distinct banks
#pragma unroll
        for (int nt = 0; nt < kQ / 8; ++nt) {
          if (nt < 2 * (warp + 1)) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = 16 * warp + g + 8 * r;
              const int j = 8 * nt + 2 * t4;
              const float v0 =
                  row >= j ? acc[nt][2 * r] * expf(acum[row] - acum[j]) * dts[j]
                           : 0.f;
              const float v1 = row >= j + 1 ? acc[nt][2 * r + 1] *
                                                  expf(acum[row] - acum[j + 1]) *
                                                  dts[j + 1]
                                            : 0.f;
              *reinterpret_cast<float2*>(sl + row * kLdS + j) =
                  make_float2(v0, v1);
            }
          }
        }
      }
      __syncthreads();

      // ---- y, all rows, head-dim columns [16 warp, + 16): 4 m-tiles x 2
      //      n-tiles
      float yacc[kQ / 16][2][4];
#pragma unroll
      for (int mt = 0; mt < kQ / 16; ++mt)
#pragma unroll
        for (int pn = 0; pn < 2; ++pn)
#pragma unroll
          for (int e = 0; e < 4; ++e) yacc[mt][pn][e] = 0.f;
      // C h_prev^T: h_prev^T's B fragments are this lane's h registers,
      // split in three
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t bh[3][2][2];  // [term][n-tile][b0, b1]
#pragma unroll
        for (int pn = 0; pn < 2; ++pn)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            split3(h[2 * kk + half][2 * pn], h[2 * kk + half][2 * pn + 1],
                   bh[0][pn][half], bh[1][pn][half], bh[2][pn][half]);
#pragma unroll
        for (int mt = 0; mt < kQ / 16; ++mt) {
          uint32_t af[4];
          ldmatrix_x4(af, sc + ((16 * mt + lane % 16) * kLdB + 16 * kk +
                                8 * (lane / 16)) * 2);
#pragma unroll
          for (int pn = 0; pn < 2; ++pn)
#pragma unroll
            for (int t = 0; t < 3; ++t)
              mma(yacc[mt][pn], af, bh[t][pn][0], bh[t][pn][1]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < kQ / 16; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ea = eacum[16 * mt + g + 8 * (e / 2)];
          yacc[mt][0][e] *= ea;
          yacc[mt][1][e] *= ea;
        }
      // + (S . L . dt) x over the causal blocks: the A fragment read as
      // float32 (rows g, g + 8, columns 2 t4 (+ 1), + 8 of the block) and
      // split in three
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sx + ((16 * kk + lane % 16) * kLdX +
                                    16 * warp + 8 * (lane / 16)) * 2);
#pragma unroll
        for (int mt = 0; mt < kQ / 16; ++mt) {
          if (mt >= kk) {
            const float* blk = sl + (16 * mt + g) * kLdS + 16 * kk + 2 * t4;
            uint32_t as[3][4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float2 v = *reinterpret_cast<const float2*>(
                  blk + 8 * (r % 2) * kLdS + 8 * (r / 2));
              split3(v.x, v.y, as[0][r], as[1][r], as[2][r]);
            }
#pragma unroll
            for (int t = 0; t < 3; ++t) {
              mma(yacc[mt][0], as[t], bv[0], bv[1]);
              mma(yacc[mt][1], as[t], bv[2], bv[3]);
            }
          }
        }
      }
      // y rows of the sequence, (batch, s, heads, p)
      const int64_t y_ss = static_cast<int64_t>(sh.heads) * sh.p;
      float* yb = a.y + (static_cast<int64_t>(bi) * sh.s + c0) * y_ss +
                  static_cast<int64_t>(head) * sh.p;
      const bool pairs = sh.p % 2 == 0;
#pragma unroll
      for (int mt = 0; mt < kQ / 16; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * mt + g + 8 * r;
          if (row >= avail) continue;
#pragma unroll
          for (int pn = 0; pn < 2; ++pn) {
            const int col = 16 * warp + 8 * pn + 2 * t4;
            float* dst = yb + row * y_ss + col;
            const float v0 = yacc[mt][pn][2 * r], v1 = yacc[mt][pn][2 * r + 1];
            if (pairs && col < sh.p) {
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            } else {
              if (col < sh.p) dst[0] = v0;
              if (col + 1 < sh.p) dst[1] = v1;
            }
          }
        }
    }

    // ---- h = h exp(acum[-1]) + dH, dH = (x . w)^T B: rows [16 warp, + 16)
    //      of h; A = (x . w)^T from x by a transposing ldmatrix, split in
    //      three. dH is summed in accumulators of its own and added to h
    //      once: the tensor cores round each mma's sum at its accumulator's
    //      scale, so mma straight into h would round at h's scale eight
    //      times a chunk. Two halves of the state columns, 32 accumulators
    //      each.
    const float dec = expf(last);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float dh[kN / 32][2][4];
#pragma unroll
      for (int np = 0; np < kN / 32; ++np)
#pragma unroll
        for (int e = 0; e < 4; ++e) dh[np][0][e] = dh[np][1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        uint32_t xa[4];
        ldmatrix_x4_trans(xa, sx + ((16 * kk + 8 * (lane / 16) + lane % 8) *
                                        kLdX + 16 * warp + 8 * ((lane / 8) % 2)) *
                                       2);
        // xa[0], xa[1]: rows j = 16 kk + 2 t4 (+ 1); xa[2], xa[3]: j + 8
        const int j = 16 * kk + 2 * t4;
        const float w[4] = {wj[j], wj[j + 1], wj[j + 8], wj[j + 9]};
        uint32_t as[3][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = unpack(xa[r]);
          split3(v.x * w[2 * (r / 2)], v.y * w[2 * (r / 2) + 1], as[0][r],
                 as[1][r], as[2][r]);
        }
#pragma unroll
        for (int np = 0; np < kN / 32; ++np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, sb + ((16 * kk + lane % 16) * kLdB +
                                      16 * (np + kN / 32 * half) +
                                      8 * (lane / 16)) * 2);
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            mma(dh[np][0], as[t], bv[0], bv[1]);
            mma(dh[np][1], as[t], bv[2], bv[3]);
          }
        }
      }
#pragma unroll
      for (int np = 0; np < kN / 32; ++np) {
        const int nt = 2 * (np + kN / 32 * half);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[nt][e] = h[nt][e] * dec + dh[np][0][e];
          h[nt + 1][e] = h[nt + 1][e] * dec + dh[np][1][e];
        }
      }
    }
  }

  float* out = a.h_last + bh * tile;
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = prow + 8 * (e / 2), nn = 8 * nt + 2 * t4 + e % 2;
      if (pp < sh.p && nn < sh.n) out[pp * sh.n + nn] = h[nt][e];
    }
}

int launch(const void* x, const void* dt, const void* a_neg, const void* bm,
           const void* cm, const void* h0, void* y, void* h_last,
           const Shape& sh, cudaStream_t stream, int* route) {
  // 16-byte copies of x, B and C rows
  const auto aligned = [](const void* ptr, int64_t a, int64_t b, int64_t c) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && a % 8 == 0 &&
           b % 8 == 0 && c % 8 == 0;
  };
  if (static_cast<int64_t>(sh.batch) * sh.heads > 0x7fffffffLL ||
      sh.p % 8 != 0 || sh.n % 8 != 0 ||
      !aligned(x, sh.x_sb, sh.x_sh, sh.x_ss) ||
      !aligned(bm, sh.b_sb, sh.b_ss, 0) || !aligned(cm, sh.c_sb, sh.c_ss, 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const bf16*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(a_neg), static_cast<const bf16*>(bm),
               static_cast<const bf16*>(cm), static_cast<const float*>(h0),
               static_cast<float*>(y), static_cast<float*>(h_last), sh};
  cudaError_t err = cudaFuncSetAttribute(
      chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_kernel<<<sh.batch * sh.heads, kThreads, Smem::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) *route = kTensorCore;
  return static_cast<int>(err);
}

}  // namespace tc

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
// heads, p) and h_last (batch, heads, p, n), float32 contiguous. bfloat16
// launches the tensor-core route, float32 the SIMT kernel. The launch
// that succeeded writes its route into *route (0 SIMT, 1 tensor cores).
// Needs 1 <= q <= 64, 1 <= p <= 64, 1 <= n <= 128, s >= 1, batch <= 65535,
// and for bfloat16 p and n multiples of 8, the strides of x, B and C
// multiples of 8 and their pointers 16-byte aligned; returns
// cudaErrorInvalidValue for anything else.
int ssd_launch(const void* x, const void* dt, const void* a_neg,
               const void* bm, const void* cm, const void* h0, void* y,
               void* h_last, int dtype, int batch, int heads, int s, int p,
               int n, int q, int64_t x_sb, int64_t x_sh, int64_t x_ss,
               int64_t dt_sb, int64_t dt_sh, int64_t dt_ss, int64_t b_sb,
               int64_t b_ss, int64_t c_sb, int64_t c_ss, void* stream,
               int* route) {
  if (batch < 1 || batch > 65535 || heads < 1 || s < 1 || p < 1 ||
      p > simt::kP || n < 1 || n > simt::kN || q < 1 || q > simt::kQ ||
      route == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape sh{batch, heads, s, p, n, q, x_sb, x_sh, x_ss, dt_sb, dt_sh,
                 dt_ss, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return simt::launch(x, dt, a_neg, bm, cm, h0, y, h_last, sh, st, route);
    case kBF16:
      return tc::launch(x, dt, a_neg, bm, cm, h0, y, h_last, sh, st, route);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
