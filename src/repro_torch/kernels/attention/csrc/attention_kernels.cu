// Flash-attention forward for Hopper (sm_90a): softmax(Q K^T / sqrt(d)) V
// with causal, sliding-window and validity masks, the tanh logit softcap,
// GQA and an online (streaming) softmax.
//
// Replaces repro/kernels/attention/kernel.py _attn_kernel /
// flash_attention_bhsd, the Pallas kernel that the JAX package's model
// attention (models/attention.py flash_attention, local_attention) follows.
// It computes what that kernel computes, in its (B, H, S, D) index order:
// - scores q . k / sqrt(d) in float32;
// - the optional softcap c * tanh(s / c) before the masks;
// - masks: causal (q >= k), window (q - k < w, w > 0), validity
//   (k < skv_valid); a masked score is -2e38;
// - online softmax with float32 m, l and acc per query row; l is clamped at
//   1e-37 before the division; the output takes the input's dtype;
// - GQA: query head h reads key/value head h / (Hq / Hkv).
// Sq and Skv are any lengths (the ragged tile is zero-filled and masked
// here, so no padding copy is needed). Every tensor comes with element
// strides for batch, head and sequence, its last dimension contiguous and
// its rows 16-byte aligned, so the model's (B, S, H, D) tensors are read
// where they lie and the output is written in the caller's layout.
//
// Two kernels, chosen by dtype in attn_fwd_launch:
//
// bfloat16: tensor cores (namespace tc). The bound is operations: at the
// gemma2 prefill (B 4, S 4608, Hq 8, Hkv 4, d 256, causal) the live (q, k)
// pairs count 4 d operations each (q . k and p . v), 348 GFLOP a layer,
// 0.352 ms at 989 TFLOP/s against 0.068 ms for its 226 MB at 3.35 TB/s.
// The design keeps P at float32 precision on the tensor cores, so it
// executes 6 d a pair (below). What it does about the four limits of the
// SIMT design it replaced:
// - No tensor cores: both products are mma.sync m16n8k16 bf16 with
//   float32 accumulators. S = Q K^T accumulates unscaled bf16 q and k and
//   is then scaled by 1/sqrt(d) in float32 (exactly the reference's
//   scale-first at d 256, where the scale is 2^-4). P is split, P_hi =
//   bf16(p) and P_lo = bf16(p - P_hi), and both go through the tensor
//   cores on the same V fragment into the same float32 accumulator, so P V
//   keeps about 16 bits of p (a bf16-P kernel misses the bands by an order
//   of magnitude); l sums the float32 p.
// - Loads did not overlap compute and shared memory held float32: Q, K
//   and V stay bf16 in shared memory, rows padded by 16 bytes so that the
//   eight rows an ldmatrix reads fall on distinct banks (d / 8 + 1 chunks a
//   row is odd). K and V tiles of 64 keys come in through cp.async.cg in a
//   two-stage ring: tile j + 1 loads while tile j multiplies. Rows past
//   the end are zero-filled by the copy's src-size operand. At d 256 a CTA
//   of kBQ = 128 query rows takes 202,752 bytes (one CTA an SM).
// - P went through shared memory: P never leaves registers; the S
//   accumulator fragment, repacked, is the A operand of P V.
// - K/V tiles were re-read per head from memory in an arbitrary order: the
//   grid runs the query heads of one (batch, q tile) next to each other,
//   heads fastest, so the heads that share a kv head read its tiles while
//   they are in L2; q tiles go longest first.
// Each warp owns 16 query rows and walks the live kv tiles (the
// reference's block-level `live` test solved for the tile range), 32 keys
// a softmax step: at d 256 the O accumulator is 128 float32 registers a
// thread and 64-key steps (32 more) make ptxas spill. Q fragments are
// re-read from shared memory (ldmatrix) at every k-step rather than held.
// The mask arithmetic runs only on keys that straddle the diagonal, the
// window's edge or skv_valid for the warp's rows. expf and tanhf stay the
// accurate library functions (no --use_fast_math); s / softcap is taken
// as s * (1 / softcap), one rounding apart, to keep a division out of the
// loop. What holds mma.sync at about 15 % of the peak is not measured
// (every warp reads all of K and V through ldmatrix, and one CTA an SM
// leaves two warps a sub-partition to hide latency); the step past it is
// wgmma, whose B operand is read once per warpgroup, fed by TMA.
//
// float32: SIMT (namespace simt), for the float32 contract of 2e-5, which
// TF32 would break. One CTA of 256 threads owns one (batch, head, 64-row q
// tile) and loops over the live 64-row kv tiles; Q (scaled), K, V and P^T
// sit in shared memory as float32, each thread computes a 4 x 4 block of
// scores with fmaf and adds P V into 4 rows x d/16 columns of its
// registers.
//
// Plain C interface (extern "C", pointers and integers only), built by
// nvcc into a shared library and loaded with ctypes by kernel.py. The entry
// point launches on the caller's stream, allocates nothing, reports which
// kernel it launched, and returns the cudaError_t of its launch
// (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr unsigned kFull = 0xffffffffu;

enum Dtype : int { kF32 = 0, kBF16 = 1 };
enum Route : int { kSimt = 0, kTensorCore = 1 };

struct Strides {  // element strides of one tensor: batch, head, sequence
  long long b, h, s;
};
struct Operands {
  Strides q, k, v, o;
};

// ------------------------------------------------------------------ simt

namespace simt {

constexpr int kThreads = 256;
constexpr int kTX = 16;            // threads along a score row
constexpr int kTY = kThreads / kTX;
constexpr int kBQ = 64;            // q rows a CTA
constexpr int kBK = 64;            // kv rows a tile
constexpr int kRows = kBQ / kTY;   // q rows a thread: 4 * ty + i
constexpr int kCols = kBK / kTX;   // score columns a thread: tx + 16 * j
static_assert(kRows == 4, "P is written and read as float4 over a thread's rows");

template <int D>
struct Layout {
  static constexpr int kQK = D + 4;      // Q and K row stride (floats)
  static constexpr int kV = D;           // V row stride
  static constexpr int kP = kBQ + 4;     // P^T row stride
  // V columns a thread: float4 groups when d allows it, else scalars
  static constexpr int kVec = D % 64 == 0 ? 4 : 1;
  static constexpr int kGroups = D / (kTX * kVec);
  static constexpr int kAcc = kGroups * kVec;
  static constexpr size_t kBytes =
      sizeof(float) * (kBQ * kQK + kBK * kQK + kBK * kV + kBK * kP);
};

__device__ __forceinline__ float4 scaled(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

// Copy rows [0, kRowsTile) of a tile whose row r starts at src + r *
// src_stride into shared memory times `scale`; rows at or past `avail` are
// zero.
template <int D, int kRowsTile>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src,
                                          long long src_stride, int avail,
                                          float scale) {
  constexpr int kPer = D / 4;
  for (int i = threadIdx.x; i < kRowsTile * kPer; i += kThreads) {
    const int r = i / kPer, c = (i % kPer) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < avail) {
      x = __ldg(reinterpret_cast<const float4*>(src + r * src_stride + c));
    }
    *reinterpret_cast<float4*>(dst + r * stride + c) = scaled(x, scale);
  }
}

// Max and sum over the 16 lanes (one half-warp) that share a score row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// grid (ceil(sq / kBQ), hq, b)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    Operands st, int hq, int hkv, int sq, int skv,
                    int skv_valid, int causal, int window, float softcap,
                    float scale) {
  using L = Layout<D>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * L::kQK;
  float* sV = sK + kBK * L::kQK;
  float* sP = sV + kBK * L::kV;  // P transposed: [kv row][q row]

  const int nq = gridDim.x;
  const int q_lo = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;

  const float* qp = q + bi * st.q.b + h * st.q.h + q_lo * st.q.s;
  const float* kp = k + bi * st.k.b + hk * st.k.h;
  const float* vp = v + bi * st.v.b + hk * st.v.h;

  // the live kv range of this q tile (the reference's `live`, solved)
  int k_end = skv_valid < skv ? skv_valid : skv;
  if (causal && q_lo + kBQ < k_end) k_end = q_lo + kBQ;
  int k_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) k_begin = q_lo - window + 1;
  const int j_begin = k_begin / kBK;
  const int j_end = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  load_tile<D, kBQ>(sQ, L::kQK, qp, st.q.s, sq - q_lo, scale);

  float m[kRows], l[kRows], acc[kRows][L::kAcc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kAcc; ++c) acc[i][c] = 0.f;
  }

  for (int j = j_begin; j < j_end; ++j) {
    const int k_lo = j * kBK;
    __syncthreads();  // the last tile's K, V and P are no longer read
    load_tile<D, kBK>(sK, L::kQK, kp + k_lo * st.k.s, st.k.s, skv - k_lo,
                      1.f);
    load_tile<D, kBK>(sV, L::kV, vp + k_lo * st.v.s, st.v.s, skv - k_lo,
                      1.f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * L::kQK + d);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        kv[c] = *reinterpret_cast<const float4*>(sK + (tx + kTX * c) * L::kQK + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float a = s[i][c];
          a = fmaf(qv[i].x, kv[c].x, a);
          a = fmaf(qv[i].y, kv[c].y, a);
          a = fmaf(qv[i].z, kv[c].z, a);
          a = fmaf(qv[i].w, kv[c].w, a);
          s[i][c] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q_lo + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int ki = k_lo + tx + kTX * c;
        float x = s[i][c];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = ki < skv_valid;
        if (causal) ok = ok && qi >= ki;
        if (window > 0) ok = ok && qi - ki < window;
        x = ok ? x : kNegInf;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[i][c] - m_new);
        s[i][c] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::kAcc; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      *reinterpret_cast<float4*>(sP + (tx + kTX * c) * L::kP + 4 * ty) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(sP + kk * L::kP + 4 * ty);
      const float* vrow = sV + kk * L::kV;
#pragma unroll
      for (int g = 0; g < L::kGroups; ++g) {
        const int col = L::kVec * tx + kTX * L::kVec * g;
        float vv[L::kVec];
        if constexpr (L::kVec == 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vrow + col);
          vv[0] = v4.x; vv[1] = v4.y; vv[2] = v4.z; vv[3] = v4.w;
        } else {
          vv[0] = vrow[col];
        }
#pragma unroll
        for (int e = 0; e < L::kVec; ++e) {
          acc[0][g * L::kVec + e] = fmaf(p.x, vv[e], acc[0][g * L::kVec + e]);
          acc[1][g * L::kVec + e] = fmaf(p.y, vv[e], acc[1][g * L::kVec + e]);
          acc[2][g * L::kVec + e] = fmaf(p.z, vv[e], acc[2][g * L::kVec + e]);
          acc[3][g * L::kVec + e] = fmaf(p.w, vv[e], acc[3][g * L::kVec + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = 4 * ty + i;
    if (q_lo + r >= sq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-37f);
    float* orow = o + bi * st.o.b + h * st.o.h + (q_lo + r) * st.o.s;
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g)
#pragma unroll
      for (int e = 0; e < L::kVec; ++e) {
        const int col = L::kVec * tx + kTX * L::kVec * g + e;
        orow[col] = acc[i][g * L::kVec + e] * inv_l;
      }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Operands& st, int b, int hq, int hkv, int sq, int skv,
           int skv_valid, int causal, int window, float softcap, float scale,
           cudaStream_t s, int* route) {
  using L = Layout<D>;
  auto kernel = attn_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  kernel<<<grid, kThreads, L::kBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, hq, hkv, sq,
      skv, skv_valid, causal, window, softcap, scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) *route = kSimt;
  return static_cast<int>(err);
}

}  // namespace simt

// ------------------------------------------------------------------ tc

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;         // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // q rows a CTA
constexpr int kBK = 64;            // kv rows a tile
constexpr int kStages = 2;         // K/V tiles in flight
constexpr int kSub = 32;           // keys a softmax step (4 registers a key)

template <int D>
struct Tile {
  static constexpr int kRow = D + 8;      // bf16 a shared row: 16 bytes pad
  static constexpr int kChunks = D / 8;   // 16-byte chunks a global row
  static constexpr uint32_t kKVBytes = kBK * kRow * sizeof(bf16);
  static constexpr size_t kBytes =
      sizeof(bf16) * kRow * (kBQ + 2 * kStages * kBK);
};
static_assert(Tile<256>::kBytes <= 232448, "inside a block's shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [0, kRowsTile) of a tile whose row r starts at src + r *
// stride into shared memory at dst (row pitch Tile<D>::kRow), 16 bytes a
// copy; rows at or past `avail` are zero-filled by the copy (src-size 0).
template <int D, int kRowsTile>
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* src,
                                          long long stride, int avail) {
  constexpr int kTotal = kRowsTile * Tile<D>::kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + kThreads - 1) / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    if (kTotal % kThreads == 0 || i < kTotal) {
      const int r = i / Tile<D>::kChunks, c = i % Tile<D>::kChunks;
      const bool ok = r < avail;
      const bf16* g = src + (ok ? r * stride : 0) + c * 8;
      const uint32_t s = dst + (r * Tile<D>::kRow + c * 8) * sizeof(bf16);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                   "l"(g), "r"(ok ? 16 : 0));
    }
  }
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

// Two probabilities (adjacent keys of one row) as bf16 pairs hi and lo
// with hi + lo = p to about 16 bits: hi = bf16(p), lo = bf16(p - hi).
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// One CTA per (head, batch, q tile), heads fastest, then batches, then q
// tiles from the last (the most live kv tiles when causal) to the first.
// Warp w owns query rows [16 w, 16 w + 16) of the tile; in the mma layouts
// lane t holds rows t / 4 and t / 4 + 8 and key (or d) columns 2 (t % 4)
// and 2 (t % 4) + 1 of each 8-wide n-tile.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    Operands st, int b, int hq, int hkv, int sq, int skv,
                    int skv_valid, int causal, int window, float softcap,
                    float scale) {
  using T = Tile<D>;
  extern __shared__ uint4 smem[];
  const uint32_t q_smem = smem_addr(smem);
  const uint32_t k_smem = q_smem + kBQ * T::kRow * sizeof(bf16);
  const uint32_t v_smem = k_smem + kStages * T::kKVBytes;

  const int nq = (sq + kBQ - 1) / kBQ;
  int idx = blockIdx.x;
  const int h = idx % hq;
  idx /= hq;
  const int bi = idx % b;
  const int q_lo = (nq - 1 - idx / b) * kBQ;
  const int hk = h / (hq / hkv);

  const bf16* qp = q + bi * st.q.b + h * st.q.h + q_lo * st.q.s;
  const bf16* kp = k + bi * st.k.b + hk * st.k.h;
  const bf16* vp = v + bi * st.v.b + hk * st.v.h;

  // the live kv range of this q tile (the reference's `live`, solved)
  int k_end = skv_valid;
  if (causal && q_lo + kBQ < k_end) k_end = q_lo + kBQ;
  const int k_begin =
      window > 0 && q_lo - window + 1 > 0 ? q_lo - window + 1 : 0;
  const int j_begin = k_begin / kBK;
  const int j_end = (k_end + kBK - 1) / kBK;

  // K and V of local tile i (kv tile j_begin + i) go to stage i % kStages
  const int n_tiles = j_end - j_begin;
  auto load_kv = [&](int i) {
    const int k_lo = (j_begin + i) * kBK;
    if (i < n_tiles) {
      copy_tile<D, kBK>(k_smem + (i % kStages) * T::kKVBytes,
                        kp + k_lo * st.k.s, st.k.s, skv - k_lo);
      copy_tile<D, kBK>(v_smem + (i % kStages) * T::kKVBytes,
                        vp + k_lo * st.v.s, st.v.s, skv - k_lo);
    }
  };
  // group 0: Q and tile 0; group 1: tile 1 (maybe empty)
  copy_tile<D, kBQ>(q_smem, qp, st.q.s, sq - q_lo);
  load_kv(0);
  cp_async_commit();
  load_kv(1);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wq_lo = q_lo + 16 * warp;  // the warp's first query row
  const int row0 = wq_lo + lane / 4;   // this lane's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);     // and its first column in an n-tile
  // ldmatrix row addresses. Q (A, x4): rows lane % 16, columns 8 (lane /
  // 16). K (B of two key n-tiles, x4): keys lane % 8 + 8 (lane / 16), d
  // 8 ((lane / 8) % 2). V (B of two d n-tiles, x4.trans): keys lane % 16,
  // d 8 (lane / 16).
  const uint32_t q_frag =
      q_smem + ((16 * warp + lane % 16) * T::kRow + 8 * (lane / 16)) * 2;
  const uint32_t k_frag =
      ((lane % 8 + 8 * (lane / 16)) * T::kRow + 8 * ((lane / 8) % 2)) * 2;
  const uint32_t v_frag = ((lane % 16) * T::kRow + 8 * (lane / 16)) * 2;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  // s / softcap as s * (1 / softcap): at most one rounding apart, and no
  // division in the loop
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 1>();  // tile i (and Q) have landed
    __syncthreads();
    // kSub keys at a time: S = Q K^T, the online softmax, O += P V
#pragma unroll 1
    for (int sub = 0; sub < kBK / kSub; ++sub) {
      const int k_lo = (j_begin + i) * kBK + sub * kSub;
      const uint32_t ks = k_smem + (i % kStages) * T::kKVBytes + k_frag +
                          sub * kSub * T::kRow * 2;
      const uint32_t vs = v_smem + (i % kStages) * T::kKVBytes + v_frag +
                          sub * kSub * T::kRow * 2;
      float s[kSub / 8][4];
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t a[4];
        ldmatrix_x4(a, q_frag + kd * 32);
#pragma unroll
        for (int np = 0; np < kSub / 16; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, ks + (np * 16 * T::kRow + kd * 16) * 2);
          mma(s[2 * np], a, bk[0], bk[1]);
          mma(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // scale, softcap, masks (only where the keys straddle an edge for
      // this warp's rows), then the online softmax of the reference
      const bool edge = k_lo + kSub > skv_valid ||
                        (causal && k_lo + kSub - 1 > wq_lo) ||
                        (window > 0 && wq_lo + 15 - k_lo >= window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x * inv_cap);
          if (edge) {
            const int qi = row0 + 8 * (e / 2);
            const int ki = k_lo + 8 * n + col0 + e % 2;
            bool ok = ki < skv_valid;
            if (causal) ok = ok && qi >= ki;
            if (window > 0) ok = ok && qi - ki < window;
            x = ok ? x : kNegInf;
          }
          s[n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the four lanes of a row: a quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        corr[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[n][e] - m[e / 2]);
          s[n][e] = p;
          l[e / 2] += p;
        }
      if (__any_sync(kFull, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e / 2];
      }

      // O += P V, 16 keys a step; P from the S fragments, split in two
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vs + (kk * 16 * T::kRow + dp * 16) * 2);
          mma(acc[2 * dp], hi, bv[0], bv[1]);
          mma(acc[2 * dp], lo, bv[0], bv[1]);
          mma(acc[2 * dp + 1], hi, bv[2], bv[3]);
          mma(acc[2 * dp + 1], lo, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    load_kv(i + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    const float inv_l = 1.f / fmaxf(sum, 1e-37f);
    const int r = row0 + 8 * i;
    if (r >= sq) continue;
    bf16* orow = o + bi * st.o.b + h * st.o.h + r * st.o.s + col0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv_l,
                                acc[n][2 * i + 1] * inv_l);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Operands& st, int b, int hq, int hkv, int sq, int skv,
           int skv_valid, int causal, int window, float softcap, float scale,
           cudaStream_t s, int* route) {
  auto kernel = attn_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile<D>::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(hq) * b * ((sq + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, Tile<D>::kBytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), st, b, hq, hkv, sq,
      skv, skv_valid, causal, window, softcap, scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) *route = kTensorCore;
  return static_cast<int>(err);
}

}  // namespace tc

// bfloat16 to the tensor cores, float32 to the SIMT kernel; the kernel
// that launched writes its route
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           const Operands& st, int b, int hq, int hkv, int sq, int skv,
           int skv_valid, int causal, int window, float softcap, float scale,
           cudaStream_t s, int* route) {
  return dtype == kBF16
             ? tc::launch<D>(q, k, v, o, st, b, hq, hkv, sq, skv, skv_valid,
                             causal, window, softcap, scale, s, route)
             : simt::launch<D>(q, k, v, o, st, b, hq, hkv, sq, skv,
                               skv_valid, causal, window, softcap, scale, s,
                               route);
}

int launch_d(int d, int dtype, const void* q, const void* k, const void* v,
             void* o, const Operands& st, int b, int hq, int hkv, int sq,
             int skv, int skv_valid, int causal, int window, float softcap,
             float scale, cudaStream_t s, int* route) {
  switch (d) {
    case 16: return launch<16>(dtype, q, k, v, o, st, b, hq, hkv, sq, skv, skv_valid, causal, window, softcap, scale, s, route);
    case 32: return launch<32>(dtype, q, k, v, o, st, b, hq, hkv, sq, skv, skv_valid, causal, window, softcap, scale, s, route);
    case 64: return launch<64>(dtype, q, k, v, o, st, b, hq, hkv, sq, skv, skv_valid, causal, window, softcap, scale, s, route);
    case 128: return launch<128>(dtype, q, k, v, o, st, b, hq, hkv, sq, skv, skv_valid, causal, window, softcap, scale, s, route);
    case 256: return launch<256>(dtype, q, k, v, o, st, b, hq, hkv, sq, skv, skv_valid, causal, window, softcap, scale, s, route);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o: (b, hq, sq, d) and k, v: (b, hkv, skv, d) by index, each laid out
// by its element strides (batch, head, sequence: strides[0..2] for q,
// [3..5] k, [6..8] v, [9..11] o), the last dimension contiguous, every row
// 16-byte aligned, all of `dtype` (0 float32, 1 bfloat16). d in {16, 32,
// 64, 128, 256}; hq a multiple of hkv; 0 <= skv_valid <= skv; window 0 =
// unbounded; softcap 0 = off. bfloat16 launches the tensor-core kernel and
// float32 the SIMT one; the launch that succeeded writes which into *route
// (0 SIMT, 1 tensor cores). Returns cudaErrorInvalidValue for anything else.
int attn_fwd_launch(const void* q, const void* k, const void* v, void* o,
                    int dtype, int b, int hq, int hkv, int sq, int skv, int d,
                    const long long* strides, int skv_valid, int causal,
                    int window, float softcap, float scale, void* stream,
                    int* route) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 ||
      skv_valid < 0 || skv_valid > skv || window < 0 || softcap < 0.f ||
      hq > 65535 || b > 65535 || strides == nullptr || route == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Operands st{{strides[0], strides[1], strides[2]},
                    {strides[3], strides[4], strides[5]},
                    {strides[6], strides[7], strides[8]},
                    {strides[9], strides[10], strides[11]}};
  if (dtype != kF32 && dtype != kBF16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_d(d, dtype, q, k, v, o, st, b, hq, hkv, sq, skv, skv_valid,
                  causal, window, softcap, scale,
                  static_cast<cudaStream_t>(stream), route);
}

}  // extern "C"
