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
//   (k < skv_valid); a masked score is -2e38. q is the query row's global
//   index, q_offset + its row (a chunked prefill's chunk starts at
//   q_offset; the reference's flash_attention(..., q_offset=)); every
//   live-range bound and mask below reads it so;
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

// grid (ceil(sq / kBQ), hq, b); kLse: write each row's log-sum-exp
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    Operands st, int hq, int hkv, int sq, int skv,
                    int skv_valid, int causal, int window, int q_offset,
                    float softcap, float scale, float* __restrict__ lse) {
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

  // the live kv range of this q tile (the reference's `live`, solved),
  // from the tile's first global query row
  const int qg_lo = q_offset + q_lo;
  int k_end = skv_valid < skv ? skv_valid : skv;
  if (causal && qg_lo + kBQ < k_end) k_end = qg_lo + kBQ;
  int k_begin = 0;
  if (window > 0 && qg_lo - window + 1 > 0) k_begin = qg_lo - window + 1;
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
      const int qi = qg_lo + 4 * ty + i;  // global
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
    if constexpr (kLse) {
      if (tx == 0) {
        lse[(static_cast<long long>(bi) * hq + h) * sq + q_lo + r] =
            m[i] + logf(fmaxf(l[i], 1e-37f));
      }
    }
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

template <int D, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Operands& st, int b, int hq, int hkv, int sq, int skv,
           int skv_valid, int causal, int window, int q_offset,
           float softcap, float scale, cudaStream_t s, int* route) {
  using L = Layout<D>;
  auto kernel = attn_fwd_kernel<D, kLse>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  kernel<<<grid, kThreads, L::kBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, hq, hkv, sq,
      skv, skv_valid, causal, window, q_offset, softcap, scale, lse);
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
// and 2 (t % 4) + 1 of each 8-wide n-tile. kLse: write each row's
// log-sum-exp (a separate instance, so serving's keeps its registers).
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    Operands st, int b, int hq, int hkv, int sq, int skv,
                    int skv_valid, int causal, int window, int q_offset,
                    float softcap, float scale, float* __restrict__ lse) {
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

  // the live kv range of this q tile (the reference's `live`, solved),
  // from the tile's first global query row
  const int qg_lo = q_offset + q_lo;
  int k_end = skv_valid;
  if (causal && qg_lo + kBQ < k_end) k_end = qg_lo + kBQ;
  const int k_begin =
      window > 0 && qg_lo - window + 1 > 0 ? qg_lo - window + 1 : 0;
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
  // the warp's first query row and this lane's rows (row_g, row_g + 8),
  // global indices (the masks read them; the output rows are row_g -
  // q_offset: at d 256 one more register a thread through the loop spills)
  const int wq_g = q_offset + q_lo + 16 * warp;
  const int row_g = wq_g + lane / 4;
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
                        (causal && k_lo + kSub - 1 > wq_g) ||
                        (window > 0 && wq_g + 15 - k_lo >= window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x * inv_cap);
          if (edge) {
            const int qi = row_g + 8 * (e / 2);
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
    const int r = row_g - q_offset + 8 * i;
    if (r >= sq) continue;
    if constexpr (kLse) {
      if (lane % 4 == 0) {
        lse[(static_cast<long long>(bi) * hq + h) * sq + r] =
            m[i] + logf(fmaxf(sum, 1e-37f));
      }
    }
    bf16* orow = o + bi * st.o.b + h * st.o.h + r * st.o.s + col0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv_l,
                                acc[n][2 * i + 1] * inv_l);
    }
  }
}

template <int D, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Operands& st, int b, int hq, int hkv, int sq, int skv,
           int skv_valid, int causal, int window, int q_offset,
           float softcap, float scale, cudaStream_t s, int* route) {
  auto kernel = attn_fwd_kernel<D, kLse>;
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
      skv, skv_valid, causal, window, q_offset, softcap, scale, lse);
  err = cudaGetLastError();
  if (err == cudaSuccess) *route = kTensorCore;
  return static_cast<int>(err);
}

}  // namespace tc

// bfloat16 to the tensor cores, float32 to the SIMT kernel, each in the
// instance that writes lse only when it is asked for; the kernel that
// launched writes its route
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           float* lse, const Operands& st, int b, int hq, int hkv, int sq,
           int skv, int skv_valid, int causal, int window, int q_offset,
           float softcap, float scale, cudaStream_t s, int* route) {
  auto run = dtype == kBF16
                 ? (lse ? tc::launch<D, true> : tc::launch<D, false>)
                 : (lse ? simt::launch<D, true> : simt::launch<D, false>);
  return run(q, k, v, o, lse, st, b, hq, hkv, sq, skv, skv_valid, causal,
             window, q_offset, softcap, scale, s, route);
}

int launch_d(int d, int dtype, const void* q, const void* k, const void* v,
             void* o, float* lse, const Operands& st, int b, int hq, int hkv,
             int sq, int skv, int skv_valid, int causal, int window,
             int q_offset, float softcap, float scale, cudaStream_t s,
             int* route) {
  switch (d) {
    case 16: return launch<16>(dtype, q, k, v, o, lse, st, b, hq, hkv, sq, skv, skv_valid, causal, window, q_offset, softcap, scale, s, route);
    case 32: return launch<32>(dtype, q, k, v, o, lse, st, b, hq, hkv, sq, skv, skv_valid, causal, window, q_offset, softcap, scale, s, route);
    case 64: return launch<64>(dtype, q, k, v, o, lse, st, b, hq, hkv, sq, skv, skv_valid, causal, window, q_offset, softcap, scale, s, route);
    case 128: return launch<128>(dtype, q, k, v, o, lse, st, b, hq, hkv, sq, skv, skv_valid, causal, window, q_offset, softcap, scale, s, route);
    case 256: return launch<256>(dtype, q, k, v, o, lse, st, b, hq, hkv, sq, skv, skv_valid, causal, window, q_offset, softcap, scale, s, route);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------------------ bwd
//
// K4b, the backward of the forward above: dQ, dK and dV from q, k, v, the
// forward's output O and log-sum-exp, and dO. It is the counterpart of the
// reference's hand-written VJP, repro/models/attention.py _flash_core_bwd
// (not a Pallas kernel: the JAX package has no backward kernel), and
// computes what that function computes:
// - P = exp(s - lse) from the recomputed scores s = softcap(u), u = q k /
//   sqrt(d), masked as in the forward (a masked P is 0);
// - delta = rowsum(dO * O) (a pre-pass), dP = dO V^T, dS = P (dP - delta)
//   times 1 - tanh(u / c)^2 with a softcap c, masked to 0;
// - dV = P^T dO, dK = dS^T (q / sqrt(d)), dQ = dS K / sqrt(d); the key and
//   value gradients of a GQA group sum over its query heads.
// Three launches a call: the delta pre-pass, then a dK/dV kernel (one CTA a
// kv tile, looping over the query heads of its group and the query tiles
// that see it) and a dQ kernel (one CTA a q tile, looping over the live kv
// tiles). Each output tile has one owner and every sum one order: no
// atomics, so two calls give the same bits. Outputs are rounded once to
// the input's dtype. Two routes, chosen by dtype in attn_bwd_launch:
//
// bfloat16: tensor cores (namespace bwd::tc). The bound is operations: 10
// d a live (q, k) pair (q k recomputed, dP, dV, dK, dQ), at gemma2's
// training shape (B 4, Hq 8, Hkv 4, S 2048, d 256, causal) 171.9 GFLOP,
// 0.174 ms at 989 TFLOP/s. The route executes 20 d a pair: S and dP are
// computed in both kernels (2 d each, twice), and dV, dK and dQ take P or
// dS split in two bf16 terms (4 d each). What it does about the limits of
// the SIMT design that bf16 ran before:
// - All five products are mma.sync m16n8k16 bf16 with float32
//   accumulators. Q, K, V and dO are exact bf16 operands; S = Q K^T and
//   dP = dO V^T take them unsplit, and 1/sqrt(d) scales the float32
//   accumulators (it is no power of two at d 32 or 128). P and dS are
//   float32 and go in as hi = bf16(x) and lo = bf16(x - hi), both on the
//   same B fragment into the same accumulator, so the three gradient
//   products keep about 16 bits of them (bf16 P and dS miss the bfloat16
//   band by an order of magnitude; kernels/attention/ref.py
//   attention_bwd_rounded_ref states this arithmetic in plain torch).
// - Operands stayed float32 in shared memory: they stay bf16, rows padded
//   by 16 bytes so that the eight rows an ldmatrix reads fall on distinct
//   banks, as in the forward.
// - No copy overlapped compute: the streamed side comes in through
//   cp.async.cg in a two-stage ring (tile i + 1 loads while tile i
//   multiplies), rows past the end zero-filled by the copy.
// - dkdv_kernel: a CTA of 8 warps owns kBK keys (K and V resident) and
//   streams kBQ = 64-row tiles of Q and dO with their lse and delta rows.
//   The warps form kKG groups of 16 keys, and each group's dK and dV are
//   split along d over kDS warps: from d 32 up, 2 groups of 4 warps (32
//   keys a CTA, a quarter of d a warp: 64 columns of each, 128 registers
//   of accumulators at d 256). For S^T = K Q^T and dP^T = V dO^T a warp
//   takes its 16 keys and its share of the tile's query rows; P^T and
//   dS^T, split, go through shared memory (four bf16 terms of kBK x 72)
//   so that every warp reads all 64 query rows of its keys as the A
//   operand of dV += P^T dO and dK += dS^T Q (dO and Q by ldmatrix
//   .trans). dK and dV are summed in two levels: each tile's products
//   from zero on the tensor cores (8 mma deep), the tiles' sums added in
//   float32 registers. One accumulator over the whole loop (up to 2,560
//   mma deep at recurrentgemma's shape: 10 heads x 2,048 queries) read
//   2.5e-4-5.1e-4 from the plain version on an H100 against about 1e-4
//   for the split alone: the tensor cores' float32 accumulation loses
//   bits as the chain grows. 188,416 bytes of shared memory at d 256.
// - dq_kernel: a CTA of 8 warps owns kQT = 128 query rows (Q and dO
//   resident), 16 a warp, and streams kKT = 32-key tiles of K and V, 16
//   keys a step at d 256 (32 spill). S and dP stay in registers and dS,
//   split, is repacked from the accumulator fragments into the A operand
//   of dQ += dS K (K by ldmatrix .trans), as the forward's P V. dQ's 128
//   accumulator registers a thread at d 256 leave no room for a second
//   level: it accumulates on the tensor cores over all live keys (256 mma
//   deep at 2,048 keys; 1.2e-4-1.3e-4 read on an H100 at chip_smoke.py's
//   K4B_CASES shapes).
//   202,752 bytes at d 256.
// - The masks run only on tiles that straddle an edge for a warp's rows
//   and keys; expf and tanhf stay the accurate library functions (no
//   --use_fast_math), s / softcap taken as s * (1 / softcap) as in the
//   forward. A query row with no live key gets P = 0 here and in the
//   SIMT kernels, where the reference's exp(-2e38 - lse) reads 1; the
//   wrapper refuses a call that would have one (kernel.py
//   check_live_rows), so no launch sees it.
// - A chunk's query rows are global rows q_offset + r (the reference's
//   _flash_core_bwd takes q_offset too): the masks read them so, a dQ
//   tile's live kv range is the forward's, and a dK/dV tile's query range
//   shifts the other way, local rows from max(0, k_lo - q_offset) (causal)
//   to the last key's window end less q_offset, empty when that is <= 0.
// What still holds it back: the two kernels recompute S and dP (4 d of
// the 20 d executed); every warp reads its operands through ldmatrix from
// shared memory, one CTA an SM, and mma.sync issues 16 x 8 x 16 at a
// time. Fusing dQ into the dK/dV pass, wgmma and TMA are later work.
//
// float32: SIMT (namespace bwd), for the float32 contract of 1e-5, which
// TF32 would break: tiles in shared memory as float32, products with fmaf.
// Tiles are square, kT rows (64, or 32 at d 256 to keep the accumulators
// in registers); 256 threads a CTA; one CTA an SM (up to 169 KB of shared
// memory).

namespace bwd {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// four consecutive elements (8- or 16-byte aligned) as float4, and back
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<uint32_t*>(&lo) = u.x;
  *reinterpret_cast<uint32_t*>(&hi) = u.y;
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

struct Operands {
  Strides q, k, v, o, dout, dq, dk, dv;
};

template <int D>
struct Cfg {
  static constexpr int kT = D >= 256 ? 32 : 64;  // rows of a q or kv tile
  static constexpr int kRow = D + 4;             // float stride of a tile row
  static constexpr int kPRow = kT + 1;           // stride of a P or dS row
  // scores: 16 x 16 threads, rows ty + 16 i, columns tx + 16 j
  static constexpr int kS = kT / 16;
  // accumulators: kCT threads across 4-column chunks, kRT across rows;
  // rows ar + kRT i, columns 4 (ac + kCT j)
  static constexpr int kCT = D / 4 < 16 ? D / 4 : 16;
  static constexpr int kRT = kThreads / kCT;
  static constexpr int kAR = kT / kRT;
  static constexpr int kAC = D / (4 * kCT);
  static_assert(kAR >= 1 && kAR * kRT == kT && kAC * kCT * 4 == D,
                "the accumulator tiling covers the tile");
  static constexpr size_t kBytes =
      sizeof(float) * (4 * kT * kRow + 2 * kT * kPRow + 2 * kT);
};
static_assert(Cfg<128>::kBytes <= 232448 && Cfg<256>::kBytes <= 232448,
              "inside a block's shared memory");

// Rows [0, kT) of a tile whose row r starts at src + r * stride into shared
// memory (row pitch Cfg<D>::kRow) times `scale`; rows at or past `avail`
// are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int avail,
                                          float scale) {
  using C = Cfg<D>;
  constexpr int kPer = D / 4;
  for (int i = threadIdx.x; i < C::kT * kPer; i += kThreads) {
    const int r = i / kPer, c = (i % kPer) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < avail) x = load4(src + r * stride + c);
    store4(dst + r * C::kRow + c,
           make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale));
  }
}

// lse and delta of rows [q_lo, q_lo + kT) of one (batch, head); 0 past sq
template <int D>
__device__ __forceinline__ void load_rows(float* slse, float* sdelta,
                                          const float* lse,
                                          const float* delta, int q_lo,
                                          int sq) {
  for (int r = threadIdx.x; r < Cfg<D>::kT; r += kThreads) {
    const bool ok = q_lo + r < sq;
    slse[r] = ok ? lse[q_lo + r] : 0.f;
    sdelta[r] = ok ? delta[q_lo + r] : 0.f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// P (if kWriteP) and dS of one (q tile, kv tile) into shared memory, rows
// the tile's queries and columns its keys. sQ holds q / sqrt(d), so the
// scores are the forward SIMT kernel's (the same fmaf chain).
template <int D, bool kWriteP>
__device__ __forceinline__ void scores(const float* sQ, const float* sdO,
                                       const float* sK, const float* sV,
                                       const float* slse, const float* sdelta,
                                       float* sP, float* sdS, int q_lo,
                                       int k_lo, int sq, int skv, int causal,
                                       int window, int q_offset,
                                       float softcap) {
  using C = Cfg<D>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[C::kS][C::kS], dp[C::kS][C::kS];
#pragma unroll
  for (int i = 0; i < C::kS; ++i)
#pragma unroll
    for (int j = 0; j < C::kS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qv[C::kS], ov[C::kS], kv[C::kS], vv[C::kS];
#pragma unroll
    for (int i = 0; i < C::kS; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * C::kRow + d);
      ov[i] = *reinterpret_cast<const float4*>(sdO + (ty + 16 * i) * C::kRow + d);
      kv[i] = *reinterpret_cast<const float4*>(sK + (tx + 16 * i) * C::kRow + d);
      vv[i] = *reinterpret_cast<const float4*>(sV + (tx + 16 * i) * C::kRow + d);
    }
#pragma unroll
    for (int i = 0; i < C::kS; ++i)
#pragma unroll
      for (int j = 0; j < C::kS; ++j) {
        s[i][j] = dot4(qv[i], kv[j], s[i][j]);
        dp[i][j] = dot4(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < C::kS; ++i) {
    const int r = ty + 16 * i, qi = q_lo + r;
#pragma unroll
    for (int j = 0; j < C::kS; ++j) {
      const int c = tx + 16 * j, ki = k_lo + c;
      float x = s[i][j], cd = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(x / softcap);
        x = softcap * t;
        cd = 1.f - t * t;
      }
      const int qg = q_offset + qi;  // global
      bool ok = qi < sq && ki < skv;
      if (causal) ok = ok && qg >= ki;
      if (window > 0) ok = ok && qg - ki < window;
      const float p = ok ? expf(x - slse[r]) : 0.f;
      const float ds = ok ? p * (dp[i][j] - sdelta[r]) * cd : 0.f;
      if (kWriteP) sP[r * C::kPRow + c] = p;
      sdS[r * C::kPRow + c] = ds;
    }
  }
}

// delta = rowsum(dO * O), one warp a row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, Operands st, int hq, int sq,
                 long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int qi = static_cast<int>(row % sq);
  const int h = static_cast<int>((row / sq) % hq);
  const long long bi = row / (static_cast<long long>(sq) * hq);
  const T* orow = o + bi * st.o.b + h * st.o.h + qi * st.o.s;
  const T* grow = dout + bi * st.dout.b + h * st.dout.h + qi * st.dout.s;
  float acc = 0.f;
  for (int c = 4 * lane; c < D; c += 128) {
    const float4 a = load4(orow + c), g = load4(grow + c);
    acc = dot4(a, g, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) delta[row] = acc;
}

// grid (ceil(skv / kT), hkv, b)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, Operands st, int hq, int hkv, int sq,
                int skv, int causal, int window, int q_offset, float softcap,
                float scale) {
  using C = Cfg<D>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + C::kT * C::kRow;
  float* sK = sdO + C::kT * C::kRow;
  float* sV = sK + C::kT * C::kRow;
  float* sP = sV + C::kT * C::kRow;
  float* sdS = sP + C::kT * C::kPRow;
  float* slse = sdS + C::kT * C::kPRow;
  float* sdelta = slse + C::kT;

  const int k_lo = blockIdx.x * C::kT;
  const int hk = blockIdx.y, bi = blockIdx.z;
  const int group = hq / hkv;
  load_tile<T, D>(sK, k + bi * st.k.b + hk * st.k.h + k_lo * st.k.s, st.k.s,
                  skv - k_lo, 1.f);
  load_tile<T, D>(sV, v + bi * st.v.b + hk * st.v.h + k_lo * st.v.s, st.v.s,
                  skv - k_lo, 1.f);

  // the query tiles that see a key of this tile (local rows: global less
  // q_offset)
  const int q_begin = causal && k_lo > q_offset ? k_lo - q_offset : 0;
  int q_end = sq;
  if (window > 0) {
    const long long last =
        static_cast<long long>(k_lo) + C::kT - 1 + window - q_offset;
    if (last < q_end) q_end = static_cast<int>(last > 0 ? last : 0);
  }
  const int i_begin = q_begin / C::kT;
  const int i_end = q_begin < q_end ? (q_end + C::kT - 1) / C::kT : i_begin;

  const int ar = threadIdx.x / C::kCT, ac = threadIdx.x % C::kCT;
  float4 adk[C::kAR][C::kAC], adv[C::kAR][C::kAC];
#pragma unroll
  for (int i = 0; i < C::kAR; ++i)
#pragma unroll
    for (int j = 0; j < C::kAC; ++j)
      adk[i][j] = adv[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long row0 = (static_cast<long long>(bi) * hq + h) * sq;
    for (int it = i_begin; it < i_end; ++it) {
      const int q_lo = it * C::kT;
      __syncthreads();  // the last tile's Q, dO, P and dS are no longer read
      load_tile<T, D>(sQ, q + bi * st.q.b + h * st.q.h + q_lo * st.q.s,
                      st.q.s, sq - q_lo, scale);
      load_tile<T, D>(sdO,
                      dout + bi * st.dout.b + h * st.dout.h + q_lo * st.dout.s,
                      st.dout.s, sq - q_lo, 1.f);
      load_rows<D>(slse, sdelta, lse + row0, delta + row0, q_lo, sq);
      __syncthreads();
      scores<D, true>(sQ, sdO, sK, sV, slse, sdelta, sP, sdS, q_lo, k_lo, sq,
                      skv, causal, window, q_offset, softcap);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < C::kT; ++r) {
#pragma unroll
        for (int j = 0; j < C::kAC; ++j) {
          const int c = 4 * (ac + C::kCT * j);
          const float4 o4 = *reinterpret_cast<const float4*>(sdO + r * C::kRow + c);
          const float4 q4 = *reinterpret_cast<const float4*>(sQ + r * C::kRow + c);
#pragma unroll
          for (int i = 0; i < C::kAR; ++i) {
            const int kr = ar + C::kRT * i;
            const float p = sP[r * C::kPRow + kr];
            const float ds = sdS[r * C::kPRow + kr];
            adv[i][j].x = fmaf(p, o4.x, adv[i][j].x);
            adv[i][j].y = fmaf(p, o4.y, adv[i][j].y);
            adv[i][j].z = fmaf(p, o4.z, adv[i][j].z);
            adv[i][j].w = fmaf(p, o4.w, adv[i][j].w);
            adk[i][j].x = fmaf(ds, q4.x, adk[i][j].x);
            adk[i][j].y = fmaf(ds, q4.y, adk[i][j].y);
            adk[i][j].z = fmaf(ds, q4.z, adk[i][j].z);
            adk[i][j].w = fmaf(ds, q4.w, adk[i][j].w);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < C::kAR; ++i) {
    const int kr = ar + C::kRT * i;
    if (k_lo + kr >= skv) continue;
#pragma unroll
    for (int j = 0; j < C::kAC; ++j) {
      const int c = 4 * (ac + C::kCT * j);
      store4(dk + bi * st.dk.b + hk * st.dk.h + (k_lo + kr) * st.dk.s + c,
             adk[i][j]);
      store4(dv + bi * st.dv.b + hk * st.dv.h + (k_lo + kr) * st.dv.s + c,
             adv[i][j]);
    }
  }
}

// grid (ceil(sq / kT), hq, b)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Operands st, int hq, int hkv, int sq,
              int skv, int causal, int window, int q_offset, float softcap,
              float scale) {
  using C = Cfg<D>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + C::kT * C::kRow;
  float* sK = sdO + C::kT * C::kRow;
  float* sV = sK + C::kT * C::kRow;
  float* sdS = sV + C::kT * C::kRow + C::kT * C::kPRow;
  float* slse = sdS + C::kT * C::kPRow;
  float* sdelta = slse + C::kT;

  const int q_lo = blockIdx.x * C::kT;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (hq / hkv);
  const long long row0 = (static_cast<long long>(bi) * hq + h) * sq;
  load_tile<T, D>(sQ, q + bi * st.q.b + h * st.q.h + q_lo * st.q.s, st.q.s,
                  sq - q_lo, scale);
  load_tile<T, D>(sdO, dout + bi * st.dout.b + h * st.dout.h + q_lo * st.dout.s,
                  st.dout.s, sq - q_lo, 1.f);
  load_rows<D>(slse, sdelta, lse + row0, delta + row0, q_lo, sq);

  // the live kv range of this q tile (as the forward)
  const int qg_lo = q_offset + q_lo;
  int k_end = skv;
  if (causal && qg_lo + C::kT < k_end) k_end = qg_lo + C::kT;
  const int k_begin =
      window > 0 && qg_lo - window + 1 > 0 ? qg_lo - window + 1 : 0;
  const int j_begin = k_begin / C::kT;
  const int j_end = (k_end + C::kT - 1) / C::kT;

  const int ar = threadIdx.x / C::kCT, ac = threadIdx.x % C::kCT;
  float4 adq[C::kAR][C::kAC];
#pragma unroll
  for (int i = 0; i < C::kAR; ++i)
#pragma unroll
    for (int j = 0; j < C::kAC; ++j) adq[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int jt = j_begin; jt < j_end; ++jt) {
    const int k_lo = jt * C::kT;
    __syncthreads();  // the last tile's K, V and dS are no longer read
    load_tile<T, D>(sK, k + bi * st.k.b + hk * st.k.h + k_lo * st.k.s, st.k.s,
                    skv - k_lo, 1.f);
    load_tile<T, D>(sV, v + bi * st.v.b + hk * st.v.h + k_lo * st.v.s, st.v.s,
                    skv - k_lo, 1.f);
    __syncthreads();
    scores<D, false>(sQ, sdO, sK, sV, slse, sdelta, nullptr, sdS, q_lo, k_lo,
                     sq, skv, causal, window, q_offset, softcap);
    __syncthreads();
#pragma unroll 2
    for (int c2 = 0; c2 < C::kT; ++c2) {
#pragma unroll
      for (int j = 0; j < C::kAC; ++j) {
        const int c = 4 * (ac + C::kCT * j);
        const float4 k4 = *reinterpret_cast<const float4*>(sK + c2 * C::kRow + c);
#pragma unroll
        for (int i = 0; i < C::kAR; ++i) {
          const float ds = sdS[(ar + C::kRT * i) * C::kPRow + c2];
          adq[i][j].x = fmaf(ds, k4.x, adq[i][j].x);
          adq[i][j].y = fmaf(ds, k4.y, adq[i][j].y);
          adq[i][j].z = fmaf(ds, k4.z, adq[i][j].z);
          adq[i][j].w = fmaf(ds, k4.w, adq[i][j].w);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < C::kAR; ++i) {
    const int r = ar + C::kRT * i;
    if (q_lo + r >= sq) continue;
#pragma unroll
    for (int j = 0; j < C::kAC; ++j) {
      const int c = 4 * (ac + C::kCT * j);
      const float4 a = adq[i][j];
      store4(dq + bi * st.dq.b + h * st.dq.h + (q_lo + r) * st.dq.s + c,
             make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, const Operands& st, int b, int hq, int hkv,
           int sq, int skv, int causal, int window, int q_offset,
           float softcap, float scale, cudaStream_t s) {
  using C = Cfg<D>;
  auto dkdv = dkdv_kernel<T, D>;
  auto dqk = dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kBytes));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(dqk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::kBytes));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(b) * hq * sq;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  delta_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(o), tdo, delta, st, hq, sq, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<dim3((skv + C::kT - 1) / C::kT, hkv, b), kThreads, C::kBytes, s>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      st, hq, hkv, sq, skv, causal, window, q_offset, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<dim3((sq + C::kT - 1) / C::kT, hq, b), kThreads, C::kBytes, s>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), st, hq, hkv, sq, skv,
      causal, window, q_offset, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, float* delta,
             void* dq, void* dk, void* dv, const Operands& st, int b, int hq,
             int hkv, int sq, int skv, int causal, int window, int q_offset,
             float softcap, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, b, hq, hkv, sq, skv, causal, window, q_offset, softcap, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, b, hq, hkv, sq, skv, causal, window, q_offset, softcap, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, b, hq, hkv, sq, skv, causal, window, q_offset, softcap, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, b, hq, hkv, sq, skv, causal, window, q_offset, softcap, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, b, hq, hkv, sq, skv, causal, window, q_offset, softcap, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------------------ bwd::tc

namespace tc {

using bf16 = __nv_bfloat16;
using ::tc::copy_tile;
using ::tc::cp_async_commit;
using ::tc::cp_async_wait;
using ::tc::ldmatrix_x4;
using ::tc::ldmatrix_x4_trans;
using ::tc::mma;
using ::tc::smem_addr;
using ::tc::split;
static_assert(kThreads == ::tc::kThreads, "copy_tile strides by this block");

constexpr int kBQ = 64;           // query rows a streamed dK/dV tile
constexpr int kQT = 16 * kWarps;  // query rows a dQ CTA: 16 a warp
constexpr int kKT = 32;           // keys a streamed dQ tile
constexpr int kStages = 2;        // streamed tiles in flight

template <int D>
struct Layout {
  // dK/dV: kKG groups of 16 keys, each group's dK and dV split along d
  // over kDS warps (a quarter of d each from d 32 up); a warp's S^T and
  // dP^T take kQW query rows of a tile
  static constexpr int kDS = D / 8 < 4 ? D / 8 : 4;
  static constexpr int kKG = kWarps / kDS;
  static constexpr int kBK = 16 * kKG;   // keys a dK/dV CTA
  static constexpr int kDW = D / kDS;    // d columns of dK and dV a warp
  static constexpr int kQW = kBQ / kDS;
  // dQ: keys a softmax step (16 at d 256, where 32 spill)
  static constexpr int kSub = D >= 256 ? 16 : 32;
  static constexpr int kRow = D + 8;     // bf16 a Q, K, V or dO row
  static constexpr int kPRow = kBQ + 8;  // bf16 a staged P^T or dS^T row
  // dK/dV: K and V; stages of Q, dO, lse and delta; P^T hi, P^T lo, dS^T
  // hi and dS^T lo
  static constexpr uint32_t kKBytes = kBK * kRow * 2;
  static constexpr uint32_t kQBytes = kBQ * kRow * 2;
  static constexpr uint32_t kStage = 2 * kQBytes + 2 * kBQ * 4;
  static constexpr uint32_t kPBytes = kBK * kPRow * 2;
  static constexpr size_t kDkdvBytes =
      2 * kKBytes + kStages * kStage + 4 * kPBytes;
  // dQ: Q and dO; stages of K and V
  static constexpr uint32_t kQTBytes = kQT * kRow * 2;
  static constexpr uint32_t kKTBytes = kKT * kRow * 2;
  static constexpr size_t kDqBytes = 2 * kQTBytes + kStages * 2 * kKTBytes;
};
static_assert(Layout<256>::kDkdvBytes <= 232448 &&
                  Layout<256>::kDqBytes <= 232448,
              "inside a block's shared memory");

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// lse and delta of kBQ query rows into shared memory (lse, then delta),
// 4 bytes a copy; rows at or past `avail` are zero-filled
__device__ __forceinline__ void copy_rows(uint32_t dst, const float* lse,
                                          const float* delta, int avail) {
  const int t = threadIdx.x;
  if (t < 2 * kBQ) {
    const int r = t % kBQ;
    const bool ok = r < avail;
    const float* g = (t < kBQ ? lse : delta) + (ok ? r : 0);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     dst + 4 * t),
                 "l"(g), "r"(ok ? 4 : 0));
  }
}

// P and dS of one score from its float32 accumulators s (q k) and dp (dO
// v): scale, softcap, mask (ok), then exp against the row's lse and the
// softcap's derivative; P returned through s, dS through dp
__device__ __forceinline__ void probs(float& s, float& dp, bool ok,
                                      float row_lse, float row_delta,
                                      float scale, float softcap,
                                      float inv_cap) {
  float x = s * scale, cd = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(x * inv_cap);
    x = softcap * t;
    cd = 1.f - t * t;
  }
  const float p = ok ? expf(x - row_lse) : 0.f;
  s = p;
  dp = ok ? p * (dp - row_delta) * cd : 0.f;
}

// qi is a local query row (qi < sq), q_offset + qi its global index
__device__ __forceinline__ bool live(int qi, int ki, int sq, int skv,
                                     int causal, int window, int q_offset) {
  bool ok = qi < sq && ki < skv;
  const int qg = q_offset + qi;
  if (causal) ok = ok && qg >= ki;
  if (window > 0) ok = ok && qg - ki < window;
  return ok;
}

// One CTA per (kv head, batch, kv tile), kv heads fastest, then batches,
// then kv tiles from the first (the most live query tiles when causal).
// In the mma layouts lane t holds rows t / 4 and t / 4 + 8 and columns
// 2 (t % 4) and 2 (t % 4) + 1 of each 8-wide n-tile; S^T and dP^T have the
// warp's keys as rows and the tile's queries as columns.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, Operands st, int b, int hq, int hkv,
                int sq, int skv, int causal, int window, int q_offset,
                float softcap, float scale) {
  using L = Layout<D>;
  constexpr int kBK = L::kBK, kQW = L::kQW, kDW = L::kDW;
  constexpr int kN = kDW / 8;  // n-tiles of the warp's dK and dV
  extern __shared__ uint4 smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const uint32_t k_smem = smem_addr(smem);
  const uint32_t v_smem = k_smem + L::kKBytes;
  const uint32_t ring = v_smem + L::kKBytes;
  const uint32_t p_off = 2 * L::kKBytes + kStages * L::kStage;
  const uint32_t p_smem = k_smem + p_off;

  int idx = blockIdx.x;
  const int hk = idx % hkv;
  idx /= hkv;
  const int bi = idx % b;
  const int k_lo = idx / b * kBK;
  const int group = hq / hkv;

  // the query tiles that see a key of this tile, for each head of the
  // group (local rows: global less q_offset)
  const int q_begin = causal && k_lo > q_offset ? k_lo - q_offset : 0;
  int q_end = sq;
  if (window > 0) {
    const long long last =
        static_cast<long long>(k_lo) + kBK - 1 + window - q_offset;
    if (last < q_end) q_end = static_cast<int>(last > 0 ? last : 0);
  }
  const int it_begin = q_begin / kBQ;
  const int n_it = q_begin < q_end ? (q_end + kBQ - 1) / kBQ - it_begin : 0;
  const int n_tiles = group * n_it;

  // local tile i: head hk group + i / n_it, query tile it_begin + i % n_it,
  // in stage i % kStages
  auto load_q = [&](int i) {
    if (i < n_tiles) {
      const int h = hk * group + i / n_it;
      const int q_lo = (it_begin + i % n_it) * kBQ;
      const uint32_t stage = ring + (i % kStages) * L::kStage;
      copy_tile<D, kBQ>(stage, q + bi * st.q.b + h * st.q.h + q_lo * st.q.s,
                        st.q.s, sq - q_lo);
      copy_tile<D, kBQ>(stage + L::kQBytes,
                        dout + bi * st.dout.b + h * st.dout.h +
                            q_lo * st.dout.s,
                        st.dout.s, sq - q_lo);
      const long long row = (static_cast<long long>(bi) * hq + h) * sq + q_lo;
      copy_rows(stage + 2 * L::kQBytes, lse + row, delta + row, sq - q_lo);
    }
  };
  // group 0: K, V and tile 0; group 1: tile 1 (maybe empty)
  copy_tile<D, kBK>(k_smem, k + bi * st.k.b + hk * st.k.h + k_lo * st.k.s,
                    st.k.s, skv - k_lo);
  copy_tile<D, kBK>(v_smem, v + bi * st.v.b + hk * st.v.h + k_lo * st.v.s,
                    st.v.s, skv - k_lo);
  load_q(0);
  cp_async_commit();
  load_q(1);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kg = warp % L::kKG, ds = warp / L::kKG;
  const int kw_lo = k_lo + 16 * kg;    // the warp's first key
  const int key0 = kw_lo + lane / 4;   // this lane's keys: key0, key0 + 8
  const int col0 = 2 * (lane % 4);     // and its first column in an n-tile
  // ldmatrix row addresses. K, V (A of S^T, dP^T, x4): keys lane % 16, d
  // 8 (lane / 16). Q, dO (B of two query n-tiles, x4): query rows kQW ds
  // + lane % 8 + 8 (lane / 16), d 8 ((lane / 8) % 2). Staged P^T, dS^T (A
  // of dV, dK, x4): keys lane % 16, query rows 8 (lane / 16). dO, Q (B of
  // two d n-tiles, x4.trans): query rows lane % 16, d kDW ds + 8 (lane /
  // 16).
  const uint32_t kv_frag =
      ((16 * kg + lane % 16) * L::kRow + 8 * (lane / 16)) * 2;
  const uint32_t qb_frag =
      ((kQW * ds + lane % 8 + 8 * (lane / 16)) * L::kRow +
       8 * ((lane / 8) % 2)) * 2;
  const uint32_t pa_frag =
      p_smem + ((16 * kg + lane % 16) * L::kPRow + 8 * (lane / 16)) * 2;
  const uint32_t qt_frag =
      ((lane % 16) * L::kRow + kDW * ds + 8 * (lane / 16)) * 2;

  // dK and dV in two levels: each tile's products accumulate on the tensor
  // cores from zero (8 mma deep), and the tile's sums are added here in
  // float32, rounded to nearest (one accumulator over the whole loop
  // misses the bfloat16 band: the header above).
  float tdk[kN][4], tdv[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) tdk[n][e] = tdv[n][e] = 0.f;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 1>();  // tile i (and K, V) have landed
    __syncthreads();
    const int q_lo = (it_begin + i % n_it) * kBQ;
    const uint32_t qs = ring + (i % kStages) * L::kStage;
    const uint32_t dos = qs + L::kQBytes;
    const float* rows = reinterpret_cast<const float*>(
        base + (qs - k_smem) + 2 * L::kQBytes);  // lse, then delta

    // S^T = K Q^T and dP^T = V dO^T for 16 keys x kQW query rows
    float s[kQW / 8][4], dp[kQW / 8][4];
#pragma unroll
    for (int n = 0; n < kQW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t a[4];
      ldmatrix_x4(a, k_smem + kv_frag + kd * 32);
#pragma unroll
      for (int np = 0; np < kQW / 16; ++np) {
        uint32_t bq[4];
        ldmatrix_x4(bq, qs + qb_frag + (np * 16 * L::kRow + kd * 16) * 2);
        mma(s[2 * np], a, bq[0], bq[1]);
        mma(s[2 * np + 1], a, bq[2], bq[3]);
      }
      ldmatrix_x4(a, v_smem + kv_frag + kd * 32);
#pragma unroll
      for (int np = 0; np < kQW / 16; ++np) {
        uint32_t bq[4];
        ldmatrix_x4(bq, dos + qb_frag + (np * 16 * L::kRow + kd * 16) * 2);
        mma(dp[2 * np], a, bq[0], bq[1]);
        mma(dp[2 * np + 1], a, bq[2], bq[3]);
      }
    }
    const int qw_lo = q_lo + kQW * ds;
    const int qw_g = q_offset + qw_lo;  // global, for the masks
    const bool edge = kw_lo + 16 > skv || qw_lo + kQW > sq ||
                      (causal && kw_lo + 15 > qw_g) ||
                      (window > 0 && qw_g + kQW - 1 - kw_lo >= window);
#pragma unroll
    for (int n = 0; n < kQW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = kQW * ds + 8 * n + col0 + e % 2;  // row in the tile
        const bool ok = !edge || live(q_lo + qc, key0 + 8 * (e / 2), sq, skv,
                                      causal, window, q_offset);
        probs(s[n][e], dp[n][e], ok, rows[qc], rows[kBQ + qc], scale,
              softcap, inv_cap);
      }
    // P^T and dS^T, each as two bf16 terms, to shared memory
#pragma unroll
    for (int n = 0; n < kQW / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t* at = reinterpret_cast<uint32_t*>(
            base + p_off +
            ((16 * kg + lane / 4 + 8 * r) * L::kPRow + kQW * ds + 8 * n +
             col0) * 2);
        constexpr int kTerm = L::kPBytes / 4;  // words between terms
        split(s[n][2 * r], s[n][2 * r + 1], at[0], at[kTerm]);
        split(dp[n][2 * r], dp[n][2 * r + 1], at[2 * kTerm], at[3 * kTerm]);
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q, 16 query rows a step, on the warp's d
    float adk[kN][4], adv[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
#pragma unroll
    for (int kq = 0; kq < kBQ / 16; ++kq) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      const uint32_t pa = pa_frag + kq * 32;
      ldmatrix_x4(ph, pa);
      ldmatrix_x4(pl, pa + L::kPBytes);
      ldmatrix_x4(sh, pa + 2 * L::kPBytes);
      ldmatrix_x4(sl, pa + 3 * L::kPBytes);
      const uint32_t at = qt_frag + kq * 16 * L::kRow * 2;
#pragma unroll
      for (int np = 0; np < kN / 2; ++np) {
        uint32_t bt[4];
        ldmatrix_x4_trans(bt, dos + at + np * 32);
        mma(adv[2 * np], ph, bt[0], bt[1]);
        mma(adv[2 * np], pl, bt[0], bt[1]);
        mma(adv[2 * np + 1], ph, bt[2], bt[3]);
        mma(adv[2 * np + 1], pl, bt[2], bt[3]);
        ldmatrix_x4_trans(bt, qs + at + np * 32);
        mma(adk[2 * np], sh, bt[0], bt[1]);
        mma(adk[2 * np], sl, bt[0], bt[1]);
        mma(adk[2 * np + 1], sh, bt[2], bt[3]);
        mma(adk[2 * np + 1], sl, bt[2], bt[3]);
      }
      if constexpr (kN % 2 == 1) {  // d 16: one n-tile a warp
        uint32_t bt[2];
        ldmatrix_x2_trans(bt, dos + at + (kN - 1) * 16);
        mma(adv[kN - 1], ph, bt[0], bt[1]);
        mma(adv[kN - 1], pl, bt[0], bt[1]);
        ldmatrix_x2_trans(bt, qs + at + (kN - 1) * 16);
        mma(adk[kN - 1], sh, bt[0], bt[1]);
        mma(adk[kN - 1], sl, bt[0], bt[1]);
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tdk[n][e] += adk[n][e];
        tdv[n][e] += adv[n][e];
      }
    __syncthreads();  // this stage and the staged terms are no longer read
    load_q(i + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= skv) continue;
    bf16* krow = dk + bi * st.dk.b + hk * st.dk.h + key * st.dk.s +
                 kDW * ds + col0;
    bf16* vrow = dv + bi * st.dv.b + hk * st.dv.h + key * st.dv.s +
                 kDW * ds + col0;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * n) =
          __floats2bfloat162_rn(tdk[n][2 * r] * scale,
                                tdk[n][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * n) =
          __floats2bfloat162_rn(tdv[n][2 * r], tdv[n][2 * r + 1]);
    }
  }
}

// One CTA per (head, batch, q tile), heads fastest, then batches, then q
// tiles from the last (the most live kv tiles when causal). Warp w owns
// query rows [16 w, 16 w + 16) of the tile.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, Operands st, int b, int hq, int hkv,
              int sq, int skv, int causal, int window, int q_offset,
              float softcap, float scale) {
  using L = Layout<D>;
  constexpr int kSub = L::kSub;
  extern __shared__ uint4 smem[];
  const uint32_t q_smem = smem_addr(smem);
  const uint32_t do_smem = q_smem + L::kQTBytes;
  const uint32_t kv_ring = do_smem + L::kQTBytes;  // a stage: K, then V

  const int nq = (sq + kQT - 1) / kQT;
  int idx = blockIdx.x;
  const int h = idx % hq;
  idx /= hq;
  const int bi = idx % b;
  const int q_lo = (nq - 1 - idx / b) * kQT;
  const int hk = h / (hq / hkv);

  // the live kv range of this q tile (as the forward)
  const int qg_lo = q_offset + q_lo;
  int k_end = skv;
  if (causal && qg_lo + kQT < k_end) k_end = qg_lo + kQT;
  const int k_begin =
      window > 0 && qg_lo - window + 1 > 0 ? qg_lo - window + 1 : 0;
  const int j_begin = k_begin / kKT;
  const int n_tiles = max(0, (k_end + kKT - 1) / kKT - j_begin);

  const bf16* kp = k + bi * st.k.b + hk * st.k.h;
  const bf16* vp = v + bi * st.v.b + hk * st.v.h;
  auto load_kv = [&](int i) {
    if (i < n_tiles) {
      const int k_lo = (j_begin + i) * kKT;
      const uint32_t stage = kv_ring + (i % kStages) * 2 * L::kKTBytes;
      copy_tile<D, kKT>(stage, kp + k_lo * st.k.s, st.k.s, skv - k_lo);
      copy_tile<D, kKT>(stage + L::kKTBytes, vp + k_lo * st.v.s, st.v.s,
                        skv - k_lo);
    }
  };
  // group 0: Q, dO and tile 0; group 1: tile 1 (maybe empty)
  copy_tile<D, kQT>(q_smem, q + bi * st.q.b + h * st.q.h + q_lo * st.q.s,
                    st.q.s, sq - q_lo);
  copy_tile<D, kQT>(do_smem,
                    dout + bi * st.dout.b + h * st.dout.h + q_lo * st.dout.s,
                    st.dout.s, sq - q_lo);
  load_kv(0);
  cp_async_commit();
  load_kv(1);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wq_lo = q_lo + 16 * warp;  // the warp's first query row
  const int row0 = wq_lo + lane / 4;   // this lane's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);     // and its first column in an n-tile
  float row_lse[2], row_delta[2];
  const long long rows = (static_cast<long long>(bi) * hq + h) * sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    row_lse[r] = qi < sq ? lse[rows + qi] : 0.f;
    row_delta[r] = qi < sq ? delta[rows + qi] : 0.f;
  }
  // ldmatrix row addresses. Q, dO (A, x4): rows lane % 16, d 8 (lane /
  // 16). K, V (B of two key n-tiles, x4): keys lane % 8 + 8 (lane / 16), d
  // 8 ((lane / 8) % 2). K (B of two d n-tiles, x4.trans): keys lane % 16,
  // d 8 (lane / 16).
  const uint32_t a_frag =
      ((16 * warp + lane % 16) * L::kRow + 8 * (lane / 16)) * 2;
  const uint32_t b_frag =
      ((lane % 8 + 8 * (lane / 16)) * L::kRow + 8 * ((lane / 8) % 2)) * 2;
  const uint32_t t_frag = ((lane % 16) * L::kRow + 8 * (lane / 16)) * 2;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 1>();  // tile i (and Q, dO) have landed
    __syncthreads();
#pragma unroll 1
    for (int sub = 0; sub < kKT / kSub; ++sub) {
      const int k_lo = (j_begin + i) * kKT + sub * kSub;
      const uint32_t ks = kv_ring + (i % kStages) * 2 * L::kKTBytes +
                          sub * kSub * L::kRow * 2;
      const uint32_t vs = ks + L::kKTBytes;

      // S = Q K^T and dP = dO V^T for the warp's 16 rows x kSub keys
      float s[kSub / 8][4], dp[kSub / 8][4];
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t a[4];
        ldmatrix_x4(a, q_smem + a_frag + kd * 32);
#pragma unroll
        for (int np = 0; np < kSub / 16; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, ks + b_frag + (np * 16 * L::kRow + kd * 16) * 2);
          mma(s[2 * np], a, bk[0], bk[1]);
          mma(s[2 * np + 1], a, bk[2], bk[3]);
        }
        ldmatrix_x4(a, do_smem + a_frag + kd * 32);
#pragma unroll
        for (int np = 0; np < kSub / 16; ++np) {
          uint32_t bv[4];
          ldmatrix_x4(bv, vs + b_frag + (np * 16 * L::kRow + kd * 16) * 2);
          mma(dp[2 * np], a, bv[0], bv[1]);
          mma(dp[2 * np + 1], a, bv[2], bv[3]);
        }
      }
      const int wq_g = q_offset + wq_lo;  // global, for the masks
      const bool edge = k_lo + kSub > skv || wq_lo + 16 > sq ||
                        (causal && k_lo + kSub - 1 > wq_g) ||
                        (window > 0 && wq_g + 15 - k_lo >= window);
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = !edge || live(row0 + 8 * (e / 2),
                                        k_lo + 8 * n + col0 + e % 2, sq, skv,
                                        causal, window, q_offset);
          probs(s[n][e], dp[n][e], ok, row_lse[e / 2], row_delta[e / 2],
                scale, softcap, inv_cap);
        }

      // dQ += dS K, 16 keys a step; dS from the dP fragments, split in two
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split(dp[2 * kk][0], dp[2 * kk][1], hi[0], lo[0]);
        split(dp[2 * kk][2], dp[2 * kk][3], hi[1], lo[1]);
        split(dp[2 * kk + 1][0], dp[2 * kk + 1][1], hi[2], lo[2]);
        split(dp[2 * kk + 1][2], dp[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk,
                            ks + t_frag + (kk * 16 * L::kRow + dn * 16) * 2);
          mma(acc[2 * dn], hi, bk[0], bk[1]);
          mma(acc[2 * dn], lo, bk[0], bk[1]);
          mma(acc[2 * dn + 1], hi, bk[2], bk[3]);
          mma(acc[2 * dn + 1], lo, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    load_kv(i + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= sq) continue;
    bf16* qrow = dq + bi * st.dq.b + h * st.dq.h + qi * st.dq.s + col0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * r] * scale,
                                acc[n][2 * r + 1] * scale);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, const Operands& st, int b, int hq, int hkv,
           int sq, int skv, int causal, int window, int q_offset,
           float softcap, float scale, cudaStream_t s) {
  using L = Layout<D>;
  auto dkdv = dkdv_kernel<D>;
  auto dqk = dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kDkdvBytes));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(dqk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kDqBytes));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(b) * hq * sq;
  const long long delta_blocks = (rows + kWarps - 1) / kWarps;
  const long long kv_blocks =
      static_cast<long long>(hkv) * b * ((skv + L::kBK - 1) / L::kBK);
  const long long q_blocks =
      static_cast<long long>(hq) * b * ((sq + kQT - 1) / kQT);
  if (delta_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL ||
      q_blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  delta_kernel<bf16, D><<<static_cast<unsigned>(delta_blocks), kThreads, 0,
                          s>>>(static_cast<const bf16*>(o), tdo, delta, st,
                               hq, sq, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<static_cast<unsigned>(kv_blocks), kThreads, L::kDkdvBytes, s>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), st, b, hq, hkv, sq, skv, causal, window,
      q_offset, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<static_cast<unsigned>(q_blocks), kThreads, L::kDqBytes, s>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), st, b, hq, hkv,
      sq, skv, causal, window, q_offset, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_d(int d, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, float* delta,
             void* dq, void* dk, void* dv, const Operands& st, int b, int hq,
             int hkv, int sq, int skv, int causal, int window, int q_offset,
             float softcap, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<16>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, b, hq, hkv, sq, skv, causal, window, q_offset, softcap, scale, s);
    case 32: return launch<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, b, hq, hkv, sq, skv, causal, window, q_offset, softcap, scale, s);
    case 64: return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, b, hq, hkv, sq, skv, causal, window, q_offset, softcap, scale, s);
    case 128: return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, b, hq, hkv, sq, skv, causal, window, q_offset, softcap, scale, s);
    case 256: return launch<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, b, hq, hkv, sq, skv, causal, window, q_offset, softcap, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the dynamic shared memory of the dK/dV and dQ kernels at head dim d
int shared_bytes(int d, int* dkdv, int* dq) {
  switch (d) {
    case 16: *dkdv = Layout<16>::kDkdvBytes; *dq = Layout<16>::kDqBytes; return 0;
    case 32: *dkdv = Layout<32>::kDkdvBytes; *dq = Layout<32>::kDqBytes; return 0;
    case 64: *dkdv = Layout<64>::kDkdvBytes; *dq = Layout<64>::kDqBytes; return 0;
    case 128: *dkdv = Layout<128>::kDkdvBytes; *dq = Layout<128>::kDqBytes; return 0;
    case 256: *dkdv = Layout<256>::kDkdvBytes; *dq = Layout<256>::kDqBytes; return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

// The C entries' common part: checks the arguments, then bfloat16 to the
// tensor cores (or, with `replaced`, to the SIMT kernels it replaced) and
// float32 to the SIMT kernels; the launch that succeeded writes its route.
int entry(bool replaced, const void* q, const void* k, const void* v,
          const void* o, const void* dout, const float* lse, float* delta,
          void* dq, void* dk, void* dv, int dtype, int b, int hq, int hkv,
          int sq, int skv, int d, const long long* t, int causal, int window,
          int q_offset, float softcap, float scale, cudaStream_t s,
          int* route) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 ||
      window < 0 || q_offset < 0 || softcap < 0.f || hq > 65535 || hkv > 65535 ||
      b > 65535 || t == nullptr || lse == nullptr || delta == nullptr ||
      route == nullptr || (dtype != kF32 && dtype != kBF16) ||
      (replaced && dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Operands st{{t[0], t[1], t[2]},    {t[3], t[4], t[5]},
                    {t[6], t[7], t[8]},    {t[9], t[10], t[11]},
                    {t[12], t[13], t[14]}, {t[15], t[16], t[17]},
                    {t[18], t[19], t[20]}, {t[21], t[22], t[23]}};
  const bool tensor_cores = dtype == kBF16 && !replaced;
  const int err =
      tensor_cores
          ? tc::launch_d(d, q, k, v, o, dout, lse, delta, dq, dk, dv, st, b,
                         hq, hkv, sq, skv, causal, window, q_offset, softcap,
                         scale, s)
      : dtype == kBF16
          ? launch_d<__nv_bfloat16>(d, q, k, v, o, dout, lse, delta, dq, dk,
                                    dv, st, b, hq, hkv, sq, skv, causal,
                                    window, q_offset, softcap, scale, s)
          : launch_d<float>(d, q, k, v, o, dout, lse, delta, dq, dk, dv, st,
                            b, hq, hkv, sq, skv, causal, window, q_offset,
                            softcap, scale, s);
  if (err == 0) *route = tensor_cores ? kTensorCore : kSimt;
  return err;
}

}  // namespace bwd

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
// unbounded; q_offset >= 0 the global index of query row 0; softcap 0 =
// off. lse, if not null, receives each query row's
// log-sum-exp, (b, hq, sq) float32 contiguous, from an instance of its own
// (training passes it; serving does not, and runs the kernel it ran before
// lse existed). bfloat16 launches the tensor-core kernel and float32 the
// SIMT one; the launch that succeeded writes which into *route (0 SIMT, 1 tensor
// cores). Returns cudaErrorInvalidValue for anything else.
int attn_fwd_launch(const void* q, const void* k, const void* v, void* o,
                    float* lse, int dtype, int b, int hq, int hkv, int sq,
                    int skv, int d, const long long* strides, int skv_valid,
                    int causal, int window, int q_offset, float softcap,
                    float scale, void* stream, int* route) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 ||
      skv_valid < 0 || skv_valid > skv || window < 0 || q_offset < 0 ||
      softcap < 0.f ||
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
  return launch_d(d, dtype, q, k, v, o, lse, st, b, hq, hkv, sq, skv,
                  skv_valid, causal, window, q_offset, softcap, scale,
                  static_cast<cudaStream_t>(stream), route);
}

// The backward of attn_fwd_launch with every key valid (K4b): from q, k, v,
// the forward's output o and lse and the output's gradient dout, writes dq
// (like q), dk and dv (like k); delta is scratch of (b, hq, sq) float32.
// strides: eight triples (batch, head, sequence) for q, k, v, o, dout, dq,
// dk, dv in that order, each tensor's last dimension contiguous and its
// rows 16-byte aligned; q_offset as in attn_fwd_launch. Three launches on
// the stream: delta, dk/dv, dq.
// bfloat16 launches the tensor-core kernels and float32 the SIMT ones; the
// launch that succeeded writes which into *route (0 SIMT, 1 tensor cores).
int attn_bwd_launch(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    float* delta, void* dq, void* dk, void* dv, int dtype,
                    int b, int hq, int hkv, int sq, int skv, int d,
                    const long long* strides, int causal, int window,
                    int q_offset, float softcap, float scale, void* stream,
                    int* route) {
  return bwd::entry(false, q, k, v, o, dout, lse, delta, dq, dk, dv, dtype,
                    b, hq, hkv, sq, skv, d, strides, causal, window, q_offset,
                    softcap, scale, static_cast<cudaStream_t>(stream), route);
}

// The dynamic shared memory, in bytes, that attn_bwd_launch's tensor-core
// dK/dV and dQ kernels take at head dim d (a CTA each); 0 on success.
int attn_bwd_shared_memory(int d, int* dkdv, int* dq) {
  if (dkdv == nullptr || dq == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bwd::tc::shared_bytes(d, dkdv, dq);
}

}  // extern "C"
