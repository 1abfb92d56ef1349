// Flash-attention forward for Hopper (sm_90a): softmax(Q K^T / sqrt(d)) V
// with causal, sliding-window and validity masks, the tanh logit softcap,
// GQA and an online (streaming) softmax.
//
// Replaces repro/kernels/attention/kernel.py _attn_kernel /
// flash_attention_bhsd, the Pallas kernel that the JAX package's model
// attention (models/attention.py flash_attention, local_attention) follows.
// It computes what that kernel computes, in its (B, H, S, D) layout:
// - q cast to float32 and scaled by 1/sqrt(d) before the product;
// - the optional softcap c * tanh(s / c) before the masks;
// - masks: causal (q >= k), window (q - k < w, w > 0), validity
//   (k < skv_valid); a masked score is -2e38;
// - online softmax with float32 m, l and acc per query row; l is clamped at
//   1e-37 before the division; the output takes the input's dtype;
// - GQA: query head h reads key/value head h / (Hq / Hkv).
// Inputs are float32 or bfloat16; Sq and Skv are any lengths (the ragged
// tile is zero-filled and masked here, so no padding copy is needed).
//
// Design for the card, not block by block from the TPU. The TPU kernel
// runs its grid in order and carries m, l and acc in VMEM across the
// sequential kv axis. Here one CTA of 256 threads owns one (batch, head,
// 64-row q tile) and loops over 64-row kv tiles itself, keeping m, l and
// acc in registers, so nothing carries between CTAs. A kv tile that no
// (q, k) pair of the q tile can reach is never visited: the loop bounds
// are the reference's `live` test solved for the tile index (causal: k_lo
// <= q_hi; window: k_hi > q_lo - w; validity: k_lo < skv_valid). Causal q
// tiles near the end of the sequence have the most live kv tiles, so the
// grid hands them out first.
//
// Per kv tile: Q (scaled, float32), K and V (float32) sit in dynamic
// shared memory. The 16 x 16 threads each compute a 4 x 4 block of the
// 64 x 64 scores from float4 reads (row strides of d + 4 floats keep the
// reads of a quarter-warp on distinct banks), reduce the row max and sum
// with shuffles over the 16 lanes that share a row, write P transposed to
// shared memory, and add P V into their 4 rows x d/16 columns of the
// accumulator. At d = 256 that is 64 float32 registers of acc a thread,
// and Q, K, V and P take 216,064 bytes of shared memory, inside the
// 227 KB a block may have; above 48 KB the launch opts in with
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize).
//
// Bound: operations. At the serving prefill (B 4, S 4608, Hq 8, Hkv 4,
// d 256, causal) the live pairs take about 348 GFLOP a layer against
// 226 MB of inputs and output, far above the card's bytes-to-operations
// line. This simple kernel runs on the float32 FMA pipes (67 TFLOP/s),
// not the tensor cores (989 TFLOP/s bf16), so its own ceiling sits well
// above the bound; a tensor-core design (mma.sync or wgmma with TMA) is
// later work. nvcc contracts a + b * c into FMA: the contract is a
// tolerance band against the plain version, not bit-exactness, so the
// contraction is left on. P stays float32 into P V and the output is rounded
// once, so in bfloat16 the band is one unit in the last place (2^-7 of the
// value); in float32 it is the reference's 2e-5.
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
constexpr int kTX = 16;            // threads along a score row
constexpr int kTY = kThreads / kTX;
constexpr int kBQ = 64;            // q rows a CTA
constexpr int kBK = 64;            // kv rows a tile
constexpr int kRows = kBQ / kTY;   // q rows a thread: 4 * ty + i
constexpr int kCols = kBK / kTX;   // score columns a thread: tx + 16 * j
constexpr float kNegInf = -2.0e38f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRows == 4, "P is written and read as float4 over a thread's rows");

enum Dtype : int { kF32 = 0, kBF16 = 1 };

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

// Copy rows [0, kRowsTile) of a (rows, D) tile at `src` into shared memory
// as float32 times `scale`; rows at or past `avail` are zero.
template <typename T, int D, int kRowsTile>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* src, int avail,
                                          float scale) {
  if constexpr (sizeof(T) == 4) {
    constexpr int kPer = D / 4;
    for (int i = threadIdx.x; i < kRowsTile * kPer; i += kThreads) {
      const int r = i / kPer, c = (i % kPer) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < avail) {
        x = __ldg(reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(src) + static_cast<size_t>(r) * D + c));
      }
      *reinterpret_cast<float4*>(dst + r * stride + c) = scaled(x, scale);
    }
  } else {
    constexpr int kPer = D / 8;
    for (int i = threadIdx.x; i < kRowsTile * kPer; i += kThreads) {
      const int r = i / kPer, c = (i % kPer) * 8;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (r < avail) {
        raw = __ldg(reinterpret_cast<const uint4*>(
            src + static_cast<size_t>(r) * D + c));
      }
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      const float2 e = __bfloat1622float2(h[2]), f = __bfloat1622float2(h[3]);
      float* row = dst + r * stride + c;
      *reinterpret_cast<float4*>(row) =
          scaled(make_float4(a.x, a.y, b.x, b.y), scale);
      *reinterpret_cast<float4*>(row + 4) =
          scaled(make_float4(e.x, e.y, f.x, f.y), scale);
    }
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
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

// grid (ceil(sq / kBQ), hq, b); q, o (b, hq, sq, D); k, v (b, hkv, skv, D).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int hq,
                    int hkv, int sq, int skv, int skv_valid, int causal,
                    int window, float softcap, float scale) {
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

  const T* qp = q + (static_cast<size_t>(bi * hq + h) * sq + q_lo) * D;
  const T* kp = k + static_cast<size_t>(bi * hkv + hk) * skv * D;
  const T* vp = v + static_cast<size_t>(bi * hkv + hk) * skv * D;

  // the live kv range of this q tile (the reference's `live`, solved)
  int k_end = skv_valid < skv ? skv_valid : skv;
  if (causal && q_lo + kBQ < k_end) k_end = q_lo + kBQ;
  int k_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) k_begin = q_lo - window + 1;
  const int j_begin = k_begin / kBK;
  const int j_end = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  load_tile<T, D, kBQ>(sQ, L::kQK, qp, sq - q_lo, scale);

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
    load_tile<T, D, kBK>(sK, L::kQK, kp + static_cast<size_t>(k_lo) * D,
                         skv - k_lo, 1.f);
    load_tile<T, D, kBK>(sV, L::kV, vp + static_cast<size_t>(k_lo) * D,
                         skv - k_lo, 1.f);
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
    T* orow = o + (static_cast<size_t>(bi * hq + h) * sq + q_lo + r) * D;
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g)
#pragma unroll
      for (int e = 0; e < L::kVec; ++e) {
        const int col = L::kVec * tx + kTX * L::kVec * g + e;
        orow[col] = from_f32<T>(acc[i][g * L::kVec + e] * inv_l);
      }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int skv_valid, int causal,
           int window, float softcap, float scale, cudaStream_t s) {
  using L = Layout<D>;
  auto kernel = attn_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  kernel<<<grid, kThreads, L::kBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv,
      skv_valid, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int b, int hq, int hkv, int sq, int skv, int skv_valid,
             int causal, int window, float softcap, float scale,
             cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, hq, hkv, sq, skv, skv_valid, causal, window, softcap, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, skv, skv_valid, causal, window, softcap, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, skv_valid, causal, window, softcap, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, skv_valid, causal, window, softcap, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, b, hq, hkv, sq, skv, skv_valid, causal, window, softcap, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o: (b, hq, sq, d); k, v: (b, hkv, skv, d); contiguous, 16-byte
// aligned, all of `dtype` (0 float32, 1 bfloat16). d in {16, 32, 64, 128,
// 256}; hq a multiple of hkv; 0 <= skv_valid <= skv; window 0 = unbounded;
// softcap 0 = off. Returns cudaErrorInvalidValue for anything else.
int attn_fwd_launch(const void* q, const void* k, const void* v, void* o,
                    int dtype, int b, int hq, int hkv, int sq, int skv, int d,
                    int skv_valid, int causal, int window, float softcap,
                    float scale, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 ||
      skv_valid < 0 || skv_valid > skv || window < 0 || softcap < 0.f ||
      hq > 65535 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_d<float>(d, q, k, v, o, b, hq, hkv, sq, skv, skv_valid,
                             causal, window, softcap, scale, s);
    case kBF16:
      return launch_d<__nv_bfloat16>(d, q, k, v, o, b, hq, hkv, sq, skv,
                                     skv_valid, causal, window, softcap,
                                     scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
