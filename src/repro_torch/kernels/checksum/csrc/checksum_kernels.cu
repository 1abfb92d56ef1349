// Device checksum for Hopper (sm_90a): the Fletcher-style pair that the
// replication fabric compares across hosts.
//
// Replaces repro/kernels/checksum/kernel.py _checksum_kernel / checksum_u32
// (with the word cast of repro/kernels/checksum/ops.py device_checksum).
// The input is read in its own dtype and each element widened in registers
// to the reference's uint32 word: bool/uint8/uint16 zero-extend,
// int8/int16/int32 sign-extend, int64/uint64 keep their low word, float16/
// bfloat16/float32 give the bits of their float32 value, float64 is rounded
// to float32 first. One element is one word (bytes are not packed).
//
// What the reference computes, with M = 65521 and blocks of b words (the
// last block zero-padded): per block j, with r = word % M and the in-block
// position t = 1..b,
//   s1_j = (uint32 sum of r) % M,   s2_j = (uint32 sum of (r * (t % M)) % M) % M,
// folded in order as S1 += s1_j, S2 += S1_before * (b % M) + s2_j (mod M).
// The fold only ever sees operands below M, so it equals the closed form
//   S1 = sum_j s1_j,   S2 = sum_j [s2_j + (b % M) * ((nb - 1 - j) % M) * s1_j]
// (mod M), and the blocks can be summed in any order. Here one warp takes
// a block at a time (a grid-stride loop over blocks: nothing assumes that
// blocks or CTAs run in order); each warp adds its part into two 64-bit
// integer accumulators with atomics, which are exact and so deterministic,
// and a last small kernel reduces them mod M.
//
// Two arithmetic paths, chosen by b:
// - b <= 32768 (the reference's default is 2048): no uint32 sum of the
//   reference can wrap (b * (M - 1) < 2^32) and t < M, so s1_j and s2_j are
//   (sum of word) % M and (sum of word * t) % M. Each lane sums its raw
//   words and words * t in 64 bits (below 2^62 for a whole block) and
//   reduces mod M once per block, so an element costs a widen, an add and a
//   multiply-add. Blocks whose start is 16-byte aligned are read as 16-byte
//   vectors, neighbouring lanes on neighbouring addresses.
// - b > 32768: the reference's arithmetic element by element (r = word % M,
//   (r * (t % M)) % M, uint32 sums that wrap, then the warp's wrapping sum,
//   which is associative and so gives the reference's s1_j, s2_j bit for
//   bit).
//
// Bound: bytes. The input is read once; the fast path does two integer
// operations an element, far below the card's integer rate. Every index is
// 64-bit: the 8 GiB bundle has 2^33 elements and 2^22 blocks.
//
// Plain C interface (extern "C", pointers and integers only), built by nvcc
// into a shared library and loaded with ctypes by kernel.py. The entry
// point launches on the caller's stream, allocates nothing, and returns the
// cudaError_t of its launches (0 = success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using u64 = unsigned long long;  // the atomics' and shuffles' 64-bit type

constexpr uint32_t kMod = 65521;
constexpr int kWarp = 32;
constexpr int kBlock = 256;
constexpr int kWarpsPerBlock = kBlock / kWarp;
constexpr int kBlocksPerSM = 2048 / kBlock;
constexpr int64_t kMaxFastBlock = 32768;
constexpr unsigned kFull = 0xffffffffu;

// Element kinds, as kernel.py names them.
enum Kind : int {
  kU8 = 0,    // bool, uint8
  kI8 = 1,    // int8
  kU16 = 2,   // uint16
  kI16 = 3,   // int16
  kW32 = 4,   // int32, uint32, float32 (its bits)
  kW64 = 5,   // int64, uint64 (the low word)
  kF16 = 6,   // float16
  kBF16 = 7,  // bfloat16
  kF64 = 8,   // float64
};

// How one element, read as raw bits, widens to the reference's word.
// kSmall: every word is below 2^16, so 16 of them and their in-vector
// weighted sum fit 32 bits.
template <int K> struct Elem;
template <> struct Elem<kU8> {
  using Raw = uint8_t;
  static constexpr bool kSmall = true;
  static __device__ __forceinline__ uint32_t word(Raw r) { return r; }
};
template <> struct Elem<kI8> {
  using Raw = uint8_t;
  static constexpr bool kSmall = false;
  static __device__ __forceinline__ uint32_t word(Raw r) {
    return static_cast<uint32_t>(static_cast<int32_t>(static_cast<int8_t>(r)));
  }
};
template <> struct Elem<kU16> {
  using Raw = uint16_t;
  static constexpr bool kSmall = true;
  static __device__ __forceinline__ uint32_t word(Raw r) { return r; }
};
template <> struct Elem<kI16> {
  using Raw = uint16_t;
  static constexpr bool kSmall = false;
  static __device__ __forceinline__ uint32_t word(Raw r) {
    return static_cast<uint32_t>(static_cast<int32_t>(static_cast<int16_t>(r)));
  }
};
template <> struct Elem<kW32> {
  using Raw = uint32_t;
  static constexpr bool kSmall = false;
  static __device__ __forceinline__ uint32_t word(Raw r) { return r; }
};
template <> struct Elem<kW64> {
  using Raw = u64;
  static constexpr bool kSmall = false;
  static __device__ __forceinline__ uint32_t word(Raw r) {
    return static_cast<uint32_t>(r);
  }
};
template <> struct Elem<kF16> {
  using Raw = uint16_t;
  static constexpr bool kSmall = false;
  static __device__ __forceinline__ uint32_t word(Raw r) {
    return __float_as_uint(__half2float(__ushort_as_half(r)));
  }
};
template <> struct Elem<kBF16> {
  using Raw = uint16_t;
  static constexpr bool kSmall = false;
  static __device__ __forceinline__ uint32_t word(Raw r) {
    return __float_as_uint(__bfloat162float(__ushort_as_bfloat16(r)));
  }
};
template <> struct Elem<kF64> {
  using Raw = u64;
  static constexpr bool kSmall = false;
  static __device__ __forceinline__ uint32_t word(Raw r) {
    return __float_as_uint(
        __double2float_rn(__longlong_as_double(static_cast<long long>(r))));
  }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Fast path, b <= kMaxFastBlock. Lane `lane` adds its share of the block's
// `len` words at `blk` (the rest of the block is zero padding, which adds
// nothing) into sum(word) -> *a and sum(word * t) -> *w.
template <int K>
__device__ __forceinline__ void lane_block_sums(
    const typename Elem<K>::Raw* blk, int64_t len, bool vec, int lane,
    u64* a, u64* w) {
  using E = Elem<K>;
  using Raw = typename E::Raw;
  constexpr int V = 16 / sizeof(Raw);
  using VAcc = typename std::conditional<E::kSmall, uint32_t, u64>::type;
  int64_t from = 0;
  if (vec) {
    const int64_t nvec = len / V;
    const uint4* vp = reinterpret_cast<const uint4*>(blk);
#pragma unroll 4
    for (int64_t v = lane; v < nvec; v += kWarp) {
      union {
        uint4 q;
        Raw e[V];
      } u;
      u.q = __ldg(vp + v);
      VAcc va = 0, vw = 0;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const VAcc x = E::word(u.e[k]);
        va += x;
        vw += x * static_cast<VAcc>(k);
      }
      // the vector's words sit at t = v * V + 1 + k
      *a += va;
      *w += vw + static_cast<u64>(v * V + 1) * va;
    }
    from = nvec * V;
  }
  for (int64_t i = from + lane; i < len; i += kWarp) {
    const u64 x = E::word(blk[i]);
    *a += x;
    *w += x * static_cast<u64>(i + 1);
  }
}

// Exact path, b > kMaxFastBlock: the reference's per-element arithmetic
// with wrapping uint32 sums; returns s1_j and s2_j (below M) in every lane.
template <int K>
__device__ __forceinline__ void warp_block_sums_wrapping(
    const typename Elem<K>::Raw* blk, int64_t len, int lane, uint32_t* s1,
    uint32_t* s2) {
  using E = Elem<K>;
  uint32_t l1 = 0, l2 = 0;
  uint32_t tm = static_cast<uint32_t>((lane + 1) % kMod);  // t % M
  constexpr uint32_t kStep = kWarp % kMod;
  for (int64_t i = lane; i < len; i += kWarp) {
    const uint32_t r = E::word(blk[i]) % kMod;
    l1 += r;
    l2 += (r * tm) % kMod;
    tm += kStep;
    if (tm >= kMod) tm -= kMod;
  }
  *s1 = warp_sum(l1) % kMod;
  *s2 = warp_sum(l2) % kMod;
}

// One warp per block of b words, grid-stride over the nb blocks; acc[0],
// acc[1] (zeroed by the caller) receive each warp's S1, S2 parts (below M).
template <int K, bool kWrap>
__global__ void __launch_bounds__(kBlock)
    checksum_kernel(const void* x, int64_t n, int64_t b, int64_t nb, bool vec,
                    unsigned long long* acc) {
  using Raw = typename Elem<K>::Raw;
  const Raw* p = static_cast<const Raw*>(x);
  const int lane = threadIdx.x % kWarp;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const u64 bm = static_cast<u64>(b % kMod);
  u64 c1 = 0, c2 = 0;  // this lane's (or, wrapping, lane 0's) parts
  for (int64_t j = warp; j < nb; j += nwarps) {
    const int64_t start = j * b;
    const int64_t len = b < n - start ? b : n - start;
    // weight of block j's s1 in S2: (b % M) * ((nb - 1 - j) % M) % M
    const u64 cj = bm * static_cast<u64>((nb - 1 - j) % kMod) % kMod;
    if constexpr (kWrap) {
      uint32_t s1, s2;
      warp_block_sums_wrapping<K>(p + start, len, lane, &s1, &s2);
      if (lane == 0) {
        c1 += s1;
        c2 += s2 + cj * s1 % kMod;
      }
    } else {
      u64 a = 0, w = 0;
      lane_block_sums<K>(p + start, len, vec, lane, &a, &w);
      // mod M is linear: this lane's part of s1_j and s2_j, and of S2
      const u64 am = a % kMod;
      c1 += am;
      c2 += w % kMod + cj * am % kMod;
    }
  }
  // c1 and c2 grow by less than 2^18 a block: 64 bits hold any grid
  c1 = warp_sum(c1 % kMod);
  c2 = warp_sum(c2 % kMod);
  if (lane == 0 && (c1 | c2)) {
    atomicAdd(acc, c1);
    atomicAdd(acc + 1, c2);
  }
}

__global__ void checksum_finish(unsigned long long* acc) {
  if (threadIdx.x < 2) acc[threadIdx.x] %= kMod;
}

int elem_size(int kind) {
  switch (kind) {
    case kU8: case kI8: return 1;
    case kU16: case kI16: case kF16: case kBF16: return 2;
    case kW32: return 4;
    case kW64: case kF64: return 8;
    default: return 0;
  }
}

template <int K>
void launch(const void* x, int64_t n, int64_t b, int64_t nb, bool vec,
            unsigned long long* acc, unsigned grid, cudaStream_t s) {
  if (b > kMaxFastBlock) {
    checksum_kernel<K, true><<<grid, kBlock, 0, s>>>(x, n, b, nb, false, acc);
  } else {
    checksum_kernel<K, false><<<grid, kBlock, 0, s>>>(x, n, b, nb, vec, acc);
  }
}

}  // namespace

extern "C" {

const char* checksum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: n elements of `kind` (contiguous, on the device); b: the block size
// in words (b >= 1); nb = ceil(n / b). out: two int64 (device), receives
// (S1, S2). Returns cudaErrorInvalidValue for an unknown kind.
int checksum_launch(const void* x, int kind, int64_t n, int64_t b,
                    int64_t nb, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int es = elem_size(kind);
  if (es == 0 || n < 1 || b < 1 || nb != (n + b - 1) / b) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned long long* acc = static_cast<unsigned long long*>(out);
  cudaError_t err = cudaMemsetAsync(acc, 0, 2 * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (nb + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSM;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  // 16-byte loads need every block to start on a 16-byte boundary
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (b * es) % 16 == 0;
  switch (kind) {
    case kU8: launch<kU8>(x, n, b, nb, vec, acc, grid, s); break;
    case kI8: launch<kI8>(x, n, b, nb, vec, acc, grid, s); break;
    case kU16: launch<kU16>(x, n, b, nb, vec, acc, grid, s); break;
    case kI16: launch<kI16>(x, n, b, nb, vec, acc, grid, s); break;
    case kW32: launch<kW32>(x, n, b, nb, vec, acc, grid, s); break;
    case kW64: launch<kW64>(x, n, b, nb, vec, acc, grid, s); break;
    case kF16: launch<kF16>(x, n, b, nb, vec, acc, grid, s); break;
    case kBF16: launch<kBF16>(x, n, b, nb, vec, acc, grid, s); break;
    case kF64: launch<kF64>(x, n, b, nb, vec, acc, grid, s); break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  checksum_finish<<<1, kWarp, 0, s>>>(acc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
