// Device code shared by the kernel sources (bc1_kernels.cu, bc2_kernels.cu,
// bc3_kernels.cu, bc45_kernels.cu, bc7_kernels.cu, rgb_kernels.cu): the YCoCg-R
// colour-pair arithmetic, the launch shape, the row lookup and launch of the BC1-BC5
// rows kernels and the map from a candidate's index to its template, the writer of the candidate colour
// regions that the BC1, BC2 and BC3 region kernels build, the loads and stores of
// the 8-byte alpha section that BC3, BC4 and BC5 blocks share, and the block-wide
// copies of byte ranges at any alignment that the RGB kernels use.
//
// Everything here has internal linkage, so each source gets its own copy and the
// one shared library links without clashes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// ---- YCoCg-R on both u16 halves of a c0 | c1 << 16 word at once (SWAR) ----------
// Guard bits (| 0x0020_0020 before each subtraction, & 0x000F_000F after each
// >> 1) keep borrows and carries inside each 16-bit half. Same arithmetic as
// dxt_lossless_transform_tpu/ops/ycocg.py:decorrelate_pair_swar.
constexpr uint32_t kP5 = 0x001F001Fu;
constexpr uint32_t kP4 = 0x000F000Fu;
constexpr uint32_t kPG = 0x00200020u;
constexpr uint32_t kP1 = 0x00010001u;

template <int V>
__device__ __forceinline__ uint32_t decorrelate_pair(uint32_t p) {
  if constexpr (V == 0) {
    return p;
  } else {
    const uint32_t r = (p >> 11) & kP5, g = (p >> 6) & kP5;
    const uint32_t gl = (p >> 5) & kP1, b = p & kP5;
    const uint32_t co = ((r | kPG) - b) & kP5;
    const uint32_t t = (b + ((co >> 1) & kP4)) & kP5;
    const uint32_t cg = ((g | kPG) - t) & kP5;
    const uint32_t y = (t + ((cg >> 1) & kP4)) & kP5;
    if constexpr (V == 1) return (y << 11) | (co << 6) | (gl << 5) | cg;
    else if constexpr (V == 2) return (gl << 15) | (y << 10) | (co << 5) | cg;
    else return (y << 11) | (co << 6) | (cg << 1) | gl;
  }
}

template <int V>
__device__ __forceinline__ uint32_t recorrelate_pair(uint32_t p) {
  if constexpr (V == 0) {
    return p;
  } else {
    uint32_t y, co, gl, cg;
    if constexpr (V == 1) {
      y = (p >> 11) & kP5; co = (p >> 6) & kP5; gl = (p >> 5) & kP1; cg = p & kP5;
    } else if constexpr (V == 2) {
      gl = (p >> 15) & kP1; y = (p >> 10) & kP5; co = (p >> 5) & kP5; cg = p & kP5;
    } else {
      y = (p >> 11) & kP5; co = (p >> 6) & kP5; cg = (p >> 1) & kP5; gl = p & kP1;
    }
    const uint32_t t = ((y | kPG) - ((cg >> 1) & kP4)) & kP5;
    const uint32_t g = (cg + t) & kP5;
    const uint32_t b = ((t | kPG) - ((co >> 1) & kP4)) & kP5;
    const uint32_t r = (b + co) & kP5;
    return (r << 11) | (g << 6) | (gl << 5) | b;
  }
}

__device__ __forceinline__ int64_t global_thread() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// ---- the rows form of a transform: a batch of files, each with its own settings ----
// The batch pipeline's step holds B files in one (B, block_size·bucket) batch, file r's
// n_r blocks at the start of row r and padding after them, and picks each file's
// settings on the card (best[r], an index into the candidates). A rows kernel writes
// row r of a (B, block_size·bucket) output in the exact layout of the per-file
// transform of the row's first n_r blocks under candidate best[r], at the row's base;
// the padding past block_size·n_r is left as it was. The candidates come as a
// kernel argument, `code`: 4 bits each, candidate c in bits 4c..4c+3, the index of
// its instantiation in the per-file entry point's table. The grid is (block chunks
// of the bucket, rows), one launch per kRowsPerLaunch rows. Each thread block reads
// its row's n_r and settings once; a block whose chunk starts at or past n_r returns
// at once, so no padding is transformed; the others switch on the settings, the same
// branch for every thread of the block, to the per-file kernel's per-block body.
constexpr int64_t kMaxRowCandidates = 16;
constexpr int64_t kRowsPerLaunch = 65535;  // the grid's y limit

struct RowBlock {
  int64_t row, n, b;  // the row, its block count, this thread's block
  unsigned settings;  // the row's instantiation index
};

// This thread's block of its row; false for a thread past the row's n_r.
__device__ __forceinline__ bool row_block(const int64_t* __restrict__ ns,
                                          const int64_t* __restrict__ best, uint64_t code,
                                          int64_t row0, RowBlock& rb) {
  rb.row = row0 + blockIdx.y;
  rb.n = ns[rb.row];
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  if (b0 >= rb.n) return false;
  rb.settings = static_cast<unsigned>((code >> (4 * best[rb.row])) & 0xFu);
  rb.b = b0 + threadIdx.x;
  return rb.b < rb.n;
}

// Launches kernel(in, out, ns, best, bucket, code, row0) over `rows` rows of
// `bucket` blocks.
template <typename In, typename Kernel>
cudaError_t launch_rows(Kernel kernel, const void* in, void* out, const void* ns,
                        const void* best, int64_t rows, int64_t bucket, int64_t code,
                        cudaStream_t st) {
  for (int64_t row0 = 0; row0 < rows; row0 += kRowsPerLaunch) {
    const int64_t r = rows - row0 < kRowsPerLaunch ? rows - row0 : kRowsPerLaunch;
    kernel<<<dim3(blocks_for(bucket), static_cast<unsigned>(r)), kThreads, 0, st>>>(
        static_cast<const In*>(in), static_cast<uint8_t*>(out),
        static_cast<const int64_t*>(ns), static_cast<const int64_t*>(best), bucket,
        static_cast<uint64_t>(code), row0);
  }
  return cudaGetLastError();
}

inline bool rows_args_valid(int64_t rows, int64_t bucket, int64_t n_cand) {
  return rows > 0 && bucket > 0 && n_cand > 0 && n_cand <= kMaxRowCandidates;
}

// ---- a candidate's instantiation index, BC1, BC2, BC4 and BC5 ----------------------
// The index of the per-file entry points' instantiations and of the rows kernels'
// candidates (ops/cuda/shuffle.py's _ROWS mirrors it): variant * 2 + split for BC1 and
// BC2, split for BC4 and BC5 (BC3's is in bc3_kernels.cu). with_*(i, f) calls f with
// the tag of instantiation i, on the host to pick the per-file kernel and on the card
// to pick the rows kernel's per-block body: the one map from the index to the template.
template <int V_, bool SPLIT_>
struct VariantSplit {
  static constexpr int V = V_;
  static constexpr bool SPLIT = SPLIT_;
};

inline unsigned variant_split_index(int64_t variant, int64_t split) {
  return static_cast<unsigned>(variant * 2 + (split ? 1 : 0));
}

#pragma nv_exec_check_disable
template <typename F>
__host__ __device__ __forceinline__ auto with_variant_split(unsigned i, F&& f) {
  switch (i) {
    case 0: return f(VariantSplit<0, false>{});
    case 1: return f(VariantSplit<0, true>{});
    case 2: return f(VariantSplit<1, false>{});
    case 3: return f(VariantSplit<1, true>{});
    case 4: return f(VariantSplit<2, false>{});
    case 5: return f(VariantSplit<2, true>{});
    case 6: return f(VariantSplit<3, false>{});
    default: return f(VariantSplit<3, true>{});
  }
}

template <bool SPLIT_>
struct Split {
  static constexpr bool SPLIT = SPLIT_;
};

#pragma nv_exec_check_disable
template <typename F>
__host__ __device__ __forceinline__ auto with_split(unsigned i, F&& f) {
  if (i) return f(Split<true>{});
  return f(Split<false>{});
}

// ---- candidate colour regions ------------------------------------------------------
// Block b's part of every candidate's colour region, for its colour word `col`
// (c0 | c1 << 16). Row c of out (u8[C, 4n]) holds exactly the bytes that
// candidate c's transform writes to its colour stream(s):
//   interleaved: d0 | d1 << 16 as u32 at word b;  split: d0 u16 at b, d1 u16 at n+b.
// Candidate c is 4 bits of `code`: variant in bits 0-1, split in bit 2. The colour
// word is decorrelated once per variant and written to each row that wants it.
__device__ __forceinline__ void write_colour_rows(uint32_t col, uint8_t* out, int64_t n,
                                                  int64_t b, uint32_t code, int n_cand) {
  const uint32_t d1 = decorrelate_pair<1>(col);
  const uint32_t d2 = decorrelate_pair<2>(col);
  const uint32_t d3 = decorrelate_pair<3>(col);
  for (int c = 0; c < n_cand; ++c) {
    const uint32_t cc = code >> (4 * c);
    const uint32_t v = cc & 3u;
    const uint32_t d = v == 0 ? col : v == 1 ? d1 : v == 2 ? d2 : d3;
    uint8_t* row = out + static_cast<int64_t>(c) * 4 * n;
    if (cc & 4u) {
      reinterpret_cast<uint16_t*>(row)[b] = static_cast<uint16_t>(d & 0xFFFFu);
      reinterpret_cast<uint16_t*>(row)[n + b] = static_cast<uint16_t>(d >> 16);
    } else {
      reinterpret_cast<uint32_t*>(row)[b] = d;
    }
  }
}

// ---- the 8-byte alpha section: a0, a1, then 6 bytes of 3-bit indices ---------------
// Read as two u32 words: w0 = a0 | a1 << 8 | index bytes 0-1 << 16, w1 = index
// bytes 2-5. It is the alpha half of a BC3 block and a whole BC4 block; a BC5 block
// is two of them. Transformed (dxt_lossless_transform_tpu/oracle/bc4.py), the
// endpoints of block b go to an endpoint stream as a0 | a1 << 8 u16 at 2b, or,
// split, a0 at b and a1 at n+b; its index bytes go to an index stream at 6b. Those
// streams start at offsets such as 2n or 10n, which are only 2-byte aligned for odd
// n (and n, 3n only 1-byte aligned), so these helpers store u16 and bytes, never
// through a uint32_t pointer.
template <bool SPLIT>
__device__ __forceinline__ void store_alpha_endpoints(uint8_t* out, int64_t n, int64_t b,
                                                      uint32_t w0) {
  if constexpr (SPLIT) {
    out[b] = static_cast<uint8_t>(w0 & 0xFFu);
    out[n + b] = static_cast<uint8_t>((w0 >> 8) & 0xFFu);
  } else {
    reinterpret_cast<uint16_t*>(out)[b] = static_cast<uint16_t>(w0 & 0xFFFFu);
  }
}

template <bool SPLIT>
__device__ __forceinline__ uint32_t load_alpha_endpoints(const uint8_t* in, int64_t n,
                                                         int64_t b) {
  if constexpr (SPLIT) {
    return static_cast<uint32_t>(in[b]) | (static_cast<uint32_t>(in[n + b]) << 8);
  } else {
    return reinterpret_cast<const uint16_t*>(in)[b];
  }
}

__device__ __forceinline__ void store_alpha_index(uint8_t* out, int64_t b, uint32_t w0,
                                                  uint32_t w1) {
  uint16_t* idx = reinterpret_cast<uint16_t*>(out) + 3 * b;
  idx[0] = static_cast<uint16_t>(w0 >> 16);
  idx[1] = static_cast<uint16_t>(w1 & 0xFFFFu);
  idx[2] = static_cast<uint16_t>(w1 >> 16);
}

// The section's words (w0, w1) from its endpoints `ep` (a0 | a1 << 8) and the index
// bytes of block b in the index stream at `in`.
__device__ __forceinline__ uint2 load_alpha_section(const uint8_t* in, int64_t b,
                                                    uint32_t ep) {
  const uint16_t* idx = reinterpret_cast<const uint16_t*>(in) + 3 * b;
  return make_uint2(ep | (static_cast<uint32_t>(idx[0]) << 16),
                    static_cast<uint32_t>(idx[1]) | (static_cast<uint32_t>(idx[2]) << 16));
}

// ---- byte ranges at any alignment, between shared and global memory ---------------
// The RGB layouts put channel planes at c*n, which may have any alignment. These copies move whole aligned 4-byte words in global memory,
// each assembled from two 4-byte words of the shared buffer with a funnel shift;
// only the up to 3 bytes at either end of the global range move one by one. Every
// thread of the thread block takes part; neighbouring threads take neighbouring
// words.

// Copies len bytes from shared `src` (4-byte aligned, and readable for 4 bytes past
// src + len) to global `dst`.
__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint8_t* src, int len) {
  const int head = min(len, static_cast<int>((4u - (reinterpret_cast<uintptr_t>(dst) & 3u)) & 3u));
  const int words = (len - head) >> 2;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  uint32_t* d = reinterpret_cast<uint32_t*>(dst + head);
  // word j of d holds bytes head + 4j .. head + 4j + 3 of src
  for (int j = threadIdx.x; j < words; j += blockDim.x) {
    d[j] = __funnelshift_r(s[j], s[j + 1], 8 * head);
  }
  for (int k = threadIdx.x; k < head; k += blockDim.x) dst[k] = src[k];
  for (int k = head + 4 * words + threadIdx.x; k < len; k += blockDim.x) dst[k] = src[k];
}

// Copies len bytes from global `src` to shared `dst` (4-byte aligned). `src` may
// have any alignment; the aligned words read are those that hold a byte of
// [src, src + len), so the range's allocation must start 4-byte aligned.
__device__ __forceinline__ void load_bytes(uint8_t* dst, const uint8_t* src, int len) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 3u);
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src - mis);
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  const int words = len >> 2;
  // word j of d holds bytes mis + 4j .. mis + 4j + 3 of the aligned words at s
  for (int j = threadIdx.x; j < words; j += blockDim.x) {
    d[j] = mis ? __funnelshift_r(s[j], s[j + 1], 8 * mis) : s[j];
  }
  for (int k = 4 * words + threadIdx.x; k < len; k += blockDim.x) dst[k] = src[k];
}

}  // namespace
