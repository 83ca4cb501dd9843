// The BC1 kernels and the LTU coverage count, for sm_90a.
//
// Built with the other sources by one nvcc call into one shared library with a plain
// C interface (dxt_lossless_transform_tpu_torch/backend.py) and called through
// ctypes. Every entry point launches on the stream it is given, allocates nothing
// (the Python wrapper allocates each output with torch.empty) and returns
// cudaGetLastError().
//
// Byte layouts are the on-disk ones (little-endian, as is the card):
//   BC1 block b:       u32 colour word c0 | c1 << 16 at 8b, u32 index word at 8b+4
//   transformed, interleaved: colour words at [0,4n), index words at [4n,8n)
//   transformed, split:       c0 u16 at [0,2n), c1 u16 at [2n,4n), indices at [4n,8n)
// n may be any block count (odd, or 1); nothing is padded.

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

// ---- dlt_bc1_transform -----------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/shuffle.py:157 bc1_transform_tpu
// (kernel _bc1_t_kernel). Bound by bytes: 8n read, 8n written, ~20 integer
// operations per block. One thread per block: one 8-byte load, then 2- and 4-byte
// stores that neighbouring threads make to neighbouring addresses, so each warp
// writes whole 64- and 128-byte segments. The TPU kernel's transposes and
// even/odd packing existed for the TPU's (8, 128) tiles and have no counterpart.
template <int V, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
bc1_transform_kernel(const uint2* __restrict__ in, uint8_t* __restrict__ out, int64_t n) {
  const int64_t b = global_thread();
  if (b >= n) return;
  const uint2 blk = in[b];
  const uint32_t d = decorrelate_pair<V>(blk.x);
  if constexpr (SPLIT) {
    reinterpret_cast<uint16_t*>(out)[b] = static_cast<uint16_t>(d & 0xFFFFu);
    reinterpret_cast<uint16_t*>(out + 2 * n)[b] = static_cast<uint16_t>(d >> 16);
  } else {
    reinterpret_cast<uint32_t*>(out)[b] = d;
  }
  reinterpret_cast<uint32_t*>(out + 4 * n)[b] = blk.y;
}

// ---- dlt_bc1_untransform -----------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/shuffle.py:185 bc1_untransform_tpu
// (kernel _bc1_u_kernel), the kernel of the load path. Bound by bytes as the
// transform is; the exact inverse, with one 8-byte store per block.
template <int V, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
bc1_untransform_kernel(const uint8_t* __restrict__ in, uint2* __restrict__ out, int64_t n) {
  const int64_t b = global_thread();
  if (b >= n) return;
  uint32_t d;
  if constexpr (SPLIT) {
    d = static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(in)[b])
        | (static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(in + 2 * n)[b]) << 16);
  } else {
    d = reinterpret_cast<const uint32_t*>(in)[b];
  }
  out[b] = make_uint2(recorrelate_pair<V>(d),
                      reinterpret_cast<const uint32_t*>(in + 4 * n)[b]);
}

template <int V, bool S>
cudaError_t launch_transform(const void* in, void* out, int64_t n, cudaStream_t st) {
  bc1_transform_kernel<V, S><<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const uint2*>(in), static_cast<uint8_t*>(out), n);
  return cudaGetLastError();
}

template <int V, bool S>
cudaError_t launch_untransform(const void* in, void* out, int64_t n, cudaStream_t st) {
  bc1_untransform_kernel<V, S><<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(in), static_cast<uint2*>(out), n);
  return cudaGetLastError();
}

// ---- dlt_bc1_regions -----------------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/regions.py:60 bc1_region_streams_tpu
// (kernel _bc1_regions_kernel). Row c of out (u8[C, 4n]) is candidate c's colour
// region, exactly the bytes its transform writes at [0, 4n):
//   interleaved: d0 | d1 << 16 as u32 at word b;  split: d0 u16 at b, d1 u16 at n+b.
// Candidate c is 4 bits of `code`: variant in bits 0-1, split in bit 2.
// Bound by bytes: 8n read (the index words ride along in the 8-byte load, which
// costs less than a strided 4-byte load), 4n written per candidate. One thread
// per block decorrelates its colour word once per variant and writes every row
// (write_colour_rows in common.cuh, which the BC3 region kernel shares).
__global__ void __launch_bounds__(kThreads)
bc1_regions_kernel(const uint2* __restrict__ in, uint8_t* __restrict__ out, int64_t n,
                   uint32_t code, int n_cand) {
  const int64_t b = global_thread();
  if (b >= n) return;
  write_colour_rows(in[b].x, out, n, b, code, n_cand);
}

// ---- dlt_ltu_counts ------------------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/estimate/pallas_ltu.py:302
// coverage_scores_pallas (_counts_call :262, kernels _make_kernel :177 for u8 rows
// and _make_kernel_packed :71 for u32 rows; u32 rows reach this kernel as their
// bytes). For each row c and each position i < valid_len - 3, with
// gram(i) = bytes i..i+3 as a little-endian u32, position i is worth weight[o] of
// the FIRST offset o (offsets ascending) with i >= k[o] and gram(i) == gram(i-k[o]),
// and nothing if there is none. counts[c] = sum over i, exact (u64).
//
// Bound: 4 bytes per position read from device memory once, and up to one gram
// compare per offset per position (fewer where a near offset matches first). The
// TPU kernel walked a sequential grid with a sliding two-tile window; here blocks
// run in any order, so each block stages its own 8 KiB tile plus the 4 KiB
// backward halo and a 3-byte lookahead in shared memory (halo bytes are read by
// two blocks, mostly from L2). A gram is two shared-memory words and one funnel
// shift. Each thread sums its positions in u32 (at most 32 positions of weight
// <= 255), the block sums through a shared atomic, and one 64-bit atomic per block
// adds to the row: integer sums, so the count is exact in any block order. The
// TPU kernel summed in f32, exact only below 2**24.
//
// Two instantiations. The near one (FAR = false) is the estimator's default: at
// most 32 offsets, all within the 4096-byte halo, weights 0-255, the table passed
// by value in the kernel's parameters. The far one takes any ascending offsets and
// weights -255..255 from a table in device memory; an offset beyond the halo reads
// its gram from global memory (two aligned 32-bit loads and a funnel shift, mostly
// L2 hits), and the sums are signed. Offsets that no position reaches are dropped
// by the wrapper, so every k in the table is below valid_len.
//
// dlt_ltu_counts_rows takes one valid length per row, from a device array: the
// per-row form of the TPU kernel (valid_rows in SMEM, pallas_ltu.py:302-323), which
// scores a whole batch of files of different lengths, each with its candidates, in
// one launch. It is the same kernel with ROWS = true: each block reads its row's
// length, and a block whose tile starts at or past that row's last position returns
// before it stages anything, so the grid, sized for the longest row, costs the
// shorter rows one early exit per tile. With ROWS = false the body is the scalar
// kernel's, instruction for instruction.
//
// dlt_ltu_counts_windowed replaces dxt_lossless_transform_tpu/estimate/pallas_ltu.py:328
// coverage_counts_windowed (_counts_call with the count window of _make_kernel
// :177-259), the per-shard partial count of the multi-device scorer. Each row is one
// shard's chunk of a global row with a halo on each side, [halo | chunk | halo], and
// pos0 is the global position of its local byte 0 (chunk start - halo, negative for
// the first shard). Local positions i in [lo, hi) (the chunk) are counted where
// pos0 + i < valid - 3 (valid: the row's global length), and a match at offset k
// needs pos0 + i >= k, the stream-head guard on global positions; summed over the
// shards, the counts are the unsharded row's. It is the per-row kernel with WIN =
// true: the tiles start at lo, the row's local valid length is valid - pos0, and the
// guard adds pos0. Its bound is the per-row kernel's over the counted positions,
// plus each block's halo bytes read; the halo in front of a tile is at least the
// largest offset (lo >= k), so a far offset reads its gram from the row in global
// memory as before, never before the row's start. Same instantiations for WIN =
// false as before: the window's terms fold to the per-row ones (0 and no cap).
constexpr int kTile = 8192;                            // positions per block
constexpr int kHalo = 4096;                            // largest near offset
constexpr int kWinWords = (kHalo + kTile + 4) / 4 + 1; // halo, tile, lookahead
constexpr int kMaxOffsets = 32;
constexpr int64_t kMaxWeight = 255;
constexpr int64_t kMaxGridY = 65535;                   // rows per launch

struct LtuOffsets {
  int32_t k[kMaxOffsets];
  uint32_t w[kMaxOffsets];
  int32_t n;
};

// The far table: k[0..n) then w[0..n), as int64, in device memory.
struct LtuFarOffsets {
  const int64_t* table;
  int32_t n;
};

// The count window of dlt_ltu_counts_windowed: each row's global valid length (a
// device array), the global position of local byte 0, and the local positions
// [lo, hi) that are counted.
struct LtuWindow {
  const int64_t* lengths;
  int64_t pos0, lo, hi;
};

// Local position of the first tile, and the global position of local byte 0: 0 for
// every form but the window.
template <typename V>
__device__ __forceinline__ int64_t window_lo(const V&) { return 0; }
__device__ __forceinline__ int64_t window_lo(const LtuWindow& w) { return w.lo; }
template <typename V>
__device__ __forceinline__ int64_t window_pos0(const V&) { return 0; }
__device__ __forceinline__ int64_t window_pos0(const LtuWindow& w) { return w.pos0; }

__device__ __forceinline__ uint32_t gram_at(const uint32_t* win, int p) {
  return __funnelshift_r(win[p >> 2], win[(p >> 2) + 1], (p & 3) * 8);
}

// gram(p) of a row from global memory, for any alignment of row + p. Both aligned
// words hold a byte of the gram (the second is read only when the gram crosses
// into it), so neither reaches past the allocation.
__device__ __forceinline__ uint32_t gram_global(const uint8_t* row, int64_t p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(row) + static_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
  const unsigned sh = static_cast<unsigned>(a & 3u) * 8u;
  return __funnelshift_r(__ldg(w), sh ? __ldg(w + 1) : 0u, sh);
}

// The near instantiation's parameters are those of the one kernel before the far
// one existed, (rows, row_len, valid_len, LtuOffsets, counts); the far one takes
// LtuFarOffsets in place of LtuOffsets. With ROWS, valid_len is a device array of
// one length per row in place of the one length; with WIN (and ROWS), the count
// window.
template <bool FAR>
using OffsetTable = std::conditional_t<FAR, LtuFarOffsets, LtuOffsets>;
template <bool ROWS, bool WIN = false>
using ValidLen = std::conditional_t<
    WIN, LtuWindow, std::conditional_t<ROWS, const int64_t* __restrict__, int64_t>>;

template <bool FAR, bool ROWS, bool WIN = false>
__global__ void __launch_bounds__(kThreads)
ltu_counts_kernel(const uint8_t* __restrict__ rows, int64_t row_len,
                  ValidLen<ROWS, WIN> valid, OffsetTable<FAR> offs,
                  unsigned long long* __restrict__ counts) {
  static_assert(ROWS || !WIN, "the window is a form of the per-row kernel");
  __shared__ uint32_t win[kWinWords];
  __shared__ uint32_t block_sum;
  const uint8_t* row = rows + static_cast<int64_t>(blockIdx.y) * row_len;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile + window_lo(valid);
  int64_t valid_len;  // in local positions: bytes at or past it read as 0
  if constexpr (WIN) {
    const int64_t shifted = valid.lengths[blockIdx.y] - valid.pos0;
    valid_len = shifted < row_len ? shifted : row_len;
    if (tile0 >= valid.hi || tile0 >= valid_len - 3) return;
  } else if constexpr (ROWS) {
    valid_len = valid[blockIdx.y];
    if (tile0 >= valid_len - 3) return;  // the whole block: no position of this row
  } else {
    valid_len = valid;
  }
  const int64_t win0 = tile0 - kHalo;  // a multiple of 4
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 3u) == 0;
  if (threadIdx.x == 0) block_sum = 0;
  for (int w = threadIdx.x; w < kWinWords; w += kThreads) {
    const int64_t g = win0 + 4 * static_cast<int64_t>(w);
    uint32_t v = 0;
    if (aligned && g >= 0 && g + 4 <= valid_len) {
      v = *reinterpret_cast<const uint32_t*>(row + g);
    } else {
      for (int j = 0; j < 4; ++j) {
        if (g + j >= 0 && g + j < valid_len) v |= static_cast<uint32_t>(row[g + j]) << (8 * j);
      }
    }
    win[w] = v;
  }
  __syncthreads();
  int64_t end = valid_len - 3;  // positions i < end have a whole gram
  if constexpr (WIN) end = end < valid.hi ? end : valid.hi;
  const int64_t pos0 = window_pos0(valid);  // the guard works on global positions
  uint32_t local = 0;
  for (int t = threadIdx.x; t < kTile; t += kThreads) {
    const int64_t i = tile0 + t;
    if (i >= end) break;
    const int lp = kHalo + t;
    const uint32_t gi = gram_at(win, lp);
    if constexpr (!FAR) {
      for (int o = 0; o < offs.n; ++o) {
        const int k = offs.k[o];
        if (k > pos0 + i) break;  // ascending: no later offset reaches back far enough
        if (gram_at(win, lp - k) == gi) {
          local += offs.w[o];
          break;
        }
      }
    } else {
      for (int o = 0; o < offs.n; ++o) {
        const int64_t k = __ldg(offs.table + o);
        if (k > pos0 + i) break;
        const uint32_t g = k <= kHalo ? gram_at(win, lp - static_cast<int>(k))
                                      : gram_global(row, i - k);
        if (g == gi) {
          local += static_cast<uint32_t>(__ldg(offs.table + offs.n + o));  // two's complement
          break;
        }
      }
    }
  }
  atomicAdd(&block_sum, local);
  __syncthreads();
  if (threadIdx.x == 0 && block_sum != 0) {
    // |block sum| <= kTile * 255 < 2**31, so the far sum sign-extends from 32 bits
    const unsigned long long add =
        FAR ? static_cast<unsigned long long>(static_cast<int64_t>(static_cast<int32_t>(block_sum)))
            : static_cast<unsigned long long>(block_sum);
    atomicAdd(&counts[blockIdx.y], add);
  }
}

}  // namespace

// ---- C entry points --------------------------------------------------------------------
extern "C" {

int dlt_bc1_transform(const void* in, void* out, int64_t n, int64_t variant,
                      int64_t split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || variant < 0 || variant > 3) return cudaErrorInvalidValue;
  switch (variant * 2 + (split ? 1 : 0)) {
    case 0: return launch_transform<0, false>(in, out, n, st);
    case 1: return launch_transform<0, true>(in, out, n, st);
    case 2: return launch_transform<1, false>(in, out, n, st);
    case 3: return launch_transform<1, true>(in, out, n, st);
    case 4: return launch_transform<2, false>(in, out, n, st);
    case 5: return launch_transform<2, true>(in, out, n, st);
    case 6: return launch_transform<3, false>(in, out, n, st);
    default: return launch_transform<3, true>(in, out, n, st);
  }
}

int dlt_bc1_untransform(const void* in, void* out, int64_t n, int64_t variant,
                        int64_t split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || variant < 0 || variant > 3) return cudaErrorInvalidValue;
  switch (variant * 2 + (split ? 1 : 0)) {
    case 0: return launch_untransform<0, false>(in, out, n, st);
    case 1: return launch_untransform<0, true>(in, out, n, st);
    case 2: return launch_untransform<1, false>(in, out, n, st);
    case 3: return launch_untransform<1, true>(in, out, n, st);
    case 4: return launch_untransform<2, false>(in, out, n, st);
    case 5: return launch_untransform<2, true>(in, out, n, st);
    case 6: return launch_untransform<3, false>(in, out, n, st);
    default: return launch_untransform<3, true>(in, out, n, st);
  }
}

int dlt_bc1_regions(const void* in, void* out, int64_t n, int64_t code, int64_t n_cand,
                    void* stream) {
  if (n <= 0 || n_cand <= 0 || n_cand > 8) return cudaErrorInvalidValue;
  bc1_regions_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(in), static_cast<uint8_t*>(out), n,
      static_cast<uint32_t>(code), static_cast<int>(n_cand));
  return cudaGetLastError();
}

}  // extern "C"

namespace {

// Checks the host offset and weight arrays (ascending offsets >= 1, weights
// -255..255) and decides the instantiation: the near one takes at most 32 offsets
// up to 4096 and weights 0-255, by value in `offs`; any other ladder needs the far
// table in device memory (k then w, int64), which the caller passes exactly when
// the same rule says far.
cudaError_t ltu_offsets(const void* offsets, const void* weights, int64_t n_offsets,
                        const void* far_table, bool* near, LtuOffsets* offs) {
  if (n_offsets < 0 || n_offsets > INT32_MAX / 2) return cudaErrorInvalidValue;
  const int64_t* ks = static_cast<const int64_t*>(offsets);
  const int64_t* ws = static_cast<const int64_t*>(weights);
  *near = n_offsets <= kMaxOffsets;
  for (int64_t o = 0; o < n_offsets; ++o) {
    const bool ascending = o == 0 || ks[o] > ks[o - 1];
    if (ks[o] < 1 || !ascending || ws[o] < -kMaxWeight || ws[o] > kMaxWeight) {
      return cudaErrorInvalidValue;
    }
    *near = *near && ks[o] <= kHalo && ws[o] >= 0;
  }
  if (*near != (far_table == nullptr)) return cudaErrorInvalidValue;
  *offs = {};
  if (*near) {
    offs->n = static_cast<int32_t>(n_offsets);
    for (int64_t o = 0; o < n_offsets; ++o) {
      offs->k[o] = static_cast<int32_t>(ks[o]);
      offs->w[o] = static_cast<uint32_t>(ws[o]);
    }
  }
  return cudaSuccess;
}

// Zeroes the counts and launches the kernel once per group of kMaxGridY rows
// (grid.y holds the rows), with enough tiles for `positions` positions (from the
// window's lo with WIN). `valid` is the one length, (ROWS) the device array of
// n_rows lengths, or (WIN) the window over such an array.
template <bool ROWS, bool WIN = false>
cudaError_t launch_counts(const void* rows, void* counts, int64_t n_rows, int64_t row_len,
                          ValidLen<ROWS, WIN> valid, int64_t positions, bool near,
                          const LtuOffsets& offs, const LtuFarOffsets& far,
                          cudaStream_t st) {
  cudaError_t rc = cudaMemsetAsync(counts, 0, n_rows * sizeof(unsigned long long), st);
  if (rc != cudaSuccess) return rc;
  const unsigned tiles = static_cast<unsigned>((positions + kTile - 1) / kTile);
  for (int64_t r0 = 0; r0 < n_rows; r0 += kMaxGridY) {
    const dim3 grid(tiles, static_cast<unsigned>(std::min(n_rows - r0, kMaxGridY)));
    const uint8_t* group = static_cast<const uint8_t*>(rows) + r0 * row_len;
    unsigned long long* group_counts = static_cast<unsigned long long*>(counts) + r0;
    ValidLen<ROWS, WIN> group_valid = valid;
    if constexpr (WIN) {
      group_valid.lengths = valid.lengths + r0;
    } else if constexpr (ROWS) {
      group_valid = valid + r0;
    }
    if (near) {
      ltu_counts_kernel<false, ROWS, WIN><<<grid, kThreads, 0, st>>>(
          group, row_len, group_valid, offs, group_counts);
    } else {
      ltu_counts_kernel<true, ROWS, WIN><<<grid, kThreads, 0, st>>>(
          group, row_len, group_valid, far, group_counts);
    }
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// offsets and weights: host arrays of n_offsets int64 each, checked here. far_table:
// the same values in device memory (k then w, int64), which the far instantiation
// reads; null when the near one takes them (at most 32 offsets up to 4096, weights
// 0-255), which the caller decides by the same rule.
int dlt_ltu_counts(const void* rows, void* counts, int64_t n_rows, int64_t row_len,
                   int64_t valid_len, const void* offsets, const void* weights,
                   int64_t n_offsets, const void* far_table, void* stream) {
  if (n_rows <= 0 || valid_len < 0 || valid_len > row_len) return cudaErrorInvalidValue;
  bool near = false;
  LtuOffsets offs;
  cudaError_t rc = ltu_offsets(offsets, weights, n_offsets, far_table, &near, &offs);
  if (rc != cudaSuccess) return rc;
  const LtuFarOffsets far = {static_cast<const int64_t*>(far_table),
                             static_cast<int32_t>(n_offsets)};
  return launch_counts<false>(rows, counts, n_rows, row_len, valid_len,
                              valid_len > 3 ? valid_len - 3 : 1, near, offs, far,
                              static_cast<cudaStream_t>(stream));
}

// As dlt_ltu_counts, with valid_rows a device array of n_rows int64 lengths, each in
// [0, row_len], and max_valid their largest, which sizes the grid; the caller checks
// both (the lengths are not read on the host).
int dlt_ltu_counts_rows(const void* rows, void* counts, int64_t n_rows, int64_t row_len,
                        const void* valid_rows, int64_t max_valid, const void* offsets,
                        const void* weights, int64_t n_offsets, const void* far_table,
                        void* stream) {
  if (n_rows <= 0 || valid_rows == nullptr || max_valid < 0 || max_valid > row_len) {
    return cudaErrorInvalidValue;
  }
  bool near = false;
  LtuOffsets offs;
  cudaError_t rc = ltu_offsets(offsets, weights, n_offsets, far_table, &near, &offs);
  if (rc != cudaSuccess) return rc;
  const LtuFarOffsets far = {static_cast<const int64_t*>(far_table),
                             static_cast<int32_t>(n_offsets)};
  return launch_counts<true>(rows, counts, n_rows, row_len,
                             static_cast<const int64_t*>(valid_rows),
                             max_valid > 3 ? max_valid - 3 : 1, near, offs, far,
                             static_cast<cudaStream_t>(stream));
}

// As dlt_ltu_counts_rows, on the windows of one shard: valid_rows holds each row's
// global valid length (a device array, not read on the host), pos0 the global
// position of local byte 0, and the local positions [lo, hi) are counted. lo must
// be a multiple of 4 and at least the largest offset, and hi + 3 at most row_len,
// so that every gram and every offset's source lies in the row.
int dlt_ltu_counts_windowed(const void* rows, void* counts, int64_t n_rows, int64_t row_len,
                            const void* valid_rows, int64_t pos0, int64_t lo, int64_t hi,
                            const void* offsets, const void* weights, int64_t n_offsets,
                            const void* far_table, void* stream) {
  if (n_rows <= 0 || valid_rows == nullptr || lo < 0 || lo % 4 != 0 || hi < lo ||
      hi + 3 > row_len) {
    return cudaErrorInvalidValue;
  }
  bool near = false;
  LtuOffsets offs;
  cudaError_t rc = ltu_offsets(offsets, weights, n_offsets, far_table, &near, &offs);
  if (rc != cudaSuccess) return rc;
  if (n_offsets > 0 && static_cast<const int64_t*>(offsets)[n_offsets - 1] > lo) {
    return cudaErrorInvalidValue;
  }
  const LtuFarOffsets far = {static_cast<const int64_t*>(far_table),
                             static_cast<int32_t>(n_offsets)};
  const LtuWindow window = {static_cast<const int64_t*>(valid_rows), pos0, lo, hi};
  return launch_counts<true, true>(rows, counts, n_rows, row_len, window,
                                   hi > lo ? hi - lo : 1, near, offs, far,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
