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
// Block b of n: the per-block body, which the rows kernel shares.
template <int V, bool SPLIT>
__device__ __forceinline__ void bc1_transform_block(const uint2* __restrict__ in,
                                                    uint8_t* __restrict__ out, int64_t n,
                                                    int64_t b) {
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

template <int V, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
bc1_transform_kernel(const uint2* __restrict__ in, uint8_t* __restrict__ out, int64_t n) {
  const int64_t b = global_thread();
  if (b >= n) return;
  bc1_transform_block<V, SPLIT>(in, out, n, b);
}

// ---- dlt_bc1_transform_rows --------------------------------------------------------
// The end of the batch pipeline's BC1 step: every file of a (B, 8·bucket) batch
// transformed under its own winner, in the per-file layout at its row's base (the
// rows form, common.cuh). Bound by bytes: 8·n_r read and written per row. Settings
// index variant * 2 + split (with_variant_split, as the per-file entry point).
__global__ void __launch_bounds__(kThreads)
bc1_transform_rows_kernel(const uint2* __restrict__ in, uint8_t* __restrict__ out,
                          const int64_t* __restrict__ ns, const int64_t* __restrict__ best,
                          int64_t bucket, uint64_t code, int64_t row0) {
  RowBlock rb;
  if (!row_block(ns, best, code, row0, rb)) return;
  const uint2* src = in + rb.row * bucket;
  uint8_t* dst = out + rb.row * 8 * bucket;
  with_variant_split(rb.settings, [&](auto s) {
    using S = decltype(s);
    bc1_transform_block<S::V, S::SPLIT>(src, dst, rb.n, rb.b);
  });
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
// Two kernels count. The generic one, ltu_counts_kernel, below: 4 bytes per
// position read from device memory once, and up to one gram compare per offset per
// position (fewer where a near offset matches first). The TPU kernel walked a sequential grid with a sliding two-tile window; here blocks
// run in any order, so each block stages its own 8 KiB tile plus the 4 KiB
// backward halo and a 3-byte lookahead in shared memory (halo bytes are read by
// two blocks, mostly from L2). A gram is two shared-memory words and one funnel
// shift. Each thread sums its positions in u32 (at most 32 positions of weight
// <= 255), the block sums through a shared atomic, and one 64-bit atomic per block
// adds to the row: integer sums, so the count is exact in any block order. The
// TPU kernel summed in f32, exact only below 2**24.
//
// The estimator's default ladder takes ltu_default_kernel (further below), which
// compiles the ladder in and is the one on every main path. Any other ladder takes
// ltu_counts_kernel: any ascending offsets and
// weights -255..255 from a table in device memory; an offset within the 4096-byte
// halo reads its gram from shared memory, one beyond it from global memory (two
// aligned 32-bit loads and a funnel shift, mostly L2 hits), and the sums are
// signed. Offsets that no position reaches are dropped by the wrapper, so every k
// in the table is below valid_len.
//
// dlt_ltu_counts_rows takes one valid length per row, from a device array: the
// per-row form of the TPU kernel (valid_rows in SMEM, pallas_ltu.py:302-323), which
// scores a whole batch of files of different lengths, each with its candidates, in
// one launch. It is either kernel with ROWS = true: each block reads its row's
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
constexpr int kHalo = 4096;                            // offsets read from shared memory
constexpr int kWinWords = (kHalo + kTile + 4) / 4 + 1; // halo, tile, lookahead
constexpr int64_t kMaxWeight = 255;
constexpr int64_t kMaxGridY = 65535;                   // rows per launch

// The offset table: k[0..n) then w[0..n), as int64, in device memory.
struct LtuTable {
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

// Stages `words` words of a row's window in shared memory: word w holds the row's
// bytes win0 + 4w .. win0 + 4w + 3 (win0 a multiple of 4), each byte before the row
// or at or past valid_len read as 0; neighbouring threads take neighbouring words.
// `aligned`: whether the row starts 4-byte aligned.
__device__ __forceinline__ void stage_words(uint32_t* win, const uint8_t* row, bool aligned,
                                            int64_t win0, int words, int64_t valid_len) {
  for (int w = threadIdx.x; w < words; w += kThreads) {
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
}

// With ROWS, valid_len is a device array of one length per row in place of the one
// length; with WIN (and ROWS), the count window.
template <bool ROWS, bool WIN = false>
using ValidLen = std::conditional_t<
    WIN, LtuWindow, std::conditional_t<ROWS, const int64_t* __restrict__, int64_t>>;

template <bool ROWS, bool WIN = false>
__global__ void __launch_bounds__(kThreads)
ltu_counts_kernel(const uint8_t* __restrict__ rows, int64_t row_len,
                  ValidLen<ROWS, WIN> valid, LtuTable offs,
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
  stage_words(win, row, aligned, win0, kWinWords, valid_len);
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
    for (int o = 0; o < offs.n; ++o) {
      const int64_t k = __ldg(offs.table + o);
      if (k > pos0 + i) break;  // ascending: no later offset reaches back far enough
      const uint32_t g = k <= kHalo ? gram_at(win, lp - static_cast<int>(k))
                                    : gram_global(row, i - k);
      if (g == gi) {
        local += static_cast<uint32_t>(__ldg(offs.table + offs.n + o));  // two's complement
        break;
      }
    }
  }
  atomicAdd(&block_sum, local);
  __syncthreads();
  if (threadIdx.x == 0 && block_sum != 0) {
    // |block sum| <= kTile * 255 < 2**31, so the signed sum sign-extends from 32 bits
    atomicAdd(&counts[blockIdx.y],
              static_cast<unsigned long long>(static_cast<int64_t>(static_cast<int32_t>(block_sum))));
  }
}

// ---- the default ladder ------------------------------------------------------------------
// Every LTU path of the estimator (the per-file searches, every batch and every mesh
// step) counts with the default ladder, estimate/ltu.py DEFAULT_OFFSETS with weights
// offset_weight(k); ltu_default_kernel counts it in all three forms (one length,
// per-row lengths, the window). The generic kernel above takes any other ladder
// (the port's first count kernel, as it read any ladder from device memory); no main
// path launches it.
//
// The count is bound by 32-bit integer issue. The generic kernel issues 13
// instructions per compare and 19 per position: one position per thread per
// iteration, the offset read from the parameter table, a 64-bit stream-head guard in
// every compare, each source gram built by two shared loads and a funnel shift by a
// variable amount, and a break on the first match, so that each warp runs as long as
// its slowest lane. Here:
//
// - each thread takes four consecutive positions, one word of the staged window: its
//   four grams come from two shared words by constant byte permutes, and for each
//   offset k the four source grams from the two or three words at k bytes back, by
//   permutes whose selectors, (-k) & 3 on, are constants, since the ladder is
//   compiled in (Rung<k, weight> below); neighbouring threads read neighbouring
//   words, so the shared loads are free of bank conflicts, and loads of the same word
//   for nearby offsets are shared;
// - the ladder is unrolled and branch-free inside each of four groups; a warp leaves
//   after a group once every lane has a match for each of its positions (one vote),
//   which keeps the early exit of the rows whose positions match near, without
//   divergence inside the warp. The nearest match wins: within a group the offsets
//   run far to near and a match overwrites, and the groups, near to far, merge by
//   max, since the weights do not grow with k;
// - the stream-head guard (a match at k needs global position >= k), which the
//   generic kernel tests in every compare, is tested only in a tile whose first
//   global position lies below the largest offset, 4096, at a row's head. A row too
//   short for the whole ladder is counted with the whole ladder all the same: an
//   offset k that no position of the row reaches (k >= valid_len - 3) matches only
//   where the guard zeroes it;
// - positions past the row's end carry a mark (kPastEnd) that counts as a match in
//   the vote and as 0 in the sum, so every lane runs the same code to the end;
// - the tile length is chosen per launch (default_tile_len, the one copy of the rule;
//   dlt_ltu_counts_shape reports it): the full 8192 positions, or fewer where tiles x
//   rows would fall short of the blocks the card holds at once, so that the windowed
//   launches of a mesh's shards (and any short launch) fill the card.
//
// Bound: 32-bit integer issue. The function needs at least a gram and an accumulate
// per position and a compare and a select per gram compare that the data needs (the
// nearest match first); 4 bytes per position from device memory (the 4096-byte halo
// again, from L2).
constexpr int kStep = 4 * kThreads;  // positions per pass of a block: a word per thread
constexpr uint32_t kPastEnd = 256;   // a position past the row's end; & 255 is 0

template <int K, uint32_t W>
struct Rung {};
template <typename... R>
struct Rungs {};

// The default ladder, in the groups after which a warp may stop, each nearest first.
using DefaultGroup0 = Rungs<Rung<1, 24>, Rung<2, 23>, Rung<3, 22>, Rung<4, 22>>;
using DefaultGroup1 = Rungs<Rung<5, 22>, Rung<6, 21>, Rung<8, 21>, Rung<12, 20>, Rung<16, 20>>;
using DefaultGroup2 = Rungs<Rung<24, 19>, Rung<32, 19>, Rung<48, 18>, Rung<64, 18>,
                            Rung<96, 17>, Rung<128, 17>>;
using DefaultGroup3 = Rungs<Rung<256, 16>, Rung<512, 15>, Rung<1024, 14>, Rung<2048, 13>,
                            Rung<4096, 12>>;
static_assert(kHalo == 4096, "the default ladder reaches the whole halo");

// The four bytes at byte offset S of the eight bytes lo | hi << 32.
template <int S>
__device__ __forceinline__ uint32_t bytes_at(uint32_t lo, uint32_t hi) {
  if constexpr (S == 0) {
    return lo;
  } else {
    return __byte_perm(lo, hi, 0x3210 + 0x1111 * S);
  }
}

// Offset K on the thread's four positions, at window words wi and wi + 1 (grams g):
// grp[j] becomes W where gram j equals the gram K bytes back (with GUARD, only where
// the global position gp + j reaches back that far). The source bytes start (-K) & 3
// bytes into word wi - ceil(K / 4).
template <int K, uint32_t W, bool GUARD>
__device__ __forceinline__ void match_rung(const uint32_t* win, int wi, const uint32_t (&g)[4],
                                           uint32_t (&grp)[4], int gp) {
  constexpr int kShift = (-K) & 3;
  const int sw = wi - (K + 3) / 4;
  const uint32_t s0 = win[sw], s1 = win[sw + 1];
  const uint32_t s2 = kShift >= 2 ? win[sw + 2] : 0u;
  const uint32_t src[4] = {
      kShift + 0 < 4 ? bytes_at<(kShift + 0) & 3>(s0, s1) : bytes_at<(kShift + 0) & 3>(s1, s2),
      kShift + 1 < 4 ? bytes_at<(kShift + 1) & 3>(s0, s1) : bytes_at<(kShift + 1) & 3>(s1, s2),
      kShift + 2 < 4 ? bytes_at<(kShift + 2) & 3>(s0, s1) : bytes_at<(kShift + 2) & 3>(s1, s2),
      kShift + 3 < 4 ? bytes_at<(kShift + 3) & 3>(s0, s1) : bytes_at<(kShift + 3) & 3>(s1, s2)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (g[j] == src[j] && (!GUARD || gp + j >= K)) grp[j] = W;
  }
}

// A group's rungs far to near, each match overwriting the farther ones'.
template <bool GUARD>
__device__ __forceinline__ void match_rungs(Rungs<>, const uint32_t*, int, const uint32_t (&)[4],
                                            uint32_t (&)[4], int) {}
template <bool GUARD, int K, uint32_t W, typename... R>
__device__ __forceinline__ void match_rungs(Rungs<Rung<K, W>, R...>, const uint32_t* win, int wi,
                                            const uint32_t (&g)[4], uint32_t (&grp)[4], int gp) {
  match_rungs<GUARD>(Rungs<R...>{}, win, wi, g, grp, gp);
  match_rung<K, W, GUARD>(win, wi, g, grp, gp);
}

// got[j] = the weight of position j's nearest match among the group's offsets, where
// it has none nearer.
template <bool GUARD, typename Group>
__device__ __forceinline__ void match_group(Group group, const uint32_t* win, int wi,
                                            const uint32_t (&g)[4], uint32_t (&got)[4], int gp) {
  uint32_t grp[4] = {0u, 0u, 0u, 0u};
  match_rungs<GUARD>(group, win, wi, g, grp, gp);
#pragma unroll
  for (int j = 0; j < 4; ++j) got[j] = max(got[j], grp[j]);
}

// Whether every position of every lane of the warp has its weight (or is past the end).
__device__ __forceinline__ bool warp_matched(const uint32_t (&got)[4]) {
  return __all_sync(0xffffffffu, min(min(got[0], got[1]), min(got[2], got[3])) != 0u);
}

// The weight of the thread's four positions at window word wi, whose global
// positions start at gp.
template <bool GUARD>
__device__ __forceinline__ uint32_t default_weights(const uint32_t* win, int wi,
                                                    uint32_t (&got)[4], int gp) {
  const uint32_t w0 = win[wi], w1 = win[wi + 1];
  const uint32_t g[4] = {w0, bytes_at<1>(w0, w1), bytes_at<2>(w0, w1), bytes_at<3>(w0, w1)};
  match_group<GUARD>(DefaultGroup0{}, win, wi, g, got, gp);
  if (!warp_matched(got)) {
    match_group<GUARD>(DefaultGroup1{}, win, wi, g, got, gp);
    if (!warp_matched(got)) {
      match_group<GUARD>(DefaultGroup2{}, win, wi, g, got, gp);
      if (!warp_matched(got)) match_group<GUARD>(DefaultGroup3{}, win, wi, g, got, gp);
    }
  }
  return (got[0] & 255u) + (got[1] & 255u) + (got[2] & 255u) + (got[3] & 255u);
}

// stage_words for the default kernel: a window inside the valid bytes of a 4-byte
// aligned row (every tile but a row's first and last) moves as whole words, four
// loads in flight a thread.
__device__ __forceinline__ void stage_window(uint32_t* win, const uint8_t* row, int64_t win0,
                                             int words, int64_t valid_len) {
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 3u) == 0;
  if (aligned && win0 >= 0 && win0 + 4 * static_cast<int64_t>(words) <= valid_len) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(row + win0);
#pragma unroll 4
    for (int w = threadIdx.x; w < words; w += kThreads) win[w] = __ldg(src + w);
    return;
  }
  stage_words(win, row, aligned, win0, words, valid_len);
}

// The default ladder's count, in the three forms of ltu_counts_kernel, with tiles of
// tile_len positions (a multiple of kStep, at most kTile).
template <bool ROWS, bool WIN = false>
__global__ void __launch_bounds__(kThreads)
ltu_default_kernel(const uint8_t* __restrict__ rows, int64_t row_len,
                   ValidLen<ROWS, WIN> valid, int tile_len,
                   unsigned long long* __restrict__ counts) {
  static_assert(ROWS || !WIN, "the window is a form of the per-row kernel");
  __shared__ uint32_t win[kWinWords];
  __shared__ uint32_t block_sum;
  const uint8_t* row = rows + static_cast<int64_t>(blockIdx.y) * row_len;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * tile_len + window_lo(valid);
  int64_t valid_len;  // in local positions: bytes at or past it read as 0
  if constexpr (WIN) {
    const int64_t shifted = valid.lengths[blockIdx.y] - valid.pos0;
    valid_len = shifted < row_len ? shifted : row_len;
    if (tile0 >= valid.hi || tile0 >= valid_len - 3) return;
  } else if constexpr (ROWS) {
    valid_len = valid[blockIdx.y];
    if (tile0 >= valid_len - 3) return;
  } else {
    valid_len = valid;
  }
  if (threadIdx.x == 0) block_sum = 0;
  stage_window(win, row, tile0 - kHalo, (kHalo + tile_len + 4) / 4 + 1, valid_len);
  __syncthreads();
  int64_t end = valid_len - 3;
  if constexpr (WIN) end = end < valid.hi ? end : valid.hi;
  // the tile's first global position; below the largest offset, the guard applies
  // (and then every position of the tile is below kHalo + kTile, so it fits an int)
  const int64_t first = window_pos0(valid) + tile0;
  const bool guard = first < kHalo;
  uint32_t local = 0;
  for (int base = 0; base < tile_len && tile0 + base < end; base += kStep) {
    const int t = base + 4 * static_cast<int>(threadIdx.x);
    uint32_t got[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) got[j] = tile0 + t + j < end ? 0u : kPastEnd;
    const int wi = (kHalo + t) >> 2;
    local += guard ? default_weights<true>(win, wi, got, static_cast<int>(first) + t)
                   : default_weights<false>(win, wi, got, 0);
  }
  local = __reduce_add_sync(0xffffffffu, local);
  if ((threadIdx.x & 31) == 0 && local != 0) atomicAdd(&block_sum, local);
  __syncthreads();
  if (threadIdx.x == 0 && block_sum != 0) atomicAdd(&counts[blockIdx.y], block_sum);
}

// The host's copy of the default ladder, in order, from the groups above.
inline void rung_table(Rungs<>, int64_t*, int64_t*, int&) {}
template <int K, uint32_t W, typename... R>
void rung_table(Rungs<Rung<K, W>, R...>, int64_t* ks, int64_t* ws, int& n) {
  ks[n] = K;
  ws[n] = W;
  ++n;
  rung_table(Rungs<R...>{}, ks, ws, n);
}

constexpr int kDefaultOffsets = 20;

// Whether (ks, ws), n entries, are the whole compiled-in ladder. A shorter ladder,
// its prefixes too, is the generic kernel's: the default kernel counts every rung.
bool default_ladder(const int64_t* ks, const int64_t* ws, int64_t n) {
  int64_t dk[kDefaultOffsets], dw[kDefaultOffsets];
  int m = 0;
  rung_table(DefaultGroup0{}, dk, dw, m);
  rung_table(DefaultGroup1{}, dk, dw, m);
  rung_table(DefaultGroup2{}, dk, dw, m);
  rung_table(DefaultGroup3{}, dk, dw, m);
  if (n != m) return false;
  for (int64_t o = 0; o < n; ++o) {
    if (ks[o] != dk[o] || ws[o] != dw[o]) return false;
  }
  return true;
}

// Blocks of ltu_default_kernel<ROWS, WIN> that the card holds at once: blocks per SM
// at kThreads threads (its static shared memory and registers) times the SMs, read
// once per process. 0 when the runtime cannot say.
template <bool ROWS, bool WIN>
int64_t default_resident() {
  static const int64_t resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ltu_default_kernel<ROWS, WIN>, kThreads, 0) != cudaSuccess) {
      cudaGetLastError();
      return int64_t{0};
    }
    return static_cast<int64_t>(per_sm) * sms;
  }();
  return resident;
}

// The tile length of a launch over `positions` positions of `rows` rows: kTile, or,
// where its tiles x rows fall short of the `resident` blocks, positions x rows /
// resident rounded down to a multiple of kStep (at least kStep), so that the grid
// covers them.
int64_t default_tile_len(int64_t positions, int64_t rows, int64_t resident) {
  const int64_t tiles = (positions + kTile - 1) / kTile;
  if (tiles * rows >= resident) return kTile;
  const int64_t fit = positions * rows / resident / kStep * kStep;
  return std::max<int64_t>(kStep, std::min<int64_t>(fit, kTile));
}

}  // namespace

// ---- C entry points --------------------------------------------------------------------
extern "C" {

int dlt_bc1_transform(const void* in, void* out, int64_t n, int64_t variant,
                      int64_t split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || variant < 0 || variant > 3) return cudaErrorInvalidValue;
  return with_variant_split(variant_split_index(variant, split), [&](auto s) {
    using S = decltype(s);
    return launch_transform<S::V, S::SPLIT>(in, out, n, st);
  });
}

int dlt_bc1_transform_rows(const void* in, void* out, const void* ns, const void* best,
                           int64_t rows, int64_t bucket, int64_t code, int64_t n_cand,
                           void* stream) {
  if (!rows_args_valid(rows, bucket, n_cand)) return cudaErrorInvalidValue;
  return launch_rows<uint2>(bc1_transform_rows_kernel, in, out, ns, best, rows, bucket,
                            code, static_cast<cudaStream_t>(stream));
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
// -255..255). The caller chooses the kernel: with a table in device memory (the same
// values, k then w, int64) ltu_counts_kernel reads it; without one (`fast`),
// ltu_default_kernel counts its compiled-in ladder, and the arrays must hold that
// whole ladder.
cudaError_t ltu_offsets(const void* offsets, const void* weights, int64_t n_offsets,
                        const void* table, bool* fast) {
  if (n_offsets < 0 || n_offsets > INT32_MAX / 2) return cudaErrorInvalidValue;
  const int64_t* ks = static_cast<const int64_t*>(offsets);
  const int64_t* ws = static_cast<const int64_t*>(weights);
  for (int64_t o = 0; o < n_offsets; ++o) {
    const bool ascending = o == 0 || ks[o] > ks[o - 1];
    if (ks[o] < 1 || !ascending || ws[o] < -kMaxWeight || ws[o] > kMaxWeight) {
      return cudaErrorInvalidValue;
    }
  }
  *fast = table == nullptr;
  return !*fast || default_ladder(ks, ws, n_offsets) ? cudaSuccess : cudaErrorInvalidValue;
}

// The default kernel's tile length for a launch over `positions` positions of
// n_rows rows (a group of at most kMaxGridY of them at a time).
template <bool ROWS, bool WIN>
int64_t default_tile(int64_t n_rows, int64_t positions) {
  return default_tile_len(positions, std::min(n_rows, kMaxGridY),
                          default_resident<ROWS, WIN>());
}

// Zeroes the counts and launches the kernel once per group of kMaxGridY rows
// (grid.y holds the rows), with enough tiles for `positions` positions (from the
// window's lo with WIN). `valid` is the one length, (ROWS) the device array of
// n_rows lengths, or (WIN) the window over such an array.
template <bool ROWS, bool WIN = false>
cudaError_t launch_counts(const void* rows, void* counts, int64_t n_rows, int64_t row_len,
                          ValidLen<ROWS, WIN> valid, int64_t positions, bool fast,
                          const LtuTable& ladder, cudaStream_t st) {
  cudaError_t rc = cudaMemsetAsync(counts, 0, n_rows * sizeof(unsigned long long), st);
  if (rc != cudaSuccess) return rc;
  const int64_t tile_len = fast ? default_tile<ROWS, WIN>(n_rows, positions) : kTile;
  const unsigned tiles = static_cast<unsigned>((positions + tile_len - 1) / tile_len);
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
    if (fast) {
      ltu_default_kernel<ROWS, WIN><<<grid, kThreads, 0, st>>>(
          group, row_len, group_valid, static_cast<int>(tile_len), group_counts);
    } else {
      ltu_counts_kernel<ROWS, WIN><<<grid, kThreads, 0, st>>>(
          group, row_len, group_valid, ladder, group_counts);
    }
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// offsets and weights: host arrays of n_offsets int64 each, checked here. table:
// the same values in device memory (k then w, int64), which ltu_counts_kernel reads;
// null for the whole default ladder, which ltu_default_kernel compiles in (the
// caller decides by the same rule).
int dlt_ltu_counts(const void* rows, void* counts, int64_t n_rows, int64_t row_len,
                   int64_t valid_len, const void* offsets, const void* weights,
                   int64_t n_offsets, const void* table, void* stream) {
  if (n_rows <= 0 || valid_len < 0 || valid_len > row_len) return cudaErrorInvalidValue;
  bool fast = false;
  cudaError_t rc = ltu_offsets(offsets, weights, n_offsets, table, &fast);
  if (rc != cudaSuccess) return rc;
  const LtuTable ladder = {static_cast<const int64_t*>(table),
                           static_cast<int32_t>(n_offsets)};
  return launch_counts<false>(rows, counts, n_rows, row_len, valid_len,
                              valid_len > 3 ? valid_len - 3 : 1, fast, ladder,
                              static_cast<cudaStream_t>(stream));
}

// As dlt_ltu_counts, with valid_rows a device array of n_rows int64 lengths, each in
// [0, row_len], and max_valid their largest, which sizes the grid; the caller checks
// both (the lengths are not read on the host).
int dlt_ltu_counts_rows(const void* rows, void* counts, int64_t n_rows, int64_t row_len,
                        const void* valid_rows, int64_t max_valid, const void* offsets,
                        const void* weights, int64_t n_offsets, const void* table,
                        void* stream) {
  if (n_rows <= 0 || valid_rows == nullptr || max_valid < 0 || max_valid > row_len) {
    return cudaErrorInvalidValue;
  }
  bool fast = false;
  cudaError_t rc = ltu_offsets(offsets, weights, n_offsets, table, &fast);
  if (rc != cudaSuccess) return rc;
  const LtuTable ladder = {static_cast<const int64_t*>(table),
                           static_cast<int32_t>(n_offsets)};
  return launch_counts<true>(rows, counts, n_rows, row_len,
                             static_cast<const int64_t*>(valid_rows),
                             max_valid > 3 ? max_valid - 3 : 1, fast, ladder,
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
                            const void* table, void* stream) {
  if (n_rows <= 0 || valid_rows == nullptr || lo < 0 || lo % 4 != 0 || hi < lo ||
      hi + 3 > row_len) {
    return cudaErrorInvalidValue;
  }
  bool fast = false;
  cudaError_t rc = ltu_offsets(offsets, weights, n_offsets, table, &fast);
  if (rc != cudaSuccess) return rc;
  if (n_offsets > 0 && static_cast<const int64_t*>(offsets)[n_offsets - 1] > lo) {
    return cudaErrorInvalidValue;
  }
  const LtuTable ladder = {static_cast<const int64_t*>(table),
                           static_cast<int32_t>(n_offsets)};
  const LtuWindow window = {static_cast<const int64_t*>(valid_rows), pos0, lo, hi};
  return launch_counts<true, true>(rows, counts, n_rows, row_len, window,
                                   hi > lo ? hi - lo : 1, fast, ladder,
                                   static_cast<cudaStream_t>(stream));
}

// The default-ladder kernel's launch over `positions` counted positions of n_rows
// rows, in form 0 (dlt_ltu_counts), 1 (dlt_ltu_counts_rows) or 2
// (dlt_ltu_counts_windowed): out[0] its tile length, out[1] and out[2] the first
// launch's grid, out[3] the blocks the card holds at once. Launches nothing.
int dlt_ltu_counts_shape(int64_t n_rows, int64_t positions, int64_t form, int64_t* out) {
  if (n_rows <= 0 || positions <= 0 || form < 0 || form > 2) return cudaErrorInvalidValue;
  if (form == 0) {
    out[0] = default_tile<false, false>(n_rows, positions);
    out[3] = default_resident<false, false>();
  } else if (form == 1) {
    out[0] = default_tile<true, false>(n_rows, positions);
    out[3] = default_resident<true, false>();
  } else {
    out[0] = default_tile<true, true>(n_rows, positions);
    out[3] = default_resident<true, true>();
  }
  out[1] = (positions + out[0] - 1) / out[0];
  out[2] = std::min(n_rows, kMaxGridY);
  return cudaSuccess;
}

}  // extern "C"
