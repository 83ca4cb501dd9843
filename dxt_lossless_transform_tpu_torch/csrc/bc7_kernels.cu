// The BC7 and BC6H mode-sort kernels of the BC7/BC6H DDS auto-transform and load
// path, for sm_90a.
//
// Built with the other sources by one nvcc call into one shared library with a
// plain C interface (dxt_lossless_transform_tpu_torch/backend.py) and called
// through ctypes. Every entry point launches on the stream it is given, allocates
// nothing and returns cudaGetLastError().
//
// Byte layouts are the on-disk ones (dxt_lossless_transform_tpu/oracle/bc7.py). A
// block is 16 bytes; its mode id comes from byte 0: for BC7 the count of trailing
// zero bits (8 for byte 0 == 0, an invalid block), for BC6H the grouping id of
// oracle/bc6h.py (0-14). For n blocks, transformed:
//   sort:    [0, m) the mode stream, m = ceil(n/2): block i's id in the low (even
//            i) or high (odd i) nibble of byte i/2, the high nibble of an odd last
//            block 0; then the 16n payload bytes at m;
//   no sort: the 16n payload bytes at 0.
// The payload holds the blocks, stably sorted by mode id within each chunk of 4096
// blocks (the ragged last chunk on its own) when sorting, either as 16-byte blocks
// or as 16 byte planes (plane p = byte p of every block, at payload offset p*n).
// n may be any block count; nothing is padded. m + p*n has any alignment, so every
// kernel moves each stream as aligned words and writes the bytes it shares with a
// neighbouring chunk's row one by one.
//
// The transform runs one 256-thread block per chunk: 342 at n = 1,398,103, the last
// holding 1,367 blocks; so does the sorting untransform, and the others one per
// 1024-block tile (below). The TPU split this work into Pallas passes around an XLA
// sort, because Mosaic has no gather or scatter; here a chunk is sorted in shared
// memory by a counting sort that is stable by construction. Bound by bytes: each
// direction reads and writes every byte once (32n + m with sorting, 32n without),
// and the per-block work is a few dozen integer operations.

#include "common.cuh"

namespace {

constexpr int kChunk = 4096;                      // blocks per sort chunk
constexpr int kGroups = kChunk / 32;              // (round, warp) groups of 32 blocks
constexpr int kModes = 16;                        // 4-bit ids; 16 marks "no block"
constexpr unsigned kAll = 0xffffffffu;            // every lane of a warp

extern __shared__ uint4 chunk_smem[];

template <int FMT>  // 0: BC7, 1: BC6H
__device__ __forceinline__ uint32_t block_mode(uint32_t b0) {
  if constexpr (FMT == 0) {
    return b0 ? static_cast<uint32_t>(__ffs(static_cast<int>(b0)) - 1) : 8u;
  } else {
    const uint32_t two = b0 & 3u;
    if (two < 2u) return two;
    const uint32_t v = b0 & 31u;
    return (v & 1u) ? 10u + min(v >> 2, 4u) : 2u + (v >> 2);
  }
}

// In-place exclusive prefix sum of the kModes * kGroups entries at `a`, by all
// THREADS threads; `warp_sums` is shared scratch for THREADS / 32 entries.
template <int THREADS>
__device__ __forceinline__ void exclusive_scan(int* a, int* warp_sums) {
  constexpr int kWarps = THREADS / 32;
  constexpr int kPer = kModes * kGroups / THREADS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = threadIdx.x * kPer;
  int v[kPer];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    v[j] = a[base + j];
    sum += v[j];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += y;
    }
    if (lane < kWarps) warp_sums[lane] = wi - w;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    a[base + j] = run;
    run += v[j];
  }
  __syncthreads();
}

// The position of each of this thread's blocks in its chunk sorted stably by mode
// id. The thread's block in round r is i = r * THREADS + threadIdx.x, so the
// chunk's order is (round, warp, lane). mode[r] is that block's id, or kModes for a
// block past the chunk's end (it gets no rank). A counting sort: each warp finds
// the lanes that share its id (__match_any_sync); the lowest of them records how
// many in the (mode, group) table; an exclusive scan of the table in (mode, round,
// warp) order gives each group's first position among its mode's blocks; a block's
// rank adds the number of lanes below it with its id.
template <int THREADS, int ROUNDS = kChunk / THREADS>
__device__ __forceinline__ void stable_ranks(const uint32_t (&mode)[ROUNDS],
                                             int (&rank)[ROUNDS], int* offsets,
                                             int* warp_sums) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;
  for (int k = threadIdx.x; k < kModes * kGroups; k += THREADS) offsets[k] = 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const uint32_t same = __match_any_sync(0xffffffffu, mode[r]);
    rank[r] = __popc(same & below);
    if (mode[r] < kModes && rank[r] == 0) {
      offsets[mode[r] * kGroups + r * kWarps + warp] = __popc(same);
    }
  }
  __syncthreads();
  exclusive_scan<THREADS>(offsets, warp_sums);
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    if (mode[r] < kModes) rank[r] += offsets[mode[r] * kGroups + r * kWarps + warp];
  }
}

// ---- moving a chunk through shared memory -------------------------------------------
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The 16 bytes at byte offset mis (0-15) of the 32 bytes a | b.
__device__ __forceinline__ uint4 bytes16_at(const uint4& a, const uint4& b, int mis) {
  const uint32_t sel = 0x3210u + 0x1111u * static_cast<uint32_t>(mis & 3);
  uint32_t w0, w1, w2, w3, w4;
  switch (mis >> 2) {
    case 0: w0 = a.x; w1 = a.y; w2 = a.z; w3 = a.w; w4 = b.x; break;
    case 1: w0 = a.y; w1 = a.z; w2 = a.w; w3 = b.x; w4 = b.y; break;
    case 2: w0 = a.z; w1 = a.w; w2 = b.x; w3 = b.y; w4 = b.z; break;
    default: w0 = a.w; w1 = b.x; w2 = b.y; w3 = b.z; w4 = b.w; break;
  }
  return make_uint4(__byte_perm(w0, w1, sel), __byte_perm(w1, w2, sel),
                    __byte_perm(w2, w3, sel), __byte_perm(w3, w4, sel));
}

// The 4x4 byte transpose: blk[j] gets byte j of a, b, c and d, a.j | b.j << 8 |
// c.j << 16 | d.j << 24. It makes words q of four consecutive blocks from words of
// planes 4q .. 4q + 3, and the words of four planes from the same word of four
// consecutive blocks. lo and hi are the last step's selectors (rotate_selector turns
// each word's bytes on the way).
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t (&blk)[4], uint32_t lo = 0x5410u,
                                           uint32_t hi = 0x7632u) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140), ab_hi = __byte_perm(a, b, 0x7362);
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140), cd_hi = __byte_perm(c, d, 0x7362);
  blk[0] = __byte_perm(ab_lo, cd_lo, lo);
  blk[1] = __byte_perm(ab_lo, cd_lo, hi);
  blk[2] = __byte_perm(ab_hi, cd_hi, lo);
  blk[3] = __byte_perm(ab_hi, cd_hi, hi);
}

// The __byte_perm selector that applies sel, then moves byte (t - r) & 3 of the
// result to byte t.
__device__ __forceinline__ uint32_t rotate_selector(uint32_t sel, int r) {
  uint32_t out = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) out |= ((sel >> (4 * ((t - r) & 3))) & 0xFu) << (4 * t);
  return out;
}

// ---- dlt_bc7_transform -----------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/planes.py:280 split_cols_modes_tpu
// (mode ids, sort keys and the packed mode stream), :46 split_planes_tpu and :77
// split_planes_flat_tpu (the byte planes) and :139 weave_cols_tpu (the sorted
// blocks), with the XLA lax.sort between them. Bound by bytes, and built as the
// sorting untransform below is, in the other direction: one 256-thread block per
// chunk with 73,728 bytes of shared memory (the chunk's 64 KiB and the 8 KiB rank
// table), three a SM, so that the 342 chunks of n = 1,398,103 run in one wave.
//
// 1. A block issues its chunk's blocks at once, in input order, as 16-byte
//    asynchronous copies into shared memory (the input is 16-byte aligned).
// 2. With sorting, once they have landed, it reads each block's first byte there
//    and ranks the chunk with stable_ranks, each thread the 16 blocks i = r * 256 +
//    threadIdx.x; it writes the mode stream from the ids of neighbouring lanes, then
//    the inverse permutation (the source of each sorted position, uint16) over the
//    rank table. Reading the ids from global memory instead, to rank while the
//    copies fly, measured 3.3-3.7 us slower on the H100: it reads the same sectors a
//    second time.
// 3. Then it writes the chunk in sorted order, each sorted block gathered from
//    shared memory by the inverse permutation: nothing is scattered. Without planes
//    a thread writes one block a step; with planes it takes four consecutive sorted
//    blocks and makes one 32-bit word of each of the 16 plane rows by 4x4 byte
//    transposes. The misalignment of an output row is the same for the whole chunk,
//    so every store is one aligned word (16 bytes, or 4 for a plane row) made from a
//    thread's word and its lower neighbour's (a shuffle, then a byte permute or a
//    funnel shift; lane 0 carries its warp's previous step). Only a row's first and
//    last word, which it shares with a neighbouring chunk, go out byte by byte.
constexpr int kTfThreads = 256;
constexpr int kTfRounds = kChunk / kTfThreads;    // blocks a thread ranks
constexpr int kTfWarps = kTfThreads / 32;
// the staged chunk, then the (mode, group) table, later the inverse permutation
constexpr int kTfSmem = 16 * kChunk + 4 * kModes * kGroups;
static_assert(2 * kChunk <= 4 * kModes * kGroups, "the inverse permutation fits the table");

// The source of sorted position j (< count): perm[j] with sorting, j without.
template <bool SORT>
__device__ __forceinline__ int source_of(const uint16_t* perm, int j) {
  if constexpr (SORT) return perm[j];
  else return j;
}

// Stores bytes k in [lo, hi) of v at p + k, one by one: the part of an aligned word
// that lies in this chunk's row.
__device__ __forceinline__ void store_part(uint8_t* p, uint32_t v, int lo, int hi) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k >= lo && k < hi) p[k] = static_cast<uint8_t>(v >> (8 * k));
  }
}

__device__ __forceinline__ void store_part16(uint8_t* p, const uint4& v, int lo, int hi) {
  store_part(p, v.x, lo, hi);
  store_part(p + 4, v.y, lo - 4, hi - 4);
  store_part(p + 8, v.z, lo - 8, hi - 8);
  store_part(p + 12, v.w, lo - 12, hi - 12);
}

__device__ __forceinline__ uint4 shfl4(const uint4& v, int lane) {
  return make_uint4(__shfl_sync(kAll, v.x, lane), __shfl_sync(kAll, v.y, lane),
                    __shfl_sync(kAll, v.z, lane), __shfl_sync(kAll, v.w, lane));
}

// The count sorted blocks of a staged chunk to dst (any alignment). Warp w writes
// positions 512w .. 512w + 511, 32 consecutive ones a step; aligned unit u of the
// output holds bytes [16u - mis, 16u + 16 - mis) of the chunk's stream, the end of
// block u - 1 and the start of block u. A lane takes block u - 1 from the lane below
// (lane 0: lane 31's of the step before, which it keeps).
template <bool SORT>
__device__ __forceinline__ void store_blocks(const uint4* stage, const uint16_t* perm,
                                             uint8_t* dst, int count) {
  constexpr int kSteps = kChunk / kTfThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15u);
  uint8_t* base = dst - mis;
  const int u0 = warp * 32 * kSteps;
  if (u0 >= count) return;
  uint4 carry = stage[source_of<SORT>(perm, u0 > 0 ? u0 - 1 : 0)];
  for (int s = 0; s < kSteps; ++s) {
    if (u0 + 32 * s >= count) break;
    const int u = u0 + 32 * s + lane;
    const uint4 cur = stage[source_of<SORT>(perm, min(u, count - 1))];
    const uint4 below = shfl4(cur, (lane + 31) & 31);
    const uint4 prev = lane ? below : carry;
    carry = below;
    if (mis == 0) {
      if (u < count) reinterpret_cast<uint4*>(base)[u] = cur;
    } else {
      const uint4 v = bytes16_at(prev, cur, 16 - mis);
      if (u > 0 && u < count) reinterpret_cast<uint4*>(base)[u] = v;
      else if (u == 0) store_part16(base, v, mis, 16);
      if (u == count - 1) {
        store_part16(base + 16 * (u + 1), bytes16_at(cur, cur, 16 - mis), 0, mis);
      }
    }
  }
}

// The 16 plane words of sorted positions 4q .. 4q + 3 (those past count read block
// 0; their bytes are never stored): word p holds byte p of each, position 4q's in
// the low byte. A lane reads its four blocks starting at the r = (q & 3)th, so that
// a quarter warp's eight 16-byte reads meet eight bank groups when the positions'
// blocks lie in order; lo and hi, rotate_selector(0x5410 and 0x7632, r), turn the
// bytes back in the transposes.
template <bool SORT>
__device__ __forceinline__ void quad_planes(const uint4* stage, const uint16_t* perm, int q,
                                            int count, uint32_t lo, uint32_t hi,
                                            uint32_t (&w)[16]) {
  const int r = q & 3;
  uint2 src = make_uint2(0u, 0u);
  if constexpr (SORT) src = reinterpret_cast<const uint2*>(perm)[q];
  uint4 b[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int k = (s + r) & 3;  // slot s holds position 4q + k
    int j = 4 * q + k;
    if constexpr (SORT) {
      j = j < count ? static_cast<int>(((k & 2 ? src.y : src.x) >> (16 * (k & 1))) & 0xFFFFu) : 0;
    } else {
      j = j < count ? j : 0;
    }
    b[s] = stage[j];
  }
  transpose4(b[0].x, b[1].x, b[2].x, b[3].x, reinterpret_cast<uint32_t(&)[4]>(w[0]), lo, hi);
  transpose4(b[0].y, b[1].y, b[2].y, b[3].y, reinterpret_cast<uint32_t(&)[4]>(w[4]), lo, hi);
  transpose4(b[0].z, b[1].z, b[2].z, b[3].z, reinterpret_cast<uint32_t(&)[4]>(w[8]), lo, hi);
  transpose4(b[0].w, b[1].w, b[2].w, b[3].w, reinterpret_cast<uint32_t(&)[4]>(w[12]), lo, hi);
}

// Stores the words w of quad q into the 16 plane rows, row p's word at row + p * n
// (row: dst + 4q). Aligned word q of a row whose start is misaligned by m holds its
// bytes [4q - m, 4q + 4 - m): the end of quad q - 1's word, from the lane below (lane
// 0: carry, lane 31's of the step before), and the start of quad q's. INSIDE: every
// lane's word lies inside the chunk's rows; else only the quads up to the last
// store, and the ends of a row go out byte by byte.
template <bool INSIDE>
__device__ __forceinline__ void store_quad(const uint32_t (&w)[16], uint32_t (&carry)[16],
                                           uint8_t* row, int64_t n, int q, int last,
                                           int count) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < 16; ++p, row += n) {
    const uint32_t below = __shfl_sync(kAll, w[p], (lane + 31) & 31);
    const uint32_t v = __funnelshift_l(lane ? below : carry[p], w[p],
                                       static_cast<uint32_t>(reinterpret_cast<uintptr_t>(row)) << 3);
    carry[p] = below;
    uint8_t* at = reinterpret_cast<uint8_t*>(reinterpret_cast<uintptr_t>(row) & ~uintptr_t{3});
    if constexpr (INSIDE) {
      *reinterpret_cast<uint32_t*>(at) = v;
    } else if (q <= last) {
      const int m = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 3u);
      if (4 * q >= m && 4 * q + 4 - m <= count) *reinterpret_cast<uint32_t*>(at) = v;
      else store_part(at, v, m - 4 * q, count + m - 4 * q);
      if (q == last && m) {
        store_part(at + 4, __funnelshift_l(w[p], 0u, 8 * m), 0, count + m - 4 * q - 4);
      }
    }
  }
}

// The 16 plane rows of the count sorted blocks of a staged chunk, plane p's row at
// dst + p * n (any alignment). Warp w makes quads 128w .. 128w + 127, 32 consecutive
// ones a step, through store_quad: only the steps at a row's ends take the checked
// form.
template <bool SORT>
__device__ __forceinline__ void store_planes(const uint4* stage, const uint16_t* perm,
                                             uint8_t* dst, int64_t n, int count) {
  constexpr int kSteps = kChunk / 4 / kTfThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int last = (count - 1) >> 2;  // the last quad that holds a block
  const int q0 = warp * 32 * kSteps;
  if (q0 > last) return;
  uint32_t carry[16];
  quad_planes<SORT>(stage, perm, q0 > 0 ? q0 - 1 : 0, count, rotate_selector(0x5410u, 3),
                    rotate_selector(0x7632u, 3), carry);
  // q & 3 == lane & 3 in every step
  const uint32_t lo = rotate_selector(0x5410u, lane & 3), hi = rotate_selector(0x7632u, lane & 3);
  for (int s = 0; s < kSteps; ++s) {
    if (q0 + 32 * s > last) break;
    const int q = q0 + 32 * s + lane;
    uint32_t w[16];
    quad_planes<SORT>(stage, perm, q, count, lo, hi, w);
    if (__all_sync(kAll, q > 0 && q < last)) {
      store_quad<true>(w, carry, dst + 4 * q, n, q, last, count);
    } else {
      store_quad<false>(w, carry, dst + 4 * q, n, q, last, count);
    }
  }
}

template <int FMT, bool SORT, bool PLANES>
__global__ void __launch_bounds__(kTfThreads, 3)
bc7_transform_kernel(const uint4* __restrict__ in, uint8_t* __restrict__ out, int64_t n) {
  uint4* stage = chunk_smem;
  uint16_t* perm = reinterpret_cast<uint16_t*>(stage + kChunk);
  __shared__ int warp_sums[kTfWarps];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int count = static_cast<int>(n - first < kChunk ? n - first : kChunk);
  for (int i = threadIdx.x; i < count; i += kTfThreads) copy16_async(stage + i, in + first + i);
  wait_async_copies();
  __syncthreads();
  if constexpr (SORT) {
    const int lane = threadIdx.x & 31;
    uint32_t mode[kTfRounds];
    int rank[kTfRounds];
#pragma unroll
    for (int r = 0; r < kTfRounds; ++r) {
      const int i = r * kTfThreads + threadIdx.x;
      mode[r] = i < count ? block_mode<FMT>(stage[i].x & 0xFFu) : kModes;
    }
    stable_ranks<kTfThreads>(mode, rank, reinterpret_cast<int*>(perm), warp_sums);
    // the mode stream: block i's id in the low nibble of byte i / 2 (i even), its odd
    // neighbour's, in the next lane, in the high one; first is even
#pragma unroll
    for (int r = 0; r < kTfRounds; ++r) {
      const int i = r * kTfThreads + threadIdx.x;
      const uint32_t id = mode[r] < kModes ? mode[r] : 0u;
      const uint32_t hi = __shfl_down_sync(kAll, id, 1);
      if (!(lane & 1) && i < count) out[(first + i) >> 1] = static_cast<uint8_t>(id | (hi << 4));
    }
    __syncthreads();  // every rank is read from the table
#pragma unroll
    for (int r = 0; r < kTfRounds; ++r) {
      const int i = r * kTfThreads + threadIdx.x;
      if (i < count) perm[rank[r]] = static_cast<uint16_t>(i);
    }
    __syncthreads();
  }
  uint8_t* payload = out + (SORT ? (n + 1) / 2 : 0);
  if constexpr (PLANES) {
    store_planes<SORT>(stage, perm, payload + first, n, count);
  } else {
    store_blocks<SORT>(stage, perm, payload + 16 * first, count);
  }
}

// ---- dlt_bc7_untransform -----------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/planes.py:116 merge_planes_flat_tpu
// and :218 merge_planes_tpu (the byte planes back to blocks) and :186 split_cols_tpu
// (the sorted blocks back to word columns), with the two XLA sorts that rebuild and
// invert the permutation, the kernels of the load path. Bound by bytes, as the
// transform is.
//
// What holds a byte-moving kernel back here is bytes in flight and waves: a block
// that ranks before it loads, or holds a whole chunk in 4-byte loads, or fits two
// to an SM, leaves the card idle. So a 256-thread block takes a span of the
// payload's order: a tile of kTileBlocks = 1024 blocks without sorting (16.5 KB of
// shared memory, up to eight blocks a SM), or a whole 4096-block chunk with sorting
// (72.5 KB, three a SM, so that the 342 chunks of n = 1,398,103 run in one wave):
//
// 1. it issues the span's whole payload at once as 16-byte asynchronous copies
//    (cp.async) of the aligned vectors that cover it, each plane's row or the
//    sorted blocks; a plane's misalignment (at m + p*n) becomes an offset into
//    shared memory;
// 2. while they are in flight, with sorting, it reads the chunk's mode stream and
//    ranks the chunk as the transform did (the same counting sort), each thread the
//    16 blocks i = r * 256 + threadIdx.x;
// 3. then each block is written as one 16-byte store, neighbouring threads on
//    neighbouring blocks. Without sorting, planes: a thread takes four consecutive
//    blocks, reads one 32-bit word of each plane (two aligned words and a byte
//    permute by the plane's misalignment, the same for the whole warp) and makes its
//    four blocks by 4x4 byte transposes (__byte_perm). With sorting, each block is
//    gathered from its rank: 16 single-byte shared reads from the plane rows, or two
//    aligned 16-byte reads and four permutes from the staged blocks. Gathering keeps
//    the scattered accesses in shared memory; scattering the sorted blocks to their
//    places instead spreads 16-byte stores over the chunk's 64 KB, which measured
//    slower.
//
// The vectors read are those that hold a byte of the payload, so no read leaves the
// aligned 16-byte segments that the input touches.
constexpr int kTileBlocks = 1024;                 // blocks of an unsorted span
constexpr int kUntThreads = 256;

// The shared memory of a span of SPAN blocks: 16 plane rows of SPAN + 32 bytes (the
// covering vectors and slack; the SPAN + 1 vectors of sorted blocks fit as well),
// then, with sorting, the rank table.
template <int SPAN>
__host__ __device__ constexpr int row_bytes() { return SPAN + 32; }
template <bool SORT>
constexpr int untransform_smem() {
  constexpr int span = SORT ? kChunk : kTileBlocks;
  return 16 * row_bytes<span>() + (SORT ? 4 * kModes * kGroups : 0);
}
static_assert(16 * (kChunk + 1) <= 16 * row_bytes<kChunk>(), "the sorted blocks fit");

// Issues the asynchronous copies of the cnt blocks of the payload's order that start
// at block b0: each plane's row (PLANES, rows of SPAN + 32 bytes) or the blocks, as
// the aligned 16-byte vectors that cover them.
template <int SPAN, bool PLANES>
__device__ __forceinline__ void issue_span(uint8_t* stage, const uint8_t* payload, int64_t n,
                                           int64_t b0, int cnt) {
  const uintptr_t align = ~static_cast<uintptr_t>(15);
  if constexpr (PLANES) {
    constexpr int kRowVecs = SPAN / 16 + 1;
    for (int v = threadIdx.x; v < 16 * kRowVecs; v += kUntThreads) {
      const int p = v / kRowVecs, j = v - p * kRowVecs;
      const uintptr_t at = reinterpret_cast<uintptr_t>(payload + p * n + b0);
      if (16 * j < static_cast<int>(at & 15u) + cnt) {
        copy16_async(stage + p * row_bytes<SPAN>() + 16 * j,
                     reinterpret_cast<const void*>((at & align) + 16 * j));
      }
    }
  } else {
    const uintptr_t at = reinterpret_cast<uintptr_t>(payload + 16 * b0);
    const int mis = static_cast<int>(at & 15u);
    for (int j = threadIdx.x; 16 * j < mis + 16 * cnt; j += kUntThreads) {
      copy16_async(stage + 16 * j, reinterpret_cast<const void*>((at & align) + 16 * j));
    }
  }
}

// The sorted block at rank rk of a staged chunk: a byte from each plane row (PLANES),
// or 16 bytes of the staged blocks.
template <bool PLANES, int ROW>
__device__ __forceinline__ uint4 sorted_block(const uint8_t* stage, const uint8_t* payload,
                                              int64_t n, int64_t first, int rk) {
  if constexpr (PLANES) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(payload + p * n + first) & 15u);
      w[p >> 2] |= static_cast<uint32_t>(stage[p * ROW + mis + rk]) << (8 * (p & 3));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(payload + 16 * first) & 15u);
    const uint4* vec = reinterpret_cast<const uint4*>(stage);
    return bytes16_at(vec[rk], vec[rk + 1], mis);
  }
}

template <bool SORT, bool PLANES>
__global__ void __launch_bounds__(kUntThreads)
bc7_untransform_kernel(const uint8_t* __restrict__ in, uint4* __restrict__ out, int64_t n) {
  constexpr int kSpan = SORT ? kChunk : kTileBlocks;  // blocks of a thread block
  constexpr int kRow = row_bytes<kSpan>();
  uint8_t* stage = reinterpret_cast<uint8_t*>(chunk_smem);
  __shared__ int warp_sums[kUntThreads / 32];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kSpan;
  const int count = static_cast<int>(n - first < kSpan ? n - first : kSpan);
  const uint8_t* payload = in + (SORT ? (n + 1) / 2 : 0);
  issue_span<kSpan, PLANES>(stage, payload, n, first, count);
  if constexpr (SORT) {
    // this thread's blocks i = r * kUntThreads + threadIdx.x, ranked while the copies
    // land, then each gathered from its rank: neighbouring threads store neighbouring
    // blocks
    constexpr int kUntRounds = kChunk / kUntThreads;
    uint32_t mode[kUntRounds];
    int rank[kUntRounds];
#pragma unroll
    for (int r = 0; r < kUntRounds; ++r) {
      const int i = r * kUntThreads + threadIdx.x;
      mode[r] = kModes;
      if (i < count) {
        // first is even, so block first + i's nibble is the (i & 1) one
        const uint32_t b = in[(first + i) >> 1];
        mode[r] = (i & 1) ? b >> 4 : b & 15u;
      }
    }
    stable_ranks<kUntThreads>(mode, rank, reinterpret_cast<int*>(stage + 16 * kRow),
                              warp_sums);
    wait_async_copies();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kUntRounds; ++r) {
      const int i = r * kUntThreads + threadIdx.x;
      if (i < count) out[first + i] = sorted_block<PLANES, kRow>(stage, payload, n, first, rank[r]);
    }
  } else {
    wait_async_copies();
    __syncthreads();
    if constexpr (PLANES) {
      const int k = 4 * static_cast<int>(threadIdx.x);  // four consecutive blocks
      if (k >= count) return;
      uint32_t word[16];
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(payload + p * n + first) & 15u);
        const uint32_t* row = reinterpret_cast<const uint32_t*>(stage + p * kRow);
        const int w = (mis >> 2) + threadIdx.x;
        word[p] = __byte_perm(row[w], row[w + 1],
                              0x3210u + 0x1111u * static_cast<uint32_t>(mis & 3));
      }
      uint32_t q[4][4];  // [word of a block][block]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        transpose4(word[4 * j], word[4 * j + 1], word[4 * j + 2], word[4 * j + 3], q[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k + j < count) out[first + k + j] = make_uint4(q[0][j], q[1][j], q[2][j], q[3][j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = j * kUntThreads + static_cast<int>(threadIdx.x);  // every 256th
        if (k < count) out[first + k] = sorted_block<false, kRow>(stage, payload, n, first, k);
      }
    }
  }
}

inline unsigned chunks_for(int64_t n) {
  return static_cast<unsigned>((n + kChunk - 1) / kChunk);
}

template <int FMT, bool SORT, bool PLANES>
cudaError_t launch_transform(const void* in, void* out, int64_t n, cudaStream_t st) {
  const auto kernel = bc7_transform_kernel<FMT, SORT, PLANES>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTfSmem);
  if (err != cudaSuccess) return err;
  kernel<<<chunks_for(n), kTfThreads, kTfSmem, st>>>(
      static_cast<const uint4*>(in), static_cast<uint8_t*>(out), n);
  return cudaGetLastError();
}

// One thread block per chunk with sorting, per tile without.
inline unsigned untransform_blocks(int64_t n, bool sort) {
  const int64_t span = sort ? kChunk : kTileBlocks;
  return static_cast<unsigned>((n + span - 1) / span);
}

template <bool SORT, bool PLANES>
cudaError_t launch_untransform(const void* in, void* out, int64_t n, cudaStream_t st) {
  const auto kernel = bc7_untransform_kernel<SORT, PLANES>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, untransform_smem<SORT>());
  if (err != cudaSuccess) return err;
  kernel<<<untransform_blocks(n, SORT), kUntThreads, untransform_smem<SORT>(), st>>>(
      static_cast<const uint8_t*>(in), static_cast<uint4*>(out), n);
  return cudaGetLastError();
}

// Blocks of `kernel`, with `threads` threads and `smem` bytes of dynamic shared
// memory each, that the card holds at once (0 if it cannot say).
template <typename Kernel>
int64_t resident_blocks(Kernel kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return static_cast<int64_t>(per_sm) * sms;
}

template <int FMT, bool SORT, bool PLANES>
int64_t transform_resident() {
  return resident_blocks(bc7_transform_kernel<FMT, SORT, PLANES>, kTfThreads, kTfSmem);
}

template <bool SORT, bool PLANES>
int64_t untransform_resident() {
  return resident_blocks(bc7_untransform_kernel<SORT, PLANES>, kUntThreads,
                         untransform_smem<SORT>());
}

using Launch = cudaError_t (*)(const void*, void*, int64_t, cudaStream_t);

// indexed by fmt * 4 + sort * 2 + planes; without sorting the format plays no part
constexpr Launch kTransform[8] = {
    launch_transform<0, false, false>, launch_transform<0, false, true>,
    launch_transform<0, true, false>,  launch_transform<0, true, true>,
    launch_transform<0, false, false>, launch_transform<0, false, true>,
    launch_transform<1, true, false>,  launch_transform<1, true, true>,
};

// indexed as kTransform
constexpr int64_t (*kTransformResident[8])() = {
    transform_resident<0, false, false>, transform_resident<0, false, true>,
    transform_resident<0, true, false>,  transform_resident<0, true, true>,
    transform_resident<0, false, false>, transform_resident<0, false, true>,
    transform_resident<1, true, false>,  transform_resident<1, true, true>,
};

// indexed by sort * 2 + planes
constexpr Launch kUntransform[4] = {
    launch_untransform<false, false>, launch_untransform<false, true>,
    launch_untransform<true, false>,  launch_untransform<true, true>,
};

}  // namespace

// ---- C entry points --------------------------------------------------------------------
extern "C" {

// in: 16n bytes, 16-byte aligned; out: 16n + ceil(n/2) bytes when sorting, else 16n,
// any alignment; fmt 0 = BC7, 1 = BC6H.
int dlt_bc7_transform(const void* in, void* out, int64_t n, int64_t fmt, int64_t sort,
                      int64_t planes, void* stream) {
  if (n <= 0 || fmt < 0 || fmt > 1) return cudaErrorInvalidValue;
  return kTransform[fmt * 4 + (sort ? 2 : 0) + (planes ? 1 : 0)](
      in, out, n, static_cast<cudaStream_t>(stream));
}

// in: the transformed bytes, 4-byte aligned; out: 16n bytes, 16-byte aligned.
int dlt_bc7_untransform(const void* in, void* out, int64_t n, int64_t sort,
                        int64_t planes, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  return kUntransform[(sort ? 2 : 0) + (planes ? 1 : 0)](
      in, out, n, static_cast<cudaStream_t>(stream));
}

// The transform's launch for n blocks: out[0] its grid, out[1] the blocks the card
// holds at once, out[2] the threads of a block, out[3] the blocks of a block's span
// (a chunk). Launches nothing.
int dlt_bc7_transform_shape(int64_t n, int64_t fmt, int64_t sort, int64_t planes,
                            int64_t* out) {
  if (n <= 0 || fmt < 0 || fmt > 1) return cudaErrorInvalidValue;
  out[0] = chunks_for(n);
  out[1] = kTransformResident[fmt * 4 + (sort ? 2 : 0) + (planes ? 1 : 0)]();
  out[2] = kTfThreads;
  out[3] = kChunk;
  return cudaSuccess;
}

// The untransform's launch for n blocks: out[0] its grid, out[1] the blocks the card
// holds at once, out[2] the threads of a block, out[3] the blocks of a block's span
// (a tile, or with sorting a chunk).
// Launches nothing.
int dlt_bc7_untransform_shape(int64_t n, int64_t sort, int64_t planes, int64_t* out) {
  if (n <= 0) return cudaErrorInvalidValue;
  constexpr int64_t (*kResident[4])() = {
      untransform_resident<false, false>, untransform_resident<false, true>,
      untransform_resident<true, false>, untransform_resident<true, true>};
  out[0] = untransform_blocks(n, sort != 0);
  out[1] = kResident[(sort ? 2 : 0) + (planes ? 1 : 0)]();
  out[2] = kUntThreads;
  out[3] = sort ? kChunk : kTileBlocks;
  return cudaSuccess;
}

}  // extern "C"
