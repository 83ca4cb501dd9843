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
// n may be any block count; nothing is padded. m + p*n has any alignment, so the
// streams move through the byte-range copies of common.cuh.
//
// The transform runs one thread block per chunk: 342 at n = 1,398,103, the last
// holding 1,367 blocks; so does the sorting untransform, and the others one per
// 1024-block tile (below). The TPU split this work into Pallas passes around an XLA
// sort, because Mosaic has no gather or scatter; here a chunk is sorted in shared
// memory by a counting sort that is stable by construction. Bound by bytes: each
// direction reads and writes every byte once (32n + m with sorting, 32n without),
// and the per-block work is a few dozen integer operations.

#include "common.cuh"

namespace {

constexpr int kChunk = 4096;                      // blocks per sort chunk
constexpr int kSortThreads = 512;
constexpr int kRounds = kChunk / kSortThreads;    // blocks per thread
constexpr int kGroups = kChunk / 32;              // (round, warp) groups of 32 blocks
constexpr int kModes = 16;                        // 4-bit ids; 16 marks "no block"
constexpr int kStageBytes = 16 * kChunk;
// Dynamic shared memory: the staged chunk (64 KiB, plus 16 bytes that store_bytes
// may read past its end), the count and offset table (one entry per mode and group)
// and the chunk's mode ids.
constexpr int kOffsetsAt = kStageBytes + 16;
constexpr int kModesAt = kOffsetsAt + 4 * kModes * kGroups;
constexpr int kSmemBytes = kModesAt + kChunk;

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
// id. The thread's block in round r is i = r * kSortThreads + threadIdx.x, so the
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

// ---- dlt_bc7_transform -----------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/planes.py:280 split_cols_modes_tpu
// (mode ids, sort keys and the packed mode stream), :46 split_planes_tpu and :77
// split_planes_flat_tpu (the byte planes) and :139 weave_cols_tpu (the sorted
// blocks), with the XLA lax.sort between them. One thread block per chunk: each
// thread loads its kRounds blocks (16-byte loads, neighbouring threads on
// neighbouring blocks), computes their ids and, when sorting, writes the chunk's
// part of the mode stream and ranks the blocks; it stores each block at its rank in
// shared memory, as 16 bytes or as one byte in each of 16 plane rows of 4096 bytes;
// then the block writes the staged chunk out in order.
template <int FMT, bool SORT, bool PLANES>
__global__ void __launch_bounds__(kSortThreads)
bc7_transform_kernel(const uint4* __restrict__ in, uint8_t* __restrict__ out, int64_t n) {
  uint8_t* stage = reinterpret_cast<uint8_t*>(chunk_smem);
  int* offsets = reinterpret_cast<int*>(stage + kOffsetsAt);
  uint8_t* modes = stage + kModesAt;
  __shared__ int warp_sums[kSortThreads / 32];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int count = static_cast<int>(n - first < kChunk ? n - first : kChunk);
  uint4 blk[kRounds];
  uint32_t mode[kRounds];
  int rank[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = r * kSortThreads + threadIdx.x;
    mode[r] = kModes;
    rank[r] = i;
    if (i < count) {
      blk[r] = in[first + i];
      if constexpr (SORT) {
        mode[r] = block_mode<FMT>(blk[r].x & 0xFFu);
        modes[i] = static_cast<uint8_t>(mode[r]);
      }
    }
  }
  if constexpr (SORT) {
    stable_ranks<kSortThreads>(mode, rank, offsets, warp_sums);  // its barriers publish modes[]
    for (int j = threadIdx.x; j < (count + 1) / 2; j += kSortThreads) {
      const uint32_t hi = 2 * j + 1 < count ? modes[2 * j + 1] : 0u;
      out[first / 2 + j] = static_cast<uint8_t>(modes[2 * j] | (hi << 4));
    }
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (r * kSortThreads + static_cast<int>(threadIdx.x) >= count) continue;
    if constexpr (PLANES) {
      const uint32_t w[4] = {blk[r].x, blk[r].y, blk[r].z, blk[r].w};
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        stage[p * kChunk + rank[r]] = static_cast<uint8_t>(w[p >> 2] >> (8 * (p & 3)));
      }
    } else {
      chunk_smem[rank[r]] = blk[r];
    }
  }
  __syncthreads();
  uint8_t* payload = out + (SORT ? (n + 1) / 2 : 0);
  if constexpr (PLANES) {
    for (int p = 0; p < 16; ++p) {
      store_bytes(payload + p * n + first, stage + p * kChunk, count);
    }
  } else {
    store_bytes(payload + 16 * first, stage, 16 * count);
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

// Words q of four consecutive blocks from words a, b, c, d of planes 4q .. 4q + 3,
// each holding the four blocks' bytes: blk[j] gets a.j | b.j << 8 | c.j << 16 |
// d.j << 24.
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t (&blk)[4]) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140), ab_hi = __byte_perm(a, b, 0x7362);
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140), cd_hi = __byte_perm(c, d, 0x7362);
  blk[0] = __byte_perm(ab_lo, cd_lo, 0x5410);
  blk[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
  blk[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  blk[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

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
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<chunks_for(n), kSortThreads, kSmemBytes, st>>>(
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

// Blocks of bc7_untransform_kernel<SORT, PLANES> that the card holds at once.
template <bool SORT, bool PLANES>
int64_t untransform_resident() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(bc7_untransform_kernel<SORT, PLANES>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           untransform_smem<SORT>()) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bc7_untransform_kernel<SORT, PLANES>, kUntThreads,
          untransform_smem<SORT>()) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return static_cast<int64_t>(per_sm) * sms;
}

using Launch = cudaError_t (*)(const void*, void*, int64_t, cudaStream_t);

// indexed by fmt * 4 + sort * 2 + planes; without sorting the format plays no part
constexpr Launch kTransform[8] = {
    launch_transform<0, false, false>, launch_transform<0, false, true>,
    launch_transform<0, true, false>,  launch_transform<0, true, true>,
    launch_transform<0, false, false>, launch_transform<0, false, true>,
    launch_transform<1, true, false>,  launch_transform<1, true, true>,
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
