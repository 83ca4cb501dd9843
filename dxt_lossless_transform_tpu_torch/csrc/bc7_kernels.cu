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
// Both entry points run one thread block per chunk: 342 at n = 1,398,103, the last
// holding 1,367 blocks. The TPU split this work into Pallas passes around an XLA
// sort, because Mosaic has no gather or scatter; here a chunk is sorted in shared
// memory by a counting sort that is stable by construction. Bound by bytes: each
// direction reads and writes every byte once (32n + m with sorting, 32n without),
// and the per-block work is a few dozen integer operations.

#include "common.cuh"

namespace {

constexpr int kChunk = 4096;                      // blocks per sort chunk
constexpr int kSortThreads = 512;
constexpr int kWarps = kSortThreads / 32;
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
// threads; `warp_sums` is shared scratch for kWarps entries.
__device__ __forceinline__ void exclusive_scan(int* a, int* warp_sums) {
  constexpr int kPer = kModes * kGroups / kSortThreads;
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
__device__ __forceinline__ void stable_ranks(const uint32_t (&mode)[kRounds],
                                             int (&rank)[kRounds], int* offsets,
                                             int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;
  for (int k = threadIdx.x; k < kModes * kGroups; k += kSortThreads) offsets[k] = 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const uint32_t same = __match_any_sync(0xffffffffu, mode[r]);
    rank[r] = __popc(same & below);
    if (mode[r] < kModes && rank[r] == 0) {
      offsets[mode[r] * kGroups + r * kWarps + warp] = __popc(same);
    }
  }
  __syncthreads();
  exclusive_scan(offsets, warp_sums);
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
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
  __shared__ int warp_sums[kWarps];
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
    stable_ranks(mode, rank, offsets, warp_sums);  // its barriers publish modes[]
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
// invert the permutation, the kernels of the load path. One thread block per chunk:
// it reads the chunk's ids from the mode stream and ranks them as the transform did
// (the same order, so no format is needed), copies the chunk's planes or sorted
// blocks into shared memory, and each thread writes its blocks, gathered from their
// ranks, to their original places with 16-byte stores.
template <bool SORT, bool PLANES>
__global__ void __launch_bounds__(kSortThreads)
bc7_untransform_kernel(const uint8_t* __restrict__ in, uint4* __restrict__ out, int64_t n) {
  uint8_t* stage = reinterpret_cast<uint8_t*>(chunk_smem);
  int* offsets = reinterpret_cast<int*>(stage + kOffsetsAt);
  __shared__ int warp_sums[kWarps];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int count = static_cast<int>(n - first < kChunk ? n - first : kChunk);
  uint32_t mode[kRounds];
  int rank[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = r * kSortThreads + threadIdx.x;
    mode[r] = kModes;
    rank[r] = i;
    if constexpr (SORT) {
      if (i < count) {
        // first is even, so block first + i's nibble is the (i & 1) one
        const uint32_t b = in[(first + i) >> 1];
        mode[r] = (i & 1) ? b >> 4 : b & 15u;
      }
    }
  }
  if constexpr (SORT) stable_ranks(mode, rank, offsets, warp_sums);
  const uint8_t* payload = in + (SORT ? (n + 1) / 2 : 0);
  if constexpr (PLANES) {
    for (int p = 0; p < 16; ++p) {
      load_bytes(stage + p * kChunk, payload + p * n + first, count);
    }
  } else {
    load_bytes(stage, payload + 16 * first, 16 * count);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = r * kSortThreads + threadIdx.x;
    if (i >= count) continue;
    if constexpr (PLANES) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        w[p >> 2] |= static_cast<uint32_t>(stage[p * kChunk + rank[r]]) << (8 * (p & 3));
      }
      out[first + i] = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      out[first + i] = chunk_smem[rank[r]];
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

template <bool SORT, bool PLANES>
cudaError_t launch_untransform(const void* in, void* out, int64_t n, cudaStream_t st) {
  const auto kernel = bc7_untransform_kernel<SORT, PLANES>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<chunks_for(n), kSortThreads, kSmemBytes, st>>>(
      static_cast<const uint8_t*>(in), static_cast<uint4*>(out), n);
  return cudaGetLastError();
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

}  // extern "C"
