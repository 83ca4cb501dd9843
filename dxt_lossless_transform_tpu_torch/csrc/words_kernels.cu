// The word deinterleave of the corpus batch steps, for sm_90a.
//
// Built with the other sources by one nvcc call into one shared library with a
// plain C interface (dxt_lossless_transform_tpu_torch/backend.py) and called
// through ctypes. The entry point launches on the stream it is given, allocates
// nothing and returns cudaGetLastError().
//
// ---- dlt_deinterleave_words ---------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/planes.py:159 deinterleave_words_tpu.
// For k in {2, 4} and any N, the k*N words of `in` go to k streams of N words, stream
// i at out + i*N: out[i][j] = in[k*j + i]. The batch steps run it on a whole flat
// (files x words) batch, which splits every block into its words (BC1: colour and
// index word; BC2-BC5: the block's four words).
//
// Bound by bytes: 4kN read and 4kN written, no arithmetic. The TPU kernel needed
// k*N % 2048 == 0 (its tile grid), and the JAX package gated it on that and fell
// back to XLA otherwise; here one thread block takes a tile of kTileWords words of
// every stream, so any N works and the last tile is partial. The block reads its
// k*kTileWords input words with neighbouring threads on neighbouring addresses into
// shared memory, then writes each stream's kTileWords words the same way. The
// shared reads are strided by k, which would put k threads of a warp on one bank;
// one pad word after every 32 (word w at w + w/32) spreads them over all 32 banks.

#include "common.cuh"

namespace {

constexpr int kTileWords = 1024;  // words of each stream per block

__device__ __forceinline__ int padded(int w) { return w + (w >> 5); }

template <int K>
__global__ void __launch_bounds__(kThreads)
deinterleave_words_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                          int64_t n) {
  __shared__ uint32_t tile[K * kTileWords + K * kTileWords / 32];
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kTileWords;
  const int64_t left = n - j0;
  const int count = left < kTileWords ? static_cast<int>(left) : kTileWords;
  const uint32_t* src = in + K * j0;
  for (int w = threadIdx.x; w < K * count; w += kThreads) tile[padded(w)] = src[w];
  __syncthreads();
  for (int i = 0; i < K; ++i) {
    uint32_t* dst = out + i * n + j0;
    for (int t = threadIdx.x; t < count; t += kThreads) dst[t] = tile[padded(K * t + i)];
  }
}

}  // namespace

extern "C" {

// in: k*n u32 words; out: k*n u32 words, stream i at out + i*n; k is 2 or 4.
int dlt_deinterleave_words(const void* in, void* out, int64_t n, int64_t k, void* stream) {
  if (n <= 0 || (k != 2 && k != 4)) return cudaErrorInvalidValue;
  const int64_t tiles = (n + kTileWords - 1) / kTileWords;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* src = static_cast<const uint32_t*>(in);
  uint32_t* dst = static_cast<uint32_t*>(out);
  if (k == 2) {
    deinterleave_words_kernel<2><<<grid, kThreads, 0, st>>>(src, dst, n);
  } else {
    deinterleave_words_kernel<4><<<grid, kThreads, 0, st>>>(src, dst, n);
  }
  return cudaGetLastError();
}

}  // extern "C"
