// The BC4 and BC5 kernels of the BC4/BC5 DDS auto-transform and load path, for
// sm_90a.
//
// Built with the other sources by one nvcc call into one shared library with a
// plain C interface (dxt_lossless_transform_tpu_torch/backend.py) and called
// through ctypes. Every entry point launches on the stream it is given, allocates
// nothing and returns cudaGetLastError().
//
// Byte layouts are the on-disk ones (dxt_lossless_transform_tpu/oracle/bc4.py,
// little-endian, as is the card). A BC4 block is one 8-byte alpha section (a0, a1,
// 6 index bytes; common.cuh), a BC5 block two of them, red then green. Transformed:
//   BC4: [0, 2n) endpoints (a0 | a1 << 8 u16 at 2b, or, split, a0 at b and a1 at
//        n+b), [2n, 8n) the 6 index bytes of block b at 2n+6b;
//   BC5: [0, 2n) red endpoints and [2n, 4n) green endpoints (each as BC4's),
//        [4n, 10n) red index bytes at 4n+6b, [10n, 16n) green index bytes at
//        10n+6b.
// n may be any block count (odd, or 1); nothing is padded. The stream bases 2n,
// 4n and 10n are only 2-byte aligned for odd n, and the split byte streams at n,
// 2n and 3n only 1-byte aligned, so every stream is written as u16 or bytes
// (the alpha-section helpers of common.cuh).

#include "common.cuh"

namespace {

// ---- dlt_bc4_transform -----------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/shuffle.py:420 bc4_transform_tpu
// (kernel _bc4_t_kernel). Bound by bytes: 8n read, 8n written, no arithmetic. One
// thread per block: one 8-byte load, then 1- and 2-byte stores that neighbouring
// threads make to neighbouring addresses. The TPU kernel's even/odd phases and
// the aw0/aw1/aw2 weave of the index words existed for the TPU's (8, 128) layout
// and have no counterpart here.
// Block b of n: the per-block body, which the rows kernel shares.
template <bool SPLIT>
__device__ __forceinline__ void bc4_transform_block(const uint2* __restrict__ in,
                                                    uint8_t* __restrict__ out, int64_t n,
                                                    int64_t b) {
  const uint2 blk = in[b];
  store_alpha_endpoints<SPLIT>(out, n, b, blk.x);
  store_alpha_index(out + 2 * n, b, blk.x, blk.y);
}

template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
bc4_transform_kernel(const uint2* __restrict__ in, uint8_t* __restrict__ out, int64_t n) {
  const int64_t b = global_thread();
  if (b >= n) return;
  bc4_transform_block<SPLIT>(in, out, n, b);
}

// ---- dlt_bc4_untransform -----------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/shuffle.py:443 bc4_untransform_tpu
// (kernel _bc4_u_kernel), the kernel of the BC4 load path. Bound by bytes as the
// transform is; the exact inverse, with one 8-byte store per block.
template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
bc4_untransform_kernel(const uint8_t* __restrict__ in, uint2* __restrict__ out, int64_t n) {
  const int64_t b = global_thread();
  if (b >= n) return;
  out[b] = load_alpha_section(in + 2 * n, b, load_alpha_endpoints<SPLIT>(in, n, b));
}

// ---- dlt_bc5_transform -----------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/shuffle.py:471 bc5_transform_tpu
// (kernel _bc5_t_kernel). Bound by bytes: 16n read, 16n written. One thread per
// block: one 16-byte load, then the red and the green section's stores, as BC4's.
// Block b of n: the per-block body, which the rows kernel shares.
template <bool SPLIT>
__device__ __forceinline__ void bc5_transform_block(const uint4* __restrict__ in,
                                                    uint8_t* __restrict__ out, int64_t n,
                                                    int64_t b) {
  const uint4 blk = in[b];
  store_alpha_endpoints<SPLIT>(out, n, b, blk.x);
  store_alpha_endpoints<SPLIT>(out + 2 * n, n, b, blk.z);
  store_alpha_index(out + 4 * n, b, blk.x, blk.y);
  store_alpha_index(out + 10 * n, b, blk.z, blk.w);
}

template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
bc5_transform_kernel(const uint4* __restrict__ in, uint8_t* __restrict__ out, int64_t n) {
  const int64_t b = global_thread();
  if (b >= n) return;
  bc5_transform_block<SPLIT>(in, out, n, b);
}

// ---- dlt_bc4_transform_rows, dlt_bc5_transform_rows ------------------------------
// The end of the batch pipeline's BC4 and BC5 steps: every file of a (B, 8·bucket)
// or (B, 16·bucket) batch transformed under its own winner, in the per-file layout at
// its row's base (the rows form, common.cuh). Bound by bytes: the row's blocks read
// and written once. Settings index: split (with_split, as the per-file entry points).
__global__ void __launch_bounds__(kThreads)
bc4_transform_rows_kernel(const uint2* __restrict__ in, uint8_t* __restrict__ out,
                          const int64_t* __restrict__ ns, const int64_t* __restrict__ best,
                          int64_t bucket, uint64_t code, int64_t row0) {
  RowBlock rb;
  if (!row_block(ns, best, code, row0, rb)) return;
  const uint2* src = in + rb.row * bucket;
  uint8_t* dst = out + rb.row * 8 * bucket;
  with_split(rb.settings, [&](auto s) {
    bc4_transform_block<decltype(s)::SPLIT>(src, dst, rb.n, rb.b);
  });
}

__global__ void __launch_bounds__(kThreads)
bc5_transform_rows_kernel(const uint4* __restrict__ in, uint8_t* __restrict__ out,
                          const int64_t* __restrict__ ns, const int64_t* __restrict__ best,
                          int64_t bucket, uint64_t code, int64_t row0) {
  RowBlock rb;
  if (!row_block(ns, best, code, row0, rb)) return;
  const uint4* src = in + rb.row * bucket;
  uint8_t* dst = out + rb.row * 16 * bucket;
  with_split(rb.settings, [&](auto s) {
    bc5_transform_block<decltype(s)::SPLIT>(src, dst, rb.n, rb.b);
  });
}

// ---- dlt_bc5_untransform -----------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/shuffle.py:501 bc5_untransform_tpu
// (kernel _bc5_u_kernel), the kernel of the BC5 load path. Bound by bytes as the
// transform is; the exact inverse, with one 16-byte store per block.
template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
bc5_untransform_kernel(const uint8_t* __restrict__ in, uint4* __restrict__ out, int64_t n) {
  const int64_t b = global_thread();
  if (b >= n) return;
  const uint2 r = load_alpha_section(in + 4 * n, b, load_alpha_endpoints<SPLIT>(in, n, b));
  const uint2 g = load_alpha_section(in + 10 * n, b,
                                     load_alpha_endpoints<SPLIT>(in + 2 * n, n, b));
  out[b] = make_uint4(r.x, r.y, g.x, g.y);
}

}  // namespace

// ---- C entry points --------------------------------------------------------------------
extern "C" {

int dlt_bc4_transform(const void* in, void* out, int64_t n, int64_t split, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2* src = static_cast<const uint2*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  with_split(split ? 1u : 0u, [&](auto s) {
    bc4_transform_kernel<decltype(s)::SPLIT><<<blocks_for(n), kThreads, 0, st>>>(src, dst, n);
  });
  return cudaGetLastError();
}

int dlt_bc4_transform_rows(const void* in, void* out, const void* ns, const void* best,
                           int64_t rows, int64_t bucket, int64_t code, int64_t n_cand,
                           void* stream) {
  if (!rows_args_valid(rows, bucket, n_cand)) return cudaErrorInvalidValue;
  return launch_rows<uint2>(bc4_transform_rows_kernel, in, out, ns, best, rows, bucket,
                            code, static_cast<cudaStream_t>(stream));
}

int dlt_bc5_transform_rows(const void* in, void* out, const void* ns, const void* best,
                           int64_t rows, int64_t bucket, int64_t code, int64_t n_cand,
                           void* stream) {
  if (!rows_args_valid(rows, bucket, n_cand)) return cudaErrorInvalidValue;
  return launch_rows<uint4>(bc5_transform_rows_kernel, in, out, ns, best, rows, bucket,
                            code, static_cast<cudaStream_t>(stream));
}

int dlt_bc4_untransform(const void* in, void* out, int64_t n, int64_t split,
                        void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint2* dst = static_cast<uint2*>(out);
  if (split) {
    bc4_untransform_kernel<true><<<blocks_for(n), kThreads, 0, st>>>(src, dst, n);
  } else {
    bc4_untransform_kernel<false><<<blocks_for(n), kThreads, 0, st>>>(src, dst, n);
  }
  return cudaGetLastError();
}

int dlt_bc5_transform(const void* in, void* out, int64_t n, int64_t split, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* src = static_cast<const uint4*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  with_split(split ? 1u : 0u, [&](auto s) {
    bc5_transform_kernel<decltype(s)::SPLIT><<<blocks_for(n), kThreads, 0, st>>>(src, dst, n);
  });
  return cudaGetLastError();
}

int dlt_bc5_untransform(const void* in, void* out, int64_t n, int64_t split,
                        void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint4* dst = static_cast<uint4*>(out);
  if (split) {
    bc5_untransform_kernel<true><<<blocks_for(n), kThreads, 0, st>>>(src, dst, n);
  } else {
    bc5_untransform_kernel<false><<<blocks_for(n), kThreads, 0, st>>>(src, dst, n);
  }
  return cudaGetLastError();
}

}  // extern "C"
