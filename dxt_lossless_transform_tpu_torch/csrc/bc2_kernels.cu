// The BC2 kernels of the BC2 DDS auto-transform and load path, for sm_90a.
//
// Built with the other sources by one nvcc call into one shared library with a
// plain C interface (dxt_lossless_transform_tpu_torch/backend.py) and called
// through ctypes. Every entry point launches on the stream it is given, allocates
// nothing and returns cudaGetLastError(). The LTU count kernel that scores the BC2
// colour regions is the one in bc1_kernels.cu.
//
// Byte layouts are the on-disk ones (little-endian, as is the card). BC2 block b is
// 16 bytes at 16b, read as four u32 words:
//   w0, w1 = the 8 bytes of explicit 4-bit alpha,
//   w2 = colour word c0 | c1 << 16,  w3 = colour-index word.
// Transformed (dxt_lossless_transform_tpu/oracle/bc2.py; stream sizes per block are
// those of dxt_lossless_transform_tpu/ops/hostwrap.py:bc2_stream_spec, (8, 4, 4) or
// split (8, 2, 2, 4)):
//   [0, 8n)    the 8 alpha bytes of block b at 8b, untouched
//   [8n, 12n)  colours: the decorrelated word as u32 at 8n+4b, or, split, d0 u16
//              at 8n+2b and d1 u16 at 10n+2b
//   [12n, 16n) colour-index words, u32 at 12n+4b
// n may be any block count (odd, or 1); nothing is padded. Every stream base is
// 4-byte aligned except 10n, which is 2-byte aligned for odd n and is written as
// u16 only.

#include "common.cuh"

namespace {

// ---- dlt_bc2_transform -----------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/shuffle.py:218 bc2_transform_tpu
// (kernel _bc2_t_kernel). Bound by bytes: 16n read, 16n written, ~27 integer
// operations per block for the colour pair. One thread per block: one 16-byte
// load, an 8-byte store of the alpha half and 2- or 4-byte stores of the colour
// and index words, neighbouring threads on neighbouring addresses. The TPU
// kernel's even/odd phases and transposed tiles existed for the TPU's (8, 128)
// layout and have no counterpart here.
// Block b of n: the per-block body, which the rows kernel shares.
template <int V, bool SPLIT>
__device__ __forceinline__ void bc2_transform_block(const uint4* __restrict__ in,
                                                    uint8_t* __restrict__ out, int64_t n,
                                                    int64_t b) {
  const uint4 blk = in[b];
  reinterpret_cast<uint2*>(out)[b] = make_uint2(blk.x, blk.y);
  const uint32_t d = decorrelate_pair<V>(blk.z);
  if constexpr (SPLIT) {
    reinterpret_cast<uint16_t*>(out + 8 * n)[b] = static_cast<uint16_t>(d & 0xFFFFu);
    reinterpret_cast<uint16_t*>(out + 10 * n)[b] = static_cast<uint16_t>(d >> 16);
  } else {
    reinterpret_cast<uint32_t*>(out + 8 * n)[b] = d;
  }
  reinterpret_cast<uint32_t*>(out + 12 * n)[b] = blk.w;
}

template <int V, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
bc2_transform_kernel(const uint4* __restrict__ in, uint8_t* __restrict__ out, int64_t n) {
  const int64_t b = global_thread();
  if (b >= n) return;
  bc2_transform_block<V, SPLIT>(in, out, n, b);
}

// ---- dlt_bc2_transform_rows --------------------------------------------------------
// The end of the batch pipeline's BC2 step: every file of a (B, 16·bucket) batch
// transformed under its own winner, in the per-file layout at its row's base (the
// rows form, common.cuh). Bound by bytes: 16·n_r read and written per row. Settings
// index variant * 2 + split (with_variant_split, as the per-file entry point).
__global__ void __launch_bounds__(kThreads)
bc2_transform_rows_kernel(const uint4* __restrict__ in, uint8_t* __restrict__ out,
                          const int64_t* __restrict__ ns, const int64_t* __restrict__ best,
                          int64_t bucket, uint64_t code, int64_t row0) {
  RowBlock rb;
  if (!row_block(ns, best, code, row0, rb)) return;
  const uint4* src = in + rb.row * bucket;
  uint8_t* dst = out + rb.row * 16 * bucket;
  with_variant_split(rb.settings, [&](auto s) {
    using S = decltype(s);
    bc2_transform_block<S::V, S::SPLIT>(src, dst, rb.n, rb.b);
  });
}

// ---- dlt_bc2_untransform -----------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/shuffle.py:245 bc2_untransform_tpu
// (kernel _bc2_u_kernel), the kernel of the BC2 load path. Bound by bytes as the
// transform is; the exact inverse, with one 16-byte store per block.
template <int V, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
bc2_untransform_kernel(const uint8_t* __restrict__ in, uint4* __restrict__ out, int64_t n) {
  const int64_t b = global_thread();
  if (b >= n) return;
  const uint2 alpha = reinterpret_cast<const uint2*>(in)[b];
  uint32_t d;
  if constexpr (SPLIT) {
    d = static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(in + 8 * n)[b])
        | (static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(in + 10 * n)[b]) << 16);
  } else {
    d = reinterpret_cast<const uint32_t*>(in + 8 * n)[b];
  }
  out[b] = make_uint4(alpha.x, alpha.y, recorrelate_pair<V>(d),
                      reinterpret_cast<const uint32_t*>(in + 12 * n)[b]);
}

// ---- dlt_bc2_regions -----------------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/regions.py:83 bc2_region_streams_tpu
// (kernel _bc2_regions_kernel) and the rows of
// dxt_lossless_transform_tpu/ops/auto.py:bc2_candidate_regions, one per distinct
// (variant, split): row c of out (u8[K, 4n], K <= 8) is the colour stream that key
// c of `code` writes at [8n, 12n), built from word 2 of each block by the BC1
// region code (write_colour_rows). Bound by bytes: 16n read (one 16-byte load per
// block; only w2 is used, but a strided 4-byte load costs the same sectors), 4n
// written per row.
__global__ void __launch_bounds__(kThreads)
bc2_regions_kernel(const uint4* __restrict__ in, uint8_t* __restrict__ out, int64_t n,
                   uint32_t code, int n_cand) {
  const int64_t b = global_thread();
  if (b >= n) return;
  write_colour_rows(in[b].z, out, n, b, code, n_cand);
}

template <int V, bool S>
cudaError_t launch_transform(const void* in, void* out, int64_t n, cudaStream_t st) {
  bc2_transform_kernel<V, S><<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const uint4*>(in), static_cast<uint8_t*>(out), n);
  return cudaGetLastError();
}

template <int V, bool S>
cudaError_t launch_untransform(const void* in, void* out, int64_t n, cudaStream_t st) {
  bc2_untransform_kernel<V, S><<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(in), static_cast<uint4*>(out), n);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, void*, int64_t, cudaStream_t);

// the 8 instantiations, indexed by variant * 2 + split
constexpr Launch kUntransform[8] = {
    launch_untransform<0, false>, launch_untransform<0, true>,
    launch_untransform<1, false>, launch_untransform<1, true>,
    launch_untransform<2, false>, launch_untransform<2, true>,
    launch_untransform<3, false>, launch_untransform<3, true>,
};

}  // namespace

// ---- C entry points --------------------------------------------------------------------
extern "C" {

int dlt_bc2_transform(const void* in, void* out, int64_t n, int64_t variant,
                      int64_t split, void* stream) {
  if (n <= 0 || variant < 0 || variant > 3) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_variant_split(variant_split_index(variant, split), [&](auto s) {
    using S = decltype(s);
    return launch_transform<S::V, S::SPLIT>(in, out, n, st);
  });
}

int dlt_bc2_transform_rows(const void* in, void* out, const void* ns, const void* best,
                           int64_t rows, int64_t bucket, int64_t code, int64_t n_cand,
                           void* stream) {
  if (!rows_args_valid(rows, bucket, n_cand)) return cudaErrorInvalidValue;
  return launch_rows<uint4>(bc2_transform_rows_kernel, in, out, ns, best, rows, bucket,
                            code, static_cast<cudaStream_t>(stream));
}

int dlt_bc2_untransform(const void* in, void* out, int64_t n, int64_t variant,
                        int64_t split, void* stream) {
  if (n <= 0 || variant < 0 || variant > 3) return cudaErrorInvalidValue;
  return kUntransform[variant * 2 + (split ? 1 : 0)](in, out, n,
                                                     static_cast<cudaStream_t>(stream));
}

int dlt_bc2_regions(const void* in, void* out, int64_t n, int64_t code, int64_t n_cand,
                    void* stream) {
  if (n <= 0 || n_cand <= 0 || n_cand > 8) return cudaErrorInvalidValue;
  bc2_regions_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<uint8_t*>(out), n,
      static_cast<uint32_t>(code), static_cast<int>(n_cand));
  return cudaGetLastError();
}

}  // extern "C"
