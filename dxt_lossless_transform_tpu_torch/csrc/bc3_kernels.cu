// The BC3 kernels of the BC3 DDS auto-transform and load path, for sm_90a.
//
// Built with the other sources by one nvcc call into one shared library with a plain
// C interface (dxt_lossless_transform_tpu_torch/backend.py) and called through
// ctypes. Every entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError(). The LTU count kernel that scores the BC3 regions
// is the one in bc1_kernels.cu.
//
// Byte layouts are the on-disk ones (little-endian, as is the card). BC3 block b is
// 16 bytes at 16b, read as four u32 words:
//   w0 = a0 | a1 << 8 | alpha-index bytes 0-1 << 16,  w1 = alpha-index bytes 2-5,
//   w2 = colour word c0 | c1 << 16,                   w3 = colour-index word.
// Transformed (dxt_lossless_transform_tpu/oracle/bc3.py; stream sizes per block are
// those of dxt_lossless_transform_tpu/ops/hostwrap.py:bc3_stream_spec):
//   [0, 2n)    alpha endpoints: a0 | a1 << 8 as u16 at 2b, or, split, a0 at b and
//              a1 at n+b
//   [2n, 8n)   the 6 alpha-index bytes of block b at 2n+6b
//   [8n, 12n)  colours: the decorrelated word as u32 at 8n+4b, or, split, d0 u16
//              at 8n+2b and d1 u16 at 10n+2b
//   [12n, 16n) colour-index words, u32 at 12n+4b
// n may be any block count (odd, or 1); nothing is padded. The stream bases 2n and
// 10n are only 2-byte aligned for odd n, so those streams are written as u16 and
// bytes, never through a uint32_t pointer (the alpha-section helpers of common.cuh).

#include "common.cuh"

namespace {

// ---- a candidate's instantiation index ---------------------------------------------
// variant * 4 + split_alpha * 2 + split_colour, the index of the per-file entry
// points' instantiations and of the rows kernel's candidates (ops/cuda/shuffle.py's
// _ROWS mirrors it). with_bc3_settings(i, f) calls f with the tag of instantiation i,
// on the host to pick the per-file kernel and on the card to pick the rows kernel's
// per-block body: the one map from the index to the template.
template <int V_, bool SA_, bool SC_>
struct Bc3Settings {
  static constexpr int V = V_;
  static constexpr bool SA = SA_, SC = SC_;
};

inline unsigned bc3_settings_index(int64_t variant, int64_t split_alpha,
                                   int64_t split_colour) {
  return static_cast<unsigned>(variant * 4 + (split_alpha ? 2 : 0) + (split_colour ? 1 : 0));
}

#pragma nv_exec_check_disable
template <typename F>
__host__ __device__ __forceinline__ auto with_bc3_settings(unsigned i, F&& f) {
  switch (i) {
    case 0: return f(Bc3Settings<0, false, false>{});
    case 1: return f(Bc3Settings<0, false, true>{});
    case 2: return f(Bc3Settings<0, true, false>{});
    case 3: return f(Bc3Settings<0, true, true>{});
    case 4: return f(Bc3Settings<1, false, false>{});
    case 5: return f(Bc3Settings<1, false, true>{});
    case 6: return f(Bc3Settings<1, true, false>{});
    case 7: return f(Bc3Settings<1, true, true>{});
    case 8: return f(Bc3Settings<2, false, false>{});
    case 9: return f(Bc3Settings<2, false, true>{});
    case 10: return f(Bc3Settings<2, true, false>{});
    case 11: return f(Bc3Settings<2, true, true>{});
    case 12: return f(Bc3Settings<3, false, false>{});
    case 13: return f(Bc3Settings<3, false, true>{});
    case 14: return f(Bc3Settings<3, true, false>{});
    default: return f(Bc3Settings<3, true, true>{});
  }
}

// ---- dlt_bc3_transform -----------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/shuffle.py:301 bc3_transform_tpu
// (kernel _bc3_t_kernel). Bound by bytes: 16n read, 16n written, ~27 integer
// operations per block for the colour pair. One thread per block: one 16-byte
// load, then 1-, 2- and 4-byte stores that neighbouring threads make to
// neighbouring addresses. The TPU kernel's even/odd phases, stride-3 weave and
// power-of-two tiles existed for the TPU's (8, 128) layout and have no
// counterpart here.
// Block b of n: the per-block body, which the rows kernel shares.
template <int V, bool SA, bool SC>
__device__ __forceinline__ void bc3_transform_block(const uint4* __restrict__ in,
                                                    uint8_t* __restrict__ out, int64_t n,
                                                    int64_t b) {
  const uint4 blk = in[b];
  store_alpha_endpoints<SA>(out, n, b, blk.x);
  store_alpha_index(out + 2 * n, b, blk.x, blk.y);
  const uint32_t d = decorrelate_pair<V>(blk.z);
  if constexpr (SC) {
    reinterpret_cast<uint16_t*>(out + 8 * n)[b] = static_cast<uint16_t>(d & 0xFFFFu);
    reinterpret_cast<uint16_t*>(out + 10 * n)[b] = static_cast<uint16_t>(d >> 16);
  } else {
    reinterpret_cast<uint32_t*>(out + 8 * n)[b] = d;
  }
  reinterpret_cast<uint32_t*>(out + 12 * n)[b] = blk.w;
}

template <int V, bool SA, bool SC>
__global__ void __launch_bounds__(kThreads)
bc3_transform_kernel(const uint4* __restrict__ in, uint8_t* __restrict__ out, int64_t n) {
  const int64_t b = global_thread();
  if (b >= n) return;
  bc3_transform_block<V, SA, SC>(in, out, n, b);
}

// ---- dlt_bc3_transform_rows --------------------------------------------------------
// The end of the batch pipeline's BC3 step: every file of a (B, 16·bucket) batch
// transformed under its own winner, written at its row's base in the per-file
// layout above (the rows form, common.cuh). Bound by bytes as the per-file kernel:
// 16·n_r read and written per row, the padding neither read nor written. Settings
// index variant * 4 + split_alpha * 2 + split_colour (with_bc3_settings, as the
// per-file entry point).
__global__ void __launch_bounds__(kThreads)
bc3_transform_rows_kernel(const uint4* __restrict__ in, uint8_t* __restrict__ out,
                          const int64_t* __restrict__ ns, const int64_t* __restrict__ best,
                          int64_t bucket, uint64_t code, int64_t row0) {
  RowBlock rb;
  if (!row_block(ns, best, code, row0, rb)) return;
  const uint4* src = in + rb.row * bucket;
  uint8_t* dst = out + rb.row * 16 * bucket;
  with_bc3_settings(rb.settings, [&](auto s) {
    using S = decltype(s);
    bc3_transform_block<S::V, S::SA, S::SC>(src, dst, rb.n, rb.b);
  });
}

// ---- dlt_bc3_untransform -----------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/shuffle.py:354 bc3_untransform_tpu
// (kernel _bc3_u_kernel), the kernel of the BC3 load path. Bound by bytes as the
// transform is; the exact inverse, with one 16-byte store per block.
template <int V, bool SA, bool SC>
__global__ void __launch_bounds__(kThreads)
bc3_untransform_kernel(const uint8_t* __restrict__ in, uint4* __restrict__ out, int64_t n) {
  const int64_t b = global_thread();
  if (b >= n) return;
  const uint32_t ep = load_alpha_endpoints<SA>(in, n, b);
  const uint2 alpha = load_alpha_section(in + 2 * n, b, ep);
  uint32_t d;
  if constexpr (SC) {
    d = static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(in + 8 * n)[b])
        | (static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(in + 10 * n)[b]) << 16);
  } else {
    d = reinterpret_cast<const uint32_t*>(in + 8 * n)[b];
  }
  out[b] = make_uint4(alpha.x, alpha.y, recorrelate_pair<V>(d),
                      reinterpret_cast<const uint32_t*>(in + 12 * n)[b]);
}

// ---- dlt_bc3_regions -----------------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/regions.py:114 bc3_region_streams_tpu
// (kernel _bc3_regions_kernel) and the rows of the single-device
// dxt_lossless_transform_tpu/ops/auto.py:bc3_candidate_regions, deduplicated: a
// BC3 candidate's score is its alpha-endpoint region's plus its colour region's,
// and candidates that share a split_alpha, or a (variant, split_colour), share
// that row. Row a of alpha (u8[A, 2n], A <= 2) is the alpha-endpoint stream for
// split flag bit a of alpha_code; row c of colour (u8[K, 4n], K <= 8) is the
// colour stream for the 4-bit key c of colour_code, written by the BC1 region
// code (write_colour_rows). Bound by bytes: 16n read (one 16-byte load per block;
// only w0 and w2 are used, but a strided 4-byte load costs the same sectors),
// 2n written per alpha row and 4n per colour row.
__global__ void __launch_bounds__(kThreads)
bc3_regions_kernel(const uint4* __restrict__ in, uint8_t* __restrict__ alpha,
                   uint8_t* __restrict__ colour, int64_t n, uint32_t alpha_code,
                   int n_alpha, uint32_t colour_code, int n_colour) {
  const int64_t b = global_thread();
  if (b >= n) return;
  const uint4 blk = in[b];
  for (int a = 0; a < n_alpha; ++a) {
    uint8_t* row = alpha + static_cast<int64_t>(a) * 2 * n;
    if ((alpha_code >> a) & 1u) {
      store_alpha_endpoints<true>(row, n, b, blk.x);
    } else {
      store_alpha_endpoints<false>(row, n, b, blk.x);
    }
  }
  write_colour_rows(blk.z, colour, n, b, colour_code, n_colour);
}

template <int V, bool SA, bool SC>
cudaError_t launch_transform(const void* in, void* out, int64_t n, cudaStream_t st) {
  bc3_transform_kernel<V, SA, SC><<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const uint4*>(in), static_cast<uint8_t*>(out), n);
  return cudaGetLastError();
}

template <int V, bool SA, bool SC>
cudaError_t launch_untransform(const void* in, void* out, int64_t n, cudaStream_t st) {
  bc3_untransform_kernel<V, SA, SC><<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(in), static_cast<uint4*>(out), n);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, void*, int64_t, cudaStream_t);

constexpr Launch kUntransform[16] = {
    launch_untransform<0, false, false>, launch_untransform<0, false, true>,
    launch_untransform<0, true, false>,  launch_untransform<0, true, true>,
    launch_untransform<1, false, false>, launch_untransform<1, false, true>,
    launch_untransform<1, true, false>,  launch_untransform<1, true, true>,
    launch_untransform<2, false, false>, launch_untransform<2, false, true>,
    launch_untransform<2, true, false>,  launch_untransform<2, true, true>,
    launch_untransform<3, false, false>, launch_untransform<3, false, true>,
    launch_untransform<3, true, false>,  launch_untransform<3, true, true>,
};

}  // namespace

// ---- C entry points --------------------------------------------------------------------
extern "C" {

int dlt_bc3_transform(const void* in, void* out, int64_t n, int64_t variant,
                      int64_t split_alpha, int64_t split_colour, void* stream) {
  if (n <= 0 || variant < 0 || variant > 3) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_bc3_settings(bc3_settings_index(variant, split_alpha, split_colour),
                           [&](auto s) {
                             using S = decltype(s);
                             return launch_transform<S::V, S::SA, S::SC>(in, out, n, st);
                           });
}

int dlt_bc3_transform_rows(const void* in, void* out, const void* ns, const void* best,
                           int64_t rows, int64_t bucket, int64_t code, int64_t n_cand,
                           void* stream) {
  if (!rows_args_valid(rows, bucket, n_cand)) return cudaErrorInvalidValue;
  return launch_rows<uint4>(bc3_transform_rows_kernel, in, out, ns, best, rows, bucket,
                            code, static_cast<cudaStream_t>(stream));
}

int dlt_bc3_untransform(const void* in, void* out, int64_t n, int64_t variant,
                        int64_t split_alpha, int64_t split_colour, void* stream) {
  if (n <= 0 || variant < 0 || variant > 3) return cudaErrorInvalidValue;
  return kUntransform[bc3_settings_index(variant, split_alpha, split_colour)](
      in, out, n, static_cast<cudaStream_t>(stream));
}

int dlt_bc3_regions(const void* in, void* alpha, void* colour, int64_t n,
                    int64_t alpha_code, int64_t n_alpha, int64_t colour_code,
                    int64_t n_colour, void* stream) {
  if (n <= 0 || n_alpha < 0 || n_alpha > 2 || n_colour < 0 || n_colour > 8) {
    return cudaErrorInvalidValue;
  }
  bc3_regions_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<uint8_t*>(alpha),
      static_cast<uint8_t*>(colour), n, static_cast<uint32_t>(alpha_code),
      static_cast<int>(n_alpha), static_cast<uint32_t>(colour_code),
      static_cast<int>(n_colour));
  return cudaGetLastError();
}

}  // extern "C"
