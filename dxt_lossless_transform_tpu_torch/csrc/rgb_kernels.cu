// The RGBA8888, BGRA8888 and BGR888 kernels of the uncompressed-RGB DDS
// auto-transform and load path, for sm_90a.
//
// Built with the other sources by one nvcc call into one shared library with a
// plain C interface (dxt_lossless_transform_tpu_torch/backend.py) and called
// through ctypes. Every entry point launches on the stream it is given, allocates
// nothing and returns cudaGetLastError().
//
// Byte layouts are the on-disk ones (dxt_lossless_transform_tpu/oracle/rgb.py). A
// pixel is S bytes, S = 4 for rgba8888 and bgra8888 and 3 for bgr888, channel c at
// byte c; red, green and blue are bytes (ri, gi, bi) = (0, 1, 2) for rgba8888 and
// (2, 1, 0) for bgra8888 and bgr888. For n pixels, transformed:
//   dec:   r' = r - g and b' = b - g, mod 256; green and alpha as they are;
//   split: plane c, byte c of every pixel, at [c*n, (c+1)*n);
//   else:  the pixels interleaved, as in the input.
// Every layout has gi = 1 and {ri, bi} = {0, 2}: the lifting always touches
// channels 0 and 2, so the kernels are instantiated on S alone and the entry points
// refuse any other channel map. n may be any pixel count; nothing is padded. Plane
// c starts at c*n, and the auto-search writes each candidate into a row of one
// tensor at S*n*r, both of any alignment, and the callers may hand in rows at any
// byte offset, so every global range moves through common.cuh's load_bytes and
// store_bytes: aligned 4-byte words, neighbouring threads on neighbouring words.

#include "common.cuh"

namespace {

constexpr int kRgbTile = 4096;         // pixels per thread block
constexpr int kPlane = kRgbTile + 16;  // bytes per channel in shared memory, with
                                       // the slack that store_bytes reads past len

// The S words of 4 consecutive pixels (4S bytes) -> S channel words, word c holding
// byte c of the 4 pixels, pixel p in byte p. For S = 3 the 12 bytes are
//   w0 = c0 c1 c2 c0'  w1 = c1' c2' c0'' c1''  w2 = c2'' c0''' c1''' c2'''
// (dxt_lossless_transform_tpu/ops/pallas/channels.py:111-116, _bgr_quad_channels).
template <int S>
__device__ __forceinline__ void split_quad(const uint32_t (&w)[S], uint32_t (&ch)[S]) {
#pragma unroll
  for (int c = 0; c < S; ++c) {
    uint32_t v = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int k = S * p + c;
      v |= ((w[k >> 2] >> (8 * (k & 3))) & 0xFFu) << (8 * p);
    }
    ch[c] = v;
  }
}

// Inverse of split_quad.
template <int S>
__device__ __forceinline__ void merge_quad(const uint32_t (&ch)[S], uint32_t (&w)[S]) {
#pragma unroll
  for (int j = 0; j < S; ++j) w[j] = 0;
#pragma unroll
  for (int c = 0; c < S; ++c) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int k = S * p + c;
      w[k >> 2] |= ((ch[c] >> (8 * p)) & 0xFFu) << (8 * (k & 3));
    }
  }
}

// Quad q's S interleaved words in a shared tile: one 16-byte access for S = 4 (a
// stride of 4 words would put 4 lanes on each bank), 3 words for S = 3 (stride 3
// meets every bank once).
template <int S>
__device__ __forceinline__ void load_quad(const uint8_t* tile, int q, uint32_t (&w)[S]) {
  if constexpr (S == 4) {
    const uint4 v = reinterpret_cast<const uint4*>(tile)[q];
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < S; ++j) w[j] = reinterpret_cast<const uint32_t*>(tile)[S * q + j];
  }
}

template <int S>
__device__ __forceinline__ void store_quad(uint8_t* tile, int q, const uint32_t (&w)[S]) {
  if constexpr (S == 4) {
    reinterpret_cast<uint4*>(tile)[q] = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int j = 0; j < S; ++j) reinterpret_cast<uint32_t*>(tile)[S * q + j] = w[j];
  }
}

__device__ __forceinline__ int tile_len(int64_t n, int64_t p0) {
  const int64_t left = n - p0;
  return left < kRgbTile ? static_cast<int>(left) : kRgbTile;
}

// ---- dlt_rgb_transform -------------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/channels.py:58 split_channels_tpu
// (S = 4) and :158 split_bgr_tpu (S = 3), and the XLA decorrelate-only route of
// dxt_lossless_transform_tpu/ops/rgb.py:31-80 (_decorrelate_words_xla,
// _transform_xla). Bound by bytes: S*n read and S*n written (0.040065 ms for the
// 4096x4096 RGBA8888 file, 0.030049 ms for BGR888, at 3.35 TB/s); the lifting is
// two per-byte SIMD subtractions (__vsub4) per 4 pixels. One thread block per tile of
// 4096 pixels: the tile's S*4096 bytes come into shared memory as aligned words,
// each thread turns 4 pixels into S channel words in registers (byte moves and the
// lifting), writes them to the tile's planes (or back interleaved) in shared
// memory, and the block writes each plane's 4096 bytes to c*n + tile start. The
// TPU kernels' pixel-phase transposes and 262,144-pixel tiles existed for its
// (8, 128) layout and have no counterpart here.
template <int S, bool DEC, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
rgb_transform_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint8_t tile_in[S * kPlane];
  __shared__ __align__(16) uint8_t tile_out[S * kPlane];
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kRgbTile;
  const int len = tile_len(n, p0);
  load_bytes(tile_in, in + S * p0, S * len);
  __syncthreads();
  // the last quad of a ragged tile reads bytes past S*len; what they give lands
  // only in bytes past len, which are not stored
  const int quads = (len + 3) >> 2;
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    uint32_t w[S], ch[S];
    load_quad<S>(tile_in, q, w);
    split_quad<S>(w, ch);
    if constexpr (DEC) {
      ch[0] = __vsub4(ch[0], ch[1]);
      ch[2] = __vsub4(ch[2], ch[1]);
    }
    if constexpr (SPLIT) {
#pragma unroll
      for (int c = 0; c < S; ++c) reinterpret_cast<uint32_t*>(tile_out + c * kPlane)[q] = ch[c];
    } else {
      merge_quad<S>(ch, w);
      store_quad<S>(tile_out, q, w);
    }
  }
  __syncthreads();
  if constexpr (SPLIT) {
#pragma unroll
    for (int c = 0; c < S; ++c) store_bytes(out + c * n + p0, tile_out + c * kPlane, len);
  } else {
    store_bytes(out + S * p0, tile_out, S * len);
  }
}

// ---- dlt_rgb_untransform -----------------------------------------------------------
// Replaces dxt_lossless_transform_tpu/ops/pallas/channels.py:92 merge_channels_tpu
// (S = 4) and :197 merge_bgr_tpu (S = 3), and the XLA recorrelate-only route of
// ops/rgb.py (_recorrelate_words_xla, _untransform_xla): the kernel of the RGB load
// path. Bound by bytes as the transform is. The exact inverse: the tile's part of
// each of the S planes (or its interleaved bytes) comes into shared memory, each
// thread restores 4 pixels with r = r' + g and b = b' + g (__vadd4) and interleaves
// them in shared memory, and the block writes the tile's S*4096 bytes in one
// coalesced pass.
template <int S, bool DEC, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
rgb_untransform_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                       int64_t n) {
  __shared__ __align__(16) uint8_t tile_in[S * kPlane];
  __shared__ __align__(16) uint8_t tile_out[S * kPlane];
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kRgbTile;
  const int len = tile_len(n, p0);
  if constexpr (SPLIT) {
#pragma unroll
    for (int c = 0; c < S; ++c) load_bytes(tile_in + c * kPlane, in + c * n + p0, len);
  } else {
    load_bytes(tile_in, in + S * p0, S * len);
  }
  __syncthreads();
  const int quads = (len + 3) >> 2;
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    uint32_t w[S], ch[S];
    if constexpr (SPLIT) {
#pragma unroll
      for (int c = 0; c < S; ++c) ch[c] = reinterpret_cast<const uint32_t*>(tile_in + c * kPlane)[q];
    } else {
      load_quad<S>(tile_in, q, w);
      split_quad<S>(w, ch);
    }
    if constexpr (DEC) {
      ch[0] = __vadd4(ch[0], ch[1]);
      ch[2] = __vadd4(ch[2], ch[1]);
    }
    merge_quad<S>(ch, w);
    store_quad<S>(tile_out, q, w);
  }
  __syncthreads();
  store_bytes(out + S * p0, tile_out, S * len);
}

template <int S, bool DEC, bool SPLIT>
void launch_rgb(bool forward, const uint8_t* in, uint8_t* out, int64_t n, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>((n + kRgbTile - 1) / kRgbTile);
  if (forward) {
    rgb_transform_kernel<S, DEC, SPLIT><<<grid, kThreads, 0, st>>>(in, out, n);
  } else {
    rgb_untransform_kernel<S, DEC, SPLIT><<<grid, kThreads, 0, st>>>(in, out, n);
  }
}

template <int S>
void launch_rgb_stride(bool forward, const uint8_t* in, uint8_t* out, int64_t n, bool dec,
                       bool split, cudaStream_t st) {
  if (dec && split) {
    launch_rgb<S, true, true>(forward, in, out, n, st);
  } else if (dec) {
    launch_rgb<S, true, false>(forward, in, out, n, st);
  } else if (split) {
    launch_rgb<S, false, true>(forward, in, out, n, st);
  } else {
    launch_rgb<S, false, false>(forward, in, out, n, st);
  }
}

int rgb_entry(bool forward, const void* in, void* out, int64_t n, int64_t stride,
              int64_t ri, int64_t gi, int64_t bi, int64_t dec, int64_t split,
              void* stream) {
  const bool channels_ok = gi == 1 && ((ri == 0 && bi == 2) || (ri == 2 && bi == 0));
  if (n <= 0 || (stride != 3 && stride != 4) || !channels_ok) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  if (stride == 4) {
    launch_rgb_stride<4>(forward, src, dst, n, dec != 0, split != 0, st);
  } else {
    launch_rgb_stride<3>(forward, src, dst, n, dec != 0, split != 0, st);
  }
  return cudaGetLastError();
}

}  // namespace

// ---- C entry points --------------------------------------------------------------------
extern "C" {

// n pixels of `stride` bytes from `in` to `out`, each at any alignment in an
// allocation that starts 4-byte aligned; the two must not overlap.
int dlt_rgb_transform(const void* in, void* out, int64_t n, int64_t stride, int64_t ri,
                      int64_t gi, int64_t bi, int64_t dec, int64_t split, void* stream) {
  return rgb_entry(true, in, out, n, stride, ri, gi, bi, dec, split, stream);
}

int dlt_rgb_untransform(const void* in, void* out, int64_t n, int64_t stride, int64_t ri,
                        int64_t gi, int64_t bi, int64_t dec, int64_t split, void* stream) {
  return rgb_entry(false, in, out, n, stride, ri, gi, bi, dec, split, stream);
}

}  // extern "C"
