// The fused mip pyramid: one launch builds one level of every surface and
// writes that level's blocks into the batch the block encoders read,
// written by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds its pyramid as an XLA
// program (cuttlefish_tpu/convert/device.py:_FusedPyramid), and the port
// built it on the card as host-launched torch ops, about 680 small device
// operations for a 2048^2 texture of 12 levels, whose launches left the
// card idle (convert/device.py:pyramid_blocks_plain, which stays the plain
// version, and is compared with this kernel on the card).  It computes what
// that function computes: level k from level k-1 as stored (sRGB-encoded
// where srgb is set) -> linear -> the separable resample, rows first, then
// columns, over the taps of convert/device.py:_taps -> sRGB -> level k's
// blocks, edge texels repeated into partial blocks (_tile), mip-major and
// surface-minor in one [N, bh*bw, 4] float32 batch.
//
// Design: a thread per texel of the level's padded block grid, taken in
// block order, so that neighbouring threads write neighbouring texels of
// the batch (16 bytes each) and a warp's reads of the level above stay in
// a few rows of it.  A thread computes each of its columns' row pass from
// the level above and folds the column pass over them; the column pass's
// inputs are made again by each thread that needs them (bit for bit the
// same values), which costs some reads from L1 and no shared memory or
// synchronisation.  Besides the blocks a thread writes its texel of the
// level in linear light (for sRGB the stored value decoded again, as the
// next level reads it), so that each texel is decoded once and the next
// launch reads linear values.  Level 0 is the same kernel without the
// resample: it tiles the input and, for sRGB, writes its linear image.
// Shapes, surface count, the filter's tap count, the block size and the
// sRGB flag are arguments; one build serves every format.
//
// What bounds it: bytes.  A 2048^2 sRGB texture reads its 64 MB level 0,
// writes its 89 MB of blocks and its 64 MB linear image once, and the
// smaller levels a third as much again: about 0.08 ms at 3.35 TB/s.  Its
// arithmetic (the taps' products and adds, 64 a channel for CatmullRom at
// a 2:1 step, and two powf a channel) is about a twentieth of that bound.
//
// Numerics, so that the kernel equals the torch ops bit for bit: each
// output is its taps' products added in source order, the zero-weight
// padding taps included (so -0.0, an inf or a NaN meet the same sums); the
// first term starts the sum (no 0 + x); products and adds are __fmul_rn and
// __fadd_rn, which nothing contracts; the sRGB transforms are
// srgb_to_linear_rgba and linear_to_srgb_rgba's float32 operations, the
// constants rounded to float32 as torch rounds a Python scalar, and the
// powers powf with the exponent rounded to float32, as torch's CUDA pow
// computes them.  No clamp: filter overshoot survives.
//
// The device functions are plain C++: the __global__ kernel and the
// launcher need nvcc and sit under __CUDACC__, and a CPU build runs the
// threads one after another (pyramid_level_cpu).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace pyr {

constexpr int kThreads = 256;  // threads a CTA

// One launch: level `out` of every surface from level `in`.
struct Level {
  const float* src;  // [s, h_in, w_in, 4]: the level above in linear light (level 0: as stored)
  float* lin;        // [s, h_out, w_out, 4]: this level in linear light for the next, or null
  float* blocks;     // [N, bh * bw, 4]: the batch; this level's blocks start at `first`
  long long first;
  int s, h_in, w_in, h_out, w_out;
  const int* idx_h;  // [h_out, k_h] source rows; k_h == 0: no resample (level 0)
  const float* wt_h;
  int k_h;
  const int* idx_w;  // [w_out, k_w] source columns
  const float* wt_w;
  int k_w;
  int bw, bh, srgb;
};

__device__ __forceinline__ float mul(float a, float b) {
#ifdef __CUDACC__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

__device__ __forceinline__ float add(float a, float b) {
#ifdef __CUDACC__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

__device__ __forceinline__ float sub(float a, float b) {
#ifdef __CUDACC__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
#ifdef __CUDACC__
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
#else
  memcpy(v, p, 4 * sizeof(float));
#endif
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
#ifdef __CUDACC__
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
#else
  memcpy(p, v, 4 * sizeof(float));
#endif
}

// srgb_to_linear_rgba on one channel: where(c <= 0.04045, c * f32(1/12.92),
// ((clamp(c, min=0.04045) + 0.055) * f32(1/1.055)) ** 2.4).  Past the test
// c is above the clamp's minimum or NaN, which the clamp passes.
__device__ __forceinline__ float to_linear(float c) {
  constexpr float kInv1292 = 1.0f / 12.92f;
  constexpr float kInv1055 = 1.0f / 1.055f;
  if (c <= 0.04045f) return mul(c, kInv1292);
  return powf(mul(add(c, 0.055f), kInv1055), 2.4f);
}

// linear_to_srgb_rgba on one channel: where(c <= 0.0031308, c * 12.92,
// 1.055 * clamp(c, min=0.0031308) ** (1 / 2.4) - 0.055).
__device__ __forceinline__ float to_srgb(float c) {
  constexpr float kInv24 = (float)(1.0 / 2.4);
  if (c <= 0.0031308f) return mul(c, 12.92f);
  return sub(mul(1.055f, powf(c, kInv24)), 0.055f);
}

// The resample of surface `sf` at output texel (y, x): for each column tap
// the row pass (the taps of row y over that column of the level above),
// then the column pass over those; each sum in tap order, its first term
// its start.
__device__ __forceinline__ void resample(const Level& L, int sf, int y, int x, float acc[4]) {
  const float* surf = L.src + (long long)sf * L.h_in * L.w_in * 4;
  const int* ih = L.idx_h + (long long)y * L.k_h;
  const float* wh = L.wt_h + (long long)y * L.k_h;
  const int* iw = L.idx_w + (long long)x * L.k_w;
  const float* ww = L.wt_w + (long long)x * L.k_w;
  for (int j = 0; j < L.k_w; ++j) {
    const float* col = surf + (long long)iw[j] * 4;
    float t[4];
    for (int i = 0; i < L.k_h; ++i) {
      float v[4];
      load4(col + (long long)ih[i] * L.w_in * 4, v);
      const float w = wh[i];
      for (int c = 0; c < 4; ++c) {
        const float p = mul(v[c], w);
        t[c] = i ? add(t[c], p) : p;
      }
    }
    const float w = ww[j];
    for (int c = 0; c < 4; ++c) {
      const float q = mul(t[c], w);
      acc[c] = j ? add(acc[c], q) : q;
    }
  }
}

// Thread i of surface sf: texel i of the level's padded blocks in block
// order (block i / (bh * bw), texel i % (bh * bw) of it).
__device__ __forceinline__ void texel(const Level& L, int sf, int i) {
  const int bsz = L.bw * L.bh;
  const int nbx = (L.w_out + L.bw - 1) / L.bw;
  const int nby = (L.h_out + L.bh - 1) / L.bh;
  const int blk = i / bsz, p = i - blk * bsz;
  const int by = blk / nbx, bx = blk - by * nbx;
  const int y = by * L.bh + p / L.bw, x = bx * L.bw + p % L.bw;
  // A partial block repeats the last row and column.
  const int yc = y < L.h_out ? y : L.h_out - 1;
  const int xc = x < L.w_out ? x : L.w_out - 1;
  float stored[4], lin[4];
  if (L.k_h == 0) {
    load4(L.src + (((long long)sf * L.h_in + yc) * L.w_in + xc) * 4, stored);
  } else {
    resample(L, sf, yc, xc, lin);
    for (int c = 0; c < 4; ++c) stored[c] = lin[c];
    if (L.srgb)
      for (int c = 0; c < 3; ++c) stored[c] = to_srgb(lin[c]);
  }
  const long long b = L.first + (long long)sf * nby * nbx + blk;
  store4(L.blocks + (b * bsz + p) * 4, stored);
  if (L.lin && y == yc && x == xc) {
    for (int c = 0; c < 4; ++c) lin[c] = stored[c];
    if (L.srgb)
      for (int c = 0; c < 3; ++c) lin[c] = to_linear(stored[c]);
    store4(L.lin + (((long long)sf * L.h_out + y) * L.w_out + x) * 4, lin);
  }
}

__host__ __device__ __forceinline__ int padded_texels(const Level& L) {
  return ((L.h_out + L.bh - 1) / L.bh) * L.bh * ((L.w_out + L.bw - 1) / L.bw) * L.bw;
}

#ifdef __CUDACC__

// grid.x covers one surface's padded texels; grid.y strides the surfaces.
__global__ void __launch_bounds__(kThreads) pyramid_kernel(const Level L) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= padded_texels(L)) return;
  for (int sf = blockIdx.y; sf < L.s; sf += gridDim.y) texel(L, sf, i);
}

#endif  // __CUDACC__

}  // namespace pyr

// The arguments of both entries: src [s, h_in, w_in, 4] float32; lin
// [s, h_out, w_out, 4] float32 or null; blocks [N, block_h * block_w, 4]
// float32, this level's first block at `first`; idx_h / wt_h [h_out, k_h]
// int32 / float32 source rows and weights (k_h == 0: level 0, no resample,
// h_out == h_in, w_out == w_in), idx_w / wt_w [w_out, k_w] the columns'.
#define PYR_LEVEL(L)                                                                    \
  pyr::Level L;                                                                         \
  L.src = (const float*)src;                                                            \
  L.lin = (float*)lin;                                                                  \
  L.blocks = (float*)blocks;                                                            \
  L.first = first;                                                                      \
  L.s = s;                                                                              \
  L.h_in = h_in;                                                                        \
  L.w_in = w_in;                                                                        \
  L.h_out = h_out;                                                                      \
  L.w_out = w_out;                                                                      \
  L.idx_h = (const int*)idx_h;                                                          \
  L.wt_h = (const float*)wt_h;                                                          \
  L.k_h = k_h;                                                                          \
  L.idx_w = (const int*)idx_w;                                                          \
  L.wt_w = (const float*)wt_w;                                                          \
  L.k_w = k_w;                                                                          \
  L.bw = block_w;                                                                       \
  L.bh = block_h;                                                                       \
  L.srgb = srgb

#ifdef __CUDACC__

// Launches on `stream` and returns cudaGetLastError() (not synchronised).
extern "C" int pyramid_level_launch(const void* src, void* lin, void* blocks, long long first,
                                    int s, int h_in, int w_in, int h_out, int w_out,
                                    const void* idx_h, const void* wt_h, int k_h,
                                    const void* idx_w, const void* wt_w, int k_w,
                                    int block_w, int block_h, int srgb, void* stream) {
  PYR_LEVEL(L);
  const int n = pyr::padded_texels(L);
  if (n <= 0 || s <= 0) return 0;
  const dim3 grid((n + pyr::kThreads - 1) / pyr::kThreads, s < 65535 ? s : 65535);
  pyr::pyramid_kernel<<<grid, pyr::kThreads, 0, (cudaStream_t)stream>>>(L);
  return (int)cudaGetLastError();
}

#else

// The same level on the CPU: every surface's threads one after another.
extern "C" int pyramid_level_cpu(const void* src, void* lin, void* blocks, long long first,
                                 int s, int h_in, int w_in, int h_out, int w_out,
                                 const void* idx_h, const void* wt_h, int k_h,
                                 const void* idx_w, const void* wt_w, int k_w,
                                 int block_w, int block_h, int srgb) {
  PYR_LEVEL(L);
  const int n = pyr::padded_texels(L);
  for (int sf = 0; sf < s; ++sf)
    for (int i = 0; i < n; ++i) pyr::texel(L, sf, i);
  return 0;
}

#endif  // __CUDACC__
