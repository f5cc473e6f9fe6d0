// BC7 block encoder, quality 0-2, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel cuttlefish_tpu/kernels/bc7_pallas.py:_kernel
// (launched by encode_bc7_pallas at bc7_pallas.py:1197).  It computes what
// that kernel computes: modes 6 -> 1 -> 5 -> 4 (mode 1 from quality 1, modes
// 5 and 4 from quality 2), each a PCA seed, least-squares refinement and
// the exact integer-decode error, keeping the lowest error per block.  The
// plain PyTorch version of the same algorithm is
// cuttlefish_tpu_torch/kernels/bc7.py; the two are compared on the card.
//
// Design: the quality 3-4 kernel's (bc7_hq_encode.cu), a warp per group of
// G = 32 blocks, 4 warps per CTA, grid = ceil(N / 128).  The TPU kernel put
// 512 blocks on vector lanes and ran mode 1's 64-partition screen as MXU
// matmuls; here a warp first stages its blocks' texels in shared memory
// with one coalesced 16-byte copy, clamped and scaled there, a block's
// [channel][texel] rows padded to 65 floats so that 32 lanes on 32 blocks
// hit 32 banks (stage_texels, bc7_common.cuh); no texel array lives in a
// thread's local frame.  The group then runs phases, each a loop of lane
// tasks in which the 32 lanes run the same code on different blocks (task
// index block-minor), with what a later phase needs in the warp's shared
// memory:
//   1. mode 6, a lane per block: its error and words become the block's
//      best so far;
//   2. mode 1's screen, a lane per block: the block's principal axis, its
//      texel moments (w2, proj, proj^2) made once, then the 64 partitions'
//      member sums, every lane on the same partition at a time so that the
//      __constant__ masks are read at one address; the best partition's
//      mask and anchor go to shared memory;
//   3. mode 1's two subset fits, a lane per (subset, block), each with its
//      mask from shared memory (lanes hold different partitions here);
//   4. mode 1 packed, then modes 5 and 4, a lane per block, each offered to
//      the block's best in encode order (6 -> 1 -> 5 -> 4, strict <: the
//      first of least error wins); the best block's words are stored.
// Each task is its own non-inlined function whose fits are inlined, so
// that a task's registers follow that task, not the whole chain.
//
// What bounds it: arithmetic.  A block reads 256 bytes and writes 16, but
// runs thousands of dependent float operations (at quality 2: five fits of
// up to 4 channels and 16 levels, and the 64-partition screen).
//
// Numerics: the rules of bc7_common.cuh (texel-order sums, rintf, no FMA
// contraction, IEEE division, first minimum on ties).  The device functions
// are plain C++; the __global__ kernel and the launchers sit under
// __CUDACC__, and a CPU build runs a group's phases with its 32 lanes one
// after another (bc7_cpu).

#include "bc7_common.cuh"

namespace bc7 {

constexpr int kWarps = 4;  // warps a CTA

// A warp's shared memory: [slot][block] arrays, so that a lane per block
// touches its own bank.
struct GroupWarp {
  float px[kGroup * kStride];     // block b, channel c, texel t at b * kStride + c * 16 + t
  float err[kGroup];              // the best error so far
  uint32_t words[4 * kGroup];     // its words [word][block]
  float axis[3 * kGroup];         // mode 1's principal axis [channel][block]
  float serr[2 * kGroup];         // mode 1's subset fits: error [subset][block]
  uint8_t sq[2 * 7 * kGroup];     // their endpoints v0[3], v1[3] and p-bit [subset][value][block]
  uint8_t sidx[2 * 16 * kGroup];  // their indices [subset][texel][block]
  uint16_t mask1[kGroup];         // the screen's partition: its subset-1 mask,
  uint8_t part[kGroup];           // number
  uint8_t anchor1[kGroup];        // and subset-1 anchor
};

__device__ __forceinline__ void store_best(GroupWarp& W, int b, const Res& r) {
  W.err[b] = r.err;
  W.words[b] = (uint32_t)r.bits.lo;
  W.words[kGroup + b] = (uint32_t)(r.bits.lo >> 32);
  W.words[2 * kGroup + b] = (uint32_t)r.bits.hi;
  W.words[3 * kGroup + b] = (uint32_t)(r.bits.hi >> 32);
}

// The fits' channel weights: Unit with unit weights (UW), whose products
// are skipped, else the array.
template <bool UW>
__device__ __forceinline__ auto weights(const Chw& chw) {
  if constexpr (UW)
    return Unit{};
  else
    return (const float*)chw.w;
}

// Keeps r as block b's best when its error is lower (strict <).
__device__ __forceinline__ void offer(GroupWarp& W, int b, const Res& r) {
  if (r.err < W.err[b]) store_best(W, b, r);
}

// ---------------------------------------------------------------------------
// The tasks
// ---------------------------------------------------------------------------

template <bool UW>
__device__ __noinline__ Res mode6_task(const float (*px)[16], Chw chw, int iters) {
  Res r;
  r.err = mode6(px, iters, weights<UW>(chw), r.bits);
  return r;
}

template <bool UW>
__device__ __noinline__ Res mode5_task(const float (*px)[16], Chw chw, int iters) {
  Res r;
  r.err = mode5(px, iters, weights<UW>(chw), 0, r.bits);
  return r;
}

template <bool UW>
__device__ __noinline__ Res mode4_task(const float (*px)[16], Chw chw, int iters) {
  Res r;
  r.err = mode4<0>(px, iters, weights<UW>(chw), 0, r.bits);
  return r;
}

// Mode 1's 64-partition screen of block b (bc7_pallas.py:_screen_2subset):
// the first partition of least residual, its mask and anchor, and the
// block's principal axis, to the warp's slots of b.
template <bool UW>
__device__ __noinline__ void mode1_screen(const float (*px)[16], Chw chw, GroupWarp& W, int b) {
  const auto cw = weights<UW>(chw);
  float ones[16];
  fill_ones(ones);
  float hi3[3], lo3[3], axis[3], mean[3];
  pca_seed<3>(px, ones, hi3, lo3, axis, mean);

  float p[3][16], proj[16], proj2[16], w2[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
#pragma unroll
    for (int c = 0; c < 3; ++c) p[c][t] = px[c][t];
    float s = (p[0][t] - mean[0]) * axis[0];
    s += (p[1][t] - mean[1]) * axis[1];
    s += (p[2][t] - mean[2]) * axis[2];
    proj[t] = s;
    proj2[t] = s * s;
    float q = wmul(cw, 0, p[0][t]) * p[0][t];
    q += wmul(cw, 1, p[1][t]) * p[1][t];
    q += wmul(cw, 2, p[2][t]) * p[2][t];
    w2[t] = q;
  }
  const float tot_all = rt(w2), ps_all = rt(proj), ps2_all = rt(proj2);
  float s1_all[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) s1_all[c] = rt(p[c]);

  float best_score = 0.0f;
  int part = 0;
  uint32_t m1 = 0;
  int anchor1 = 0;
#pragma unroll 1
  for (int q = 0; q < 64; ++q) {
    const uint32_t m = c_part2[q];
    float s1[3] = {0.0f, 0.0f, 0.0f};
    float tot = 0.0f, pss = 0.0f, ps2 = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      if ((m >> t) & 1u) {
        s1[0] += p[0][t];
        s1[1] += p[1][t];
        s1[2] += p[2][t];
        tot += w2[t];
        pss += proj[t];
        ps2 += proj2[t];
      }
    }
    const float ns = (float)__popc(m);
    const float r1[3] = {s1_all[0] - s1[0], s1_all[1] - s1[1], s1_all[2] - s1[2]};
    const float score =
        sub_err<3>(tot, s1, pss, ps2, ns + 1e-6f, cw) +
        sub_err<3>(tot_all - tot, r1, ps_all - pss, ps2_all - ps2, (16.0f - ns) + 1e-6f, cw);
    const int a = c_anchor2[q];
    if (q == 0 || score < best_score) {
      best_score = score;
      part = q;
      m1 = m;
      anchor1 = a;
    }
  }
  W.part[b] = (uint8_t)part;
  W.mask1[b] = (uint16_t)m1;
  W.anchor1[b] = (uint8_t)anchor1;
#pragma unroll
  for (int c = 0; c < 3; ++c) W.axis[c * kGroup + b] = axis[c];
}

// Subset s of block b's mode-1 partition fitted in full: its error,
// endpoints, p-bit and indices to the warp's slots of (s, b).
template <bool UW>
__device__ __noinline__ void mode1_subset(const float (*px)[16], Chw chw, GroupWarp& W, int s,
                                          int b, int iters) {
  const uint32_t m1 = W.mask1[b];
  const uint32_t m = s ? m1 : ~m1 & 0xFFFFu;
  float axis[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) axis[c] = W.axis[c * kGroup + b];
  float mk[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) mk[t] = ((m >> t) & 1u) ? 1.0f : 0.0f;
  float hi[3], lo[3];
  seed_of<3>(px, mk, axis, hi, lo);
  QMode1 q;
  int idx[16];
  W.serr[s * kGroup + b] = fit<3, 8>(px, mk, weights<UW>(chw), iters, hi, lo, q, idx);
  uint8_t* v = W.sq + s * 7 * kGroup + b;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c * kGroup] = (uint8_t)q.v0[c];
    v[(3 + c) * kGroup] = (uint8_t)q.v1[c];
  }
  v[6 * kGroup] = (uint8_t)q.p;
#pragma unroll
  for (int t = 0; t < 16; ++t) W.sidx[(s * 16 + t) * kGroup + b] = (uint8_t)idx[t];
}

// Block b's mode 1 from its two subset fits (err0 + err1 + the alpha
// penalty), packed and offered to its best.
template <bool UW>
__device__ __noinline__ void mode1_pack(const float (*px)[16], Chw chw, GroupWarp& W, int b) {
  const float err = W.serr[b] + W.serr[kGroup + b] + alpha_penalty(px, weights<UW>(chw));
  if (!(err < W.err[b])) return;
  const uint32_t m1 = W.mask1[b];
  const int anchor1 = W.anchor1[b];
  int idx[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) idx[t] = W.sidx[(((m1 >> t) & 1u) * 16 + t) * kGroup + b];
  // Texel 0 anchors subset 0; anchor1 anchors subset 1.  A set index MSB
  // at an anchor is cleared by inverting that subset's indices.
  const bool swap0 = idx[0] >= 4;
  int a1val = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (swap0 && !((m1 >> t) & 1u)) idx[t] = 7 - idx[t];
    if (t == anchor1) a1val = idx[t];
  }
  const bool swap1 = a1val >= 4;
#pragma unroll
  for (int t = 0; t < 16; ++t)
    if (swap1 && ((m1 >> t) & 1u)) idx[t] = 7 - idx[t];

  const uint8_t* q0 = W.sq + b;
  const uint8_t* q1 = W.sq + 7 * kGroup + b;
  Res r;
  r.err = err;
  Bits& out = r.bits;
  out.clear();
  out.put(2, 2);
  out.put(W.part[b], 6);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out.put(q0[(swap0 ? 3 + c : c) * kGroup], 6);
    out.put(q0[(swap0 ? c : 3 + c) * kGroup], 6);
    out.put(q1[(swap1 ? 3 + c : c) * kGroup], 6);
    out.put(q1[(swap1 ? c : 3 + c) * kGroup], 6);
  }
  out.put(q0[6 * kGroup], 1);
  out.put(q1[6 * kGroup], 1);
  // Index bits: 3 each, minus 1 at texel 0 and at the subset-1 anchor.
#pragma unroll
  for (int t = 0; t < 16; ++t)
    out.put(idx[t], 3 - (t == 0 ? 1 : 0) - (t == anchor1 ? 1 : 0));
  store_best(W, b, r);
}

// ---------------------------------------------------------------------------
// A group of blocks
// ---------------------------------------------------------------------------

// Quality 0: mode 6 with one refinement round; 1: modes 6 and 1 with two;
// 2: modes 6, 1, 5 and 4 with two.  UW: every channel weight is 1.  Blocks
// i0 .. i0 + ng - 1 of blocks [n,16,4] by one warp; W: its shared memory;
// out: [n,4] words.  Each phase is its own loop of lane tasks, so that the
// warp holds no state in registers between them.
template <int Q, bool UW>
__device__ void encode_group(const float* blocks, long long i0, int ng, Chw chw, GroupWarp& W,
                             uint32_t* out) {
  constexpr int iters = Q == 0 ? 1 : 2;
  stage_texels(blocks, i0, ng, W.px);
  WARP_SYNC();
  FOR_LANES(lane) {
    for (int b = lane; b < ng; b += 32) store_best(W, b, mode6_task<UW>(block_texels(W.px, b), chw, iters));
  }
  if (Q >= 1) {
    FOR_LANES(lane) {
      for (int b = lane; b < ng; b += 32) mode1_screen<UW>(block_texels(W.px, b), chw, W, b);
    }
    WARP_SYNC();
    FOR_LANES(lane) {
      for (int task = lane; task < 2 * ng; task += 32) {
        const int s = task >= ng ? 1 : 0, b = task - s * ng;
        mode1_subset<UW>(block_texels(W.px, b), chw, W, s, b, iters);
      }
    }
    WARP_SYNC();
    FOR_LANES(lane) {
      for (int b = lane; b < ng; b += 32) mode1_pack<UW>(block_texels(W.px, b), chw, W, b);
    }
  }
  FOR_LANES(lane) {
    for (int b = lane; b < ng; b += 32) {
      if (Q >= 2) {
        offer(W, b, mode5_task<UW>(block_texels(W.px, b), chw, iters));
        offer(W, b, mode4_task<UW>(block_texels(W.px, b), chw, iters));
      }
      uint32_t* o = out + (i0 + b) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = W.words[j * kGroup + b];
    }
  }
}

#ifndef __CUDACC__

// n blocks [n,16,4] at quality 0-2 -> words [n,4] on the CPU: groups of
// kGroup blocks, as the card's warps take them, each group's lanes one
// after another.
inline void bc7_cpu(const float* blocks, uint32_t* out, int n, int quality, const float* chw) {
  static GroupWarp W;
  const Chw w = {{chw[0], chw[1], chw[2], chw[3]}};
  const bool unit = chw[0] == 1.0f && chw[1] == 1.0f && chw[2] == 1.0f && chw[3] == 1.0f;
  for (long long i0 = 0; i0 < n; i0 += kGroup) {
    const int ng = n - i0 < kGroup ? (int)(n - i0) : kGroup;
    if (quality == 0)
      unit ? encode_group<0, true>(blocks, i0, ng, w, W, out)
           : encode_group<0, false>(blocks, i0, ng, w, W, out);
    else if (quality == 1)
      unit ? encode_group<1, true>(blocks, i0, ng, w, W, out)
           : encode_group<1, false>(blocks, i0, ng, w, W, out);
    else
      unit ? encode_group<2, true>(blocks, i0, ng, w, W, out)
           : encode_group<2, false>(blocks, i0, ng, w, W, out);
  }
}

#endif  // !__CUDACC__

#ifdef __CUDACC__

// Registers: quality 1 is capped at 128 (4 CTAs an SM; at 168-184 it ran
// 1.06-1.28x slower), 0 and 2 at 170 (3 CTAs), where a cap at 128 spills
// and loses and no cap lets them take 177-185.
template <int Q, bool UW>
__global__ void __launch_bounds__(kWarps * 32, Q == 1 ? 4 : 3)
    bc7_kernel(const float* __restrict__ blocks, uint32_t* __restrict__ out, int n, Chw chw) {
  __shared__ GroupWarp s_warp[kWarps];
  const int warp = threadIdx.x >> 5;
  const long long i0 = ((long long)blockIdx.x * kWarps + warp) * kGroup;
  if (i0 >= n) return;
  const int ng = n - i0 < kGroup ? (int)(n - i0) : kGroup;
  encode_group<Q, UW>(blocks, i0, ng, chw, s_warp[warp], out);
}

#endif  // __CUDACC__

}  // namespace bc7

#ifdef __CUDACC__

// Copies the 64 partition masks and subset-1 anchors (host arrays) into
// constant memory of the current device.  Returns a cudaError_t.
extern "C" int bc7_set_tables(const uint16_t* masks, const int* anchors) {
  cudaError_t e = cudaMemcpyToSymbol(bc7::c_part2, masks, 64 * sizeof(uint16_t));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(bc7::c_anchor2, anchors, 64 * sizeof(int));
  return (int)e;
}

// blocks: [n,16,4] float32 device pointer, 16-byte aligned; out: [n,4]
// uint32.  Launches on `stream` and returns cudaGetLastError() (the launch
// is not synchronised).
extern "C" int bc7_encode_launch(const void* blocks, void* out, int n,
                                 int quality, float w0, float w1, float w2,
                                 float w3, void* stream) {
  if (n <= 0) return 0;
  const bc7::Chw chw = {{w0, w1, w2, w3}};
  constexpr int per_cta = bc7::kWarps * bc7::kGroup;
  const dim3 grid((n + per_cta - 1) / per_cta);
  cudaStream_t s = (cudaStream_t)stream;
  const float* in = (const float*)blocks;
  uint32_t* o = (uint32_t*)out;
  const bool unit = w0 == 1.0f && w1 == 1.0f && w2 == 1.0f && w3 == 1.0f;
#define CF_BC7(Q)                                                                     \
  case Q:                                                                             \
    if (unit)                                                                         \
      bc7::bc7_kernel<Q, true><<<grid, bc7::kWarps * 32, 0, s>>>(in, o, n, chw);      \
    else                                                                              \
      bc7::bc7_kernel<Q, false><<<grid, bc7::kWarps * 32, 0, s>>>(in, o, n, chw);     \
    break;
  switch (quality) {
    CF_BC7(0) CF_BC7(1) CF_BC7(2)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CF_BC7
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
