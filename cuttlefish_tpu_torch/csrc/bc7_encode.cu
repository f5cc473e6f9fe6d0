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
// Design: one thread per 4x4 block, its 16x4 texels in registers, 128
// threads per CTA, grid = ceil(N / 128).  The TPU kernel put 512 blocks on
// vector lanes and ran mode 1's 64-partition screen as MXU matmuls; here the
// screen is a loop over 64 uint16 membership masks in __constant__ memory
// that sums the same moments (w2, s1, proj, proj^2) exactly.
//
// What bounds it: arithmetic.  A block reads 256 bytes and writes 16, but
// runs thousands of dependent float operations, and its per-block state
// (texels, centred copies, index sets) presses on the 255-register limit,
// so occupancy is low and some state spills to local memory.  Coalesced
// loads, shared-memory staging and a texel-per-lane layout are later work.
//
// The per-block primitives and modes 6, 5 and 4 are in bc7_common.cuh
// (shared with the quality 3-4 kernel, bc7_hq_encode.cu), with the rules
// that keep the kernel bit for bit equal to the plain version.  The device
// functions are plain C++: the __global__ kernel and the launchers need
// nvcc and sit under __CUDACC__.

#include "bc7_common.cuh"

namespace bc7 {

// Mode 1: 64-partition screen, then the best partition's two fits.
__device__ __forceinline__ float mode1(const float (&px)[4][16], int iters,
                                       const float* chw, Bits& out) {
  const float cw[3] = {chw[0], chw[1], chw[2]};
  float ones[16];
  fill_ones(ones);
  float hi3[3], lo3[3], axis[3], mean[3];
  pca_seed<3>(px, ones, hi3, lo3, axis, mean);

  float proj[16], proj2[16], w2[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float s = (px[0][t] - mean[0]) * axis[0];
    s += (px[1][t] - mean[1]) * axis[1];
    s += (px[2][t] - mean[2]) * axis[2];
    proj[t] = s;
    proj2[t] = s * s;
    float q = cw[0] * px[0][t] * px[0][t];
    q += cw[1] * px[1][t] * px[1][t];
    q += cw[2] * px[2][t] * px[2][t];
    w2[t] = q;
  }
  const float tot_all = rt(w2), ps_all = rt(proj), ps2_all = rt(proj2);
  float s1_all[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) s1_all[c] = rt(px[c]);

  float best_score = 0.0f;
  int part = 0;
#pragma unroll 1
  for (int p = 0; p < 64; ++p) {
    const uint32_t m = c_part2[p];
    float s1[3] = {0.0f, 0.0f, 0.0f};
    float tot = 0.0f, pss = 0.0f, ps2 = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      if ((m >> t) & 1u) {
        s1[0] += px[0][t];
        s1[1] += px[1][t];
        s1[2] += px[2][t];
        tot += w2[t];
        pss += proj[t];
        ps2 += proj2[t];
      }
    }
    const float ns = (float)__popc(m);
    const float r1[3] = {s1_all[0] - s1[0], s1_all[1] - s1[1],
                         s1_all[2] - s1[2]};
    const float score =
        sub_err<3>(tot, s1, pss, ps2, ns + 1e-6f, cw) +
        sub_err<3>(tot_all - tot, r1, ps_all - pss, ps2_all - ps2,
                (16.0f - ns) + 1e-6f, cw);
    if (p == 0 || score < best_score) {
      best_score = score;
      part = p;
    }
  }
  const uint32_t m1 = c_part2[part];
  const int anchor1 = c_anchor2[part];

  float mk0[16], mk1[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    mk1[t] = ((m1 >> t) & 1u) ? 1.0f : 0.0f;
    mk0[t] = 1.0f - mk1[t];
  }
  float hi0[3], lo0[3], hi1[3], lo1[3];
  seed_of<3>(px, mk0, axis, hi0, lo0);
  seed_of<3>(px, mk1, axis, hi1, lo1);
  QMode1 q0, q1;
  int idx0[16], idx1[16];
  const float err0 = fit<3, 8>(px, mk0, cw, iters, hi0, lo0, q0, idx0);
  const float err1 = fit<3, 8>(px, mk1, cw, iters, hi1, lo1, q1, idx1);
  const float err = err0 + err1 + alpha_penalty(px, chw);

  int idx[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) idx[t] = ((m1 >> t) & 1u) ? idx1[t] : idx0[t];
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

  out.clear();
  out.put(2, 2);
  out.put(part, 6);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out.put(swap0 ? q0.v1[c] : q0.v0[c], 6);
    out.put(swap0 ? q0.v0[c] : q0.v1[c], 6);
    out.put(swap1 ? q1.v1[c] : q1.v0[c], 6);
    out.put(swap1 ? q1.v0[c] : q1.v1[c], 6);
  }
  out.put(q0.p, 1);
  out.put(q1.p, 1);
  // Index bits: 3 each, minus 1 at texel 0 and at the subset-1 anchor.
#pragma unroll
  for (int t = 0; t < 16; ++t)
    out.put(idx[t], 3 - (t == 0 ? 1 : 0) - (t == anchor1 ? 1 : 0));
  return err;
}

// One block: px holds clip(x,0,1)*255 per channel and texel.
template <int Q>
__device__ __forceinline__ void encode_block(const float (&px)[4][16],
                                             const float* chw,
                                             uint32_t (&words)[4]) {
  const int iters = Q == 0 ? 1 : 2;
  Bits best, cand;
  float err = mode6(px, iters, chw, best);
  if (Q >= 1) {
    const float e = mode1(px, iters, chw, cand);
    if (e < err) {
      best = cand;
      err = e;
    }
  }
  if (Q >= 2) {
    float e = mode5(px, iters, chw, 0, cand);
    if (e < err) {
      best = cand;
      err = e;
    }
    e = mode4<0>(px, iters, chw, 0, cand);
    if (e < err) {
      best = cand;
      err = e;
    }
  }
  words[0] = (uint32_t)best.lo;
  words[1] = (uint32_t)(best.lo >> 32);
  words[2] = (uint32_t)best.hi;
  words[3] = (uint32_t)(best.hi >> 32);
}

#ifdef __CUDACC__

struct Chw {
  float w[4];
};

template <int Q>
__global__ void __launch_bounds__(kThreads)
    bc7_kernel(const float4* __restrict__ blocks, uint4* __restrict__ out,
               int n, Chw chw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float px[4][16];
  const float4* src = blocks + (size_t)i * 16;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const float4 q = src[t];
    px[0][t] = clampf(q.x, 0.0f, 1.0f) * 255.0f;
    px[1][t] = clampf(q.y, 0.0f, 1.0f) * 255.0f;
    px[2][t] = clampf(q.z, 0.0f, 1.0f) * 255.0f;
    px[3][t] = clampf(q.w, 0.0f, 1.0f) * 255.0f;
  }
  uint32_t words[4];
  encode_block<Q>(px, chw.w, words);
  out[i] = make_uint4(words[0], words[1], words[2], words[3]);
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

// blocks: [n,16,4] float32 device pointer; out: [n,4] uint32.  Launches on
// `stream` and returns cudaGetLastError() (the launch is not synchronised).
extern "C" int bc7_encode_launch(const void* blocks, void* out, int n,
                                 int quality, float w0, float w1, float w2,
                                 float w3, void* stream) {
  if (n <= 0) return 0;
  const bc7::Chw chw = {{w0, w1, w2, w3}};
  const dim3 grid((n + bc7::kThreads - 1) / bc7::kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const float4* in = (const float4*)blocks;
  uint4* o = (uint4*)out;
  switch (quality) {
    case 0: bc7::bc7_kernel<0><<<grid, bc7::kThreads, 0, s>>>(in, o, n, chw); break;
    case 1: bc7::bc7_kernel<1><<<grid, bc7::kThreads, 0, s>>>(in, o, n, chw); break;
    case 2: bc7::bc7_kernel<2><<<grid, bc7::kThreads, 0, s>>>(in, o, n, chw); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
