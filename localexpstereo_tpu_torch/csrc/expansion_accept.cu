// Fused expansion move for Hopper (sm_90a): pairwise tables, boundary
// t-links, submodular graph build, push-relabel min-cut and the exact
// per-region energy guard, one thread block per region.
//
// Replaces localexpstereo_tpu/ops/mincut_pallas.py::expansion_accept_pallas
// (both its [b, S, S] kernel, _make_expansion_kernel, and its
// region-on-lanes kernel, _make_expansion_kernel_rl, which existed only to
// fill the TPU's 128 vector lanes). The plain PyTorch version of the same
// semantics is ops/mincut_cuda.py::expansion_accept_reference.
//
// Design: grid = N regions, 1024 threads per block, block-stride loops over
// the S*S pixels of the region. All per-region planes live in a global
// workspace [N, kPlanes, S, S] allocated by the wrapper: at S = 387 one
// plane is 599 KB, more than the 227 KB of shared memory a block may use.
// Phases are separated by __syncthreads(). The min-cut solve is the shared
// push-relabel core of push_relabel.cuh (Jacobi semantics of
// mincut_pallas._solver_core). Built with --fmad=false so every table
// entry, excess sum and guard term rounds like the plain version.
//
// What bounds it on an H100: the solve is a chain of block-wide barriers
// over state that sits in L2/global memory; the work per barrier is a few
// loads per pixel. At S = 387 the 6 regions of a color run as 6 blocks on
// 132 SMs, so the card is mostly idle; at S = 42 the 468 regions give
// enough blocks to fill it. Keeping a region's state in shared memory at
// S = 42 (about 25 planes of 7 KB) and splitting an S = 387 region over a
// thread-block cluster are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "push_relabel.cuh"

namespace {

// Workspace planes per region (ops/mincut_cuda.py: WORK_PLANES).
constexpr int kC00 = 0;     // 4 planes: pairwise table, both keep
constexpr int kC01 = 4;     // 4 planes: q switches
constexpr int kC10 = 8;     // 4 planes: p switches
constexpr int kT0 = 12;     // keep cost (unary + boundary t-links)
constexpr int kT1 = 13;     // switch cost
constexpr int kE = 14;      // excess
constexpr int kCapT = 15;   // residual sink capacity
constexpr int kH = 16;      // heights (two buffers)
constexpr int kH2 = 17;
constexpr int kCapFw = 18;  // 4 planes: residual forward capacities
constexpr int kFw0 = 22;    // 4 planes: initial forward capacities
constexpr int kAmt = 26;    // pushed amount
constexpr int kDir = 27;    // push direction code (int)
constexpr int kAcc = 28;    // unguarded accept mask (0/1)
constexpr int kPlanes = 29;

__global__ void __launch_bounds__(kThreads) expansion_accept_kernel(
    const float* __restrict__ halo, const float* __restrict__ props,
    const float* __restrict__ tox, const float* __restrict__ toy,
    const float* __restrict__ coeff8, const float* __restrict__ ccost,
    const float* __restrict__ pcost, uint8_t* __restrict__ accept,
    float* __restrict__ work, int s, float lam, float tau, int max_rounds,
    int sweeps) {
  const int n = blockIdx.x;
  Region r;
  r.s = s;
  r.ss = s * s;
  r.hmax = (float)(s * s + 2);
  float* const w = work + (size_t)n * kPlanes * r.ss;
  auto plane = [&](int k) { return w + (size_t)k * r.ss; };
  r.e = plane(kE);
  r.capt = plane(kCapT);
  r.capfw = plane(kCapFw);
  r.fw0 = plane(kFw0);
  r.amt = plane(kAmt);
  r.dir = reinterpret_cast<int*>(plane(kDir));
  const int hs = s + 2;
  const float* hal = halo + (size_t)n * hs * hs * 4;
  const float* cf = coeff8 + (size_t)n * 8 * r.ss;
  const float pa = props[n * 4 + 0], pb = props[n * 4 + 1],
              pc = props[n * 4 + 2];
  const float hx0 = tox[n] - 1.0f, hy0 = toy[n] - 1.0f;  // halo origin

  // Disparity of the current label (d0h) / the proposal (d1h) at haloed
  // pixel (i, j), evaluated there, as the wrapper of the TPU kernel did.
  auto d0h = [&](int i, int j) {
    const float* l = hal + ((size_t)j * hs + i) * 4;
    return l[0] * (hx0 + (float)i) + l[1] * (hy0 + (float)j) + l[2];
  };
  auto d1h = [&](int i, int j) {
    return pa * (hx0 + (float)i) + pb * (hy0 + (float)j) + pc;
  };
  auto slope_a = [&](int i, int j) { return hal[((size_t)j * hs + i) * 4]; };
  auto slope_b = [&](int i, int j) {
    return hal[((size_t)j * hs + i) * 4 + 1];
  };

  // ---- pairwise tables and boundary t-links (mincut_pallas.py:239-278) --
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x) {
    const int x = p % s, y = p / s, cx = x + 1, cy = y + 1;
    const float d0 = d0h(cx, cy), d1 = d1h(cx, cy);
    const float a0 = slope_a(cx, cy), b0 = slope_b(cx, cy);
    for (int i = 0; i < 4; ++i) {
      const int k = kFwd[i];
      const float dx = (float)kNbDx[k], dy = (float)kNbDy[k];
      const int qx = cx + kNbDx[k], qy = cy + kNbDy[k];
      const float d0q = d0h(qx, qy);
      const float d_le_ee = d0q - (slope_a(qx, qy) * dx + slope_b(qx, qy) * dy);
      const float d_ee_le = d0 + a0 * dx + b0 * dy;
      const float d1q = d1h(qx, qy);
      const float w = cf[(size_t)k * r.ss + p] * lam;
      plane(kC00 + i)[p] =
          fminf(fabsf(d0 - d_le_ee) + fabsf(d_ee_le - d0q), tau) * w;
      plane(kC01 + i)[p] =
          fminf(fabsf(d0 - d1) + fabsf(d_ee_le - d1q), tau) * w;
      plane(kC10 + i)[p] =
          fminf(fabsf(d1 - d_le_ee) + fabsf(d1q - d0q), tau) * w;
    }
    float t0b = 0.0f, t1b = 0.0f;
    for (int k = 0; k < 8; ++k) {
      const float dx = (float)kNbDx[k], dy = (float)kNbDy[k];
      const bool outside = !r.inside(x + kNbDx[k], y + kNbDy[k]);
      const int qx = cx + kNbDx[k], qy = cy + kNbDy[k];
      const float d0q = d0h(qx, qy);
      const float dq_p = d0q - (slope_a(qx, qy) * dx + slope_b(qx, qy) * dy);
      const float d0_q = d0 + a0 * dx + b0 * dy;
      const float d1_q = d1h(qx, qy);
      const float w = (outside ? cf[(size_t)k * r.ss + p] : 0.0f) * lam;
      t0b += fminf(fabsf(d0 - dq_p) + fabsf(d0_q - d0q), tau) * w;
      t1b += fminf(fabsf(d1 - dq_p) + fabsf(d1_q - d0q), tau) * w;
    }
    const size_t g = (size_t)n * r.ss + p;
    plane(kT0)[p] = ccost[g] + t0b;
    plane(kT1)[p] = pcost[g] + t1b;
  }
  __syncthreads();

  // ---- submodular graph build (mincut_pallas.py:280-293) -----------------
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x) {
    const int x = p % s, y = p / s;
    float sigma = plane(kT0)[p];
    for (int i = 0; i < 4; ++i) {
      const int dx = kNbDx[kFwd[i]], dy = kNbDy[kFwd[i]];
      const float em = r.inside(x + dx, y + dy) ? 1.0f : 0.0f;
      const float c00 = plane(kC00 + i)[p], c01 = plane(kC01 + i)[p],
                  c10 = plane(kC10 + i)[p];
      float d_minus_c = 0.0f;  // (c00 - c01) of the edge (p - dir, p)
      if (r.inside(x - dx, y - dy)) {
        const int q = p - dy * s - dx;
        d_minus_c = (plane(kC00 + i)[q] - plane(kC01 + i)[q]) * 1.0f;
      }
      sigma = sigma + c01 * em + d_minus_c;
      const float fw = fmaxf(0.0f, c10 + c01 - c00) * em;
      plane(kFw0 + i)[p] = fw;
      plane(kCapFw + i)[p] = fw;
    }
    const float nu = sigma - plane(kT1)[p];
    plane(kE)[p] = fmaxf(nu, 0.0f);
    plane(kCapT)[p] = fmaxf(-nu, 0.0f);
  }
  __syncthreads();

  // ---- push-relabel solve (mincut_pallas.py:139-174) ---------------------
  const float* h = push_relabel(r, plane(kH), plane(kH2), max_rounds, sweeps);
  float* acc = plane(kAcc);
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x)
    acc[p] = h[p] >= r.hmax ? 1.0f : 0.0f;
  __syncthreads();

  // ---- exact per-region energy-delta guard (mincut_pallas.py:297-312) ----
  float part = 0.0f;
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x) {
    const int x = p % s, y = p / s;
    const float xm = acc[p];
    float contrib = (plane(kT1)[p] - plane(kT0)[p]) * xm;
    for (int i = 0; i < 4; ++i) {
      const int dx = kNbDx[kFwd[i]], dy = kNbDy[kFwd[i]];
      const bool in = r.inside(x + dx, y + dy);
      const float em = in ? 1.0f : 0.0f;
      const float xq = in ? acc[p + dy * s + dx] : 0.0f;
      const float c00 = plane(kC00 + i)[p];
      const float pair = c00 * (1.0f - xm) * (1.0f - xq)
          + plane(kC01 + i)[p] * (1.0f - xm) * xq
          + plane(kC10 + i)[p] * xm * (1.0f - xq);
      contrib = contrib + (pair - c00) * em;
    }
    part += contrib;
  }
  const bool ok = block_sum(part) <= 0.0f;
  uint8_t* out = accept + (size_t)n * r.ss;
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x)
    out[p] = (ok && acc[p] > 0.5f) ? 1 : 0;
}

}  // namespace

extern "C" int expansion_accept_launch(
    const void* halo, const void* props, const void* tox, const void* toy,
    const void* coeff8, const void* ccost, const void* pcost, void* accept,
    void* work, int n, int s, float lam, float tau, int max_rounds,
    int sweeps, void* stream) {
  if (n > 0) {
    expansion_accept_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)halo, (const float*)props, (const float*)tox,
        (const float*)toy, (const float*)coeff8, (const float*)ccost,
        (const float*)pcost, (uint8_t*)accept, (float*)work, s, lam, tau,
        max_rounds, sweeps);
  }
  return (int)cudaGetLastError();
}
