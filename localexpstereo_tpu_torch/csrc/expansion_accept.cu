// Fused expansion move for Hopper (sm_90a): pairwise tables, boundary
// t-links, submodular graph build, push-relabel min-cut and the exact
// per-region energy guard, one thread block or one thread-block cluster
// per region.
//
// Replaces localexpstereo_tpu/ops/mincut_pallas.py::expansion_accept_pallas
// (both its [b, S, S] kernel, _make_expansion_kernel, and its
// region-on-lanes kernel, _make_expansion_kernel_rl, which existed only to
// fill the TPU's 128 vector lanes). The plain PyTorch version of the same
// semantics is ops/mincut_cuda.py::expansion_accept_reference.
//
// Design: the launch plan (ops/mincut_cuda.py::launch_plan) gives each
// region K blocks in row bands and says where the solve state lives, and
// the kernel is instantiated once per state layout (push_relabel.cuh): at
// S = 42 one block of 512 threads per region with the whole solve state in
// shared memory, two regions an SM; at S = 129 and 387 a cluster of 2 and
// 16 blocks of 1024 threads, each block holding its band's hot planes in
// shared memory and reading the neighbouring rows through distributed
// shared memory. The tables (c00, c01, c10: 12 planes) and the unaries t0,
// t1 stay in a global workspace: they are written once and read by the
// graph build (which reads row y - 1) and the guard. Phases are separated
// by cluster barriers. The guard sums each block's part, then the blocks'
// parts by rank, so that `ok` is the same in every run. Built with
// --fmad=false so every table entry, excess sum and guard term rounds like
// the plain version.
//
// What bounds it on an H100: not bytes (about 15 us a call at the main
// path's shapes) nor float operations (about 0.08 ms at S = 387), but the
// solve's chain of phases: some 200 cluster barriers a call at S = 387,
// each phase about 10 pixels a thread of integer address work, shared-
// memory loads and, for active pixels, capacity loads from L2. One block
// per region left 126 of 132 SMs idle at S = 387; the cluster puts 96 SMs
// on a color, and the interior rows of a band, which read no other block,
// compile to plain shared-memory loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "push_relabel.cuh"

namespace {

// Table slots of a region's global workspace (ops/mincut_cuda.py:
// TABLE_PLANES), followed by the state's slots (state_slots).
constexpr int kC00 = 0;     // 4 planes: pairwise table, both keep
constexpr int kC01 = 4;     // 4 planes: q switches
constexpr int kC10 = 8;     // 4 planes: p switches
constexpr int kT0 = 12;     // keep cost (unary + boundary t-links)
constexpr int kT1 = 13;     // switch cost
constexpr int kTables = 14;

template <int kState>
__global__ void __launch_bounds__(kMaxThreads) expansion_accept_kernel(
    const float* __restrict__ halo, const float* __restrict__ props,
    const float* __restrict__ tox, const float* __restrict__ toy,
    const float* __restrict__ coeff8, const float* __restrict__ ccost,
    const float* __restrict__ pcost, uint8_t* __restrict__ accept,
    float* work, int s, float lam, float tau, int max_rounds, int sweeps,
    int cluster, int band_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.x / cluster;
  Team t = make_team(blockIdx.x % cluster, cluster);
  const int ss = s * s;
  float* const w =
      work + (size_t)n * (kTables + state_slots(kState)) * ss;
  auto plane = [&](int k) { return w + (size_t)k * ss; };
  const Region<kState> r =
      make_region<kState>(t, s, band_rows, plane(kTables), smem);
  const int hs = s + 2;
  const float* hal = halo + (size_t)n * hs * hs * 4;
  const float* cf = coeff8 + (size_t)n * 8 * ss;
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
  for (int p = r.p0 + threadIdx.x; p < r.p1; p += blockDim.x) {
    int x, y;
    r.xy(p, &x, &y);
    const int cx = x + 1, cy = y + 1;
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
      const float w = cf[(size_t)k * ss + p] * lam;
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
      const float w = (outside ? cf[(size_t)k * ss + p] : 0.0f) * lam;
      t0b += fminf(fabsf(d0 - dq_p) + fabsf(d0_q - d0q), tau) * w;
      t1b += fminf(fabsf(d1 - dq_p) + fabsf(d1_q - d0q), tau) * w;
    }
    const size_t g = (size_t)n * ss + p;
    plane(kT0)[p] = ccost[g] + t0b;
    plane(kT1)[p] = pcost[g] + t1b;
  }
  t.sync();

  // ---- submodular graph build (mincut_pallas.py:280-293) -----------------
  for (int p = r.p0 + threadIdx.x; p < r.p1; p += blockDim.x) {
    int x, y;
    r.xy(p, &x, &y);
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
      r.fw0(i)[p] = fw;
      r.capfw(i)[p] = fw;
    }
    const float nu = sigma - plane(kT1)[p];
    r.e()[p] = fmaxf(nu, 0.0f);
    r.capt()[p] = fmaxf(-nu, 0.0f);
  }
  t.sync();

  // ---- push-relabel solve (mincut_pallas.py:139-174) ---------------------
  const float* h = r.plane(push_relabel(r, t, max_rounds, sweeps));
  auto accepted = [&](int q) {
    return *r.at(Edge{}, h, q) >= r.hmax ? 1.0f : 0.0f;
  };

  // ---- exact per-region energy-delta guard (mincut_pallas.py:297-312) ----
  float part = 0.0f;
  for (int p = r.p0 + threadIdx.x; p < r.p1; p += blockDim.x) {
    int x, y;
    r.xy(p, &x, &y);
    const float xm = accepted(p);
    float contrib = (plane(kT1)[p] - plane(kT0)[p]) * xm;
    for (int i = 0; i < 4; ++i) {
      const int dx = kNbDx[kFwd[i]], dy = kNbDy[kFwd[i]];
      const bool in = r.inside(x + dx, y + dy);
      const float em = in ? 1.0f : 0.0f;
      const float xq = in ? accepted(p + dy * s + dx) : 0.0f;
      const float c00 = plane(kC00 + i)[p];
      const float pair = c00 * (1.0f - xm) * (1.0f - xq)
          + plane(kC01 + i)[p] * (1.0f - xm) * xq
          + plane(kC10 + i)[p] * xm * (1.0f - xq);
      contrib = contrib + (pair - c00) * em;
    }
    part += contrib;
  }
  const bool ok = t.sum(part) <= 0.0f;
  uint8_t* out = accept + (size_t)n * ss;
  for (int p = r.p0 + threadIdx.x; p < r.p1; p += blockDim.x)
    out[p] = (ok && accepted(p) > 0.5f) ? 1 : 0;
  t.sync();  // no block leaves while another reads its shared memory
}

// The kernel of a state layout (push_relabel.cuh: kState*).
template <typename F>
cudaError_t with_kernel(int state, F f) {
  switch (state) {
    case kStateGlobal: return f(expansion_accept_kernel<kStateGlobal>);
    case kStateBanded: return f(expansion_accept_kernel<kStateBanded>);
    case kStateShared: return f(expansion_accept_kernel<kStateShared>);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int expansion_accept_launch(
    const void* halo, const void* props, const void* tox, const void* toy,
    const void* coeff8, const void* ccost, const void* pcost, void* accept,
    void* work, int n, int s, float lam, float tau,
    int max_rounds, int sweeps, int cluster, int threads, int smem,
    int state, int band_rows, void* stream) {
  if (n <= 0) return 0;
  return (int)with_kernel(state, [&](auto kernel) {
    return launch_regions(
        kernel, n, cluster, threads, smem, (cudaStream_t)stream,
        (const float*)halo, (const float*)props, (const float*)tox,
        (const float*)toy, (const float*)coeff8, (const float*)ccost,
        (const float*)pcost, (uint8_t*)accept, (float*)work, s, lam, tau,
        max_rounds, sweeps, cluster, band_rows);
  });
}

extern "C" int expansion_accept_configure(int state) {
  return (int)with_kernel(state, [](auto kernel) { return configure(kernel); });
}

extern "C" int expansion_accept_occupancy(int cluster, int threads,
                                          int smem, int state, int* active,
                                          int* regs) {
  return (int)with_kernel(state, [&](auto kernel) {
    return occupancy(kernel, cluster, threads, smem, active, regs);
  });
}
