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
// Phases are separated by __syncthreads(); every loop condition is a
// __syncthreads_or() that all threads of the block reach, and no thread
// returns early.
//
// The solve keeps the Jacobi semantics of mincut_pallas._solver_core, so a
// solve truncated by the round cap matches the plain version too:
//   - global relabel: min-plus BFS to its unique fixpoint. The fixpoint does
//     not depend on the iteration order, so the relaxation runs in place
//     (Gauss-Seidel), alternating the pixel order between passes;
//   - push: each active node takes at most one admissible direction, in the
//     order sink, 4 forward edges, 4 backward edges; a direction code and an
//     amount per pixel replace the 9 flow planes;
//   - apply: inflow sums the neighbours' pushes in the reference order
//     (forward k = 0..3 from p - dir, then backward k = 0..3 from p + dir),
//     then e = (e - outflow) + inflow;
//   - relabel: reads the pre-sweep heights and writes a second buffer;
//   - backward residuals are rebuilt as fw0 - capfw, never carried.
// Built with --fmad=false so every table entry, excess sum and guard term
// rounds like the plain version.
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

namespace {

constexpr int kThreads = 1024;
constexpr float kInf = 3e38f;
constexpr float kEps = 1e-7f;

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
constexpr int kDir = 27;    // push direction code (int): -1 none, 0..7, 8 sink
constexpr int kAcc = 28;    // unguarded accept mask (0/1)
constexpr int kPlanes = 29;

// pairwise.NEIGHBORS and pairwise.FORWARD.
__constant__ int kNbDx[8] = {-1, 1, 0, 0, -1, 1, -1, 1};
__constant__ int kNbDy[8] = {0, 0, -1, 1, -1, -1, 1, 1};
__constant__ int kFwd[4] = {1, 3, 6, 7};

struct Region {
  int s, ss;
  float hmax;
  float* w;

  __device__ float* plane(int k) const { return w + (size_t)k * ss; }
  __device__ bool inside(int x, int y) const {
    return x >= 0 && x < s && y >= 0 && y < s;
  }
  // Residual capacity from p = (x, y) along out-direction j (0..3 forward
  // edge j, 4..7 backward edge j-4), and the neighbour's index; 0 when the
  // neighbour lies outside the window.
  __device__ float out_cap(int j, int p, int x, int y, int* q) const {
    int k = j & 3;
    int dx = kNbDx[kFwd[k]], dy = kNbDy[kFwd[k]];
    if (j >= 4) { dx = -dx; dy = -dy; }
    if (!inside(x + dx, y + dy)) { *q = -1; return 0.0f; }
    *q = p + dy * s + dx;
    if (j < 4) return plane(kCapFw + k)[p];
    return plane(kFw0 + k)[*q] - plane(kCapFw + k)[*q];
  }
};

// Global relabel into h: exact residual distance to the sink, hmax where
// the sink is unreachable.
__device__ void bfs(const Region& r, float* h) {
  const float* capt = r.plane(kCapT);
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x)
    h[p] = capt[p] > kEps ? 1.0f : kInf;
  __syncthreads();
  int pass = 0;
  int changed;
  do {
    changed = 0;
    for (int i = threadIdx.x; i < r.ss; i += blockDim.x) {
      int p = (pass & 1) ? r.ss - 1 - i : i;
      int x = p % r.s, y = p / r.s;
      float cur = h[p];
      float best = cur;
      for (int j = 0; j < 8; ++j) {
        int q;
        float cap = r.out_cap(j, p, x, y, &q);
        if (cap > kEps) best = fminf(best, h[q] + 1.0f);
      }
      if (best < cur) {
        h[p] = best;
        changed = 1;
      }
    }
    ++pass;
  } while (__syncthreads_or(changed));
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x)
    if (h[p] >= kInf) h[p] = r.hmax;
  __syncthreads();
}

// Any node with excess below hmax (uniform across the block).
__device__ int any_active(const Region& r, const float* h) {
  const float* e = r.plane(kE);
  int act = 0;
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x)
    act |= (e[p] > kEps) && (h[p] < r.hmax);
  return __syncthreads_or(act);
}

// One push / apply / relabel sweep; heights move from h to h2. Returns
// whether any node is still active (uniform across the block).
__device__ int sweep(const Region& r, const float* h, float* h2) {
  float* e = r.plane(kE);
  float* capt = r.plane(kCapT);
  float* amt = r.plane(kAmt);
  int* dir = reinterpret_cast<int*>(r.plane(kDir));

  // Push phase: choose one admissible direction per active node.
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x) {
    int x = p % r.s, y = p / r.s;
    float ep = e[p], hp = h[p];
    int code = -1;
    float a = 0.0f;
    if (ep > kEps && hp < r.hmax) {
      if (capt[p] > kEps && hp == 1.0f) {
        code = 8;
        a = fminf(ep, capt[p]);
      } else {
        for (int j = 0; j < 8; ++j) {
          int q;
          float cap = r.out_cap(j, p, x, y, &q);
          float nbh = q >= 0 ? h[q] : r.hmax;
          if (cap > kEps && hp == nbh + 1.0f) {
            code = j;
            a = fminf(ep, cap);
            break;
          }
        }
      }
    }
    dir[p] = code;
    amt[p] = a;
  }
  __syncthreads();

  // Apply phase: each node updates its own excess and capacities.
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x) {
    int x = p % r.s, y = p / r.s;
    int code = dir[p];
    float a = amt[p];
    float outflow = code >= 0 ? a : 0.0f;
    if (code == 8) capt[p] = capt[p] - a;
    float inflow = 0.0f;
    for (int k = 0; k < 4; ++k) {          // forward pushes from p - dir_k
      int dx = kNbDx[kFwd[k]], dy = kNbDy[kFwd[k]];
      if (r.inside(x - dx, y - dy)) {
        int q = p - dy * r.s - dx;
        if (dir[q] == k) inflow = inflow + amt[q];
      }
    }
    for (int k = 0; k < 4; ++k) {          // backward pushes from p + dir_k
      int dx = kNbDx[kFwd[k]], dy = kNbDy[kFwd[k]];
      float* capfw = r.plane(kCapFw + k);
      float c = capfw[p];
      if (code == k) c = c - a;
      if (r.inside(x + dx, y + dy)) {
        int q = p + dy * r.s + dx;
        if (dir[q] == 4 + k) {
          c = c + amt[q];
          inflow = inflow + amt[q];
        }
      }
      capfw[p] = c;
    }
    e[p] = (e[p] - outflow) + inflow;
  }
  __syncthreads();

  // Relabel phase: nodes that could not push rise to 1 + the lowest
  // neighbour they have residual capacity to.
  int act = 0;
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x) {
    int x = p % r.s, y = p / r.s;
    float ep = e[p], hp = h[p];
    float best = capt[p] > kEps ? 0.0f : kInf;
    for (int j = 0; j < 8; ++j) {
      int q;
      float cap = r.out_cap(j, p, x, y, &q);
      if (cap > kEps) best = fminf(best, h[q]);
    }
    bool active = ep > kEps && hp < r.hmax;
    bool could_push = best <= hp - 1.0f;
    float new_h = best >= kInf ? r.hmax : fminf(best + 1.0f, r.hmax);
    float hn = (active && !could_push) ? fmaxf(hp, new_h) : hp;
    h2[p] = hn;
    act |= (ep > kEps) && (hn < r.hmax);
  }
  return __syncthreads_or(act);
}

__device__ float block_sum(float v) {
  __shared__ float partial[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  float total = partial[0];
  __syncthreads();
  return total;
}

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
  r.w = work + (size_t)n * kPlanes * r.ss;
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
      r.plane(kC00 + i)[p] =
          fminf(fabsf(d0 - d_le_ee) + fabsf(d_ee_le - d0q), tau) * w;
      r.plane(kC01 + i)[p] =
          fminf(fabsf(d0 - d1) + fabsf(d_ee_le - d1q), tau) * w;
      r.plane(kC10 + i)[p] =
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
    r.plane(kT0)[p] = ccost[g] + t0b;
    r.plane(kT1)[p] = pcost[g] + t1b;
  }
  __syncthreads();

  // ---- submodular graph build (mincut_pallas.py:280-293) -----------------
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x) {
    const int x = p % s, y = p / s;
    float sigma = r.plane(kT0)[p];
    for (int i = 0; i < 4; ++i) {
      const int dx = kNbDx[kFwd[i]], dy = kNbDy[kFwd[i]];
      const float em = r.inside(x + dx, y + dy) ? 1.0f : 0.0f;
      const float c00 = r.plane(kC00 + i)[p], c01 = r.plane(kC01 + i)[p],
                  c10 = r.plane(kC10 + i)[p];
      float d_minus_c = 0.0f;  // (c00 - c01) of the edge (p - dir, p)
      if (r.inside(x - dx, y - dy)) {
        const int q = p - dy * s - dx;
        d_minus_c = (r.plane(kC00 + i)[q] - r.plane(kC01 + i)[q]) * 1.0f;
      }
      sigma = sigma + c01 * em + d_minus_c;
      const float fw = fmaxf(0.0f, c10 + c01 - c00) * em;
      r.plane(kFw0 + i)[p] = fw;
      r.plane(kCapFw + i)[p] = fw;
    }
    const float nu = sigma - r.plane(kT1)[p];
    r.plane(kE)[p] = fmaxf(nu, 0.0f);
    r.plane(kCapT)[p] = fmaxf(-nu, 0.0f);
  }
  __syncthreads();

  // ---- push-relabel solve (mincut_pallas.py:139-174) ---------------------
  float* h = r.plane(kH);
  float* h2 = r.plane(kH2);
  int live = 1;
  for (int rounds = 0; live && rounds < max_rounds; ++rounds) {
    bfs(r, h);
    live = any_active(r, h);
    int act = live;
    for (int k = 0; k < sweeps && act; ++k) {
      act = sweep(r, h, h2);
      float* t = h;
      h = h2;
      h2 = t;
    }
  }
  bfs(r, h);
  float* acc = r.plane(kAcc);
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x)
    acc[p] = h[p] >= r.hmax ? 1.0f : 0.0f;
  __syncthreads();

  // ---- exact per-region energy-delta guard (mincut_pallas.py:297-312) ----
  float part = 0.0f;
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x) {
    const int x = p % s, y = p / s;
    const float xm = acc[p];
    float contrib = (r.plane(kT1)[p] - r.plane(kT0)[p]) * xm;
    for (int i = 0; i < 4; ++i) {
      const int dx = kNbDx[kFwd[i]], dy = kNbDy[kFwd[i]];
      const bool in = r.inside(x + dx, y + dy);
      const float em = in ? 1.0f : 0.0f;
      const float xq = in ? acc[p + dy * s + dx] : 0.0f;
      const float c00 = r.plane(kC00 + i)[p];
      const float pair = c00 * (1.0f - xm) * (1.0f - xq)
          + r.plane(kC01 + i)[p] * (1.0f - xm) * xq
          + r.plane(kC10 + i)[p] * xm * (1.0f - xq);
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
