// Push-relabel min-cut core shared by the port's graph-cut kernels
// (expansion_accept.cu, mincut_accept.cu), as the JAX package's two Pallas
// kernels share mincut_pallas._solver_core. One thread block solves one
// S x S region; its planes live in global memory (see each kernel).
//
// The solve keeps the Jacobi semantics of _solver_core, so a solve cut
// short by the round cap matches the plain version too
// (ops/mincut.py::solve_preflow):
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
// Every loop condition is a __syncthreads_or() that all threads of the
// block reach, and no thread returns early.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr float kInf = 3e38f;
constexpr float kEps = 1e-7f;

// pairwise.NEIGHBORS and pairwise.FORWARD.
__constant__ int kNbDx[8] = {-1, 1, 0, 0, -1, 1, -1, 1};
__constant__ int kNbDy[8] = {0, 0, -1, 1, -1, -1, 1, 1};
__constant__ int kFwd[4] = {1, 3, 6, 7};

// One region's solver state: S x S planes, the 4-plane groups at a stride
// of S * S floats.
struct Region {
  int s, ss;
  float hmax;
  float* e;            // excess
  float* capt;         // residual sink capacity
  float* capfw;        // 4 planes: residual forward capacities
  const float* fw0;    // 4 planes: initial forward capacities
  float* amt;          // pushed amount
  int* dir;            // push direction code: -1 none, 0..7, 8 sink

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
    if (j < 4) return capfw[(size_t)k * ss + p];
    return fw0[(size_t)k * ss + *q] - capfw[(size_t)k * ss + *q];
  }
};

// Global relabel into h: exact residual distance to the sink, hmax where
// the sink is unreachable.
__device__ void bfs(const Region& r, float* h) {
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x)
    h[p] = r.capt[p] > kEps ? 1.0f : kInf;
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
  int act = 0;
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x)
    act |= (r.e[p] > kEps) && (h[p] < r.hmax);
  return __syncthreads_or(act);
}

// One push / apply / relabel sweep; heights move from h to h2. Returns
// whether any node is still active (uniform across the block).
__device__ int sweep(const Region& r, const float* h, float* h2) {
  float* e = r.e;
  float* capt = r.capt;
  float* amt = r.amt;
  int* dir = r.dir;

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
      float* capfw = r.capfw + (size_t)k * r.ss;
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

// The solve (mincut_pallas.py:139-174): rounds of a global relabel and up
// to `sweeps` sweeps while any node is active, until no active node can
// reach the sink or `max_rounds` is hit; then the final global relabel.
// Returns the buffer (h or h2) holding the final distances: the source
// side, which accepts, is dist >= hmax.
__device__ float* push_relabel(const Region& r, float* h, float* h2,
                               int max_rounds, int sweeps) {
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
  return h;
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

}  // namespace
