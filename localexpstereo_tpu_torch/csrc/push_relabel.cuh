// Push-relabel min-cut core shared by the port's graph-cut kernels
// (expansion_accept.cu, mincut_accept.cu), as the JAX package's two Pallas
// kernels share mincut_pallas._solver_core, and the launch plan both use
// (ops/mincut_cuda.py::launch_plan).
//
// One region of S x S pixels is solved by one thread block, or by a
// thread-block cluster of K blocks in row bands: block r owns rows
// [r * B, (r + 1) * B), B = ceil(S / K), and the last bands may be short or
// empty. Where the state lives (kState*):
//   - shared: K = 1 and the region's whole solve state (54 B a pixel) in
//     the block's shared memory (S = 42: 95 KB, two blocks an SM);
//   - banded: each block holds its band's hot planes (h, h2, e, capt, amt,
//     dir, mask: 22 B a pixel) in shared memory and reads the neighbouring
//     bands' rows through distributed shared memory; the capacities
//     (capfw, fw0: 32 B a pixel) stay in the global workspace, in L2;
//   - global: every plane in the global workspace (bands too large for
//     shared memory).
//
// What bounds it on an H100: not bytes or operations but the chain of
// phases (a BFS pass, a push, an apply, a relabel, each ended by a barrier)
// and, within a phase, each pixel's integer work and load latency. The
// design shortens both: K SMs on one region; the hot planes in shared
// memory; each phase compiled for a band's interior rows, which read only
// this block's shared memory, and for its edge rows; a pixel's neighbour
// loads written without branches, so that they issue together; a BFS over
// an 8-bit residual mask built once per global relabel, relaxing locally
// inside a band before each cluster-wide vote; sweeps that touch the
// capacities only of active or pushed-to pixels.
//
// The solve keeps the Jacobi semantics of _solver_core, so a solve cut
// short by the round cap matches the plain version too
// (ops/mincut.py::solve_preflow):
//   - global relabel: min-plus BFS to its unique fixpoint. The fixpoint does
//     not depend on the iteration order, so the relaxation runs in place
//     (Gauss-Seidel), alternating the pixel order between passes, and a
//     band relaxes to its own fixpoint before the cluster votes; the loop
//     ends after a whole pass in which no block changed a height;
//   - push: each active node takes at most one admissible direction, in the
//     order sink, 4 forward edges, 4 backward edges; a direction code and an
//     amount per pixel replace the 9 flow planes;
//   - apply: inflow sums the neighbours' pushes in the reference order
//     (forward k = 0..3 from p - dir, then backward k = 0..3 from p + dir),
//     then e = (e - outflow) + inflow; a capacity no push touched is left
//     as it is (the same bits);
//   - relabel: reads the pre-sweep heights and writes a second buffer;
//     inactive nodes keep their height;
//   - backward residuals are rebuilt as fw0 - capfw, never carried.
// Every loop condition is a vote that all threads of the cluster reach, and
// no thread returns early.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 1024;
constexpr float kInf = 3e38f;
constexpr float kEps = 1e-7f;

// pairwise.NEIGHBORS and pairwise.FORWARD.
__constant__ int kNbDx[8] = {-1, 1, 0, 0, -1, 1, -1, 1};
__constant__ int kNbDy[8] = {0, 0, -1, 1, -1, -1, 1, 1};
__constant__ int kFwd[4] = {1, 3, 6, 7};
// The 8 out-directions of the solve: the 4 forward edges, then the same
// reversed. Loops over them are unrolled, so each entry is a constant.
__constant__ int kOutDx[8] = {1, 0, -1, 1, -1, 0, 1, -1};
__constant__ int kOutDy[8] = {0, 1, 1, 1, 0, -1, -1, -1};

// Where the solve state lives (ops/mincut_cuda.py: STATES).
constexpr int kStateGlobal = 0;
constexpr int kStateBanded = 1;
constexpr int kStateShared = 2;

// State planes. Float planes 0..4 are hot (h, h2, e, capt, amt), 5..12
// cold (capfw x4, fw0 x4); then the int8 planes dir and mask, which in the
// global workspace share one slot of S*S floats.
constexpr int kHotFloats = 5;
constexpr int kFloats = 13;

__host__ __device__ constexpr int state_slots(int state) {
  return state == kStateGlobal ? kFloats + 1
       : state == kStateBanded ? kFloats - kHotFloats : 0;
}

// Where a pixel lies in its band: in an interior row, whose neighbours are
// all this block's, or in an edge row, whose neighbours may be another
// block's (banded state only). A phase's code is compiled once for each.
struct Interior {};
struct Edge {};

// One block's view of its region's solver state, for state layout
// kState (known at compile time, so that shared-memory planes compile to
// shared-memory loads). A plane pointer is indexed by the region's pixel
// index; at() reaches the pixels that other blocks of the cluster hold in
// their shared memory. Every neighbour read is written without branches,
// so that a pixel's loads issue together.
template <int kState>
struct Region {
  int s, ss;
  float hmax;
  float inv_s;         // 1 / s, for the pixel's row and column
  int p0, p1;          // this block's band: pixels [p0, p1), whole rows
  int held;            // pixels each block of the cluster holds
  int stride;          // elements from one hot plane to the next
  int shift;           // pixel index of a hot plane's first element
  long long up, dn;    // bytes from this block's shared memory to the
                       // previous / next rank's (banded state only)
  float* hot;          // h, h2, e, capt, amt
  int8_t* bytes;       // dir (-1 none, 0..7, 8 sink), mask (residual
                       // out-edges of the last global relabel)
  float* cold;         // capfw x4, then fw0 x4, at a stride of S*S

  __device__ float* plane(int i) const {
    return hot + (size_t)i * stride - shift;
  }
  __device__ float* e() const { return plane(2); }
  __device__ float* capt() const { return plane(3); }
  __device__ float* amt() const { return plane(4); }
  __device__ int8_t* dir() const { return bytes - shift; }
  __device__ uint8_t* mask() const {
    return reinterpret_cast<uint8_t*>(bytes + stride - shift);
  }
  __device__ float* capfw(int k) const { return cold + (size_t)k * ss; }
  __device__ float* fw0(int k) const { return cold + (size_t)(4 + k) * ss; }

  // Column and row of pixel p, exact for S < 2048 (launch_plan refuses
  // larger windows): the product's rounding error, below S * 2^-23, stays
  // under the 0.5 / S margin around each row boundary.
  __device__ void xy(int p, int* x, int* y) const {
    *y = __float2int_rz(((float)p + 0.5f) * inv_s);
    *x = p - *y * s;
  }
  __device__ bool inside(int x, int y) const {
    return x >= 0 && x < s && y >= 0 && y < s;
  }
  __device__ bool edge(int p) const {
    if constexpr (kState == kStateBanded) return p < p0 + s || p >= p1 - s;
    else return false;
  }
  // Pixel q of a hot plane, a neighbour of a pixel in an interior row.
  template <class T>
  __device__ T* at(Interior, T* pl, int q) const {
    return pl + q;
  }
  // Pixel q of a hot plane, from whichever block holds it: in the banded
  // state the previous rank holds its pixel q at the same offset from its
  // band's start, which lies `held` pixels before ours.
  template <class T>
  __device__ T* at(Edge, T* pl, int q) const {
    if constexpr (kState != kStateBanded) {
      return pl + q;
    } else {
      const long long d = q < p0 ? up + (long long)held * sizeof(T)
                        : q >= p1 ? dn - (long long)held * sizeof(T) : 0;
      return reinterpret_cast<T*>(reinterpret_cast<uintptr_t>(pl + q) + d);
    }
  }
  // Residual capacities from p = (x, y) along the 8 out-directions (0
  // where the neighbour lies outside the window): forward edge j at p,
  // backward edge j - 4 as fw0 - capfw at the neighbour. The capacities of
  // another block's rows are in global memory and were written before the
  // last cluster barrier, which also invalidates this SM's L1.
  __device__ void out_caps(int p, int x, int y, float* cap) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool in = inside(x + kOutDx[j], y + kOutDy[j]);
      const int q = in ? p + kOutDy[j] * s + kOutDx[j] : p;
      const int k = j & 3;
      if (j < 4) cap[j] = in ? capfw(k)[p] : 0.0f;
      else cap[j] = in ? fw0(k)[q] - capfw(k)[q] : 0.0f;
    }
  }
};

__device__ float block_sum(float v) {
  __shared__ float partial[kMaxThreads / 32];
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

// Two vote slots in this block's shared memory.
__device__ int* vote_slots() {
  __shared__ int slots[2];
  return slots;
}

// The blocks that solve one region: barriers and votes over the cluster,
// or over the block when K = 1.
struct Team {
  int rank, size;
  int epoch;  // votes taken so far (the same in every block)

  __device__ void sync() const {
    if (size > 1) cg::this_cluster().sync();
    else __syncthreads();
  }

  // Whether v is non-zero in any thread of the team. A block that holds a
  // non-zero writes the vote's number into slot (number & 1) of every
  // block; after the barrier each block reads its own slot. A slot is
  // written again two votes later, after the next barrier, which every
  // block reaches only once it has read this vote: no reset is needed.
  __device__ int any(int v) {
    const int b = __syncthreads_or(v);
    if (size == 1) return b;
    const int e = ++epoch;
    int* slot = vote_slots() + (e & 1);
    if (b && (int)threadIdx.x < size)
      *cg::this_cluster().map_shared_rank(slot, (int)threadIdx.x) = e;
    cg::this_cluster().sync();
    return *(volatile int*)slot == e;
  }

  // Sum of v over the team, in a fixed order: each block's sum, then the
  // blocks' sums by rank. No float atomics, so the result is the same in
  // every run. Call once per kernel; the kernel ends with sync().
  __device__ float sum(float v) {
    __shared__ float mine, total;
    const float b = block_sum(v);
    if (size == 1) return b;
    if (threadIdx.x == 0) mine = b;
    cg::this_cluster().sync();
    if (threadIdx.x == 0) {
      float acc = 0.0f;
      for (int i = 0; i < size; ++i)
        acc += *cg::this_cluster().map_shared_rank(&mine, i);
      total = acc;
    }
    __syncthreads();
    return total;
  }
};

// Call before the team's first sync(), which orders the slots' reset
// before any other block's vote.
__device__ Team make_team(int rank, int size) {
  if (threadIdx.x < 2) vote_slots()[threadIdx.x] = 0;
  return Team{rank, size, 0};
}

// Points the region's planes at this block's share of the state. `gstate`
// holds the region's global slots (state_slots), `smem` the block's dynamic
// shared memory (ops/mincut_cuda.py: launch_plan gives its size).
template <int kState>
__device__ Region<kState> make_region(const Team& t, int s, int band_rows,
                                      float* gstate, unsigned char* smem) {
  Region<kState> r;
  r.s = s;
  r.ss = s * s;
  r.hmax = (float)(s * s + 2);
  r.inv_s = 1.0f / (float)s;
  const int y0 = min(t.rank * band_rows, s);
  r.p0 = y0 * s;
  r.p1 = min(y0 + band_rows, s) * s;
  r.up = r.dn = 0;
  if constexpr (kState == kStateGlobal) {
    r.held = 0;
    r.stride = r.ss;
    r.shift = 0;
    r.hot = gstate;
    r.cold = gstate + (size_t)kHotFloats * r.ss;
    r.bytes = reinterpret_cast<int8_t*>(gstate + (size_t)kFloats * r.ss);
  } else {
    // Pixels a block holds in shared memory, and the first one's index.
    const int held = kState == kStateShared ? r.ss : band_rows * s;
    r.held = held;
    r.stride = held;
    r.shift = t.rank * band_rows * s;
    r.hot = reinterpret_cast<float*>(smem);
    if constexpr (kState == kStateBanded) {
      auto delta = [&](int rank) {
        return reinterpret_cast<char*>(
                   cg::this_cluster().map_shared_rank(smem, rank)) -
               reinterpret_cast<char*>(smem);
      };
      if (t.rank > 0) r.up = delta(t.rank - 1);
      if (t.rank + 1 < t.size) r.dn = delta(t.rank + 1);
    }
    constexpr int nf = kState == kStateShared ? kFloats : kHotFloats;
    r.bytes = reinterpret_cast<int8_t*>(r.hot + (size_t)nf * held);
    if constexpr (kState == kStateShared)
      r.cold = r.hot + (size_t)kHotFloats * held;
    else
      r.cold = gstate;
  }
  return r;
}

// Calls f(p, x, y, where) for each pixel p = (x, y) of the block's band,
// `where` an Interior or an Edge for at().
template <class R, class F>
__device__ void each_pixel(const R& r, F f) {
  for (int p = r.p0 + threadIdx.x; p < r.p1; p += blockDim.x) {
    int x, y;
    r.xy(p, &x, &y);
    if (r.edge(p)) f(p, x, y, Edge{});
    else f(p, x, y, Interior{});
  }
}

// Global relabel into height plane `hi`: exact residual distance to the
// sink, hmax where the sink is unreachable. The residual out-edges do not
// change during it, so a mask of them is built first. Heights in the edge
// rows of a band are read from the neighbouring band while its block
// writes them (monotone decreasing 32-bit values): those reads are
// volatile, so no height is kept in a register, and a stale one only
// delays a decrease to the next pass.
template <class R>
__device__ void bfs(const R& r, Team& t, int hi) {
  float* h = r.plane(hi);
  const float* capt = r.capt();
  uint8_t* mask = r.mask();
  each_pixel(r, [&](int p, int x, int y, auto) {
    h[p] = capt[p] > kEps ? 1.0f : kInf;
    float cap[8];
    r.out_caps(p, x, y, cap);
    int m = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) m |= (cap[j] > kEps) << j;
    mask[p] = (uint8_t)m;
  });
  t.sync();
  // Relaxes pixel p against its residual out-neighbours; whether it fell.
  auto relax = [&](int p, int m, auto where) {
    constexpr bool kEdgeRow = std::is_same<decltype(where), Edge>::value;
    const float cur = h[p];
    float best = cur;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = p + kOutDy[j] * r.s + kOutDx[j];
      const float* hq = r.at(where, h, q);
      float v = kInf;
      if ((m >> j) & 1) v = kEdgeRow ? *(const volatile float*)hq : *hq;
      best = fminf(best, v + 1.0f);
    }
    if (best < cur) h[p] = best;
    return best < cur;
  };
  int pass = 0;
  for (;;) {
    int moved = 0, changed;
    do {
      changed = 0;
      for (int i = r.p0 + threadIdx.x; i < r.p1; i += blockDim.x) {
        const int p = (pass & 1) ? r.p0 + r.p1 - 1 - i : i;
        const int m = mask[p];
        if (!m) continue;
        changed |= r.edge(p) ? relax(p, m, Edge{}) : relax(p, m, Interior{});
      }
      ++pass;
      changed = __syncthreads_or(changed);
      moved |= changed;
    } while (changed);
    if (t.size == 1 || !t.any(moved)) break;
  }
  for (int p = r.p0 + threadIdx.x; p < r.p1; p += blockDim.x)
    if (h[p] >= kInf) h[p] = r.hmax;
  t.sync();
}

// Any node with excess below hmax (uniform across the team).
template <class R>
__device__ int any_active(const R& r, Team& t, int hi) {
  const float* h = r.plane(hi);
  const float* e = r.e();
  int act = 0;
  for (int p = r.p0 + threadIdx.x; p < r.p1; p += blockDim.x)
    act |= (e[p] > kEps) && (h[p] < r.hmax);
  return t.any(act);
}

// One push / apply / relabel sweep; heights move from plane hi to plane
// hi ^ 1. Returns whether any node is still active (uniform across the
// team).
template <class R>
__device__ int sweep(const R& r, Team& t, int hi) {
  const float* h = r.plane(hi);
  float* e = r.e();
  float* capt = r.capt();
  float* amt = r.amt();
  int8_t* dir = r.dir();

  // Push phase: choose one admissible direction per active node.
  each_pixel(r, [&](int p, int x, int y, auto where) {
    const float ep = e[p], hp = h[p];
    int code = -1;
    float a = 0.0f;
    if (ep > kEps && hp < r.hmax) {
      if (capt[p] > kEps && hp == 1.0f) {
        code = 8;
        a = fminf(ep, capt[p]);
      } else {
        float cap[8], nbh[8];
        r.out_caps(p, x, y, cap);
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // loaded beside the capacities
          const int q = p + kOutDy[j] * r.s + kOutDx[j];
          nbh[j] = r.inside(x + kOutDx[j], y + kOutDy[j])
              ? *r.at(where, h, q) : r.hmax;
        }
#pragma unroll
        for (int j = 7; j >= 0; --j) {  // the first admissible one wins
          if (cap[j] > kEps && hp == nbh[j] + 1.0f) {
            code = j;
            a = fminf(ep, cap[j]);
          }
        }
      }
    }
    dir[p] = (int8_t)code;
    amt[p] = a;
  });
  t.sync();

  // Apply phase: each node updates its own excess and capacities.
  each_pixel(r, [&](int p, int x, int y, auto where) {
    const int code = dir[p];
    const float a = amt[p];
    const float outflow = code >= 0 ? a : 0.0f;
    if (code == 8) capt[p] = capt[p] - a;
    // The neighbours' pushes toward p: from p + out-direction j, a push
    // along its direction (j + 4) & 7. j = 4..7 are the forward pushes
    // from p - dir_k, j = 0..3 the backward ones from p + dir_k.
    bool in[8];
    float na[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = p + kOutDy[j] * r.s + kOutDx[j];
      in[j] = r.inside(x + kOutDx[j], y + kOutDy[j])
              && *r.at(where, dir, q) == ((j + 4) & 7);
      na[j] = in[j] ? *r.at(where, amt, q) : 0.0f;
    }
    float inflow = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k)            // forward pushes from p - dir_k
      if (in[4 + k]) inflow = inflow + na[4 + k];
#pragma unroll
    for (int k = 0; k < 4; ++k) {          // backward pushes from p + dir_k
      if (code == k || in[k]) {
        float* capfw = r.capfw(k);
        float c = capfw[p];
        if (code == k) c = c - a;
        if (in[k]) {
          c = c + na[k];
          inflow = inflow + na[k];
        }
        capfw[p] = c;
      }
    }
    e[p] = (e[p] - outflow) + inflow;
  });
  t.sync();

  // Relabel phase: active nodes that could not push rise to 1 + the lowest
  // neighbour they have residual capacity to.
  float* h2 = r.plane(hi ^ 1);
  int act = 0;
  each_pixel(r, [&](int p, int x, int y, auto where) {
    const float ep = e[p], hp = h[p];
    float hn = hp;
    if (ep > kEps && hp < r.hmax) {
      float best = capt[p] > kEps ? 0.0f : kInf;
      float cap[8];
      r.out_caps(p, x, y, cap);
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // loaded beside the capacities
        const int q = p + kOutDy[j] * r.s + kOutDx[j];
        const float nb = r.inside(x + kOutDx[j], y + kOutDy[j])
            ? *r.at(where, h, q) : kInf;
        if (cap[j] > kEps) best = fminf(best, nb);
      }
      const bool could_push = best <= hp - 1.0f;
      const float new_h = best >= kInf ? r.hmax : fminf(best + 1.0f, r.hmax);
      if (!could_push) hn = fmaxf(hp, new_h);
    }
    h2[p] = hn;
    act |= (ep > kEps) && (hn < r.hmax);
  });
  return t.any(act);
}

// The solve (mincut_pallas.py:139-174): rounds of a global relabel and up
// to `sweeps` sweeps while any node is active, until no active node can
// reach the sink or `max_rounds` is hit; then the final global relabel.
// Returns the height plane (0 or 1) holding the final distances: the
// source side, which accepts, is dist >= hmax.
template <class R>
__device__ int push_relabel(const R& r, Team& t, int max_rounds,
                            int sweeps) {
  int cur = 0;
  int live = 1;
  for (int rounds = 0; live && rounds < max_rounds; ++rounds) {
    bfs(r, t, cur);
    live = any_active(r, t, cur);
    int act = live;
    for (int k = 0; k < sweeps && act; ++k) {
      act = sweep(r, t, cur);
      cur ^= 1;
    }
  }
  bfs(r, t, cur);
  return cur;
}

// Sets what every launch of `kernel` on the current device may need: as
// much dynamic shared memory as a block can take beside the kernel's static
// shared memory, and clusters of more than 8 blocks. Called once per kernel
// and device, before its first occupancy query or launch
// (ops/mincut_cuda.py: configured).
template <typename... P>
cudaError_t configure(void (*kernel)(P...)) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

inline cudaLaunchConfig_t region_config(int n, int cluster, int threads,
                                        int smem, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

// Launches `kernel` over n regions: n clusters of `cluster` blocks (one
// block per region when cluster is 1). A launch the card refuses returns
// its error; nothing falls back to another configuration.
template <typename... P, typename... A>
cudaError_t launch_regions(void (*kernel)(P...), int n, int cluster,
                           int threads, int smem, cudaStream_t stream,
                           A... args) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      region_config(n, cluster, threads, smem, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// How many regions of this plan the card runs at once (clusters, or
// blocks when cluster is 1), and the kernel's registers per thread.
template <typename... P>
cudaError_t occupancy(void (*kernel)(P...), int cluster, int threads,
                      int smem, int* active, int* regs) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  *regs = fa.numRegs;
  if (cluster > 1) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg =
        region_config(1, cluster, threads, smem, nullptr, &attr);
    return cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
  }
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *active = per_sm * sms;
  return err;
}

}  // namespace
