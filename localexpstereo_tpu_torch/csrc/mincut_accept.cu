// Push-relabel min-cut of prebuilt grid graphs for Hopper (sm_90a), one
// thread block per region: the solve of the fusion move.
//
// Replaces localexpstereo_tpu/ops/mincut_pallas.py::mincut_accept_pallas
// (its kernel _make_kernel over _solver_core): from the excess e, the sink
// capacities cap_t and the 4 forward capacities cap_fw of N regions of
// S x S pixels, run push-relabel until no active node can reach the sink
// or the round cap is hit, and return the source side (dist >= hmax) as the
// accept mask. The plain PyTorch version of the same semantics is
// ops/mincut.py::solve_preflow; the wrapper is
// ops/mincut_cuda.py::solve_graph.
//
// Design: grid = N regions, 1024 threads per block, block-stride loops over
// the region's pixels, the solve of push_relabel.cuh (shared with
// expansion_accept.cu). The mutable state lives in a global workspace
// [N, kPlanes, S, S] allocated by the wrapper (at S = 387 a plane is
// 599 KB, above the 227 KB of shared memory a block may use); the initial
// forward capacities are read from the input, which is never written.
// Built with --fmad=false, like the plain version's arithmetic.
//
// What bounds it on an H100: not the bytes (25 per pixel in and out, a few
// microseconds a call) but the chain of block-wide barriers of the BFS
// passes and sweeps, each a few loads per pixel from L2/global memory. At
// S = 387 the 6 regions of a color run as 6 blocks on 132 SMs. Shared-
// memory state at S = 42 and a thread-block cluster per region at S = 387
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "push_relabel.cuh"

namespace {

// Workspace planes per region (ops/mincut_cuda.py: MINCUT_WORK_PLANES).
constexpr int kE = 0;       // excess
constexpr int kCapT = 1;    // residual sink capacity
constexpr int kCapFw = 2;   // 4 planes: residual forward capacities
constexpr int kH = 6;       // heights (two buffers)
constexpr int kH2 = 7;
constexpr int kAmt = 8;     // pushed amount
constexpr int kDir = 9;     // push direction code (int)
constexpr int kPlanes = 10;

__global__ void __launch_bounds__(kThreads) mincut_accept_kernel(
    const float* __restrict__ e0, const float* __restrict__ capt0,
    const float* __restrict__ capfw0, uint8_t* __restrict__ accept,
    float* __restrict__ work, int s, int max_rounds, int sweeps) {
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
  r.fw0 = capfw0 + (size_t)n * 4 * r.ss;
  r.amt = plane(kAmt);
  r.dir = reinterpret_cast<int*>(plane(kDir));

  const size_t g = (size_t)n * r.ss;
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x) {
    r.e[p] = e0[g + p];
    r.capt[p] = capt0[g + p];
    for (int k = 0; k < 4; ++k)
      r.capfw[(size_t)k * r.ss + p] = r.fw0[(size_t)k * r.ss + p];
  }
  __syncthreads();

  const float* h = push_relabel(r, plane(kH), plane(kH2), max_rounds, sweeps);
  uint8_t* out = accept + g;
  for (int p = threadIdx.x; p < r.ss; p += blockDim.x)
    out[p] = h[p] >= r.hmax ? 1 : 0;
}

}  // namespace

extern "C" int mincut_accept_launch(const void* e, const void* capt,
                                    const void* capfw, void* accept,
                                    void* work, int n, int s, int max_rounds,
                                    int sweeps, void* stream) {
  if (n > 0) {
    mincut_accept_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)e, (const float*)capt, (const float*)capfw,
        (uint8_t*)accept, (float*)work, s, max_rounds, sweeps);
  }
  return (int)cudaGetLastError();
}
