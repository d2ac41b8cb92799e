// Push-relabel min-cut of prebuilt grid graphs for Hopper (sm_90a), one
// thread block or one thread-block cluster per region: the solve of the
// fusion move.
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
// Design: the solve and the launch plan of push_relabel.cuh, shared with
// expansion_accept.cu (ops/mincut_cuda.py::launch_plan), one instantiation
// per state layout: one block per region with its state in shared memory
// at S = 42, a cluster of K blocks in row bands at S >= 129. Each block
// copies its band of the 6 input planes into the 10 planes of the state
// (the initial forward capacities too, so that the state has one layout for
// both kernels), then solves. Built with --fmad=false, like the plain
// version's arithmetic.
//
// What bounds it on an H100: not the bytes (25 per pixel in and out, a few
// microseconds a call) but the chain of barriers of the BFS passes and
// sweeps and each phase's integer and load latency; these fusion graphs
// converge in about two rounds a region, so the BFS passes dominate. The
// cluster spreads an S = 387 region over 16 SMs, which one block per
// region left idle.

#include <cuda_runtime.h>
#include <stdint.h>

#include "push_relabel.cuh"

namespace {

template <int kState>
__global__ void __launch_bounds__(kMaxThreads) mincut_accept_kernel(
    const float* __restrict__ e0, const float* __restrict__ capt0,
    const float* __restrict__ capfw0, uint8_t* __restrict__ accept,
    float* work, int s, int max_rounds, int sweeps, int cluster,
    int band_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.x / cluster;
  Team t = make_team(blockIdx.x % cluster, cluster);
  const int ss = s * s;
  const Region<kState> r = make_region<kState>(
      t, s, band_rows, work + (size_t)n * state_slots(kState) * ss, smem);
  const size_t g = (size_t)n * ss;
  for (int p = r.p0 + threadIdx.x; p < r.p1; p += blockDim.x) {
    r.e()[p] = e0[g + p];
    r.capt()[p] = capt0[g + p];
    for (int k = 0; k < 4; ++k) {
      const float c = capfw0[(g * 4) + (size_t)k * ss + p];
      r.fw0(k)[p] = c;
      r.capfw(k)[p] = c;
    }
  }
  t.sync();

  const float* h = r.plane(push_relabel(r, t, max_rounds, sweeps));
  uint8_t* out = accept + g;
  for (int p = r.p0 + threadIdx.x; p < r.p1; p += blockDim.x)
    out[p] = h[p] >= r.hmax ? 1 : 0;
  t.sync();  // no block leaves while another reads its shared memory
}

// The kernel of a state layout (push_relabel.cuh: kState*).
template <typename F>
cudaError_t with_kernel(int state, F f) {
  switch (state) {
    case kStateGlobal: return f(mincut_accept_kernel<kStateGlobal>);
    case kStateBanded: return f(mincut_accept_kernel<kStateBanded>);
    case kStateShared: return f(mincut_accept_kernel<kStateShared>);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int mincut_accept_launch(const void* e, const void* capt,
                                    const void* capfw, void* accept,
                                    void* work, int n, int s,
                                    int max_rounds, int sweeps, int cluster,
                                    int threads, int smem, int state,
                                    int band_rows, void* stream) {
  if (n <= 0) return 0;
  return (int)with_kernel(state, [&](auto kernel) {
    return launch_regions(kernel, n, cluster, threads, smem,
                          (cudaStream_t)stream, (const float*)e,
                          (const float*)capt, (const float*)capfw,
                          (uint8_t*)accept, (float*)work, s, max_rounds,
                          sweeps, cluster, band_rows);
  });
}

extern "C" int mincut_accept_configure(int state) {
  return (int)with_kernel(state, [](auto kernel) { return configure(kernel); });
}

extern "C" int mincut_accept_occupancy(int cluster, int threads, int smem,
                                       int state, int* active, int* regs) {
  return (int)with_kernel(state, [&](auto kernel) {
    return occupancy(kernel, cluster, threads, smem, active, regs);
  });
}
