// RANSAC's refit sums for Hopper (sm_90a): the normal equations of the
// weighted least-squares plane fit of each cell, A^T W A (9 values) and
// A^T W d (3 values), each a sequential fused-multiply-add chain over the
// cell's P pixels.
//
// Replaces no Pallas kernel. The JAX package computes these sums with two
// einsums (localexpstereo_tpu/models/proposals.py:218-219), and XLA's CPU
// backend evaluates each output as acc = fma(fw[p], f[p], acc) for
// p = 0 .. P-1 in order, from 0, with fw = feats * weight and f = feats or
// d * weight. The card's own summation order is another, and on near-tied
// moves that is enough to part the card's solve from the CPU's (ROADMAP
// C8). The plain PyTorch version, models/proposals.py::
// refit_sums_reference, takes each step as a float64 product (exact for
// float32 factors) plus a float64 sum rounded to float32. This kernel does
// the same arithmetic with round-to-nearest intrinsics, so the two agree
// bit for bit by construction. It is CUDA C++ and not Triton because every
// rounding of the chain is the point, and Triton may contract a multiply
// and an add. The wrapper is models/proposals.py::refit_sums.
//
// Design: one block a cell. What bounds it on an H100 is not the bytes
// (20 a pixel, read once: 2 MB at the main path's largest cells) but the
// chain of P dependent steps of each output (a conversion to float64, a
// float64 add, a rounding to float32). Twelve threads of warp 0 run the
// twelve chains, p in order, from shared memory; the other warps stage the
// next chunk of pixels (fw, f and d * w, 7 floats a pixel) while they do,
// in two buffers. The chains' loads thus come from shared memory and run
// ahead of the chain in the unrolled loop; a chain that read global memory
// itself waited on it at every few steps.
//
// refit_chain_probe_launch runs the chain alone, its operands in
// registers, to measure the floor that P dependent steps set.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kOutputs = 12;
constexpr int kThreads = 128;
constexpr int kStagers = kThreads - 32;
constexpr int kChunk = 512;
// A staged pixel: fw0, fw1, fw2, f0, f1, f2, d * w. The twelve chain
// threads read seven neighbouring words of one pixel: no bank conflicts.
constexpr int kStride = 7;

__device__ __forceinline__ float chain_step(float a, float b, float acc) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)acc));
}

// Stages pixels [p0, p0 + m) of one cell into s, thread t of n.
__device__ __forceinline__ void stage(float* s, const float* f,
                                      const float* w, const float* dc,
                                      int p0, int m, int t, int n) {
  for (int q = t; q < m; q += n) {
    const int g = p0 + q;
    const float wq = w[g];
    const float f0 = f[g * 3], f1 = f[g * 3 + 1], f2 = f[g * 3 + 2];
    float* o = s + q * kStride;
    o[0] = __fmul_rn(f0, wq);
    o[1] = __fmul_rn(f1, wq);
    o[2] = __fmul_rn(f2, wq);
    o[3] = f0;
    o[4] = f1;
    o[5] = f2;
    o[6] = __fmul_rn(dc[g], wq);
  }
}

__global__ void __launch_bounds__(kThreads) refit_sums_kernel(
    const float* __restrict__ feats, const float* __restrict__ weight,
    const float* __restrict__ d, float* __restrict__ ata,
    float* __restrict__ atb, int p) {
  __shared__ float buf[2][kChunk * kStride];
  const int cell = blockIdx.x;
  const int t = threadIdx.x;
  const float* f = feats + (size_t)cell * p * 3;
  const float* w = weight + (size_t)cell * p;
  const float* dc = d + (size_t)cell * p;
  // Output o < 9 is A^T W A's (i, j) = (o / 3, o % 3): fw_i * f_j; o >= 9
  // is A^T W d's row o - 9: fw_i * (d * w).
  const int i = t < 9 ? t / 3 : t - 9;
  const int b = t < 9 ? 3 + t % 3 : 6;
  const int chunks = (p + kChunk - 1) / kChunk;
  stage(buf[0], f, w, dc, 0, min(kChunk, p), t, kThreads);
  __syncthreads();
  float acc = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const int p0 = c * kChunk;
    if (t >= 32) {
      if (c + 1 < chunks) {
        stage(buf[(c + 1) & 1], f, w, dc, p0 + kChunk,
              min(kChunk, p - p0 - kChunk), t - 32, kStagers);
      }
    } else if (t < kOutputs) {
      const float* s = buf[c & 1];
      const int m = min(kChunk, p - p0);
#pragma unroll 16
      for (int q = 0; q < m; ++q) {
        acc = chain_step(s[q * kStride + i], s[q * kStride + b], acc);
      }
    }
    __syncthreads();
  }
  if (t < 9) {
    ata[(size_t)cell * 9 + t] = acc;
  } else if (t < kOutputs) {
    atb[(size_t)cell * 3 + (t - 9)] = acc;
  }
}

// The chain alone: p steps of chain_step on operands that change every
// step but never wait on memory. Writes each thread's sum (so that nothing
// is dropped) and thread 0's clock cycles a step.
__global__ void refit_chain_probe_kernel(float* __restrict__ out,
                                         double* __restrict__ cycles,
                                         int p) {
  float a = 1.0f + threadIdx.x, acc = 0.0f;
  const long long t0 = clock64();
  for (int q = 0; q < p; ++q) {
    acc = chain_step(a, 0.75f, acc);
    a = __fadd_rn(a, 0.5f);
  }
  const long long t1 = clock64();
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) cycles[0] = (double)(t1 - t0) / (p > 0 ? p : 1);
}

}  // namespace

extern "C" int refit_sums_launch(const void* feats, const void* weight,
                                 const void* d, void* ata, void* atb, int n,
                                 int p, void* stream) {
  if (n <= 0) return 0;
  refit_sums_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)feats, (const float*)weight, (const float*)d,
      (float*)ata, (float*)atb, p);
  return (int)cudaGetLastError();
}

// out: kOutputs floats; cycles: one double.
extern "C" int refit_chain_probe_launch(void* out, void* cycles, int p,
                                        void* stream) {
  refit_chain_probe_kernel<<<1, kOutputs, 0, (cudaStream_t)stream>>>(
      (float*)out, (double*)cycles, p);
  return (int)cudaGetLastError();
}
