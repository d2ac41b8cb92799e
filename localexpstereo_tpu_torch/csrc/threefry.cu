// The proposals' random draws for Hopper (sm_90a), made where they are used:
// jax.random's threefry2x32 (the partitionable scheme) and the float
// arithmetic that turns its bits into uniform draws and random unit vectors.
//
// Replaces no Pallas kernel: the JAX side is XLA's threefry. On the card the
// port used to hash on the host and copy each draw over, a pageable copy that
// drains the card before the next host step. Here the key's two words come in
// as launch arguments, so a draw uploads nothing. The plain versions are
// ops/rng.py::uniform (the tensor threefry2x32, then ops/xla_math.fma) and
// ops/plane.py::random_unit_vector (ops/xla_math.sincosf, sqrt, fma); this
// file does the same arithmetic, each float64 multiply, add, root and
// rounding one round-to-nearest intrinsic, and is built with --fmad=false,
// so that the two agree bit for bit by construction. It is CUDA C++ and not
// Triton because every rounding is the point, and Triton may contract a
// multiply and an add. The wrapper is ops/threefry_cuda.py.
//
// Design: one thread a draw, a grid-stride loop. The main path draws a few
// hundred to some 15,000 values a call (468 cells, 32 RANSAC hypotheses of
// each), so the launch is the cost: 20 rounds of integer work a draw and 4
// or 12 bytes written, far below the card's rates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 (20 rounds) of the counter pair (x0, x1) under (k0, k1):
// ops/rng.py::threefry2x32.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// Draw i of jax.random.uniform(key, minval=lo, maxval=hi): the bits of
// counter (i >> 32, i & 0xFFFFFFFF), 23 of them as a float in [1, 2), minus
// 1, then XLA's fused multiply-add as ops/xla_math.fma computes it (float64
// product and sum, one rounding to float32), then torch.maximum(lo, .).
__device__ __forceinline__ float draw(uint32_t k0, uint32_t k1, uint64_t i,
                                      float lo, float hi) {
  uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
  threefry2x32(k0, k1, x0, x1);
  const uint32_t bits = x0 ^ x1;
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float scaled = __double2float_rn(__dadd_rn(
      __dmul_rn((double)f, (double)__fsub_rn(hi, lo)), (double)lo));
  return lo < scaled ? scaled : lo;
}

// glibc's sinf / cosf as ops/xla_math.sincosf computes them, for
// 0 <= x < 120 (theta < 2 pi here, so no range check).
constexpr double kHpiInv = 0x1.45f306dc9c883p+23;
constexpr double kHpiHi = 0x1.921fb54442dp+0;
constexpr double kHpiLo = 0x1.8p-48;
constexpr double kC0 = 0x1p+0, kC1 = -0x1.ffffffd0c621cp-2,
                 kC2 = 0x1.55553e1068f19p-5, kC3 = -0x1.6c087e89a359dp-10,
                 kC4 = 0x1.99343027bf8c3p-16;
constexpr double kS1 = -0x1.555545995a603p-3, kS2 = 0x1.1107605230bc4p-7,
                 kS3 = -0x1.994eb3774cf24p-13;
// abstop12 of 2^-12: below it sin x = x, cos x = 1.
constexpr uint32_t kTiny = 0x398;

__device__ __forceinline__ void sincos_xla(float x, float& s, float& c) {
  const double xd = (double)x;
  const int n = (__double2int_rz(__dmul_rn(xd, kHpiInv)) + 0x800000) >> 24;
  const double nd = (double)n;
  const double r = __dsub_rn(__dsub_rn(xd, __dmul_rn(nd, kHpiHi)),
                             __dmul_rn(nd, kHpiLo));
  const double r2 = __dmul_rn(r, r);
  const double r3 = __dmul_rn(r, r2);
  const float sp = __double2float_rn(__dadd_rn(
      __dadd_rn(r, __dmul_rn(r3, kS1)),
      __dmul_rn(__dmul_rn(r3, r2), __dadd_rn(kS2, __dmul_rn(r2, kS3)))));
  const double r4 = __dmul_rn(r2, r2);
  const float cp = __double2float_rn(__dadd_rn(
      __dadd_rn(__dadd_rn(kC0, __dmul_rn(r2, kC1)), __dmul_rn(r4, kC2)),
      __dmul_rn(__dmul_rn(r4, r2), __dadd_rn(kC3, __dmul_rn(r2, kC4)))));
  s = (n & 1) ? cp : sp;
  c = (n & 1) ? sp : cp;
  if (n & 2) s = -s;
  if ((n + 1) & 2) c = -c;
  if (((__float_as_uint(x) >> 20) & 0x7FF) < kTiny) {
    s = x;
    c = 1.0f;
  }
}

__global__ void __launch_bounds__(kThreads) uniform_kernel(
    float* __restrict__ out, int64_t n, uint32_t k0, uint32_t k1, float lo,
    float hi) {
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    out[i] = draw(k0, k1, (uint64_t)i, lo, hi);
  }
}

// plane.random_unit_vector: theta ~ U(0, theta_hi) under key a, z ~
// U(z_lo, 1) under key b, r = sqrt(max(fma(-z, z, 1), 0)), out[i] =
// (r cos theta, r sin theta, z).
__global__ void __launch_bounds__(kThreads) unit_vector_kernel(
    float* __restrict__ out, int64_t n, uint32_t a0, uint32_t a1,
    uint32_t b0, uint32_t b1, float theta_hi, float z_lo) {
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const float theta = draw(a0, a1, (uint64_t)i, 0.0f, theta_hi);
    const float z = draw(b0, b1, (uint64_t)i, z_lo, 1.0f);
    float t = __double2float_rn(
        __dadd_rn(__dmul_rn(-(double)z, (double)z), 1.0));
    t = t < 0.0f ? 0.0f : t;
    const float r = __double2float_rn(__dsqrt_rn((double)t));
    float s, c;
    sincos_xla(theta, s, c);
    out[3 * i] = __fmul_rn(r, c);
    out[3 * i + 1] = __fmul_rn(r, s);
    out[3 * i + 2] = z;
  }
}

int blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < 65535 ? b : 65535);
}

}  // namespace

// out: n float32.
extern "C" int threefry_uniform_launch(void* out, int64_t n, uint32_t k0,
                                       uint32_t k1, float lo, float hi,
                                       void* stream) {
  if (n <= 0) return 0;
  uniform_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (float*)out, n, k0, k1, lo, hi);
  return (int)cudaGetLastError();
}

// out: n x 3 float32.
extern "C" int threefry_unit_vector_launch(void* out, int64_t n, uint32_t a0,
                                           uint32_t a1, uint32_t b0,
                                           uint32_t b1, float theta_hi,
                                           float z_lo, void* stream) {
  if (n <= 0) return 0;
  unit_vector_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (float*)out, n, a0, a1, b0, b1, theta_hi, z_lo);
  return (int)cudaGetLastError();
}
