// Unary cost windows for Hopper (sm_90a): plane-indexed sampling of the
// cost volume, fused with the guided filter that aggregates it.
//
// Replaces localexpstereo_tpu/ops/unary_pallas.py::sample_windows_dma (its
// kernel _make_kernel). The plain PyTorch version of the same semantics is
// ops/unary_cuda.py::sample_windows_reference: ops/unary_volume.py's
// sample_windows_aligned, then ops/guided.py's filter_windows.
//
// Per region n (window origin (fox, foy) in image coordinates, proposal
// plane (a, b, c)) and window pixel (x, y) of the F x F window:
//   d = a*gx + b*gy + c, dv = clip(d - min_disp, 0, D-1) (0 if d is not
//   finite); the tent along d has two taps, floor(dv) and floor(dv)+1 (the
//   upper one clamped at D-1), read straight from the padded volume; the
//   uint8 decode q*scale + zero follows the 2-tap sum (the weights sum to
//   1); a non-finite d gives COST_FOR_INVALID; the cost is truncated at
//   th_col and is 0 outside the image.
// With r_gf > 0 the raw window p is then guided-filtered with the global
// statistics (guide 3, mean 3, inverse covariance 6 channels) read at the
// same pixels of their padded [Hp, Wp, C] arrays:
//   s = box(p, p*g0, p*g1, p*g2); mean_p, cov -> a_r, a_g, a_b, b
//   out = (box(a_r) g0 + box(a_g) g1 + box(a_b) g2 + box(b)) / |box|.
//
// Design. The TPU kernel DMAs an aligned [D, F, F] superset of each window
// into VMEM, rolls lanes, selects rows with a where-chain and contracts the
// full tent over D: all of that exists for the TPU's (8, 128) tiling. Here
// a thread reads only its two taps from global memory. A filter window is
// up to 407 x 407 (663 KB a float plane), far above the 227 KB of shared
// memory of a block, so the filter runs as five launches over a global
// workspace, one thread per window pixel each:
//   1. sample the raw cost; with r_gf > 0 write the 4 planes p, p*g0..g2;
//   2. box sums along y (float64) of the 4 planes;
//   3. box sums along x (float64, rounded to float32), then the filter
//      coefficients a_r, a_g, a_b, b (times the in-image mask) as 4 planes;
//   4. box sums along y of the coefficients;
//   5. box sums along x and the output.
// The box sums accumulate in float64 like ops/boxfilter.py, whose float32
// result does not depend on the summation order; the number of in-image
// pixels under a box is the product of its in-image rows and columns, an
// exact integer. Built with --fmad=false, so every product and sum rounds
// as in the plain version.
//
// What bounds it on an H100: memory traffic. Each window pixel reads 2
// volume bytes (or floats) and 12 statistics floats, and the filter moves
// about 4 float + 8 double planes per region through L2; the box passes
// read (2r+1) neighbours each, served from L1. Keeping an F = 62 window's
// planes in shared memory (15 KB each) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kCostForInvalid = 1e6f;

struct Geometry {
  int n, f, r;               // regions, window side, filter radius
  int d, hv, wv, vol_pad;    // volume [D, Hv, Wv]: pixel (x, y) at
                             // [y + vol_pad, x + vol_pad]
  int hp, wp, pad;           // statistics [Hp, Wp, C]: at [y + pad, x + pad]
  int height, width;
  float neg_min_disp, th_col, scale, zero;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const uint8_t* p) {
  return (float)(*p);
}

// Offset of channel 0 of pixel (gx, gy) in a padded [Hp, Wp, C] array, the
// position clamped into the array (only out-of-image pixels, whose terms
// are multiplied away, can fall outside).
__device__ __forceinline__ size_t stat_offset(const Geometry& g, int gx,
                                              int gy, int channels) {
  int yy = clampi(gy + g.pad, 0, g.hp - 1);
  int xx = clampi(gx + g.pad, 0, g.wp - 1);
  return ((size_t)yy * g.wp + xx) * channels;
}

// In-image rows (or columns) of the clipped box [i - r, i + r] of a window
// whose first pixel lies at image coordinate o, the image being [0, len).
__device__ __forceinline__ int box_inside(int i, int o, int r, int f,
                                          int len) {
  int lo = max(max(i - r, 0), -o);
  int hi = min(min(i + r, f - 1), len - 1 - o);
  return hi >= lo ? hi - lo + 1 : 0;
}

// 1. Raw cost of every window pixel.
template <typename T>
__global__ void sample_kernel(const T* __restrict__ vol,
                              const float* __restrict__ guide,
                              const float* __restrict__ props,
                              const int* __restrict__ fox,
                              const int* __restrict__ foy,
                              float* __restrict__ out,
                              float* __restrict__ planes, Geometry g) {
  const int n = blockIdx.y;
  const int ff = g.f * g.f;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ff) return;
  const int y = idx / g.f;
  const int x = idx - y * g.f;
  const int gx = fox[n] + x;
  const int gy = foy[n] + y;
  const float xs = (float)gx;
  const float ys = (float)gy;
  const float a = props[4 * n + 0];
  const float b = props[4 * n + 1];
  const float c = props[4 * n + 2];

  const float d = a * xs + b * ys + c;
  const bool finite = isfinite(d);
  float dv = 0.0f;
  if (finite) {
    dv = fminf(fmaxf(d + g.neg_min_disp, 0.0f), (float)(g.d - 1));
  }
  const float lo = floorf(dv);
  const float w_lo = fmaxf(1.0f - fabsf(lo - dv), 0.0f);
  const float w_hi = fmaxf(1.0f - fabsf((lo + 1.0f) - dv), 0.0f);
  const int ilo = (int)lo;
  const int ihi = min(ilo + 1, g.d - 1);
  const int iy = clampi(gy + g.vol_pad, 0, g.hv - 1);
  const int ix = clampi(gx + g.vol_pad, 0, g.wv - 1);
  const size_t plane = (size_t)g.hv * g.wv;
  const size_t pix = (size_t)iy * g.wv + ix;
  const float v_lo = load_f(vol + (size_t)ilo * plane + pix);
  const float v_hi = load_f(vol + (size_t)ihi * plane + pix);
  float cost = (v_lo * w_lo + v_hi * w_hi) * g.scale + g.zero;
  if (!finite) cost = kCostForInvalid;
  cost = fminf(cost, g.th_col);
  const bool inside = gx >= 0 && gx < g.width && gy >= 0 && gy < g.height;
  const float p = inside ? cost : 0.0f;

  if (planes == nullptr) {
    out[(size_t)n * ff + idx] = p;
    return;
  }
  // p is already 0 outside the image, so it needs no mask here.
  const float* gi = guide + stat_offset(g, gx, gy, 3);
  float* base = planes + (size_t)n * 4 * ff + idx;
  base[0] = p;
  base[ff] = p * gi[0];
  base[2 * ff] = p * gi[1];
  base[3 * ff] = p * gi[2];
}

// 2 and 4. Box sums along y of [M, F, F] float planes, in float64.
__global__ void box_rows_kernel(const float* __restrict__ in,
                                double* __restrict__ out, Geometry g) {
  const int m = blockIdx.y;
  const int ff = g.f * g.f;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ff) return;
  const int y = idx / g.f;
  const int x = idx - y * g.f;
  const float* src = in + (size_t)m * ff + x;
  const int y1 = min(y + g.r, g.f - 1);
  double acc = 0.0;
  for (int yy = max(y - g.r, 0); yy <= y1; ++yy) {
    acc += (double)src[(size_t)yy * g.f];
  }
  out[(size_t)m * ff + idx] = acc;
}

// Box sum along x of row y of a float64 plane, rounded to float32.
__device__ __forceinline__ float box_cols(const double* plane, int y, int x,
                                          const Geometry& g) {
  const double* row = plane + (size_t)y * g.f;
  const int x1 = min(x + g.r, g.f - 1);
  double acc = 0.0;
  for (int xx = max(x - g.r, 0); xx <= x1; ++xx) acc += row[xx];
  return (float)acc;
}

// 3. Filter coefficients (ops/guided.py::filter_windows, same expressions).
__global__ void coeff_kernel(const double* __restrict__ rows,
                             const float* __restrict__ mean,
                             const float* __restrict__ inv,
                             const int* __restrict__ fox,
                             const int* __restrict__ foy,
                             float* __restrict__ planes, Geometry g) {
  const int n = blockIdx.y;
  const int ff = g.f * g.f;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ff) return;
  const int y = idx / g.f;
  const int x = idx - y * g.f;
  const int gx = fox[n] + x;
  const int gy = foy[n] + y;
  const double* base = rows + (size_t)n * 4 * ff;
  const float s_p = box_cols(base, y, x, g);
  const float s0 = box_cols(base + ff, y, x, g);
  const float s1 = box_cols(base + 2 * ff, y, x, g);
  const float s2 = box_cols(base + 3 * ff, y, x, g);
  const float cnt = (float)(box_inside(y, foy[n], g.r, g.f, g.height)
                            * box_inside(x, fox[n], g.r, g.f, g.width));
  const float inv_n = 1.0f / fmaxf(cnt, 1e-8f);
  const float* mi = mean + stat_offset(g, gx, gy, 3);
  const float* ii = inv + stat_offset(g, gx, gy, 6);
  const float mean_p = s_p * inv_n;
  const float c0 = s0 * inv_n - mi[0] * mean_p;
  const float c1 = s1 * inv_n - mi[1] * mean_p;
  const float c2 = s2 * inv_n - mi[2] * mean_p;
  const float a_r = ii[0] * c0 + ii[1] * c1 + ii[2] * c2;
  const float a_g = ii[1] * c0 + ii[3] * c1 + ii[4] * c2;
  const float a_b = ii[2] * c0 + ii[4] * c1 + ii[5] * c2;
  const float bb = mean_p - a_r * mi[0] - a_g * mi[1] - a_b * mi[2];
  const bool inside = gx >= 0 && gx < g.width && gy >= 0 && gy < g.height;
  const float m = inside ? 1.0f : 0.0f;
  float* out = planes + (size_t)n * 4 * ff + idx;
  out[0] = a_r * m;
  out[ff] = a_g * m;
  out[2 * ff] = a_b * m;
  out[3 * ff] = bb * m;
}

// 5. The filtered output.
__global__ void output_kernel(const double* __restrict__ rows,
                              const float* __restrict__ guide,
                              const int* __restrict__ fox,
                              const int* __restrict__ foy,
                              float* __restrict__ out, Geometry g) {
  const int n = blockIdx.y;
  const int ff = g.f * g.f;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ff) return;
  const int y = idx / g.f;
  const int x = idx - y * g.f;
  const int gx = fox[n] + x;
  const int gy = foy[n] + y;
  const double* base = rows + (size_t)n * 4 * ff;
  const float ab0 = box_cols(base, y, x, g);
  const float ab1 = box_cols(base + ff, y, x, g);
  const float ab2 = box_cols(base + 2 * ff, y, x, g);
  const float ab3 = box_cols(base + 3 * ff, y, x, g);
  const float cnt = (float)(box_inside(y, foy[n], g.r, g.f, g.height)
                            * box_inside(x, fox[n], g.r, g.f, g.width));
  const float inv_n = 1.0f / fmaxf(cnt, 1e-8f);
  const float* gi = guide + stat_offset(g, gx, gy, 3);
  out[(size_t)n * ff + idx] =
      (ab0 * gi[0] + ab1 * gi[1] + ab2 * gi[2] + ab3) * inv_n;
}

template <typename T>
int launch_all(const T* vol, const float* guide, const float* mean,
               const float* inv, const float* props, const int* fox,
               const int* foy, float* out, float* work_f, double* work_d,
               const Geometry& g, cudaStream_t stream) {
  const int ff = g.f * g.f;
  const dim3 block(kThreads);
  const dim3 per_region((ff + kThreads - 1) / kThreads, g.n);
  const dim3 per_plane((ff + kThreads - 1) / kThreads, 4 * g.n);
  const bool filter = g.r > 0;
  sample_kernel<T><<<per_region, block, 0, stream>>>(
      vol, guide, props, fox, foy, out, filter ? work_f : nullptr, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !filter) return (int)err;
  box_rows_kernel<<<per_plane, block, 0, stream>>>(work_f, work_d, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  coeff_kernel<<<per_region, block, 0, stream>>>(work_d, mean, inv, fox, foy,
                                                 work_f, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  box_rows_kernel<<<per_plane, block, 0, stream>>>(work_f, work_d, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  output_kernel<<<per_region, block, 0, stream>>>(work_d, guide, fox, foy,
                                                  out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the pipeline on `stream`. vol_u8 selects the volume type (uint8
// or float32); with r_gf = 0 only the sampling runs and guide/mean/inv and
// the workspaces are not read. Returns the CUDA error code (0 on success).
extern "C" int sample_windows_launch(
    const void* vol, int vol_u8, const void* guide, const void* mean,
    const void* inv, const void* props, const void* fox, const void* foy,
    void* out, void* work_f, void* work_d, int n, int f, int d, int hv,
    int wv, int vol_pad, int hp, int wp, int pad, int height, int width,
    float neg_min_disp, float th_col, float scale, float zero, int r_gf,
    void* stream) {
  if (n <= 0) return 0;
  Geometry g{n, f, r_gf, d, hv, wv, vol_pad, hp, wp, pad, height, width,
             neg_min_disp, th_col, scale, zero};
  const cudaStream_t s = (cudaStream_t)stream;
  if (vol_u8) {
    return launch_all<uint8_t>(
        (const uint8_t*)vol, (const float*)guide, (const float*)mean,
        (const float*)inv, (const float*)props, (const int*)fox,
        (const int*)foy, (float*)out, (float*)work_f, (double*)work_d, g, s);
  }
  return launch_all<float>(
      (const float*)vol, (const float*)guide, (const float*)mean,
      (const float*)inv, (const float*)props, (const int*)fox,
      (const int*)foy, (float*)out, (float*)work_f, (double*)work_d, g, s);
}
