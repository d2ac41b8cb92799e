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
//   upper one clamped at D-1), read straight from the padded volume
//   (uint8, bfloat16 or float32, widened to float32 exactly); the decode
//   q*scale + zero follows the 2-tap sum (the weights sum to 1; a float
//   volume has scale 1, zero 0); a non-finite d gives COST_FOR_INVALID;
//   the cost is truncated at th_col and is 0 outside the image.
// With r_gf > 0 the raw window p is then guided-filtered with the global
// statistics (guide 3, mean 3, inverse covariance 6 channels) read at the
// same pixels of their padded [Hp, Wp, C] arrays:
//   s = box(p, p*g0, p*g1, p*g2); mean_p, cov -> a_r, a_g, a_b, b
//   out = (box(a_r) g0 + box(a_g) g1 + box(a_b) g2 + box(b)) / |box|,
// every box clipped at the window's edges (not the image's).
//
// What bounds it on an H100: memory traffic. A filtered window pixel must
// write 4 bytes and read its 2 volume taps, and the statistics cost 48
// bytes a pixel over the union of the windows; the arithmetic (about 100
// float32 and float64 operations a pixel) is far below the card's rate.
//
// Design: one launch a call, nothing through device memory but the inputs
// and the output. The grid is one block a tile (strip, row chunk, region;
// ops/unary_cuda.py::launch_plan). A tile owns the output columns
// [x0, x0 + W) and rows [y0, y0 + Hc) of one window; stage 1 reads its
// columns widened by 2r, stage 2 by r, both clipped to [0, F). It walks the
// rows from y0 - 2r (clipped) to y0 + Hc + 2r, kBatch rows a step: at step
// t row t enters stage 1, coefficient row t - r stage 2, and output row
// t - 2r is written. Where one tile spans the window (F = 62) nothing is
// computed twice; the plan weighs more tiles (a fuller card at N = 6 or
// 54) against the 4r rows of warm-up each row chunk repeats.
// - Stage 1, down. Every (row, column) of the step samples p and p*g0..2
//   of the row entering and of the row leaving, 2r + 1 rows up (sampled
//   again: its bytes are in L1/L2), and stores their difference in
//   float64; then each (plane, column) adds them to its running vertical
//   sum. O(1) a pixel, no ring of input rows.
// - Stage 1, across. A warp takes a row of vertical sums, turns it into
//   float64 prefix sums (a sequential run a lane, then a warp scan of the
//   runs) and reads each box as the difference of two prefix sums, rounded
//   to float32 once. O(1) a pixel.
// - Stage 2, down. Every (row, column) turns its box sums into the
//   coefficients a_r, a_g, a_b, b (times the in-image mask), with mean and
//   inv read once a pixel, into a ring of 2r + 1 + kBatch rows in shared
//   memory; each (plane, column) then adds the row entering and subtracts
//   the row leaving.
// - Stage 2, across. As stage 1, then the output row, coalesced; the guide
//   is read again (an L2 hit), before the scan so that its latency hides.
// Float64 sums of float32 values are exact while their exponents span
// less than 29 bits, so the float32 box sums equal the plain version's
// (ops/boxfilter.py: float64 cumulative sums) whatever the order; built
// with --fmad=false, every other product and sum rounds as in the plain
// version.
//
// The four costs of the five-launch version this replaces, and what
// became of each: five launches a call are one; its float32 and float64
// workspaces (87 MB at F = 62, N = 468, above the 50 MB of L2) are gone,
// with the guide read twice from L2 in place of 4 + 8 planes streamed
// through it four times; its box passes summed 2r + 1 taps a pixel and
// now take a running sum and a prefix difference; and the raw route reads
// its taps as before, one thread a pixel over bands of whole window rows:
// neighbouring threads take neighbouring x, whose taps lie in one d-plane
// while the plane's disparity stays within one level, so a warp's 32 bytes
// of a tap fall in one or two 32-byte sectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBatch = 8;            // rows a filter tile takes per step
constexpr int kRawThreads = 256;
// A filter block has 128 to 512 threads and at most 64 registers a thread
// (two blocks of 512 an SM), so that an SM keeps about 1024 threads.
constexpr int kMinThreads = 128, kMaxThreads = 512, kSmThreads = 1024;
constexpr int kMaxWidth = 256;       // output columns of a tile at most
constexpr int kMaxSmem = 232448;     // dynamic shared memory of one block
constexpr int kSmemPerSm = 233472, kSmemReserved = 1024;
constexpr float kCostForInvalid = 1e6f;
// The volume's element type, as ops/unary_cuda.py::VOL_TYPES numbers it.
enum VolType { kVolFloat32 = 0, kVolUint8 = 1, kVolBfloat16 = 2 };

struct Geometry {
  int n, f, r;               // regions, window side, filter radius
  int d, hv, wv, vol_pad;    // volume [D, Hv, Wv]: pixel (x, y) at
                             // [y + vol_pad, x + vol_pad]
  int hp, wp, pad;           // statistics [Hp, Wp, C]: at [y + pad, x + pad]
  int height, width;
  float neg_min_disp, th_col, scale, zero;
  int tile_w, tile_h;        // a tile's output columns and rows
};

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

// The filter kernel's block for tiles W columns wide, w1 = W + 4r and
// w2 = W + 2r columns (clipped to F) in its two stages. Its rings hold
// `ring` = 2r + 1 + kBatch rows: a step's rows and the 2r + 1 before them.
// Shared memory, in this order:
//   vsum   double [kBatch][4][w1]  a step's rows of vertical sums, then
//                                  their prefix sums across;
//   carry  double [4][w1 + w2]     each column's vertical sums so far;
//   ring1  float [ring][w1]        stage 1's rows of p;
//   ring2  float [ring][4][w2]     stage 2's rows: box sums, then
//                                  coefficients.
// Threads: about kSmThreads over the blocks that shared memory lets an SM
// hold, a multiple of 32 in [kMinThreads, kMaxThreads].
// ops/unary_cuda.py::tile_plan computes the same numbers.
struct Layout {
  int w1, w2, ring, threads;
  long long bytes;
};

__host__ __device__ __forceinline__ Layout filter_layout(int f, int r,
                                                         int tile_w) {
  Layout l;
  l.w1 = imin(f, tile_w + 4 * r);
  l.w2 = imin(f, tile_w + 2 * r);
  l.ring = 2 * r + 1 + kBatch;
  l.bytes = 32LL * kBatch * l.w1 + 32LL * (l.w1 + l.w2)
            + 4LL * l.ring * l.w1 + 16LL * l.ring * l.w2;
  const long long per_sm = kSmemPerSm / (l.bytes + kSmemReserved);
  const int t = per_sm > 0 ? (int)(kSmThreads / per_sm) : kMaxThreads;
  l.threads = imin(imax(t, kMinThreads), kMaxThreads) / 32 * 32;
  return l;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const uint8_t* p) {
  return (float)(*p);
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

__device__ __forceinline__ bool in_image(const Geometry& g, int gx, int gy) {
  return gx >= 0 && gx < g.width && gy >= 0 && gy < g.height;
}

// Raw cost of image pixel (gx, gy) under the plane (a, b, c).
template <typename T>
__device__ __forceinline__ float raw_cost(const T* __restrict__ vol,
                                          const Geometry& g, float a,
                                          float b, float c, int gx, int gy) {
  const float d = a * (float)gx + b * (float)gy + c;
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
  return in_image(g, gx, gy) ? cost : 0.0f;
}

// r_gf = 0: the raw costs, one thread a pixel, a block a band of tile_h
// whole window rows.
template <typename T>
__global__ void __launch_bounds__(kRawThreads)
raw_kernel(const T* __restrict__ vol, const float* __restrict__ props,
           const int64_t* __restrict__ fox, const int64_t* __restrict__ foy,
           float* __restrict__ out, Geometry g) {
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * g.tile_h;
  const int px = imin(g.tile_h, g.f - y0) * g.f;
  const int ox = (int)fox[n];
  const int oy = (int)foy[n] + y0;
  const float a = props[4 * n + 0];
  const float b = props[4 * n + 1];
  const float c = props[4 * n + 2];
  float* o = out + ((size_t)n * g.f + y0) * g.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < px; i += kRawThreads) {
    const int y = i / g.f;
    const int x = i - y * g.f;
    o[i] = raw_cost(vol, g, a, b, c, ox + x, oy + y);
  }
}

// Turns the 4 planes (stride `plane`) of a row of `width` float64 values
// into their inclusive prefix sums, in place; called by a whole warp.
__device__ __forceinline__ void prefix_row(double* row, int plane, int width,
                                           int lane) {
  const int per = (width + 31) >> 5;
  const int lo = lane * per;
  const int hi = imin(lo + per, width);
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int c = lo; c < hi; ++c) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      acc[p] += row[p * plane + c];
      row[p * plane + c] = acc[p];
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const double y = __shfl_up_sync(0xffffffffu, acc[p], off);
      if (lane >= off) acc[p] += y;
    }
  }
  double base[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const double y = __shfl_up_sync(0xffffffffu, acc[p], 1);
    base[p] = lane > 0 ? y : 0.0;
  }
  for (int c = lo; c < hi; ++c) {
#pragma unroll
    for (int p = 0; p < 4; ++p) row[p * plane + c] += base[p];
  }
  __syncwarp();
}

// The box sums at window column x, clipped to [0, F), from a prefix row
// whose first column is window column `first`; rounded to float32 once.
__device__ __forceinline__ float4 box_from_prefix(const double* row,
                                                  int plane, int x, int r,
                                                  int f, int first) {
  const int hi = imin(x + r, f - 1) - first;
  const int lo = imax(x - r, 0) - first - 1;
  double s[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    s[p] = row[p * plane + hi] - (lo >= 0 ? row[p * plane + lo] : 0.0);
  }
  return make_float4((float)s[0], (float)s[1], (float)s[2], (float)s[3]);
}

// Calls body(k, j) for every k < rows, j < w, the block's threads taking
// the pairs in turn (no division in the loop).
template <typename F>
__device__ __forceinline__ void for_items(int rows, int w, F&& body) {
  int k = threadIdx.x / w, j = threadIdx.x - k * w;
  const int dk = blockDim.x / w, dj = blockDim.x - dk * w;
  while (k < rows) {
    body(k, j);
    j += dj;
    k += dk;
    if (j >= w) {
      j -= w;
      ++k;
    }
  }
}

// r_gf > 0: the filtered costs, a block a tile (see the note at the top).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
filter_kernel(const T* __restrict__ vol, const float* __restrict__ guide,
              const float* __restrict__ mean, const float* __restrict__ inv,
              const float* __restrict__ props,
              const int64_t* __restrict__ fox,
              const int64_t* __restrict__ foy, float* __restrict__ out,
              Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = filter_layout(g.f, g.r, g.tile_w);
  const int pw1 = lay.w1, pw2 = lay.w2, nring = lay.ring;
  double* vsum = reinterpret_cast<double*>(smem);
  double* carry1 = vsum + kBatch * 4 * pw1;
  double* carry2 = carry1 + 4 * pw1;
  float* ring1 = reinterpret_cast<float*>(carry2 + 4 * pw2);
  float* ring2 = ring1 + nring * pw1;
  const int f = g.f, r = g.r, n = blockIdx.z, span = 2 * r + 1;
  const int x0 = blockIdx.x * g.tile_w, x1 = imin(x0 + g.tile_w, f);
  const int y0 = blockIdx.y * g.tile_h, y1 = imin(y0 + g.tile_h, f);
  const int c1 = imax(x0 - 2 * r, 0), w1 = imin(x1 + 2 * r, f) - c1;
  const int c2 = imax(x0 - r, 0), w2 = imin(x1 + r, f) - c2;
  // Steps t walk the input rows [ya, t_end): at step t row t enters stage
  // 1, coefficient row t - r stage 2, and output row t - 2r is written.
  // Row t sits in ring slot (t - ya) mod nring, the row leaving at step t
  // (t - span) in slot (t - ya + kBatch) mod nring.
  const int ya = imax(y0 - 2 * r, 0), t_end = y1 + 2 * r;
  const int in_end = imin(t_end, f);
  const int yc_lo = imax(y0 - r, 0), yc_hi = imin(y1 + r, f);
  const int ox = (int)fox[n], oy = (int)foy[n];
  const float a = props[4 * n + 0];
  const float b = props[4 * n + 1];
  const float c = props[4 * n + 2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, warps = nthreads >> 5;
  for (int i = tid; i < 4 * (pw1 + pw2); i += nthreads) carry1[i] = 0.0;
  auto wrap = [nring](int s) { return s >= nring ? s - nring : s; };

  for (int t0 = ya, slot0 = 0; t0 < t_end;
       t0 += kBatch, slot0 = wrap(slot0 + kBatch)) {
    // Stage 1, down: p and p*g0..2 of each row entering less those of the
    // row leaving (its p from ring1, its guide again from L1/L2), for
    // every (row, column) of the step ...
    for_items(kBatch, w1, [&](int k, int j) {
      const int t = t0 + k, gx = ox + c1 + j, slot = wrap(slot0 + k);
      float p = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
      if (t < in_end) {
        p = raw_cost(vol, g, a, b, c, gx, oy + t);
        const float* gi = guide + stat_offset(g, gx, oy + t, 3);
        g0 = gi[0];
        g1 = gi[1];
        g2 = gi[2];
      }
      ring1[slot * pw1 + j] = p;
      double* v = vsum + k * 4 * pw1 + j;
      v[0] = (double)p;
      v[pw1] = (double)(p * g0);
      v[2 * pw1] = (double)(p * g1);
      v[3 * pw1] = (double)(p * g2);
      const int tg = t - span;
      if (tg >= ya && tg < in_end) {
        // A row leaving within this step (r = 1) is sampled again.
        const float q = tg >= t0
                            ? raw_cost(vol, g, a, b, c, gx, oy + tg)
                            : ring1[wrap(slot + kBatch) * pw1 + j];
        const float* gi = guide + stat_offset(g, gx, oy + tg, 3);
        v[0] -= (double)q;
        v[pw1] -= (double)(q * gi[0]);
        v[2 * pw1] -= (double)(q * gi[1]);
        v[3 * pw1] -= (double)(q * gi[2]);
      }
    });
    __syncthreads();
    // ... then the running sums of each (plane, column) down the step.
    for_items(4, w1, [&](int p, int j) {
      double s = carry1[p * pw1 + j];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        double* v = vsum + (k * 4 + p) * pw1 + j;
        s += *v;
        *v = s;
      }
      carry1[p * pw1 + j] = s;
    });
    __syncthreads();
    // Stage 1, across: box sums of the coefficient rows, a warp a row.
    for (int k = warp; k < kBatch; k += warps) {
      const int yc = t0 + k - r;
      if (yc < yc_lo || yc >= yc_hi) continue;
      double* row = vsum + k * 4 * pw1;
      prefix_row(row, pw1, w1, lane);
      float* dst = ring2 + wrap(slot0 + k) * 4 * pw2;
      for (int q = lane; q < w2; q += 32) {
        const float4 s4 = box_from_prefix(row, pw1, c2 + q, r, f, c1);
        dst[q] = s4.x;
        dst[pw2 + q] = s4.y;
        dst[2 * pw2 + q] = s4.z;
        dst[3 * pw2 + q] = s4.w;
      }
    }
    __syncthreads();
    // Stage 2, down: the coefficients of every (row, column) of the step
    // (ops/guided.py::filter_windows, the same expressions) ...
    for_items(kBatch, w2, [&](int k, int j) {
      const int yc = t0 + k - r;
      float* v = ring2 + wrap(slot0 + k) * 4 * pw2 + j;
      float a_r = 0.0f, a_g = 0.0f, a_b = 0.0f, bb = 0.0f, msk = 0.0f;
      if (yc >= yc_lo && yc < yc_hi) {
        const int x = c2 + j, gx = ox + x, gy = oy + yc;
        const float* mi = mean + stat_offset(g, gx, gy, 3);
        const float* ii = inv + stat_offset(g, gx, gy, 6);
        const float cnt = (float)(box_inside(yc, oy, r, f, g.height)
                                  * box_inside(x, ox, r, f, g.width));
        const float inv_n = 1.0f / fmaxf(cnt, 1e-8f);
        const float mean_p = v[0] * inv_n;
        const float q0 = v[pw2] * inv_n - mi[0] * mean_p;
        const float q1 = v[2 * pw2] * inv_n - mi[1] * mean_p;
        const float q2 = v[3 * pw2] * inv_n - mi[2] * mean_p;
        a_r = ii[0] * q0 + ii[1] * q1 + ii[2] * q2;
        a_g = ii[1] * q0 + ii[3] * q1 + ii[4] * q2;
        a_b = ii[2] * q0 + ii[4] * q1 + ii[5] * q2;
        bb = mean_p - a_r * mi[0] - a_g * mi[1] - a_b * mi[2];
        msk = in_image(g, gx, gy) ? 1.0f : 0.0f;
      }
      v[0] = a_r * msk;
      v[pw2] = a_g * msk;
      v[2 * pw2] = a_b * msk;
      v[3 * pw2] = bb * msk;
    });
    __syncthreads();
    // ... then the running sums of each (plane, column): add the row
    // entering, subtract the row leaving.
    for_items(4, w2, [&](int p, int j) {
      double s = carry2[p * pw2 + j];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int slot = wrap(slot0 + k);
        const float in = ring2[(slot * 4 + p) * pw2 + j];
        const float gone = t0 + k - span >= ya
            ? ring2[(wrap(slot + kBatch) * 4 + p) * pw2 + j]
            : 0.0f;
        s += (double)in - (double)gone;
        vsum[(k * 4 + p) * pw1 + j] = s;
      }
      carry2[p * pw2 + j] = s;
    });
    __syncthreads();
    // Stage 2, across: the output rows, a warp a row; a lane's first two
    // pixels read the guide before the scan, so that its latency hides.
    for (int k = warp; k < kBatch; k += warps) {
      const int yo = t0 + k - 2 * r;
      if (yo < y0 || yo >= y1) continue;
      float gv[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int x = x0 + lane + 32 * q;
        if (x < x1) {
          const float* gi = guide + stat_offset(g, ox + x, oy + yo, 3);
          gv[q][0] = gi[0];
          gv[q][1] = gi[1];
          gv[q][2] = gi[2];
        }
      }
      double* row = vsum + k * 4 * pw1;
      prefix_row(row, pw1, w2, lane);
      const int in_y = box_inside(yo, oy, r, f, g.height);
      float* o = out + ((size_t)n * f + yo) * f;
      for (int x = x0 + lane, q = 0; x < x1; x += 32, ++q) {
        float g0 = gv[0][0], g1 = gv[0][1], g2 = gv[0][2];
        if (q == 1) {
          g0 = gv[1][0];
          g1 = gv[1][1];
          g2 = gv[1][2];
        } else if (q > 1) {
          const float* gi = guide + stat_offset(g, ox + x, oy + yo, 3);
          g0 = gi[0];
          g1 = gi[1];
          g2 = gi[2];
        }
        const float4 ab = box_from_prefix(row, pw1, x, r, f, c2);
        const float cnt = (float)(in_y * box_inside(x, ox, r, f, g.width));
        const float inv_n = 1.0f / fmaxf(cnt, 1e-8f);
        o[x] = (ab.x * g0 + ab.y * g1 + ab.z * g2 + ab.w) * inv_n;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* vol, const float* guide, const float* mean,
           const float* inv, const float* props, const int64_t* fox,
           const int64_t* foy, float* out, const Geometry& g,
           cudaStream_t stream) {
  const int chunks = (g.f + g.tile_h - 1) / g.tile_h;
  if (g.r == 0) {
    if (g.tile_w != g.f) return (int)cudaErrorInvalidValue;
    raw_kernel<T><<<dim3(1, chunks, g.n), kRawThreads, 0, stream>>>(
        vol, props, fox, foy, out, g);
    return (int)cudaGetLastError();
  }
  const Layout lay = filter_layout(g.f, g.r, g.tile_w);
  if (g.tile_w > kMaxWidth || lay.bytes > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const int strips = (g.f + g.tile_w - 1) / g.tile_w;
  filter_kernel<T><<<dim3(strips, chunks, g.n), lay.threads,
                     (size_t)lay.bytes, stream>>>(vol, guide, mean, inv,
                                                  props, fox, foy, out, g);
  return (int)cudaGetLastError();
}

template <typename T>
const void* kernel_of(int r) {
  return r == 0 ? (const void*)raw_kernel<T> : (const void*)filter_kernel<T>;
}

// Calls fn(T{}) with T the element type of volume type `vol_type`;
// cudaErrorInvalidValue for an unknown type.
template <typename Fn>
int with_vol_type(int vol_type, Fn&& fn) {
  switch (vol_type) {
    case kVolFloat32:
      return fn(float{});
    case kVolUint8:
      return fn(uint8_t{});
    case kVolBfloat16:
      return fn(__nv_bfloat16{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the kernel for one call on `stream`: tiles of tile_w x tile_h
// output pixels (ops/unary_cuda.py::launch_plan; with r_gf = 0 tile_w must
// be f). vol_type is the volume's element type (VolType); with r_gf = 0
// guide/mean/inv are not read. Returns the CUDA error code (0 on success).
extern "C" int sample_windows_launch(
    const void* vol, int vol_type, const void* guide, const void* mean,
    const void* inv, const void* props, const void* fox, const void* foy,
    void* out, int n, int f, int d, int hv, int wv, int vol_pad, int hp,
    int wp, int pad, int height, int width, float neg_min_disp,
    float th_col, float scale, float zero, int r_gf, int tile_w, int tile_h,
    void* stream) {
  if (n <= 0) return 0;
  if (tile_w <= 0 || tile_h <= 0) return (int)cudaErrorInvalidValue;
  Geometry g{n, f, r_gf, d, hv, wv, vol_pad, hp, wp, pad, height, width,
             neg_min_disp, th_col, scale, zero, tile_w, tile_h};
  const cudaStream_t s = (cudaStream_t)stream;
  return with_vol_type(vol_type, [&](auto tag) {
    using T = decltype(tag);
    return launch<T>((const T*)vol, (const float*)guide, (const float*)mean,
                     (const float*)inv, (const float*)props,
                     (const int64_t*)fox, (const int64_t*)foy, (float*)out,
                     g, s);
  });
}

// Lets the filter kernels of every volume type take the most dynamic
// shared memory a block can have, on the current device; called once per
// device.
extern "C" int sample_windows_configure() {
  for (int t = kVolFloat32; t <= kVolBfloat16; ++t) {
    const int err = with_vol_type(t, [](auto tag) {
      return (int)cudaFuncSetAttribute(
          filter_kernel<decltype(tag)>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    });
    if (err != 0) return err;
  }
  return 0;
}

// The block of a plan (threads, dynamic shared memory) and the card's
// answer for it: blocks an SM runs at once and registers a thread, for the
// kernel of volume type vol_type and radius r (0: the raw kernel).
extern "C" int sample_windows_occupancy(int vol_type, int f, int r,
                                        int tile_w, int* threads,
                                        int* smem_bytes,
                                        int* blocks_per_sm, int* registers) {
  int t = kRawThreads;
  long long bytes = 0;
  if (r > 0) {
    const Layout lay = filter_layout(f, r, tile_w);
    t = lay.threads;
    bytes = lay.bytes;
    if (tile_w > kMaxWidth || bytes > kMaxSmem) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const void* k = nullptr;
  const int bad = with_vol_type(vol_type, [&](auto tag) {
    k = kernel_of<decltype(tag)>(r);
    return 0;
  });
  if (bad != 0) return bad;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k, t,
                                                      (size_t)bytes);
  *threads = t;
  *smem_bytes = (int)bytes;
  *registers = attr.numRegs;
  return (int)err;
}
