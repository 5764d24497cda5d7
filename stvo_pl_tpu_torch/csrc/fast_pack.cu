// Fused FAST-9/16 response + sub-pixel offsets + 3x3 NMS + cell packing.
//
// Replaces the TPU kernel stvo_pl_tpu/ops/fast_kernel.py::_fast_pack_pallas
// (body _make_kernel).  Output is bit-identical to it: one int32 per pixel,
//
//   floor(score * 256) * 2^14 + (15 - cell_idx) * 2^10 + oy5 * 32 + ox5
//
// at 3x3-NMS survivors inside the detector border, 0 elsewhere, in the
// padded shape [N, ceil(H/40)*40, round_up(W,128)] that the selection glue
// (ops/fast_kernel.py select_from_packed) pools.
//
// What bounds it on an H100: operations, by a small margin over bytes.  Per
// pixel it reads one float and writes one int (about 154 MB per VO step at
// B=8 over the four pyramid levels, 46 us at 3.35 TB/s), and the response
// needs about 204 float32 min/max/sub operations per pixel when the arc
// windows share subtrees (55 us at 67 TFLOP/s).  This simple version
// recomputes each 9-arc (about 300 operations per pixel).  The design
// keeps every intermediate out of device memory:
// one block per (image, 32-row x 128-column tile) stages the tile plus a
// 4-pixel halo in shared memory (40 x 136 floats), computes the response
// for the tile plus a 1-pixel ring in shared memory (34 x 130), and forms
// the offsets, the border mask, NMS and the packed word in registers.
// Device memory sees one read of the image (plus halo re-reads) and one
// write of the packed map.
//
// Bit-exactness: compiled with -fmad=false, and the lines whose rounding
// matters (parabola, quantization, tie-break epsilon) use __f*_rn
// intrinsics in the reference kernel's operation order.  The reference
// rolls columns with wrap-around at the padded width; only columns within
// 4 px of the image edge see wrapped values there, and the border mask
// (edge >= 4, checked by the wrapper) hides them, so zero padding here
// gives the same words.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TY = 32;
constexpr int TX = 128;
constexpr int HALO = 4;
constexpr int SH = TY + 2 * HALO;  // staged image rows
constexpr int SW = TX + 2 * HALO;  // staged image columns
constexpr int RH = TY + 2;         // response rows (tile + 1-px ring)
constexpr int RW = TX + 2;
constexpr int THREADS = 256;

// 16-pixel Bresenham circle of radius 3 in angular order (dy, dx); the
// same order as ops/fast.py CIRCLE.
__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ float masked_se(float rp, int y, int x, int H,
                                           int W, int edge) {
  // NMS surface: positive response inside the border, minus the top-left
  // tie-break epsilon (y*W + x) * 1e-7; 0 elsewhere.
  bool inside = (y >= edge) && (y < H - edge) && (x >= edge) && (x < W - edge);
  if (!(rp > 0.f) || !inside) return 0.f;
  float eps = __fmul_rn(__int2float_rn(y * W + x), 1e-7f);
  return __fsub_rn(rp, eps);
}

__device__ __forceinline__ int quant_offset(float l, float c, float r) {
  // 1-D parabola vertex offset, clamped to +-0.5, quantized to 5 bits:
  // den = l - 2c + r; o = 0.5 (l - r) / den when den < -1e-6.
  float den = __fadd_rn(__fsub_rn(l, __fmul_rn(2.0f, c)), r);
  float o = 0.f;
  if (den < -1e-6f) o = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(l, r)), den);
  o = fminf(fmaxf(o, -0.5f), 0.5f);
  return (int)__fadd_rn(__fmul_rn(__fadd_rn(o, 0.5f), 31.0f), 0.5f);
}

__global__ void __launch_bounds__(THREADS)
fast_pack_kernel(const float* __restrict__ img, int* __restrict__ out,
                 int H, int W, int Hout, int Wp, int edge) {
  __shared__ float s_img[SH][SW];
  __shared__ float s_rp[RH][RW];
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const float* im = img + (size_t)n * H * W;

  for (int i = threadIdx.x; i < SH * SW; i += THREADS) {
    int r = i / SW, c = i % SW;
    int y = y0 - HALO + r, x = x0 - HALO + c;
    s_img[r][c] = (y >= 0 && y < H && x >= 0 && x < W)
                      ? im[(size_t)y * W + x] : 0.f;
  }
  __syncthreads();

  // FAST response at image (y0 - 1 + r, x0 - 1 + c): the max over the 16
  // contiguous 9-arcs of min(diff) (bright) and of -max(diff) (dark).
  // min/max are exact, so any evaluation order gives the reference bits.
  for (int i = threadIdx.x; i < RH * RW; i += THREADS) {
    int r = i / RW, c = i % RW;
    float ctr = s_img[r + 3][c + 3];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      d[k] = __fsub_rn(s_img[r + 3 + c_dy[k]][c + 3 + c_dx[k]], ctr);
    float bright = -INFINITY, dark = INFINITY;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      float mn = d[s], mx = d[s];
#pragma unroll
      for (int j = 1; j < 9; ++j) {
        mn = fminf(mn, d[(s + j) & 15]);
        mx = fmaxf(mx, d[(s + j) & 15]);
      }
      bright = fmaxf(bright, mn);
      dark = fminf(dark, mx);
    }
    float resp = fmaxf(bright, -dark);
    s_rp[r][c] = resp > 0.f ? resp : 0.f;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TY * TX; i += THREADS) {
    int r = i / TX, c = i % TX;
    int y = y0 + r, x = x0 + c;
    if (y >= Hout || x >= Wp) continue;
    int word = 0;
    float rc = s_rp[r + 1][c + 1];
    bool inside = (y >= edge) && (y < H - edge) && (x >= edge) &&
                  (x < W - edge);
    if (rc > 0.f && inside) {
      float sc = masked_se(rc, y, x, H, W, edge);
      float nmax = -INFINITY;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          if (dy == 0 && dx == 0) continue;
          nmax = fmaxf(nmax, masked_se(s_rp[r + 1 + dy][c + 1 + dx],
                                       y + dy, x + dx, H, W, edge));
        }
      if (sc >= nmax) {
        int oqx = quant_offset(s_rp[r + 1][c], rc, s_rp[r + 1][c + 2]);
        int oqy = quant_offset(s_rp[r][c + 1], rc, s_rp[r + 2][c + 1]);
        int q = (int)__fmul_rn(rc, 256.0f);
        int idx = (y % 4) * 4 + x % 4;
        word = q * 16384 + (15 - idx) * 1024 + oqy * 32 + oqx;
      }
    }
    out[((size_t)n * Hout + y) * Wp + x] = word;
  }
}

}  // namespace

extern "C" int stvo_fast_pack(const void* img, void* out, int N, int H,
                              int W, int Hout, int Wp, int edge,
                              void* stream) {
  dim3 grid(Wp / TX, (Hout + TY - 1) / TY, N);
  fast_pack_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)img, (int*)out, H, W, Hout, Wp, edge);
  return (int)cudaGetLastError();
}
