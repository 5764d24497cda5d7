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
// What bounds it on an H100: instruction issue.  Per pixel it reads one
// float and writes one int (about 154 MB per VO step at B=8 over the four
// pyramid levels, 46 us at 3.35 TB/s), and the response is a few hundred
// min/max operations, which issue at half the float32 rate.  The design
// cuts the instructions per pixel:
//
// - The response works on order-preserving integer keys of the pixel
//   values (key(f) = bits(f) ^ ((bits(f) >> 31) & 0x7FFFFFFF): signed
//   integer order = float order for finite values), so Hopper's
//   three-input integer min/max (VIMNMX3, __vimin3_s32 / __vimax3_s32)
//   does two float min/max operations per instruction.  Each arc side is
//   16 three-wide windows + 16 nine-wide windows + an 8-instruction
//   maximum: 40 instructions, 80 for both sides, against about 300 when
//   every 9-arc is recomputed with two-input min/max.
// - The circle differences are never formed: rounding is monotone, so
//   min over an arc of fl(nb - c) = fl(min over the arc of nb - c), and
//   the response is max(fl(B - c), fl(c - D)) with B = max over arcs of
//   the arc minimum and D = min over arcs of the arc maximum of the raw
//   neighbours.  Same bits as the reference for finite inputs.
// - The NMS surface (border mask + tie-break epsilon) is formed once per
//   response pixel, not nine times per candidate.
// - The sub-pixel fit and the packed word (two IEEE divisions) run only
//   for NMS survivors, which each warp compacts into a list first, so a
//   warp runs that code once per 32 survivors instead of once per row of
//   pixels that holds one.
//
// One block per (image, 32-row x 128-column tile) stages the tile plus a
// 4-pixel halo in shared memory (40 x 136 keys), computes the response for
// the tile plus a 1-pixel ring (34 x 130), then the NMS surface in the
// keys' place, and the packed words.  Device memory sees one read of the
// image (plus halo re-reads) and one write of the packed map.
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
constexpr int WARPS = THREADS / 32;
constexpr int PER_WARP = TY * TX / WARPS;  // output pixels of one warp

// order-preserving float <-> int key; the map is its own inverse
__device__ __forceinline__ int fkey(int bits) {
  return bits ^ ((bits >> 31) & 0x7FFFFFFF);
}

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

// max over the 16 circular 9-windows of the window minimum (kMin = true),
// or min over them of the window maximum, of 16 keys
template <bool kMin>
__device__ __forceinline__ int arc_extreme(const int (&k)[16]) {
  auto in3 = [](int a, int b, int c) {
    return kMin ? __vimin3_s32(a, b, c) : __vimax3_s32(a, b, c);
  };
  auto out3 = [](int a, int b, int c) {
    return kMin ? __vimax3_s32(a, b, c) : __vimin3_s32(a, b, c);
  };
  int m3[16], w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m3[i] = in3(k[i], k[(i + 1) & 15], k[(i + 2) & 15]);
#pragma unroll
  for (int s = 0; s < 16; ++s) w[s] = in3(m3[s], m3[(s + 3) & 15], m3[(s + 6) & 15]);
  const int a = out3(w[0], w[1], w[2]), b = out3(w[3], w[4], w[5]);
  const int c = out3(w[6], w[7], w[8]), d = out3(w[9], w[10], w[11]);
  const int e = out3(w[12], w[13], w[14]);
  const int ab = out3(a, b, c), de = out3(d, e, w[15]);
  return kMin ? max(ab, de) : min(ab, de);
}

__global__ void __launch_bounds__(THREADS)
fast_pack_kernel(const float* __restrict__ img, int* __restrict__ out,
                 int H, int W, int Hout, int Wp, int edge) {
  // keys of the staged image, then (after the response) the NMS surface
  __shared__ int s_buf[SH * SW];
  __shared__ float s_rp[RH][RW];
  __shared__ unsigned short s_list[WARPS][PER_WARP];
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const float* im = img + (size_t)n * H * W;

  for (int i = threadIdx.x; i < SH * SW; i += THREADS) {
    int r = i / SW, c = i % SW;
    int y = y0 - HALO + r, x = x0 - HALO + c;
    float v = (y >= 0 && y < H && x >= 0 && x < W) ? im[(size_t)y * W + x]
                                                     : 0.f;
    s_buf[i] = fkey(__float_as_int(v));
  }
  __syncthreads();

  // FAST response at image (y0 - 1 + r, x0 - 1 + c): max(fl(B - ctr),
  // fl(ctr - D)) over the keys of the circle (see the header).
  for (int i = threadIdx.x; i < RH * RW; i += THREADS) {
    int r = i / RW, c = i % RW;
    const int* p = s_buf + (r + 3) * SW + (c + 3);
    // the 16-pixel Bresenham circle of radius 3 in angular order, as
    // ops/fast.py CIRCLE: (dy, dx) = (-3, 0), (-3, 1), (-2, 2), ...
    const int k[16] = {p[-3 * SW],     p[-3 * SW + 1], p[-2 * SW + 2],
                       p[-SW + 3],     p[3],           p[SW + 3],
                       p[2 * SW + 2],  p[3 * SW + 1],  p[3 * SW],
                       p[3 * SW - 1],  p[2 * SW - 2],  p[SW - 3],
                       p[-3],          p[-SW - 3],     p[-2 * SW - 2],
                       p[-3 * SW - 1]};
    const float ctr = __int_as_float(fkey(p[0]));
    const float bf = __int_as_float(fkey(arc_extreme<true>(k)));
    const float df = __int_as_float(fkey(arc_extreme<false>(k)));
    const float resp = fmaxf(__fsub_rn(bf, ctr), __fsub_rn(ctr, df));
    s_rp[r][c] = resp > 0.f ? resp : 0.f;
  }
  __syncthreads();

  float* s_se = reinterpret_cast<float*>(s_buf);    // [RH][RW]
  for (int i = threadIdx.x; i < RH * RW; i += THREADS) {
    int r = i / RW, c = i % RW;
    s_se[i] = masked_se(s_rp[r][c], y0 - 1 + r, x0 - 1 + c, H, W, edge);
  }
  __syncthreads();

  // NMS: zeros are written at once, survivors are listed per warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int listed = 0;
  for (int i0 = warp * PER_WARP; i0 < (warp + 1) * PER_WARP; i0 += 32) {
    const int i = i0 + lane;
    const int r = i / TX, c = i % TX;
    const int y = y0 + r, x = x0 + c;
    const float* q = s_se + (r + 1) * RW + (c + 1);
    const float sc = q[0];
    float nmax = fmaxf(fmaxf(q[-RW - 1], q[-RW]), q[-RW + 1]);
    nmax = fmaxf(nmax, fmaxf(q[-1], q[1]));
    nmax = fmaxf(nmax, fmaxf(fmaxf(q[RW - 1], q[RW]), q[RW + 1]));
    const bool valid = y < Hout;
    const bool inside = (y >= edge) && (y < H - edge) && (x >= edge) &&
                        (x < W - edge);
    const bool keep = valid && inside && s_rp[r + 1][c + 1] > 0.f &&
                      sc >= nmax;
    if (valid && !keep) out[((size_t)n * Hout + y) * Wp + x] = 0;
    const unsigned m = __ballot_sync(0xFFFFFFFFu, keep);
    if (keep) s_list[warp][listed + __popc(m & ((1u << lane) - 1u))] =
        (unsigned short)i;
    listed += __popc(m);
  }
  __syncwarp();
  for (int j = lane; j < listed; j += 32) {
    const int i = s_list[warp][j];
    const int r = i / TX, c = i % TX;
    const int y = y0 + r, x = x0 + c;
    const float rc = s_rp[r + 1][c + 1];
    int oqx = quant_offset(s_rp[r + 1][c], rc, s_rp[r + 1][c + 2]);
    int oqy = quant_offset(s_rp[r][c + 1], rc, s_rp[r + 2][c + 1]);
    int qs = (int)__fmul_rn(rc, 256.0f);
    int idx = (y % 4) * 4 + x % 4;
    out[((size_t)n * Hout + y) * Wp + x] =
        qs * 16384 + (15 - idx) * 1024 + oqy * 32 + oqx;
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
