// ORB's orientation and rotated-BRIEF descriptor, one keypoint per warp:
// [K, 33, 33] float32 patches -> desc [K, 8] int32, cos [K], sin [K].
//
// Replaces no TPU kernel: the JAX package (stvo_pl_tpu/ops/orb.py
// orient_describe) leaves this to XLA as one product of the quantized
// patches against a [1089, 30 x 256] +/-1 test matrix (all 30 orientation
// bins), of which each keypoint keeps the 256 columns of its own bin.  On
// an H100 that product ran as a legacy bf16 GEMM of depth 1089 at about
// 145 TFLOP/s, with 29/30 of its work and its [K, 7680] output thrown
// away.  The port's CPU path still takes the product
// (ops/orb.py orient_describe_product); its twin here is
// ops/orb.py orient_describe_plain.  Output is bit-identical to both.
//
// What bounds it on an H100: bytes.  Each keypoint's patch, 4,356 B, is
// read once and 40 B are written; the 256 tests and the moments are a few
// hundred integer operations per keypoint.  The design keeps the patch
// read wide and everything else on chip:
//
// - A block takes KPB keypoints, a warp each.  Their patches are one
//   contiguous run of KPB * 1089 floats: the block loads it with 16-byte
//   loads (9 a thread, all issued before any is used) when the run is
//   16-byte aligned, word by word otherwise and for a ragged last block.
//   Each value is quantized on the way in, clamp(rint(x), 0, 255) as the
//   plain path's round and clamp, and kept as a byte in shared memory.
// - The intensity-centroid moments m10 = sum q dx, m01 = sum q dy over the
//   radius-15 disc are integer sums (|m| < 2^21), reduced across the warp
//   by XOR shuffles: exact, as the plain path's float32 sums of the same
//   integers are.
// - cos, sin and the orientation bin repeat the plain path's float32
//   operations in its order (ops/orb.py orientation, _bin_index): the
//   norm, the 1e-6 guard, two divisions, atan2f, the scale 30 / (2 pi)
//   rounded to float32, rint (half to even, as torch.round) and the
//   remainder mod 30.  The tree builds with -fmad=false, and the lines
//   whose rounding matters spell it with __f*_rn intrinsics.
// - Lane l evaluates test 32 w + l of word w for w = 0..7, q[i1] > q[i0]
//   with (i0, i1) from the [30, 256] table of the keypoint's bin (built on
//   the host from the same rotated pattern as the test matrix, 30 KB, read
//   through the L1), and __ballot_sync packs each word: bit l of word w is
//   test 32 w + l, as the plain path's packing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int P = 33;                  // patch side
constexpr int R = 16;                  // patch radius
constexpr int PP = P * P;              // 1089 pixels
constexpr int ORI_R2 = 15 * 15;        // intensity-centroid disc
constexpr int N_BINS = 30;
constexpr int N_BITS = 256;
constexpr int WORDS = N_BITS / 32;
constexpr int KPB = 8;                 // keypoints (warps) a block
constexpr int THREADS = 32 * KPB;
constexpr int VEC4 = KPB * PP / 4;     // 16-byte groups of a full block
constexpr int LOADS = (VEC4 + THREADS - 1) / THREADS;
// 30 / (2 pi) in double, then rounded to float32 as the plain path's
// float32 multiply by the Python scalar rounds it
constexpr float BIN_SCALE = (float)(30.0 / (2.0 * 3.14159265358979323846));

static_assert(KPB * PP % 4 == 0, "a full block is whole 16-byte groups");

__device__ __forceinline__ unsigned char quant(float x) {
  return (unsigned char)fminf(fmaxf(rintf(x), 0.0f), 255.0f);
}

__global__ void __launch_bounds__(THREADS)
orb_describe_kernel(const float* __restrict__ patches,
                    const short2* __restrict__ table, int* __restrict__ desc,
                    float* __restrict__ cos_out, float* __restrict__ sin_out,
                    int K) {
  __shared__ __align__(16) unsigned char q[KPB * PP];
  const int k0 = blockIdx.x * KPB;
  const int nk = min(KPB, K - k0);
  const float* src = patches + (size_t)k0 * PP;

  // ---- stage the block's patches, quantized, as bytes ----
  if (nk == KPB && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4 v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = u * THREADS + threadIdx.x;
      if (i < VEC4) v[u] = __ldcs(s4 + i);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = u * THREADS + threadIdx.x;
      if (i < VEC4) {
        uchar4 o;
        o.x = quant(v[u].x);
        o.y = quant(v[u].y);
        o.z = quant(v[u].z);
        o.w = quant(v[u].w);
        reinterpret_cast<uchar4*>(q)[i] = o;
      }
    }
  } else {
    const int n = nk * PP;
    for (int i = threadIdx.x; i < n; i += THREADS) q[i] = quant(__ldcs(src + i));
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= nk) return;
  const int k = k0 + warp;
  const unsigned char* mine = q + warp * PP;

  // ---- intensity-centroid moments: exact integer sums ----
  int m10 = 0, m01 = 0;
  for (int i = lane; i < PP; i += 32) {
    const int dy = i / P - R;
    const int dx = i - (dy + R) * P - R;
    if (dx * dx + dy * dy <= ORI_R2) {
      const int v = mine[i];
      m10 += v * dx;
      m01 += v * dy;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_xor_sync(0xFFFFFFFFu, m10, off);
    m01 += __shfl_xor_sync(0xFFFFFFFFu, m01, off);
  }

  // ---- orientation and its bin, the plain path's float32 operations ----
  const float f10 = __int2float_rn(m10);
  const float f01 = __int2float_rn(m01);
  const float norm =
      __fsqrt_rn(__fadd_rn(__fmul_rn(f10, f10), __fmul_rn(f01, f01)));
  const bool safe = norm > 1e-6f;
  const float den = fmaxf(norm, 1e-6f);
  const float c = safe ? __fdiv_rn(f10, den) : 1.0f;
  const float s = safe ? __fdiv_rn(f01, den) : 0.0f;
  int bin = (int)rintf(__fmul_rn(atan2f(s, c), BIN_SCALE)) % N_BINS;
  if (bin < 0) bin += N_BINS;

  // ---- the bin's 256 tests, 8 a lane, packed by ballots ----
  const short2* tests = table + bin * N_BITS;
  unsigned word = 0;
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    const short2 t = __ldg(tests + w * 32 + lane);
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, mine[t.y] > mine[t.x]);
    if (lane == w) word = bits;
  }
  if (lane < WORDS) desc[(size_t)k * WORDS + lane] = (int)word;
  if (lane == 0) {
    cos_out[k] = c;
    sin_out[k] = s;
  }
}

}  // namespace

// patches [K, 33, 33] f32, table [30, 256] (i0, i1) int16 pairs; writes
// desc [K, 8] int32, cos [K], sin [K].  Returns cudaGetLastError().
extern "C" int stvo_orb_describe(const void* patches, const void* table,
                                 void* desc, void* cos_out, void* sin_out,
                                 int K, void* stream) {
  if (K > 0) {
    const int blocks = (K + KPB - 1) / KPB;
    orb_describe_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(patches),
        static_cast<const short2*>(table), static_cast<int*>(desc),
        static_cast<float*>(cos_out), static_cast<float*>(sin_out), K);
  }
  return (int)cudaGetLastError();
}
