// Batched patch extraction: [N, H, W] images + [N, K] top-left corners
// -> [N, K, PY, PX] windows, in the image's 4-byte element type.
//
// Replaces the TPU kernel stvo_pl_tpu/ops/patches.py::_pallas_extract,
// both its square mode (33 x 33 f32 ORB patches on the main path) and its
// (1, PX) row mode (32-bit integers passed through bit for bit).  Reads
// outside the image return 0, as the reference's zero-padded staging does.
//
// What bounds it on an H100: bytes.  It does no arithmetic; the patches it
// writes (16 x 1200 x 33 x 33 x 4 B = 84 MB per VO step at B=8) dominate
// the traffic, and the reads hit the same image rows many times through
// L2 (a level-0 image is 1.8 MB, all 16 are 29 MB of the 50 MB L2).  The
// reference stages each image in VMEM; here nothing is staged, and the
// design is about keeping enough bytes in flight and writing them wide:
//
// - The work is split over the flat output [N * K * PY * PX], not over
//   (image, patch): thread t of block b takes UNROLL groups of 4
//   consecutive output words, group g = (b * UNROLL + u) * THREADS + t, and
//   writes each group with one 16-byte store.  A group may cross a patch
//   and an image boundary (PY * PX * 4 B is not a multiple of 16); the
//   output starts 16-byte aligned, so only the last group of the whole
//   output can be partial, and it is written word by word.
// - Element e of the output belongs to patch j = e / (PY PX) (flat over
//   n * K + k), row i / PX and column i % PX of it.  The main path's 33 x
//   33 is a template instance, so these divisions are by constants (on
//   an H100, 7% less time per VO step than the magic-number instance);
//   other sizes (the row mode (1, PX), the tests' (5, 7)) take the same code
//   with divisions by host-computed magic numbers.  The image of patch j is
//   j / K, by magic number too.
// - Each thread issues the loads of all its UNROLL x 4 words before any of
//   its stores, so 16 independent loads are in flight per thread.
//
// Bits are copied as 32-bit words: the f32 and the integer modes are one
// kernel.

#include <cuda_runtime.h>

#include <cstdint>

#include "fast_div.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                     // 16-byte groups per thread
constexpr int VEC = 4;                        // words per group

// CPY, CPX > 0: the patch size as constants; 0: the divisions by magic
// numbers (per_div = PY * PX, px_div = PX)
template <int CPY, int CPX>
__global__ void __launch_bounds__(THREADS)
extract_kernel(const unsigned* __restrict__ img, const int* __restrict__ y0,
               const int* __restrict__ x0, unsigned* __restrict__ out,
               int H, int W, Div kdiv, Div per_div, Div px_div,
               unsigned total) {
  const unsigned base = blockIdx.x * (UNROLL * THREADS) + threadIdx.x;
  unsigned v[UNROLL][VEC];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      const unsigned e = (base + u * THREADS) * VEC + c;
      v[u][c] = 0u;
      if (e >= total) continue;
      unsigned j, i, r, col;
      if constexpr (CPY > 0) {
        j = e / (CPY * CPX);
        i = e - j * (CPY * CPX);
        r = i / CPX;
        col = i - r * CPX;
      } else {
        j = div_of(e, per_div);
        i = e - j * per_div.d;
        r = div_of(i, px_div);
        col = i - r * px_div.d;
      }
      const unsigned n = div_of(j, kdiv);
      const int y = __ldg(y0 + j) + (int)r;
      const int x = __ldg(x0 + j) + (int)col;
      if ((unsigned)y < (unsigned)H && (unsigned)x < (unsigned)W)
        v[u][c] = __ldg(img + ((size_t)n * H + y) * W + x);
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const unsigned g = base + u * THREADS;
    if ((size_t)g * VEC + VEC <= total) {
      reinterpret_cast<uint4*>(out)[g] =
          make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        if ((size_t)g * VEC + c < total) out[(size_t)g * VEC + c] = v[u][c];
    }
  }
}

int launch(const void* img, const void* y0, const void* x0, void* out, int N,
           int H, int W, int K, int PY, int PX, void* stream) {
  const unsigned long long total =
      (unsigned long long)N * K * (unsigned long long)PY * PX;
  // 32-bit flat indices; the output is allocated fresh, so 16-byte aligned
  if (N < 0 || K < 0 || PY < 1 || PX < 1 || total >= (1ull << 31) ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  if (total > 0) {
    const unsigned per_block = UNROLL * THREADS * VEC;
    const unsigned blocks = (unsigned)((total + per_block - 1) / per_block);
    const Div kdiv = make_div((unsigned)K);
    const Div per_div = make_div((unsigned)(PY * PX));
    const Div px_div = make_div((unsigned)PX);
    cudaStream_t s = (cudaStream_t)stream;
    if (PY == 33 && PX == 33)
      extract_kernel<33, 33><<<blocks, THREADS, 0, s>>>(
          (const unsigned*)img, (const int*)y0, (const int*)x0,
          (unsigned*)out, H, W, kdiv, per_div, px_div,
          (unsigned)total);
    else
      extract_kernel<0, 0><<<blocks, THREADS, 0, s>>>(
          (const unsigned*)img, (const int*)y0, (const int*)x0,
          (unsigned*)out, H, W, kdiv, per_div, px_div,
          (unsigned)total);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stvo_extract_patches_f32(const void* img, const void* y0,
                                        const void* x0, void* out, int N,
                                        int H, int W, int K, int PY, int PX,
                                        void* stream) {
  return launch(img, y0, x0, out, N, H, W, K, PY, PX, stream);
}

extern "C" int stvo_extract_patches_b32(const void* img, const void* y0,
                                        const void* x0, void* out, int N,
                                        int H, int W, int K, int PY, int PX,
                                        void* stream) {
  return launch(img, y0, x0, out, N, H, W, K, PY, PX, stream);
}
