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
// L2.  The design: one block per (image, chunk of corners); the threads
// of a block walk each patch in row-major order, so neighbouring threads
// read neighbouring columns of one patch row and write neighbouring
// output words — both sides coalesce.  The element type is a template
// parameter: float for the f32 mode, unsigned int as the bit copy for
// int32/uint32 data.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 8;

template <typename T>
__global__ void __launch_bounds__(THREADS)
extract_kernel(const T* __restrict__ img, const int* __restrict__ y0,
               const int* __restrict__ x0, T* __restrict__ out, int H, int W,
               int K, int PY, int PX) {
  const int n = blockIdx.y;
  const int per = PY * PX;
  const T* im = img + (size_t)n * H * W;
  const int kend = min(K, (int)(blockIdx.x + 1) * CHUNK);
  for (int k = blockIdx.x * CHUNK; k < kend; ++k) {
    const int ya = y0[(size_t)n * K + k];
    const int xa = x0[(size_t)n * K + k];
    T* o = out + ((size_t)n * K + k) * per;
    for (int i = threadIdx.x; i < per; i += THREADS) {
      int y = ya + i / PX, x = xa + i % PX;
      o[i] = (y >= 0 && y < H && x >= 0 && x < W) ? im[(size_t)y * W + x]
                                                  : T(0);
    }
  }
}

template <typename T>
int launch(const void* img, const void* y0, const void* x0, void* out, int N,
           int H, int W, int K, int PY, int PX, void* stream) {
  if (N > 0 && K > 0) {
    dim3 grid((K + CHUNK - 1) / CHUNK, N);
    extract_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)img, (const int*)y0, (const int*)x0, (T*)out, H, W, K, PY,
        PX);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stvo_extract_patches_f32(const void* img, const void* y0,
                                        const void* x0, void* out, int N,
                                        int H, int W, int K, int PY, int PX,
                                        void* stream) {
  return launch<float>(img, y0, x0, out, N, H, W, K, PY, PX, stream);
}

extern "C" int stvo_extract_patches_b32(const void* img, const void* y0,
                                        const void* x0, void* out, int N,
                                        int H, int W, int K, int PY, int PX,
                                        void* stream) {
  return launch<unsigned int>(img, y0, x0, out, N, H, W, K, PY, PX, stream);
}
