// All-pairs Hamming distances of 256-bit descriptors by XOR + popcount:
// d1 [B, N, 8] x d2 [B, M, 8] 32-bit words -> out [B, N, M] i32.
//
// Replaces the TPU kernel stvo_pl_tpu/ops/hamming.py::hamming_matrix_pallas
// (body _hamming_kernel), which tiles the matrix 256 x 256 and needs N and
// M to be multiples of its tile.  That constraint is the TPU's, not the
// function's: here any N and M go, the ragged edge is masked.
//
// One block computes a 64 x 64 tile of one batch entry.  Both descriptor
// tiles go to shared memory word-major (W[w][row]), so that the 32 threads
// of a warp, which hold 32 neighbouring columns, read 32 neighbouring words
// of the second set (no bank conflict) and one broadcast word of the first.
// A thread holds 8 rows x 2 columns of sums in registers: per word 8 + 2
// shared loads feed 16 XOR + __popc + add.  A warp writes whole 128-byte
// rows of the output.
//
// What bounds it on an H100: the N * M * 4 output bytes (the inputs are
// 32 bytes per descriptor); the 24 integer operations per pair are a
// third of that time at the card's peak.

#include <cuda_runtime.h>

namespace {

constexpr int WORDS = 8;
constexpr int TN = 64, TM = 64;
constexpr int THREADS = 256;
constexpr int ROWS = TN / (THREADS / 32);     // 8 rows per thread
constexpr int COLS = TM / 32;                 // 2 columns per thread

__global__ void __launch_bounds__(THREADS)
hamming_popc_kernel(const unsigned* __restrict__ d1,
                    const unsigned* __restrict__ d2, int* __restrict__ out,
                    int N, int M) {
  // rows padded by 4 words: the loading threads (8 words of 4 descriptors
  // per warp) then store to 32 different banks
  __shared__ unsigned A[WORDS][TN + 4];
  __shared__ unsigned Bm[WORDS][TM + 4];
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * TN, m0 = blockIdx.x * TM;
  const unsigned* a = d1 + (size_t)b * N * WORDS;
  const unsigned* c = d2 + (size_t)b * M * WORDS;

  // TN * WORDS == TM * WORDS == 2 * THREADS words per tile
  for (int i = threadIdx.x; i < TN * WORDS; i += THREADS) {
    const int r = i / WORDS, w = i % WORDS;
    A[w][r] = n0 + r < N ? a[(size_t)(n0 + r) * WORDS + w] : 0u;
    Bm[w][r] = m0 + r < M ? c[(size_t)(m0 + r) * WORDS + w] : 0u;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int acc[ROWS][COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[i][j] = 0;

#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    unsigned bv[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) bv[j] = Bm[w][lane + 32 * j];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const unsigned av = A[w][warp * ROWS + i];
#pragma unroll
      for (int j = 0; j < COLS; ++j) acc[i][j] += __popc(av ^ bv[j]);
    }
  }

  int* o = out + (size_t)b * N * M;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int n = n0 + warp * ROWS + i;
    if (n >= N) break;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int m = m0 + lane + 32 * j;
      if (m < M) o[(size_t)n * M + m] = acc[i][j];
    }
  }
}

}  // namespace

// d1 [B, N, 8], d2 [B, M, 8] 32-bit words, out [B, N, M] i32, contiguous,
// on the device.
extern "C" int stvo_hamming_popc(const void* d1, const void* d2, void* out,
                                 int B, int N, int M, void* stream) {
  if (B < 0 || N < 0 || M < 0 || B > 65535 || (N + TN - 1) / TN > 65535)
    return (int)cudaErrorInvalidValue;
  if (B > 0 && N > 0 && M > 0) {
    hamming_popc_kernel<<<dim3((M + TM - 1) / TM, (N + TN - 1) / TN, B),
                          THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned*)d1, (const unsigned*)d2, (int*)out, N, M);
  }
  return (int)cudaGetLastError();
}
