// All-pairs Hamming distances of 256-bit descriptors on the tensor cores:
// d1 [B, N, 8] x d2 [B, M, 8] 32-bit words -> out [B, N, M] i32.
//
// Replaces the TPU kernel stvo_pl_tpu/ops/hamming.py:87
// hamming_matrix_pallas (body _hamming_kernel), which tiles the matrix
// 256 x 256 and needs N and M to be multiples of its tile.  That constraint
// is the TPU's, not the function's: here any N and M go, the ragged edge is
// masked.
//
// What bounds it on an H100: the N * M * 4 output bytes (the inputs are 32
// bytes per descriptor).  XOR + popcount word by word does not reach that
// bound: an SM issues POPC at 16 per clock, a quarter of its rate for 32-bit
// adds and logic, so 8 POPCs per pair take longer than the pair's 4 bytes
// of store.  Here the tensor cores do the per-pair work:
//
//   popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b),
//
// and one 1-bit MMA (mma.sync m16n8k256 .b1 .and.popc) gives popc(a & b)
// for 16 x 8 pairs of whole descriptors: a fragment of A or B is exactly
// the packed words, with no unpacking.  popc(a) and popc(b) are taken once
// per row and column of a warp's tile (0.5 POPC per pair, against 8).
//
// What is left is the store: each warp stages its 32 x 32 tile in shared
// memory and writes whole row pieces of 128 bytes with 16-byte stores
// (4-byte stores where M is not a multiple of 4), from small blocks (64 x
// 64, 4 warps) of which many are resident, so that enough stores are in
// flight.  The stores are streaming (st.global.cs, evict first): the
// output of a point-matching launch (46 MB) nearly fills the 50 MB L2,
// and with plain stores the kernel ran 14% slower than a fill of the same
// bytes; with them it runs at the fill's time
// (tools/time_torch_kernels.py --kernels b5).

#include <cuda_runtime.h>

namespace {

constexpr int WN = 32, WM = 32;             // warp tile: rows x columns
constexpr int FN = WN / 16, FM = WM / 8;    // MMA fragments per warp tile
constexpr int WARPS_N = 2, WARPS_M = 2;
constexpr int TN = WN * WARPS_N, TM = WM * WARPS_M;   // block tile 64 x 64
constexpr int THREADS = 32 * WARPS_N * WARPS_M;
// staging row stride in words: 8 more than the tile's width, so that the
// fragments' 8-byte stores of the 8 rows of a warp fall on distinct banks
constexpr int SROW = WM + 8;
constexpr int LPR = WM / 4, RPI = 32 / LPR;

// d += popc(a & b) over k = 256 for a 16 x 8 tile.  Fragments (PTX ISA,
// mma.m16n8k256 .b1), with g = lane / 4 and t = lane % 4: a0 / a2 hold row
// g at k-blocks t and 4 + t of 32 bits, a1 / a3 row g + 8; b0 / b1 column
// g at the same k-blocks; d0, d1 row g and d2, d3 row g + 8, columns 2t
// and 2t + 1.
__device__ __forceinline__ void mma_and_popc(int (&d)[4],
                                             const unsigned (&a)[4],
                                             const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// sum of v over the 4 lanes of a quad (the lanes that share g)
__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A descriptor as 4 pairs of words; a lane reads pair t, words 2t and
// 2t + 1, into the k-blocks t and 4 + t of its fragment.  A and B put the
// same words at the same k, which is all that the sum over k asks.
__global__ void __launch_bounds__(THREADS)
hamming_mma_kernel(const uint2* __restrict__ d1, const uint2* __restrict__ d2,
                   int* __restrict__ out, int N, int M) {
  __shared__ __align__(16) int stage[WARPS_N * WARPS_M][WN][SROW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * TN + (warp / WARPS_M) * WN;
  const int m0 = blockIdx.x * TM + (warp % WARPS_M) * WM;
  const uint2* a = d1 + (size_t)b * N * 4;
  const uint2* c = d2 + (size_t)b * M * 4;

  // rows and columns past the edge read the last one; they are not stored
  unsigned af[FN][4];
  int pa[FN][2];
#pragma unroll
  for (int f = 0; f < FN; ++f) {
    const uint2 x = a[(size_t)min(n0 + 16 * f + g, N - 1) * 4 + t];
    const uint2 y = a[(size_t)min(n0 + 16 * f + g + 8, N - 1) * 4 + t];
    af[f][0] = x.x;
    af[f][1] = y.x;
    af[f][2] = x.y;
    af[f][3] = y.y;
    pa[f][0] = quad_sum(__popc(x.x) + __popc(x.y));
    pa[f][1] = quad_sum(__popc(y.x) + __popc(y.y));
  }
  unsigned bf[FM][2];
  int pb[FM][2];
#pragma unroll
  for (int j = 0; j < FM; ++j) {
    const uint2 z = c[(size_t)min(m0 + 8 * j + g, M - 1) * 4 + t];
    bf[j][0] = z.x;
    bf[j][1] = z.y;
    // column 8j + g's count sits in quad g; this lane's columns are 2t
    // and 2t + 1, quads 2t and 2t + 1
    const int p = quad_sum(__popc(z.x) + __popc(z.y));
    pb[j][0] = __shfl_sync(0xffffffffu, p, 8 * t);
    pb[j][1] = __shfl_sync(0xffffffffu, p, 8 * t + 4);
  }

  int (*st)[SROW] = stage[warp];
#pragma unroll
  for (int f = 0; f < FN; ++f) {
#pragma unroll
    for (int j = 0; j < FM; ++j) {
      int d[4] = {0, 0, 0, 0};
      mma_and_popc(d, af[f], bf[j]);
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<int2*>(&st[16 * f + g][col]) =
          make_int2(pa[f][0] + pb[j][0] - 2 * d[0],
                    pa[f][0] + pb[j][1] - 2 * d[1]);
      *reinterpret_cast<int2*>(&st[16 * f + g + 8][col]) =
          make_int2(pa[f][1] + pb[j][0] - 2 * d[2],
                    pa[f][1] + pb[j][1] - 2 * d[3]);
    }
  }
  __syncwarp();

  // 16 bytes a lane, LPR lanes a row: a warp store covers RPI whole rows
  // of the warp's tile
  int* o = out + (size_t)b * N * M;
  const int cq = 4 * (lane % LPR), m = m0 + cq;
  const bool vec = (M & 3) == 0;      // then m < M means m + 3 < M
#pragma unroll
  for (int i = 0; i < WN / RPI; ++i) {
    const int r = RPI * i + lane / LPR, n = n0 + r;
    if (n >= N || m >= M) continue;
    const int4 v = *reinterpret_cast<const int4*>(&st[r][cq]);
    int* p = o + (size_t)n * M + m;
    if (vec) {
      __stcs(reinterpret_cast<int4*>(p), v);
    } else {
      __stcs(p, v.x);
      if (m + 1 < M) __stcs(p + 1, v.y);
      if (m + 2 < M) __stcs(p + 2, v.z);
      if (m + 3 < M) __stcs(p + 3, v.w);
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
    hamming_mma_kernel<<<dim3((M + TM - 1) / TM, (N + TN - 1) / TN, B),
                         THREADS, 0, (cudaStream_t)stream>>>(
        (const uint2*)d1, (const uint2*)d2, (int*)out, N, M);
  }
  return (int)cudaGetLastError();
}
