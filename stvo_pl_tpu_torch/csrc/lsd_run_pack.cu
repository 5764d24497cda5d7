// All-direction aligned-run scoring for the dense line detector:
// [N, H, W] i32 direction bitmasks (bit d = pixel aligned to steps[d])
// -> [N, D, Hp/8, Wp] i32 row-pooled packed run maps, Hp = round_up(H, 64),
// Wp = round_up(W, 128).
//
// Replaces the TPU kernel stvo_pl_tpu/ops/lsd_kernel.py::
// _run_pack_multi_pallas (body _make_multi_kernel).  Per direction (dx, dy),
// on the PADDED Hp x Wp domain with zero fill outside it:
//
//   thick = a | a[p +- perp]        perp = one row if |dx| >= |dy|, else
//   dil   = thick | thick[p +- step]       one column
//   run   = (dil & dil[p + step] & dil[p - step]) | thick
//   f     = min(number of consecutive run pixels p, p+step, ..., cap)
//   word  = (f * hq_d) * 64 + (63 - (y % 8) * 8 - x % 8)   at run starts
//           (run & !run[p - step]), 0 elsewhere
//   out   = max of word over each group of 8 rows
//
// The reference holds a whole padded canvas on chip and gets f by 8 rounds
// of pointer doubling over whole-image rolls, which gives exactly
// min(L, 2^8).  An SM's shared memory cannot hold a canvas, so the same
// function is computed in two passes:
//
//   1. run_bits_kernel: one block per (image, 32 x 128 tile).  The tile of
//      the bitmask plus a 9-px halo goes to shared memory (low 16 bits:
//      D <= 16), the thick words of all directions are formed there at
//      once (only two perpendicular axes exist), and each pixel's D run
//      bits leave as one 16-bit word.  |dx|, |dy| <= 4 bounds the halo.
//   2. pack_kernel: one thread per (image, 8-row group, column).  It finds
//      the run starts in its 8 pixels and walks each run forward, at most
//      `cap` hops, through the run words (23.6 MB at the main-path shape,
//      so the walks are served by L2).  The 8-row maximum stays in a
//      register: no atomics, the output is written once, coalesced.
//
// All arithmetic is integer, so the result equals the reference bit for
// bit.  What bounds it on an H100: about as many bytes (input words read
// once, output words written once) as operations; the walks make the work
// depend on the data (total hops = run pixels below the cap).
//
// The directions, their hop weights hq and D are arguments, so one build
// serves every direction count.
//
// Second entry, stvo_lsd_run_pack: ONE direction of a 0/1 aligned mask
// [N, H, W] (one byte per pixel) -> [N, Hp, Wp] i32, Hp = round_up(H, 8):
// every pixel's own word f * 64 + (63 - (y % 8) * 8 - x % 8) at run starts,
// without hop weight and without the 8-row maximum.  Replaces the TPU kernel
// stvo_pl_tpu/ops/lsd_kernel.py::_run_pack_pallas (body _make_kernel), which
// the per-direction candidate generator of the dense detector launches once
// per direction.  It shares pass 1 (run_bits_kernel with D = 1; the padded
// height need not be a multiple of the tile, so tile rows beyond Hp are
// outside the domain and are not written) and has a pass 2 of its own,
// pack_pixel_kernel, one thread per pixel.  Bytes bound it: 1 in, 4 out per
// pixel against about 17 integer operations.

#include <cuda_runtime.h>

#include <cstdlib>

namespace {

constexpr int MAX_D = 16;
constexpr int MAX_STEP = 4;
constexpr int TY = 32, TX = 128;          // tile of the padded domain
constexpr int HT = 2 * MAX_STEP;          // thick halo: p +- 2 * step
constexpr int HA = HT + 1;                // bitmask halo: one more for perp
constexpr int AY = TY + 2 * HA, AX = TX + 2 * HA;
constexpr int TTY = TY + 2 * HT, TTX = TX + 2 * HT;
constexpr int THREADS = 256;

struct Dirs {
  int D;
  int dx[MAX_D];
  int dy[MAX_D];
  int hq[MAX_D];
};

__device__ __forceinline__ bool in_dom(int y, int x, int Hp, int Wp) {
  return (unsigned)y < (unsigned)Hp && (unsigned)x < (unsigned)Wp;
}

// the low 16 direction bits of a bitmask pixel / bit 0 of a 0/1 mask pixel
__device__ __forceinline__ unsigned load_bits(int v) {
  return (unsigned)v & 0xFFFFu;
}
__device__ __forceinline__ unsigned load_bits(unsigned char v) {
  return v != 0 ? 1u : 0u;
}

template <typename In>
__global__ void __launch_bounds__(THREADS)
run_bits_kernel(const In* __restrict__ bits, unsigned short* __restrict__ run,
                int H, int W, int Hp, int Wp, Dirs dirs, unsigned mask_v) {
  __shared__ unsigned short A[AY][AX];
  __shared__ unsigned short T[TTY][TTX];
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const In* im = bits + (size_t)n * H * W;
  const unsigned mask_h = ~mask_v;

  for (int i = threadIdx.x; i < AY * AX; i += THREADS) {
    const int ly = i / AX, lx = i % AX;
    const int y = y0 + ly - HA, x = x0 + lx - HA;
    unsigned v = 0;
    if ((unsigned)y < (unsigned)H && (unsigned)x < (unsigned)W)
      v = load_bits(im[(size_t)y * W + x]);
    A[ly][lx] = (unsigned short)v;
  }
  __syncthreads();

  // thick words; zero outside the padded domain (the shifts' zero fill)
  for (int i = threadIdx.x; i < TTY * TTX; i += THREADS) {
    const int ly = i / TTX, lx = i % TTX;
    const int y = y0 + ly - HT, x = x0 + lx - HT;
    unsigned v = 0;
    if (in_dom(y, x, Hp, Wp)) {
      const int ay = ly + 1, ax = lx + 1;
      const unsigned vert = A[ay + 1][ax] | A[ay - 1][ax];
      const unsigned horz = A[ay][ax + 1] | A[ay][ax - 1];
      v = A[ay][ax] | (vert & mask_v) | (horz & mask_h);
    }
    T[ly][lx] = (unsigned short)v;
  }
  __syncthreads();

  unsigned short* out = run + (size_t)n * Hp * Wp;
  for (int i = threadIdx.x; i < TY * TX; i += THREADS) {
    const int ly = i / TX, lx = i % TX;
    const int y = y0 + ly, x = x0 + lx;
    if (y >= Hp) break;                  // a ragged last tile row (B4 only)
    const int ty = ly + HT, tx = lx + HT;
    const unsigned t0 = T[ty][tx];
    unsigned word = 0;
    for (int d = 0; d < dirs.D; ++d) {
      const int dx = dirs.dx[d], dy = dirs.dy[d];
      const unsigned tm1 = T[ty - dy][tx - dx];
      const unsigned tm2 = T[ty - 2 * dy][tx - 2 * dx];
      const unsigned tp1 = T[ty + dy][tx + dx];
      const unsigned tp2 = T[ty + 2 * dy][tx + 2 * dx];
      const unsigned dil0 = t0 | tm1 | tp1;
      const unsigned dilm =
          in_dom(y - dy, x - dx, Hp, Wp) ? (tm2 | tm1 | t0) : 0u;
      const unsigned dilp =
          in_dom(y + dy, x + dx, Hp, Wp) ? (t0 | tp1 | tp2) : 0u;
      word |= ((dil0 & dilm & dilp) | t0) & (1u << d);
    }
    out[(size_t)y * Wp + x] = (unsigned short)word;
  }
}

__global__ void __launch_bounds__(THREADS)
pack_kernel(const unsigned short* __restrict__ run, int* __restrict__ out,
            int Hp, int Wp, Dirs dirs, int cap) {
  const int x = blockIdx.x * THREADS + threadIdx.x;
  if (x >= Wp) return;
  const int ty = blockIdx.y, n = blockIdx.z;
  const int Ht = Hp / 8;
  const unsigned short* R = run + (size_t)n * Hp * Wp;

  unsigned rows[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) rows[r] = R[(size_t)(ty * 8 + r) * Wp + x];

  for (int d = 0; d < dirs.D; ++d) {
    const int dx = dirs.dx[d], dy = dirs.dy[d], hq = dirs.hq[d];
    int best = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (!((rows[r] >> d) & 1u)) continue;
      const int y = ty * 8 + r;
      const int yb = y - dy, xb = x - dx;
      if (in_dom(yb, xb, Hp, Wp) && ((R[(size_t)yb * Wp + xb] >> d) & 1u))
        continue;                               // not a run start
      int f = 1, yy = y + dy, xx = x + dx;
      while (f < cap && in_dom(yy, xx, Hp, Wp) &&
             ((R[(size_t)yy * Wp + xx] >> d) & 1u)) {
        ++f;
        yy += dy;
        xx += dx;
      }
      best = max(best, (f * hq) * 64 + (63 - r * 8 - (x & 7)));
    }
    out[(((size_t)n * dirs.D + d) * Ht + ty) * Wp + x] = best;
  }
}

// One direction, one thread per pixel of the padded domain: the word of
// the pixel's own run start, 0 elsewhere.
__global__ void __launch_bounds__(THREADS)
pack_pixel_kernel(const unsigned short* __restrict__ run,
                  int* __restrict__ out, int Hp, int Wp, int dx, int dy,
                  int cap) {
  const int x = blockIdx.x * THREADS + threadIdx.x;
  if (x >= Wp) return;
  const int y = blockIdx.y, n = blockIdx.z;
  const unsigned short* R = run + (size_t)n * Hp * Wp;
  int word = 0;
  if (R[(size_t)y * Wp + x] & 1u) {
    const int yb = y - dy, xb = x - dx;
    if (!(in_dom(yb, xb, Hp, Wp) && (R[(size_t)yb * Wp + xb] & 1u))) {
      int f = 1, yy = y + dy, xx = x + dx;
      while (f < cap && in_dom(yy, xx, Hp, Wp) &&
             (R[(size_t)yy * Wp + xx] & 1u)) {
        ++f;
        yy += dy;
        xx += dx;
      }
      word = f * 64 + (63 - (y & 7) * 8 - (x & 7));
    }
  }
  out[((size_t)n * Hp + y) * Wp + x] = word;
}

}  // namespace

// bits [N, H, W] i32, run [N, Hp, Wp] 16-bit scratch, out [N, D, Hp/8, Wp]
// i32, all on the device; steps: 3 * D host ints (dx[D], dy[D], hq[D]).
extern "C" int stvo_lsd_run_pack_multi(const void* bits, void* run, void* out,
                                       int N, int H, int W, int Hp, int Wp,
                                       int D, const int* steps, int cap,
                                       void* stream) {
  if (D < 1 || D > MAX_D || Hp % TY || Wp % TX || Hp % 8 || H > Hp || W > Wp)
    return (int)cudaErrorInvalidValue;
  Dirs dirs;
  dirs.D = D;
  unsigned mask_v = 0;
  for (int d = 0; d < MAX_D; ++d) {
    const bool on = d < D;
    dirs.dx[d] = on ? steps[d] : 0;
    dirs.dy[d] = on ? steps[D + d] : 0;
    dirs.hq[d] = on ? steps[2 * D + d] : 0;
    if (!on) continue;
    const int ax = abs(dirs.dx[d]), ay = abs(dirs.dy[d]);
    if (ax > MAX_STEP || ay > MAX_STEP) return (int)cudaErrorInvalidValue;
    if (ax >= ay) mask_v |= 1u << d;     // thicken across rows
  }
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    run_bits_kernel<int><<<dim3(Wp / TX, Hp / TY, N), THREADS, 0, s>>>(
        (const int*)bits, (unsigned short*)run, H, W, Hp, Wp, dirs, mask_v);
    pack_kernel<<<dim3((Wp + THREADS - 1) / THREADS, Hp / 8, N), THREADS, 0,
                  s>>>((const unsigned short*)run, (int*)out, Hp, Wp, dirs,
                       cap);
  }
  return (int)cudaGetLastError();
}

// aligned [N, H, W] one byte per pixel (0 / non-zero), run [N, Hp, Wp]
// 16-bit scratch, out [N, Hp, Wp] i32, all on the device; one direction
// (dx, dy); Hp a multiple of 8 (any number of tiles), Wp of 128.
extern "C" int stvo_lsd_run_pack(const void* aligned, void* run, void* out,
                                 int N, int H, int W, int Hp, int Wp, int dx,
                                 int dy, int cap, void* stream) {
  if (Hp % 8 || Wp % TX || H > Hp || W > Wp || Hp > 65535 ||
      abs(dx) > MAX_STEP || abs(dy) > MAX_STEP || (dx == 0 && dy == 0))
    return (int)cudaErrorInvalidValue;
  Dirs dirs;
  for (int d = 0; d < MAX_D; ++d) dirs.dx[d] = dirs.dy[d] = dirs.hq[d] = 0;
  dirs.D = 1;
  dirs.dx[0] = dx;
  dirs.dy[0] = dy;
  dirs.hq[0] = 1;
  const unsigned mask_v = abs(dx) >= abs(dy) ? 1u : 0u;
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    run_bits_kernel<unsigned char>
        <<<dim3(Wp / TX, (Hp + TY - 1) / TY, N), THREADS, 0, s>>>(
            (const unsigned char*)aligned, (unsigned short*)run, H, W, Hp, Wp,
            dirs, mask_v);
    pack_pixel_kernel<<<dim3((Wp + THREADS - 1) / THREADS, Hp, N), THREADS, 0,
                        s>>>((const unsigned short*)run, (int*)out, Hp, Wp,
                             dx, dy, cap);
  }
  return (int)cudaGetLastError();
}
