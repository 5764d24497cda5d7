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
// min(L, 2^8).  Here two passes compute the same function:
//
//   1. run_planes_kernel: one block per (image, 64 x 128 tile).  Warp
//      ballots turn the bitmask tile plus a 9-px halo into one 32-bit
//      plane word per (direction, row, 32 columns) in shared memory; the
//      thick, dilated and gap-closed run bits are then formed 32 pixels
//      per instruction (funnel shifts across neighbouring words for the
//      column offsets, |dx|, |dy| <= 4), and written as run planes
//      [N, D, Hp, Wp/32] (1 bit per pixel and direction: 11.8 MB at the
//      main-path shape).  The block also zero-fills its part of the
//      output.
//   2. chain_pack_kernel: the run length is a reverse scan along each
//      chain of the direction,
//          f(p) = run(p) ? min(1 + f(p + step), cap) : 0,
//      done on bits: a warp takes 32 chains in tiles of 32 steps, loads a
//      tile's run bits as 32 row words (addresses that never depend on the
//      data) and transposes them across the warp, so each lane holds 32
//      steps of its chain in one word; inside the tile a run's length is a
//      count of trailing ones, and a run that leaves the tile adds the
//      carry of the tile before (see the pass's own comment).  Run starts
//      go to the 8-row maximum by atomicMax (about 3% of the pixels of a
//      rendered canvas are starts; they are the pass's whole cost).
//
// All arithmetic is integer, so the result equals the reference bit for
// bit, for every cap = 2^k, k <= 8.  What bounds it on an H100: bytes
// (input words read once, output words written once); the operations of
// pass 1 are a few per pixel and direction, those of pass 2 about two.
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
// per direction.  Pass 1 (run_plane_kernel) writes one run bit per pixel
// ([N, Hp, Wp / 32] words, L2-resident), pass 2 (start_pack_kernel) writes
// every output word once from staged 4 KB spans and measures run lengths
// only at starts (see the section's own comment).  Bytes bound it: 1 in, 4 out per pixel
// against about 17 integer operations.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdlib>

#include "fast_div.cuh"

namespace {

constexpr int MAX_D = 16;
constexpr int MAX_STEP = 4;
constexpr int HT = 2 * MAX_STEP;          // thick halo: p +- 2 * step
constexpr int HA = HT + 1;                // bitmask halo: one more for perp

struct Dirs {
  int D;
  int dx[MAX_D];
  int dy[MAX_D];
  int hq[MAX_D];
};

// ---- the all-direction kernel, pass 1: run planes ------------------------

constexpr int PY = 64, PX = 128;          // tile of the padded domain
constexpr int PW = PX / 32;               // plane words of a tile row
constexpr int PWW = PW + 2;               // ... with one word each side
constexpr int PTR = PY + 2 * HT;          // thick-plane rows
constexpr int PAR = PTR + 2;              // bitmask-plane rows
constexpr int P_THREADS = 512;

__host__ __device__ constexpr int planes_smem(int D) {
  return D * (PAR + PTR) * PWW * 4;
}

// bits j = plane[column x_w + j + shift] of one plane row, shift in
// [-8, 8], from the row's words w - 1, w, w + 1
__device__ __forceinline__ unsigned shifted(const unsigned* row, int w,
                                            int shift) {
  if (shift > 0) return __funnelshift_r(row[w], row[w + 1], shift);
  if (shift < 0) return __funnelshift_r(row[w - 1], row[w], 32 + shift);
  return row[w];
}

// the bits j of a word at columns x_w + j for which x_w + j + shift lies in
// [0, Wp) (tiles are whole words, so only the first and last word clip)
__device__ __forceinline__ unsigned col_mask(int x_w, int shift, int Wp) {
  if (x_w + shift < 0) return ~0u << (-shift);
  if (x_w + 31 + shift >= Wp) return ~0u >> shift;
  return ~0u;
}

__global__ void __launch_bounds__(P_THREADS)
run_planes_kernel(const int* __restrict__ bits, unsigned* __restrict__ planes,
                  int* __restrict__ out, int H, int W, int Hp, int Wp,
                  Dirs dirs, unsigned mask_v) {
  extern __shared__ unsigned smem[];
  const int D = dirs.D;
  unsigned* Ap = smem;                              // [D][PAR][PWW]
  unsigned* Tp = smem + D * PAR * PWW;              // [D][PTR][PWW]
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * PY, x0 = blockIdx.x * PX;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* im = bits + (size_t)n * H * W;

  // bitmask planes: word wi of a row covers columns x0 - 32 + 32 wi + j;
  // only the tile and its 9-px halo are read.  Each warp issues the loads
  // of LOADS row words before it ballots them, so their latencies overlap.
  constexpr int LOADS = 16, WARPS = P_THREADS / 32;
  const unsigned dmask = (1u << D) - 1u;        // D <= 16
  for (int t0 = warp; t0 < PAR * PWW; t0 += WARPS * LOADS) {
    unsigned a[LOADS];
#pragma unroll
    for (int b = 0; b < LOADS; ++b) {
      const int task = t0 + b * WARPS;
      const int ra = task / PWW, wi = task % PWW;
      const int y = y0 - HA + ra, x = x0 - 32 + wi * 32 + lane;
      a[b] = 0;
      if (task < PAR * PWW && (unsigned)y < (unsigned)H &&
          (unsigned)x < (unsigned)W && x >= x0 - HA && x < x0 + PX + HA)
        a[b] = (unsigned)__ldg(im + (size_t)y * W + x);
    }
#pragma unroll
    for (int b = 0; b < LOADS; ++b) {
      const int task = t0 + b * WARPS;
      unsigned mine = 0;
      // ballots only for the directions present in these 32 pixels (few:
      // most row words hold no set bit at all)
      for (unsigned act = __reduce_or_sync(0xFFFFFFFFu, a[b]) & dmask; act;
           act &= act - 1) {
        const int d = __ffs(act) - 1;
        const unsigned m = __ballot_sync(0xFFFFFFFFu, (a[b] >> d) & 1u);
        mine = lane == d ? m : mine;
      }
      if (lane < D && task < PAR * PWW) Ap[lane * PAR * PWW + task] = mine;
    }
  }
  __syncthreads();

  // thick planes, zero outside the padded domain
  for (int i = threadIdx.x; i < D * PTR * PWW; i += P_THREADS) {
    const int d = i / (PTR * PWW), rt = (i / PWW) % PTR, wi = i % PWW;
    const int y = y0 - HT + rt;
    const bool outside = (unsigned)y >= (unsigned)Hp ||
                         (wi == 0 && x0 == 0) ||
                         (wi == PWW - 1 && x0 + PX == Wp);
    unsigned v = 0;
    if (!outside) {
      const unsigned* A = Ap + (d * PAR + rt + 1) * PWW;
      const unsigned a = A[wi];
      if ((mask_v >> d) & 1u) {
        v = a | A[wi - PWW] | A[wi + PWW];
      } else {
        const unsigned l = wi > 0 ? A[wi - 1] : 0u;
        const unsigned r = wi < PWW - 1 ? A[wi + 1] : 0u;
        v = a | ((a << 1) | (l >> 31)) | ((a >> 1) | (r << 31));
      }
    }
    Tp[i] = v;
  }
  __syncthreads();

  // run planes of the tile
  const int WW = Wp / 32;
  for (int i = threadIdx.x; i < D * PY * PW; i += P_THREADS) {
    const int d = i / (PY * PW), r = (i / PW) % PY, wo = i % PW;
    const int dx = dirs.dx[d], dy = dirs.dy[d];
    const int y = y0 + r, x_w = x0 + wo * 32, w = wo + 1;
    const unsigned* T = Tp + (d * PTR + r + HT) * PWW;
    const unsigned t0 = T[w];
    const unsigned tm1 = shifted(T - dy * PWW, w, -dx);
    const unsigned tm2 = shifted(T - 2 * dy * PWW, w, -2 * dx);
    const unsigned tp1 = shifted(T + dy * PWW, w, dx);
    const unsigned tp2 = shifted(T + 2 * dy * PWW, w, 2 * dx);
    const unsigned dom_m =
        (unsigned)(y - dy) < (unsigned)Hp ? col_mask(x_w, -dx, Wp) : 0u;
    const unsigned dom_p =
        (unsigned)(y + dy) < (unsigned)Hp ? col_mask(x_w, dx, Wp) : 0u;
    const unsigned dil0 = t0 | tm1 | tp1;
    const unsigned dilm = (tm2 | tm1 | t0) & dom_m;
    const unsigned dilp = (t0 | tp1 | tp2) & dom_p;
    planes[(((size_t)n * D + d) * Hp + y) * WW + x_w / 32] =
        (dil0 & dilm & dilp) | t0;
  }

  // zero-fill this tile's 8 row groups of every direction's output
  const int Ht = Hp / 8;
  for (int i = threadIdx.x; i < D * (PY / 8) * (PX / 4); i += P_THREADS) {
    const int d = i / ((PY / 8) * (PX / 4)), g = (i / (PX / 4)) % (PY / 8);
    const int c4 = i % (PX / 4);
    int4* o = reinterpret_cast<int4*>(
        out + (((size_t)n * D + d) * Ht + y0 / 8 + g) * Wp + x0);
    o[c4] = make_int4(0, 0, 0, 0);
  }
}

// ---- the all-direction kernel, pass 2: reverse scans along the chains ----
//
// Chains of one direction: the major axis u is the rows when dy != 0 (step
// su = dy, |dy| = DM), the columns when dy == 0 (su = dx); v is the other
// axis, of length V, and a step moves v by sv (dx, or 0 for dy == 0).
// u' = su > 0 ? u : U - 1 - u makes every step go to larger u'.  Chain t,
// residue rho visits (u' = q * DM + rho, v = (t + sv * q) mod V) for
// q = 0, 1, ...: every (u', v) lies on exactly one (t, rho) and its
// successor along the step is the chain's next element, unless v + sv
// leaves [0, V) (a break: the real chain ends at the domain edge and t
// continues with another one).
//
// One warp scans 32 chains t0 .. t0 + 31 of one residue in blocks of 32
// steps, from the largest q down: the run bits of a block (32 steps x 32
// chains) are loaded as 32 row words (lane L: step qb + L, one funnel
// shift of two plane words) and transposed across the warp, so that lane j
// holds chain t0 + j's 32 bits W (bit i = step qb + i).  In a word the run
// length from bit i is a count of trailing ones; a run that reaches bit 31
// continues with the carry F = f at bit 0 of the block before (larger q).
// A run start is a set bit whose predecessor (bit i - 1, or the next
// block's bit 31 for bit 0) is clear or across a break.

constexpr int C_THREADS = 128;

// 32 x 32 bit transpose across a warp: lane L's word bit j in, lane j's
// word bit L out
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  const unsigned masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int j = 16 >> k;
    const unsigned m = masks[k];
    const unsigned y = __shfl_xor_sync(0xFFFFFFFFu, x, j);
    x = (lane & j) ? (x & ~m) | ((y >> j) & m) : (x & m) | ((y & m) << j);
  }
  return x;
}

struct Scan {
  unsigned run0;   // bit 0 of the block before (larger q)
  int f0;          // the capped run length at that bit
};

// One block of 32 steps of one chain (bit i = step qb + i): emits the
// starts the block decides through emit(q, f) and returns the new carry.
// brk: bit i set when step qb + i is the last of a real chain (break).
template <typename Emit>
__device__ __forceinline__ Scan scan_block(unsigned W, unsigned brk, Scan c,
                                           int qb, int cap, Emit emit) {
  // the run continues from bit i to bit i + 1 (bit 31: into the block
  // before)
  const unsigned cont = ((W >> 1) | (c.run0 << 31)) & ~brk;
  // the block before's bit 0 is a start unless bit 31 runs into it
  if (c.run0 && !((W & ~brk) >> 31)) emit(qb + 32, c.f0);
  // starts at bits 1 .. 31 (bit 0 is decided by the next block)
  unsigned starts = W & ~((W << 1) & ~(brk << 1)) & ~1u;
  while (starts) {
    const int i = __ffs(starts) - 1;
    starts &= starts - 1;
    const unsigned ones = ~(cont >> i);       // non-zero: i >= 1
    const int n = __ffs(ones) - 1;            // run length - 1, in block
    emit(qb + i, n >= 32 - i ? min(32 - i + c.f0, cap) : min(n + 1, cap));
  }
  Scan next;
  next.run0 = W & 1u;
  if (next.run0) {
    const int n = cont == ~0u ? 32 : __ffs(~cont) - 1;
    next.f0 = n >= 32 ? min(32 + c.f0, cap) : min(n + 1, cap);
  } else {
    next.f0 = 0;
  }
  return next;
}

// dy != 0: the warp's chains t0 + lane over the rows
__device__ __forceinline__ void scan_rows(const unsigned* __restrict__ pl,
                                          int* __restrict__ out, int t0,
                                          int U, int V, int su, int sv,
                                          int hq, int cap) {
  const int lane = threadIdx.x % 32, t = t0 + lane;
  const int WW = V / 32, DM = abs(su);
  const bool flip = su < 0;
  const int qtop = (U - 1) / DM;
  for (int rho = 0; rho < DM; ++rho) {
    Scan c = {0u, 0};
    for (int qb = qtop - 31; qb >= -32; qb -= 32) {
      // lane L loads step qb + L: 32 consecutive columns from the warp's
      // first chain's column at that step
      const int q = qb + lane, up = q * DM + rho;
      unsigned R = 0;
      if (up >= 0 && up < U) {
        const int y = flip ? U - 1 - up : up;
        int col = (t0 + sv * q) % V;
        if (col < 0) col += V;
        const int w = col >> 5;
        const unsigned* row = pl + (size_t)y * WW;
        R = __funnelshift_r(__ldg(row + w), __ldg(row + (w + 1 == WW ? 0 : w + 1)),
                            col & 31);
      }
      const unsigned W = transpose32(R, lane);
      // this chain's column at step qb, and its break inside the block
      int c0 = (t + sv * qb) % V;
      if (c0 < 0) c0 += V;
      unsigned brk = 0;
      if (sv != 0) {
        const int i1 = sv > 0 ? (V - c0 - 1) / sv : c0 / (-sv);
        if (i1 < 32) brk = 1u << i1;
      }
      c = scan_block(W, brk, c, qb, cap, [&](int qs, int f) {
        const int us = qs * DM + rho;
        const int y = flip ? U - 1 - us : us;
        int x = (t + sv * qs) % V;
        if (x < 0) x += V;
        atomicMax(out + (size_t)(y >> 3) * V + x,
                  (f * hq) * 64 + (63 - (y & 7) * 8 - (x & 7)));
      });
    }
  }
}

// dy == 0, |dx| == 1: each lane's chain is its row; a block of 32 steps is
// one plane word (bit-reversed when dx < 0)
__device__ __forceinline__ void scan_cols(const unsigned* __restrict__ pl,
                                          int* __restrict__ out, int y,
                                          int U, int su, int hq, int cap) {
  const int WW = U / 32;
  const bool flip = su < 0;
  const unsigned* row = pl + (size_t)y * WW;
  Scan c = {0u, 0};
  for (int qb = U - 32; qb >= -32; qb -= 32) {
    unsigned W = 0;
    if (qb >= 0) W = flip ? __brev(__ldg(row + (U - 32 - qb) / 32))
                          : __ldg(row + qb / 32);
    c = scan_block(W, 0u, c, qb, cap, [&](int qs, int f) {
      const int x = flip ? U - 1 - qs : qs;
      atomicMax(out + (size_t)(y >> 3) * U + x,
                (f * hq) * 64 + (63 - (y & 7) * 8 - (x & 7)));
    });
  }
}

// dy == 0, |dx| = DM >= 2 (no direction of lsd.DIR_STEPS): one thread per
// row walks its DM interleaved chains, f in registers
template <int DM>
__device__ __forceinline__ void walk_cols(const unsigned* __restrict__ pl,
                                          int* __restrict__ out, int y,
                                          int U, int su, int hq, int cap) {
  const int WW = U / 32;
  const bool flip = su < 0;
  const unsigned* row = pl + (size_t)y * WW;
  int f[DM], run[DM];
#pragma unroll
  for (int k = 0; k < DM; ++k) f[k] = run[k] = 0;
  for (int q = (U - 1) / DM; q >= -1; --q) {
#pragma unroll
    for (int rho = DM - 1; rho >= 0; --rho) {
      const int up = q * DM + rho;
      const int x = flip ? U - 1 - up : up;
      const int bit = up >= 0 && up < U ? (__ldg(row + (x >> 5)) >> (x & 31)) & 1 : 0;
      if (run[rho] && !bit) {
        const int uh = up + DM, xh = flip ? U - 1 - uh : uh;
        atomicMax(out + (size_t)(y >> 3) * U + xh,
                  (f[rho] * hq) * 64 + (63 - (y & 7) * 8 - (xh & 7)));
      }
      f[rho] = bit ? min(f[rho] + 1, cap) : 0;
      run[rho] = bit;
    }
  }
}

__global__ void __launch_bounds__(C_THREADS)
chain_pack_kernel(const unsigned* __restrict__ planes, int* __restrict__ out,
                  int Hp, int Wp, Dirs dirs, int cap) {
  const int d = blockIdx.y, n = blockIdx.z;
  const int dx = dirs.dx[d], dy = dirs.dy[d], hq = dirs.hq[d];
  const unsigned* pl = planes + ((size_t)n * dirs.D + d) * Hp * (Wp / 32);
  int* o = out + ((size_t)n * dirs.D + d) * (Hp / 8) * Wp;
  if (dy != 0) {
    const int t0 = blockIdx.x * C_THREADS + threadIdx.x / 32 * 32;
    if (t0 < Wp) scan_rows(pl, o, t0, Hp, Wp, dy, dx, hq, cap);
    return;
  }
  const int y = blockIdx.x * C_THREADS + threadIdx.x;
  if (y >= Hp) return;
  switch (abs(dx)) {
    case 1: scan_cols(pl, o, y, Wp, dx, hq, cap); break;
    case 2: walk_cols<2>(pl, o, y, Wp, dx, hq, cap); break;
    case 3: walk_cols<3>(pl, o, y, Wp, dx, hq, cap); break;
    default: walk_cols<4>(pl, o, y, Wp, dx, hq, cap);
  }
}

// ---- the one-direction kernel ---------------------------------------------
//
// Pass 1, run_plane_kernel: one block per (image, RT rows of the padded
// domain), over the whole padded width, warps on rows and lanes on words.
// A row's bitmask word (32 mask bytes, which need not start on 16 bytes)
// is cut out of the three aligned 16-byte vectors that hold it, each
// gathered into 16 bits by one multiply per 4 bytes; columns >= W are
// cleared.  Thick, dilated and gap-closed bits are then word
// operations as in B3's pass 1, and the run plane [N, Hp, Wp / 32] (one
// bit per pixel: 0.96 MB, L2-resident for pass 2) is written once.
//
// Pass 2, start_pack_kernel: every output word is written exactly once.
// A lane owns one plane word, 32 pixels of a row; a warp owns 32
// consecutive plane words (flat over image, row and word), whose outputs
// are 1024 consecutive words: the lanes stage them in shared memory and
// the warp stores them as 16-byte vectors, 512 contiguous bytes per store
// instruction.  The starts of a word are run bits whose predecessor p -
// step is clear or outside the domain (one shifted window of the row dy
// back).  Lengths:
// - dy = 0 and |dx| = 1: trailing-ones (leading-ones for dx < 0) counts
//   along the row's words;
// - otherwise: the windows of the HOPS rows ahead along the step, shifted
//   by h dx, are loaded at once and ANDed in turn, so each start's length
//   up to HOPS + 1 is a count of set bits; the runs of a word still alive
//   after them are finished by the whole warp, 32 hops per round (lane j
//   loads the word's window at hop h + j, one ballot per run finds its
//   end).
// No atomics and no memset: the zeros go out in the same stores.

constexpr int RT = 16;                    // rows of a pass-1 tile
constexpr int R_THREADS = 256;
constexpr int R_WARPS = R_THREADS / 32;
constexpr int S_THREADS = 256;            // pass 2: threads of a block
constexpr int HOPS = 8;                   // hops of every start loaded at once

// bit k = byte k of v, for bytes that are 0 or 1: byte k (bit 8 k) times
// 2^(24 - 7 k) lands on bit 24 + k, and the 16 partial products of the
// multiply set distinct bits, so nothing carries
__device__ __forceinline__ unsigned byte_bits4(unsigned v) {
  return (v * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned byte_bits16(uint4 q) {
  return byte_bits4(q.x) | byte_bits4(q.y) << 4 |
         byte_bits4(q.z) << 8 | byte_bits4(q.w) << 12;
}

// bitmask rows RT + 4|dy| + 2 and thick rows RT + 4|dy|, each Wp / 32 + 2
// words wide
__host__ __device__ constexpr int plane_smem_words(int ady, int WW) {
  return (2 * RT + 8 * ady + 2) * (WW + 2);
}

// bit j = byte b + j of the mask (0 or 1; bytes from `total` on read as
// 0), from the aligned 16-byte vectors at a, a + 16 and a + 32, a = b
// rounded down to 16
__device__ __forceinline__ unsigned mask_word(
    const unsigned char* __restrict__ mask, size_t total, size_t b) {
  const size_t a = b & ~(size_t)15;
  unsigned long long v = 0ull;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t o = a + 16 * k;
    unsigned h = 0u;
    if (o + 16 <= total) {
      h = byte_bits16(__ldg(reinterpret_cast<const uint4*>(mask + o)));
    } else {                                 // the mask's last bytes
      for (size_t q = o; q < total; ++q) h |= (unsigned)mask[q] << (q - o);
    }
    v |= (unsigned long long)h << (16 * k);
  }
  return (unsigned)(v >> (b & 15));
}

__global__ void __launch_bounds__(R_THREADS)
run_plane_kernel(const unsigned char* __restrict__ mask,
                 unsigned* __restrict__ plane, int H, int W, int Hp, int WW,
                 int dx, int dy, int mask_v) {
  extern __shared__ unsigned smem[];
  const int ady = abs(dy);
  const int AR = RT + 4 * ady + 2, TR = RT + 4 * ady, SW = WW + 2;
  unsigned* As = smem;                       // [AR][SW], word 1 + w
  unsigned* Ts = As + AR * SW;               // [TR][SW]
  const int n = blockIdx.y, y0 = blockIdx.x * RT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ya = y0 - 2 * ady - 1;           // image row of As row 0
  const int nw = (W + 31) >> 5;              // words that hold image columns

  // 1. bitmask rows ya .. ya + AR - 1, columns >= W cleared
  const size_t total = (size_t)gridDim.y * H * W;
  for (int ar = warp; ar < AR; ar += R_WARPS) {
    const int y = ya + ar;
    const bool row_in = (unsigned)y < (unsigned)H;
    const size_t rs = ((size_t)n * H + (row_in ? y : 0)) * W;
    for (int wi = lane; wi < SW; wi += 32) {
      const int w = wi - 1;
      unsigned a = 0u;
      if (row_in && w >= 0 && w < nw) {
        a = mask_word(mask, total, rs + 32 * w);
        const int cols = W - 32 * w;
        if (cols < 32) a &= (1u << cols) - 1u;
      }
      As[ar * SW + wi] = a;
    }
  }
  __syncthreads();

  // 2. thick rows, zero outside the padded domain
  for (int tr = warp; tr < TR; tr += R_WARPS) {
    const int y = y0 - 2 * ady + tr;
    for (int wi = lane; wi < SW; wi += 32) {
      unsigned v = 0u;
      if ((unsigned)y < (unsigned)Hp && wi > 0 && wi < SW - 1) {
        const unsigned* A = As + (tr + 1) * SW + wi;
        const unsigned a = A[0];
        v = mask_v ? a | A[-SW] | A[SW]
                   : a | (a << 1) | (A[-1] >> 31) | (a >> 1) | (A[1] << 31);
      }
      Ts[tr * SW + wi] = v;
    }
  }
  __syncthreads();

  // 3. run words of the tile
  const int Wp = 32 * WW;
  for (int r = warp; r < RT; r += R_WARPS) {
    const int y = y0 + r;
    if (y >= Hp) break;                      // a ragged last tile
    const unsigned* T = Ts + (r + 2 * ady) * SW;
    const unsigned dom_rm = (unsigned)(y - dy) < (unsigned)Hp ? ~0u : 0u;
    const unsigned dom_rp = (unsigned)(y + dy) < (unsigned)Hp ? ~0u : 0u;
    for (int w = lane; w < WW; w += 32) {
      const int x_w = 32 * w, wi = w + 1;
      const unsigned t0 = T[wi];
      const unsigned tm1 = shifted(T - dy * SW, wi, -dx);
      const unsigned tm2 = shifted(T - 2 * dy * SW, wi, -2 * dx);
      const unsigned tp1 = shifted(T + dy * SW, wi, dx);
      const unsigned tp2 = shifted(T + 2 * dy * SW, wi, 2 * dx);
      const unsigned dil0 = t0 | tm1 | tp1;
      const unsigned dilm = (tm2 | tm1 | t0) & dom_rm & col_mask(x_w, -dx, Wp);
      const unsigned dilp = (t0 | tp1 | tp2) & dom_rp & col_mask(x_w, dx, Wp);
      plane[((size_t)n * Hp + y) * WW + w] = (dil0 & dilm & dilp) | t0;
    }
  }
}

// bit j = the run bit of row y at column x + j, 0 outside the domain
__device__ __forceinline__ unsigned window32(const unsigned* P, int y, int x,
                                             int Hp, int WW) {
  if ((unsigned)y >= (unsigned)Hp) return 0u;
  const unsigned* row = P + (size_t)y * WW;
  const int w = x >> 5, b = x & 31;          // floor, also for x < 0
  const unsigned lo = (unsigned)w < (unsigned)WW ? __ldg(row + w) : 0u;
  const unsigned hi =
      b && (unsigned)(w + 1) < (unsigned)WW ? __ldg(row + w + 1) : 0u;
  return __funnelshift_r(lo, hi, b);
}

// run pixels from column x of one plane row along dx = +-1, at most cap:
// counts of trailing (dx > 0) or leading (dx < 0) ones, word by word
__device__ __forceinline__ int row_ones(const unsigned* row, int WW, int x,
                                        int dx, int cap) {
  int n = 0;
  while (n < cap) {
    const int w = x >> 5, b = x & 31;
    const unsigned word = (unsigned)w < (unsigned)WW ? __ldg(row + w) : 0u;
    int t, avail;
    if (dx > 0) {
      const unsigned v = ~(word >> b);
      t = v ? __ffs(v) - 1 : 32;
      avail = 32 - b;
    } else {
      t = __clz(~(word << (31 - b)));
      avail = b + 1;
    }
    n += t;
    if (t < avail) break;
    x += dx * t;
  }
  return min(n, cap);
}

__global__ void __launch_bounds__(S_THREADS)
start_pack_kernel(const unsigned* __restrict__ plane, int* __restrict__ out,
                  unsigned words, Div ww_div, Div hp_div, int Hp, int WW,
                  int dx, int dy, int cap) {
  // per warp: its 32 lanes' 32 output words each, 8 int4 per lane at a
  // stride of 9 int4 (no bank conflicts on either side)
  __shared__ int4 stage[S_THREADS / 32][32 * 9];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned first = blockIdx.x * S_THREADS + warp * 32;  // warp's word
  const unsigned f = first + lane;
  int4* mine = &stage[warp][lane * 9];
  int* mine_w = reinterpret_cast<int*>(mine);
  int n = 0, y = 0, w = 0;
  unsigned st = 0u;
  const unsigned* P = plane;
  if (f < words) {
    const unsigned nrow = div_of(f, ww_div);
    w = (int)(f - nrow * (unsigned)WW);
    n = (int)div_of(nrow, hp_div);
    y = (int)(nrow - (unsigned)n * (unsigned)Hp);
    P = plane + (size_t)n * Hp * WW;
    const unsigned own = __ldg(plane + f);
    if (own) st = own & ~window32(P, y - dy, 32 * w - dx, Hp, WW);
  }
  const int pos = 63 - (y & 7) * 8;          // minus (x & 7) = bit & 7
  unsigned more = 0u;                        // runs past HOPS hops
  if (dy == 0 && (dx == 1 || dx == -1)) {
    const unsigned* row = P + (size_t)y * WW;
#pragma unroll
    for (int k = 0; k < 8; ++k) mine[k] = make_int4(0, 0, 0, 0);
    for (unsigned t = st; t; t &= t - 1) {
      const int i = __ffs(t) - 1;
      mine_w[i] = row_ones(row, WW, 32 * w + i, dx, cap) * 64 + pos - (i & 7);
    }
  } else {
    // alive[k]: the starts whose run reaches hop k + 1, HOPS hops loaded
    // at once
    unsigned alive[HOPS];
#pragma unroll
    for (int k = 0; k < HOPS; ++k)
      alive[k] = st ? window32(P, y + (k + 1) * dy, 32 * w + (k + 1) * dx,
                               Hp, WW)
                    : 0u;
    unsigned a = st;
#pragma unroll
    for (int k = 0; k < HOPS; ++k) {
      a = k + 1 < cap ? a & alive[k] : 0u;
      alive[k] = a;
    }
    more = HOPS + 1 < cap ? a : 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      int v[4] = {0, 0, 0, 0};
      if ((st >> (4 * k)) & 0xFu) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * k + c;
          if ((st >> i) & 1u) {
            int fl = 1;
#pragma unroll
            for (int h = 0; h < HOPS; ++h) fl += (alive[h] >> i) & 1u;
            v[c] = fl * 64 + pos - (i & 7);
          }
        }
      }
      mine[k] = make_int4(v[0], v[1], v[2], v[3]);
    }
  }
  // runs alive after HOPS hops: the warp finishes each together, 32 hops
  // a round (lane j tests hop h + j; the first clear bit of the ballot
  // ends the run), and adds the hops to the staged word
  __syncwarp();
  for (unsigned pending = __ballot_sync(0xFFFFFFFFu, more != 0u); pending;
       pending &= pending - 1) {
    const int L = __ffs(pending) - 1;
    unsigned lm = __shfl_sync(0xFFFFFFFFu, more, L);
    const int ly = __shfl_sync(0xFFFFFFFFu, y, L);
    const int lw = __shfl_sync(0xFFFFFFFFu, w, L);
    const int ln = __shfl_sync(0xFFFFFFFFu, n, L);
    const unsigned* LP = plane + (size_t)ln * Hp * WW;
    int ext = 0;                             // lane i: hops of the run at bit i
    for (int h = HOPS + 1; lm && h < cap; h += 32) {
      const int hh = h + lane;
      const unsigned win =
          hh < cap ? window32(LP, ly + hh * dy, 32 * lw + hh * dx, Hp, WW)
                   : 0u;
      for (unsigned t = lm; t; t &= t - 1) {
        const int i = __ffs(t) - 1;
        const unsigned m = __ballot_sync(0xFFFFFFFFu, (win >> i) & 1u);
        const int run = m == 0xFFFFFFFFu ? 32 : __ffs(~m) - 1;
        if (lane == i) ext += run;
        if (run < 32) lm &= ~(1u << i);
      }
    }
    const unsigned had = __shfl_sync(0xFFFFFFFFu, more, L);
    if ((had >> lane) & 1u)
      reinterpret_cast<int*>(&stage[warp][L * 9])[lane] += ext * 64;
  }
  __syncwarp();
  // the warp's 32 words are 1024 consecutive output words
  int4* o = reinterpret_cast<int4*>(out) + (size_t)first * 8;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int j = lane + 32 * m;
    if (first + j / 8 < words) o[j] = stage[warp][(j / 8) * 9 + j % 8];
  }
}

}  // namespace

// bits [N, H, W] i32, run [N, D, Hp, Wp/32] 32-bit run-plane scratch,
// out [N, D, Hp/8, Wp] i32, all on the device; steps: 3 * D host ints
// (dx[D], dy[D], hq[D]).
extern "C" int stvo_lsd_run_pack_multi(const void* bits, void* run, void* out,
                                       int N, int H, int W, int Hp, int Wp,
                                       int D, const int* steps, int cap,
                                       void* stream) {
  if (D < 1 || D > MAX_D || Hp % PY || Wp % PX || H > Hp || W > Wp)
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
    if (ax > MAX_STEP || ay > MAX_STEP || ax + ay == 0)
      return (int)cudaErrorInvalidValue;
    if (ax >= ay) mask_v |= 1u << d;     // thicken across rows
  }
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaFuncSetAttribute(
        run_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        planes_smem(MAX_D));
    if (e != cudaSuccess) return (int)e;
    run_planes_kernel<<<dim3(Wp / PX, Hp / PY, N), P_THREADS, planes_smem(D),
                        s>>>((const int*)bits, (unsigned*)run, (int*)out, H,
                             W, Hp, Wp, dirs, mask_v);
    const int chains = Wp > Hp ? Wp : Hp;
    chain_pack_kernel<<<dim3((chains + C_THREADS - 1) / C_THREADS, D, N),
                        C_THREADS, 0, s>>>((const unsigned*)run, (int*)out,
                                           Hp, Wp, dirs, cap);
  }
  return (int)cudaGetLastError();
}

// aligned [N, H, W] one byte per pixel (0 or 1), 16-byte aligned; run
// 32-bit scratch of N Hp Wp / 32 words (the run plane); out [N, Hp, Wp]
// i32; all on the device; one direction (dx, dy); Hp a multiple of 8, Wp
// of 128.
extern "C" int stvo_lsd_run_pack(const void* aligned, void* run, void* out,
                                 int N, int H, int W, int Hp, int Wp, int dx,
                                 int dy, int cap, void* stream) {
  if (N < 0 || N > 65535 || Hp % 8 || Wp % 128 || H > Hp || W > Wp ||
      (size_t)N * Hp * Wp >= (1ull << 31) || abs(dx) > MAX_STEP ||
      abs(dy) > MAX_STEP || (dx == 0 && dy == 0) || cap < 1 ||
      (uintptr_t)aligned % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const int WW = Wp / 32;
  const size_t smem = (size_t)plane_smem_words(abs(dy), WW) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        run_plane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (N > 0 && Hp > 0 && Wp > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    run_plane_kernel<<<dim3((Hp + RT - 1) / RT, N), R_THREADS, smem, s>>>(
        (const unsigned char*)aligned, (unsigned*)run, H, W, Hp, WW, dx, dy,
        abs(dx) >= abs(dy) ? 1 : 0);
    const unsigned words = (unsigned)((size_t)N * Hp * WW);
    start_pack_kernel<<<(words + S_THREADS - 1) / S_THREADS, S_THREADS, 0,
                        s>>>((const unsigned*)run, (int*)out, words,
                             make_div((unsigned)WW), make_div((unsigned)Hp),
                             Hp, WW, dx, dy, cap);
  }
  return (int)cudaGetLastError();
}
