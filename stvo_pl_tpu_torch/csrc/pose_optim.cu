// The optimizePose state machine (models/optimizer.py `optimize_pose`) for
// B lanes at once: one thread block per lane.
//
// Replaces no TPU kernel: the JAX package leaves the optimizer to XLA,
// which fuses its elementwise work into a few loops.  In eager PyTorch,
// and in the CUDA graph that `parallel/compiled` captures of it, the same
// state machine is some 22 thousand small kernels a step: every solver
// iteration of stage 1, of the refine and of the robust fallback, each
// unrolled, both branches of the good/bad-solution select computed and one
// discarded.  What bounds the plain path on an H100 is those launches; the
// arithmetic is a few hundred thousand operations a lane and an iteration.
//
// Here a block stages its lane's point and line matches in shared memory
// once and runs the whole state machine on them, taking only the branch
// the lane selects:
//
//   * per iteration, each thread evaluates its features' residual,
//     Jacobian and weight, and a fixed-order reduction (each thread's
//     features in turn, a shuffle tree in each warp, then the warps in
//     order) sums H (its lower triangle, the part the Cholesky factor
//     reads), g and e per modality in float32, as the plain path does
//     (the outlier rejection's counts and trimmed means in double);
//   * one thread does the serial 6x6 work: Cholesky, solve, the SE(3) step
//     and the status logic; warp 0 runs the float64 Jacobi sweeps of
//     eigvalsh6;
//   * masked medians (the upper median sorted[n // 2], invalid entries at
//     +inf, NaN above +inf as torch.sort orders them) come from a radix
//     select over the float keys, exact whatever the order of the sort.
//
// Every per-feature term, weight and 6x6 step is the plain path's IEEE
// float32 arithmetic, operation by operation (the library is built with
// -fmad=false), so the results differ from the plain path only where it
// sums in another order: over the features, and the few-term sums of the
// 3- and 4-vectors.  The sums are in a fixed order with no atomics on
// floats: answers repeat bit for bit.  They stay in float32, the plain
// path's precision: double sums, tried, are closer to float64 but stop
// converged solves earlier than the plain path's rounding noise lets it
// (an accurate g gives a step under min_error_change), up to 9 iterations
// apart on the card.
//
// The matches must fit in shared memory: 29 bytes a point and 61 a line
// (`stvo_pose_optim_smem` says whether a capacity fits; the wrapper
// raises where it does not).

#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;                  // threads per block (one lane)
constexpr int NWARP = NT / 32;
constexpr int NACC = 28;                 // H lower (21), g (6), e
using acc_t = float;                     // the feature sums' type
constexpr float BIG_ERR = 999999999.9f;
constexpr float SQRT_CHI2_995_3DOF = 2.7955f;
constexpr float MAD_SCALE = 1.4826f;
constexpr unsigned KEY_INF = 0xFF800000u;    // the key of +inf

enum : unsigned char { F_VALID = 1, F_INLIER = 2, F_INLIER2 = 4 };
enum { K_CAUCHY, K_PARABOLA, K_TUKEY, K_HUBER, K_WELSCH, K_TSTUDENT };

}  // namespace

// Everything a launch needs; the same layout as `ops/pose_optim._Args`.
struct PoseOptimArgs {
  const float* P;             // [B, Np, 3]
  const float* obs;           // [B, Np, 2]
  const float* p_sigma2;      // [B, Np]
  const unsigned char* p_valid;
  const unsigned char* p_inlier;
  const float* sP;            // [B, Nl, 3]
  const float* eP;            // [B, Nl, 3]
  const float* spl;           // [B, Nl, 2]
  const float* epl;           // [B, Nl, 2]
  const float* le;            // [B, Nl, 3]
  const float* l_sigma2;      // [B, Nl]
  const unsigned char* l_valid;
  const unsigned char* l_inlier;
  const float* DT_prev;       // [B, 4, 4]
  const float* cov_prev;      // [B, 6, 6]
  const float* err_prev;      // [B]
  float* DT;                  // [B, 4, 4] out
  float* cov;                 // [B, 6, 6] out
  float* eig;                 // [B, 6] out
  float* err;                 // [B] out
  unsigned char* good;        // [B] out
  long long* n_pt;            // [B] out
  long long* n_ls;            // [B] out
  int* iters;                 // [B] out
  unsigned char* p_inlier_out;  // [B, Np] out
  unsigned char* l_inlier_out;  // [B, Nl] out
  int B, Np, Nl;
  float fx, fy, cx, cy;
  float homog_th, min_error, min_error_change, inlier_k;
  int min_features, max_iters, max_iters_ref, optim_mode, robust_kernel;
  int use_motion_model, has_points, has_lines;
};

namespace {

// ---------------------------------------------------------------------------
// torch's elementwise semantics: clamp and maximum / minimum keep NaN
// ---------------------------------------------------------------------------

__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x != x ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ float clamp_hi(float x, float hi) {
  return x != x ? x : (x > hi ? hi : x);
}
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return clamp_hi(clamp_lo(x, lo), hi);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

// order-preserving key of a float; NaN above +inf
__device__ __forceinline__ unsigned fkey(float x) {
  if (x != x) return 0xFFFFFFFFu;
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// ---------------------------------------------------------------------------
// Per-feature terms (`_point_terms`, `_line_terms`, `segment_overlap`,
// `robust.robust_weight`)
// ---------------------------------------------------------------------------

struct Cam {
  float fx, fy, cx, cy;
};

// T: the top 3 x 4 of the pose, row-major (mm(P, R^T) + t)
__device__ __forceinline__ void transform(const float* T, float x, float y,
                                          float z, float& gx, float& gy,
                                          float& gz) {
  gx = ((x * T[0] + y * T[1]) + z * T[2]) + T[3];
  gy = ((x * T[4] + y * T[5]) + z * T[6]) + T[7];
  gz = ((x * T[8] + y * T[9]) + z * T[10]) + T[11];
}

__device__ __forceinline__ void project(const Cam& c, float gx, float gy,
                                        float gz, float& u, float& v) {
  const float zs = fabsf(gz) < 1e-6f ? 1e-6f : gz;
  u = c.cx + (c.fx * gx) / zs;
  v = c.cy + (c.fy * gy) / zs;
}

__device__ __forceinline__ void point_jac(float gx, float gy, float gz,
                                          float lx, float ly, float fx,
                                          float th, float (&J)[6]) {
  const float fgz2 = fx / clamp_lo(gz * gz, th);
  const float nf = -fgz2;
  J[0] = (fgz2 * lx) * gz;
  J[1] = (fgz2 * ly) * gz;
  J[2] = nf * ((gx * lx) + (gy * ly));
  J[3] = nf * (((gx * gy) * lx + (gy * gy) * ly) + (gz * gz) * ly);
  J[4] = fgz2 * (((gx * gx) * lx + (gz * gz) * lx) + (gx * gy) * ly);
  J[5] = fgz2 * ((gx * gz) * ly - (gy * gz) * lx);
}

// residual norm and unit-residual Jacobian of one point
__device__ __forceinline__ float point_term(const float* T, const Cam& c,
                                            float th, float x, float y,
                                            float z, float uo, float vo,
                                            float (&J)[6]) {
  float gx, gy, gz, u, v;
  transform(T, x, y, z, gx, gy, gz);
  project(c, gx, gy, gz, u, v);
  const float ex = u - uo, ey = v - vo;
  const float norm = sqrtf(ex * ex + ey * ey);
  point_jac(gx, gy, gz, ex, ey, c.fx, th, J);
  const float d = clamp_lo(norm, th);
#pragma unroll
  for (int k = 0; k < 6; ++k) J[k] = J[k] / d;
  return norm;
}

__device__ __forceinline__ float point_norm(const float* T, const Cam& c,
                                            float x, float y, float z,
                                            float uo, float vo) {
  float gx, gy, gz, u, v;
  transform(T, x, y, z, gx, gy, gz);
  project(c, gx, gy, gz, u, v);
  const float ex = u - uo, ey = v - vo;
  return sqrtf(ex * ex + ey * ey);
}

struct LineIn {
  float sx, sy, sz, ex, ey, ez, spx, spy, epx, epy, a, b, c;
};

// residual norm, Jacobian (with_jac) and overlap factor of one line
__device__ __forceinline__ float line_term(const float* T, const Cam& c,
                                           float th, const LineIn& L,
                                           bool with_jac, float (&J)[6],
                                           float& overlap) {
  float sgx, sgy, sgz, egx, egy, egz, su, sv, eu, ev;
  transform(T, L.sx, L.sy, L.sz, sgx, sgy, sgz);
  transform(T, L.ex, L.ey, L.ez, egx, egy, egz);
  project(c, sgx, sgy, sgz, su, sv);
  project(c, egx, egy, egz, eu, ev);
  const float ds = (L.a * su + L.b * sv) + L.c;
  const float de = (L.a * eu + L.b * ev) + L.c;
  const float norm = sqrtf(ds * ds + de * de);
  if (!with_jac) return norm;
  float Js[6], Je[6];
  point_jac(sgx, sgy, sgz, L.a, L.b, c.fx, th, Js);
  point_jac(egx, egy, egz, L.a, L.b, c.fx, th, Je);
  const float d = clamp_lo(norm, th);
#pragma unroll
  for (int k = 0; k < 6; ++k) J[k] = (Js[k] * ds + Je[k] * de) / d;
  // segment_overlap(spl, epl, sp_proj, ep_proj)
  const float lx = L.epx - L.spx, ly = L.epy - L.spy;
  const float denom = clamp_lo(lx * lx + ly * ly, 1e-12f);
  const float lam_s = ((su - L.spx) * lx + (sv - L.spy) * ly) / denom;
  const float lam_e = ((eu - L.spx) * lx + (ev - L.spy) * ly) / denom;
  const float ov = clamp_hi(max_nan(lam_s, lam_e), 1.0f)
                   - clamp_lo(min_nan(lam_s, lam_e), 0.0f);
  overlap = clamp2(ov, 0.0f, 1.0f);
  return norm;
}

__device__ __forceinline__ float robust_weight(float r, int kernel) {
  const float r2 = r * r;
  switch (kernel) {
    case K_PARABOLA: return r <= 1.0f ? 1.0f - r2 : 0.0f;
    case K_TUKEY: {
      const float q = 1.0f - r2;
      return r <= 1.0f ? q * q : 0.0f;
    }
    case K_HUBER: return r <= 1.0f ? 1.0f : 1.0f / clamp_lo(r, 1e-12f);
    case K_WELSCH: return expf(-r2);
    case K_TSTUDENT: return 1.0f / (5.0f + r2);
    default: return 1.0f / (1.0f + r2);
  }
}

// H lower (row-major over i >= j), g, e: J_i (J_j w), J_i (r w), (r r) w
__device__ __forceinline__ void accumulate(acc_t (&acc)[NACC],
                                           const float (&J)[6], float r,
                                           float w) {
  float Jw[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) Jw[k] = J[k] * w;
  int n = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) acc[n++] += (acc_t)(J[i] * Jw[j]);
  const float rw = r * w;
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += (acc_t)(J[i] * rw);
  acc[27] += (acc_t)((r * r) * w);
}

// ---------------------------------------------------------------------------
// Serial 6x6 algebra (`ops/linalg.py`, `ops/se3.py`), one thread
// ---------------------------------------------------------------------------

// lower Cholesky factor of H + 1e-10 max|diag H| I (H's lower triangle);
// L = I where the factorization failed
__device__ __noinline__ bool cholesky6(const float* H, float (&L)[36]) {
  float scale = fabsf(H[0]);
  for (int j = 1; j < 6; ++j) scale = max_nan(scale, fabsf(H[j * 7]));
  const float jit = 1e-10f * clamp_lo(scale, 1e-30f);
  bool ok = true;
  for (int k = 0; k < 36; ++k) L[k] = 0.0f;
  for (int j = 0; j < 6; ++j) {
    float s = H[j * 7] + jit;
    for (int k = 0; k < j; ++k) s = s - L[j * 6 + k] * L[j * 6 + k];
    ok = ok && (s > FLT_MIN);
    const float ljj = sqrtf(s);
    L[j * 7] = ljj;
    for (int i = j + 1; i < 6; ++i) {
      float v = H[i * 6 + j];
      for (int k = 0; k < j; ++k) v = v - L[i * 6 + k] * L[j * 6 + k];
      L[i * 6 + j] = v / ljj;
    }
  }
  for (int k = 0; k < 36; ++k) ok = ok && finite(L[k]);
  if (!ok)
    for (int k = 0; k < 36; ++k) L[k] = (k % 7 == 0) ? 1.0f : 0.0f;
  return ok;
}

// X = L^-T L^-1 B for m columns of B (row-major 6 x m, in place)
__device__ __noinline__ void chol_solve(const float (&L)[36], float* X, int m) {
  for (int c = 0; c < m; ++c) {
    float y[6];
    for (int i = 0; i < 6; ++i) {
      float v = X[i * m + c];
      for (int k = 0; k < i; ++k) v = v - L[i * 6 + k] * y[k];
      y[i] = v / L[i * 7];
    }
    float x[6];
    for (int i = 5; i >= 0; --i) {
      float v = y[i];
      for (int k = i + 1; k < 6; ++k) v = v - L[k * 6 + i] * x[k];
      x[i] = v / L[i * 7];
    }
    for (int i = 0; i < 6; ++i) X[i * m + c] = x[i];
  }
}

// solve6: x = H^-1 g, 0 and false unless the factorization holds and
// log det H >= 0
__device__ __noinline__ bool solve6(const float* H, const float* g, float (&x)[6]) {
  float L[36];
  const bool ok_chol = cholesky6(H, L);
  for (int i = 0; i < 6; ++i) x[i] = g[i];
  chol_solve(L, x, 1);
  float logdet = 0.0f;
  for (int i = 0; i < 6; ++i) logdet = logdet + logf(clamp_lo(L[i * 7], 0.0f));
  logdet = 2.0f * logdet;
  bool ok = ok_chol && finite(logdet) && logdet >= 0.0f;
  for (int i = 0; i < 6; ++i) ok = ok && finite(x[i]);
  if (!ok)
    for (int i = 0; i < 6; ++i) x[i] = 0.0f;
  return ok;
}

// inv6: H^-1 through the Cholesky factor, zeros where it failed
__device__ __noinline__ void inv6(const float* H, float* out) {
  float L[36];
  const bool ok = cholesky6(H, L);
  float X[36];
  for (int k = 0; k < 36; ++k) X[k] = (k % 7 == 0) ? 1.0f : 0.0f;
  chol_solve(L, X, 6);
  for (int k = 0; k < 36; ++k) out[k] = ok ? X[k] : 0.0f;
}

__device__ void set_eye4(float* T) {
  for (int k = 0; k < 16; ++k) T[k] = (k % 5 == 0) ? 1.0f : 0.0f;
}

// C = A B for 4 x 4
__device__ void mm4(const float* A, const float* B, float* C) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      float s = A[i * 4] * B[j];
      for (int k = 1; k < 4; ++k) s = s + A[i * 4 + k] * B[k * 4 + j];
      C[i * 4 + j] = s;
    }
}

__device__ void skew_sq(const float (&w)[3], float (&W)[9], float (&W2)[9]) {
  W[0] = 0.0f;  W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.0f;  W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.0f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float s = W[i * 3] * W[j];
      for (int k = 1; k < 3; ++k) s = s + W[i * 3 + k] * W[k * 3 + j];
      W2[i * 3 + j] = s;
    }
}

// expmap_se3 of the twist [t, w]
__device__ __noinline__ void expmap_se3(const float* x, float* T) {
  const float w[3] = {x[3], x[4], x[5]};
  const float t2 = (w[0] * w[0] + w[1] * w[1]) + w[2] * w[2];
  const bool small = t2 < 1e-8f;
  const float t2s = small ? 1.0f : t2;
  const float th = sqrtf(t2s);
  const float A = small ? 1.0f - t2 / 6.0f : sinf(th) / th;
  const float B = small ? 0.5f - t2 / 24.0f : (1.0f - cosf(th)) / t2s;
  const float C = small ? (float)(1.0 / 6.0) - t2 / 120.0f
                        : (th - sinf(th)) / (t2s * th);
  float W[9], W2[9];
  skew_sq(w, W, W2);
  float V[9];
  for (int k = 0; k < 9; ++k) {
    const float I = (k % 4 == 0) ? 1.0f : 0.0f;
    V[k] = (I + B * W[k]) + C * W2[k];
    T[(k / 3) * 4 + k % 3] = (I + A * W[k]) + B * W2[k];
  }
  for (int i = 0; i < 3; ++i)
    T[i * 4 + 3] = (V[i * 3] * x[0] + V[i * 3 + 1] * x[1]) + V[i * 3 + 2] * x[2];
  T[12] = 0.0f; T[13] = 0.0f; T[14] = 0.0f; T[15] = 1.0f;
}

__device__ void inverse_se3(const float* T, float* Ti) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) Ti[i * 4 + j] = T[j * 4 + i];
    Ti[i * 4 + 3] = -((T[i] * T[3] + T[4 + i] * T[7]) + T[8 + i] * T[11]);
  }
  Ti[12] = 0.0f; Ti[13] = 0.0f; Ti[14] = 0.0f; Ti[15] = 1.0f;
}

// DT <- expmap(dx)^-1 DT
__device__ __noinline__ void se3_step(const float (&dx)[6], const float* DT, float* out) {
  float E[16], Ei[16];
  expmap_se3(dx, E);
  inverse_se3(E, Ei);
  mm4(Ei, DT, out);
}

__device__ __noinline__ void so3_log(const float* T, float (&w)[3]) {
  const float tr = (T[0] + T[5]) + T[10];
  const float cs = clamp2((tr - 1.0f) * 0.5f, -1.0f, 1.0f);
  const float a[3] = {T[9] - T[6], T[2] - T[8], T[4] - T[1]};
  const float an = sqrtf((a[0] * a[0] + a[1] * a[1]) + a[2] * a[2]);
  const float sn = 0.5f * an;
  const float theta = atan2f(sn, cs);
  const bool small = theta < 1e-6f;
  const bool near_pi = (an < 2e-3f) && (cs < 0.0f);
  if (small) {
    for (int k = 0; k < 3; ++k) w[k] = 0.5f * a[k];
  } else if (near_pi) {
    const float Bd[3] = {T[0] + 1.0f, T[5] + 1.0f, T[10] + 1.0f};
    int k = 0;
    for (int i = 1; i < 3; ++i)
      if (Bd[i] > Bd[k] || (Bd[i] != Bd[i] && Bd[k] == Bd[k])) k = i;
    // column k of R + I
    const float col[3] = {T[k] + (k == 0 ? 1.0f : 0.0f),
                          T[4 + k] + (k == 1 ? 1.0f : 0.0f),
                          T[8 + k] + (k == 2 ? 1.0f : 0.0f)};
    const float cn = clamp_lo(
        sqrtf((col[0] * col[0] + col[1] * col[1]) + col[2] * col[2]), 1e-12f);
    const float ax[3] = {col[0] / cn, col[1] / cn, col[2] / cn};
    const float dot = (ax[0] * a[0] + ax[1] * a[1]) + ax[2] * a[2];
    const float ts = theta * (dot < 0.0f ? -1.0f : 1.0f);
    for (int i = 0; i < 3; ++i) w[i] = ts * ax[i];
  } else {
    const float sc = theta / an;
    for (int i = 0; i < 3; ++i) w[i] = sc * a[i];
  }
}

// renormalize_se3(T) = expmap(logmap(T))
__device__ __noinline__ void renormalize_se3(const float* T, float* out) {
  float w[3];
  so3_log(T, w);
  const float theta = sqrtf((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2]);
  float W[9], W2[9];
  skew_sq(w, W, W2);
  const float cs = cosf(theta), sn = sinf(theta);
  const bool small = theta < 1e-4f;
  const float ts = small ? 1.0f : theta;
  const float coef = small
      ? (float)(1.0 / 12.0) + (theta * theta) / 720.0f
      : 1.0f / (ts * ts) - (1.0f + cs) / ((2.0f * ts) * sn + 1e-30f);
  float x[6];
  for (int i = 0; i < 3; ++i) {
    float s = 0.0f;
    for (int k = 0; k < 3; ++k) {
      const float I = (i == k) ? 1.0f : 0.0f;
      const float Vinv = (I - 0.5f * W[i * 3 + k]) + coef * W2[i * 3 + k];
      s = (k == 0) ? Vinv * T[3] : s + Vinv * T[k * 4 + 3];
    }
    x[i] = s;
  }
  x[3] = w[0]; x[4] = w[1]; x[5] = w[2];
  expmap_se3(x, out);
}

// ---------------------------------------------------------------------------
// Shared state of a block
// ---------------------------------------------------------------------------

struct Feats {
  int Np, Nl;
  float *px, *py, *pz, *pu, *pv, *psq, *pr;
  float *sx, *sy, *sz, *ex, *ey, *ez, *spx, *spy, *epx, *epy, *la, *lb,
      *lc, *lsq, *lr;
  unsigned char *pf, *lf;

  __device__ LineIn line(int i) const {
    return LineIn{sx[i], sy[i], sz[i], ex[i], ey[i], ez[i], spx[i],
                  spy[i], epx[i], epy[i], la[i], lb[i], lc[i]};
  }
};

struct Sol {
  float T[16];
  float cov[36];
  float err;
  int iters;
};

struct Ctx {
  Cam cam;
  float homog_th, min_error, mec;
  int kernel;
};

struct Shared {
  Feats f;                      // the staged matches
  Ctx x;                        // the settings
  double warp[NWARP * NACC];
  acc_t sum_p[NACC], sum_l[NACC];
  double cnt[3];
  double jA[36], jB[36];        // Jacobi
  int hist[256];
  float T[16];                  // the iterate, broadcast
  float H[36];                  // the kept normal matrix
  float T0[16];                 // DT_init
  float err, err_prev, lam, s_p, s_l;
  int it, status, n_active;
  unsigned sel_prefix;
  int sel_k;
  int good1;
  Sol sol1, sol2;
};

// Fixed-order sums over the block of v[0..N): a shuffle tree in each
// warp, then the warps in order; out is valid after the call.
template <class T, int N>
__device__ void block_sum(T (&v)[N], double* warp_mem, T* out) {
  T* warp_buf = reinterpret_cast<T*>(warp_mem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T x = v[i];
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    v[i] = x;
  }
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) warp_buf[warp * N + i] = v[i];
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    T s = warp_buf[i];
    for (int w = 1; w < nwarp; ++w) s += warp_buf[w * N + i];
    out[i] = s;
  }
  __syncthreads();
}

// counts over the block of the features whose flags hold `need`
__device__ __noinline__ void count2(const Feats& f, unsigned char need, Shared& sh,
                       int& np, int& nl) {
  double c[2] = {0.0, 0.0};
  for (int i = threadIdx.x; i < f.Np; i += blockDim.x)
    c[0] += ((f.pf[i] & need) == need) ? 1.0 : 0.0;
  for (int i = threadIdx.x; i < f.Nl; i += blockDim.x)
    c[1] += ((f.lf[i] & need) == need) ? 1.0 : 0.0;
  block_sum(c, sh.warp, sh.cnt);
  np = (int)sh.cnt[0];
  nl = (int)sh.cnt[1];
  __syncthreads();
}

// The value of rank k among keys key(0..n): a radix select, 8 bits a
// pass, with warp-aggregated counts.
template <class KeyFn>
__device__ float radix_select(int n, int k, KeyFn key, Shared& sh) {
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0u, mask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += blockDim.x) sh.hist[b] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += blockDim.x) {
      const int i = base + threadIdx.x;
      int bin = -1;
      if (i < n) {
        const unsigned kk = key(i);
        if ((kk & mask) == prefix) bin = (int)((kk >> shift) & 255u);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&sh.hist[bin], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int cum = 0, b = 0;
      for (; b < 255; ++b) {
        if (cum + sh.hist[b] > k) break;
        cum += sh.hist[b];
      }
      sh.sel_k = k - cum;
      sh.sel_prefix = prefix | ((unsigned)b << shift);
    }
    __syncthreads();
    k = sh.sel_k;
    prefix = sh.sel_prefix;
    mask |= 255u << shift;
  }
  __syncthreads();
  return key_value(prefix);
}

// robust.masked_median over vals[0..N) where flags hold `need`; n = count
__device__ float masked_median(const float* vals, const unsigned char* fl,
                               int N, int n, unsigned char need,
                               Shared& sh) {
  if (n == 0) return 0.0f;
  return radix_select(N, n / 2, [&](int i) {
    return ((fl[i] & need) == need) ? fkey(vals[i]) : KEY_INF;
  }, sh);
}

// robust.masked_stdv_mad: 1.4826 median(|x - median(x)|)
__device__ __noinline__ float masked_stdv_mad(const float* vals, const unsigned char* fl,
                                 int N, int n, unsigned char need,
                                 Shared& sh) {
  const float med = masked_median(vals, fl, N, n, need, sh);
  if (n == 0) return MAD_SCALE * 0.0f;
  const float mad = radix_select(N, n / 2, [&](int i) {
    return ((fl[i] & need) == need) ? fkey(fabsf(vals[i] - med)) : KEY_INF;
  }, sh);
  return MAD_SCALE * mad;
}

// ---------------------------------------------------------------------------
// Jacobi eigenvalues (`linalg.eigvalsh6`), float64, warp 0
// ---------------------------------------------------------------------------

// the round-robin rounds of `linalg._round_robin_pairs`: 3 disjoint pairs
__constant__ int c_pairs[5][3][2] = {
    {{0, 5}, {1, 4}, {2, 3}}, {{0, 4}, {3, 5}, {1, 2}},
    {{0, 3}, {2, 4}, {1, 5}}, {{0, 2}, {1, 3}, {4, 5}},
    {{0, 1}, {2, 5}, {3, 4}}};
constexpr int JACOBI_SWEEPS = 8;

// Ascending float32 eigenvalues of the symmetric M (row-major 6 x 6) into
// ev (thread 0's); every thread calls it.
__device__ __noinline__ void eigvalsh6(const float* M, Shared& sh, float (&ev)[6]) {
  const int lane = threadIdx.x;
  const int nl = blockDim.x < 32 ? blockDim.x : 32;
  if (lane < 32) {
    for (int e = lane; e < 36; e += nl) sh.jA[e] = (double)M[e];
    __syncwarp();
    for (int sweep = 0; sweep < JACOBI_SWEEPS; ++sweep) {
      for (int r = 0; r < 5; ++r) {
        // each lane forms the round's three rotations itself
        double c[6], s[6];
        int partner[6];
        bool first[6];
        for (int m = 0; m < 3; ++m) {
          const int p = c_pairs[r][m][0], q = c_pairs[r][m][1];
          const double app = sh.jA[p * 7], aqq = sh.jA[q * 7];
          const double apq = sh.jA[p * 6 + q];
          const bool nz = apq != 0.0;
          const double tau = (aqq - app) / (2.0 * (nz ? apq : 1.0));
          const double sgn = tau >= 0.0 ? 1.0 : -1.0;
          double t = sgn / (fabs(tau) + sqrt(1.0 + tau * tau));
          t = nz ? t : 0.0;
          const double cc = 1.0 / sqrt(1.0 + t * t);
          const double ss = t * cc;
          c[p] = cc; s[p] = ss; partner[p] = q; first[p] = true;
          c[q] = cc; s[q] = ss; partner[q] = p; first[q] = false;
        }
        // A1 = J^T A: row p = c A_p - s A_q, row q = s A_p + c A_q
        for (int e = lane; e < 36; e += nl) {
          const int i = e / 6, j = e % 6, o = partner[i];
          const double ai = sh.jA[i * 6 + j], ao = sh.jA[o * 6 + j];
          sh.jB[e] = first[i] ? c[i] * ai + (-s[i]) * ao
                              : s[i] * ao + c[i] * ai;
        }
        __syncwarp();
        // A2 = A1 J: column p = c A1_p - s A1_q, column q = s A1_p + c A1_q
        for (int e = lane; e < 36; e += nl) {
          const int i = e / 6, j = e % 6, o = partner[j];
          const double aj = sh.jB[i * 6 + j], ao = sh.jB[i * 6 + o];
          sh.jA[e] = first[j] ? aj * c[j] + ao * (-s[j])
                              : ao * s[j] + aj * c[j];
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double d[6];
    for (int i = 0; i < 6; ++i) d[i] = sh.jA[i * 7];
    // ascending, NaN last (torch.sort)
    for (int i = 1; i < 6; ++i) {
      const double v = d[i];
      int j = i - 1;
      while (j >= 0 && (d[j] > v || (d[j] != d[j] && v == v))) {
        d[j + 1] = d[j];
        --j;
      }
      d[j + 1] = v;
    }
    for (int i = 0; i < 6; ++i) ev[i] = (float)d[i];
  }
  __syncthreads();
}

// isGoodSolution from the eigenvalues of cov: eig in [0, 1], err in
// [0, 1], DT finite
__device__ bool is_good(const float* T, const float (&ev)[6], float err) {
  bool ok = ev[0] >= 0.0f && ev[5] <= 1.0f && err >= 0.0f && err <= 1.0f;
  for (int k = 0; k < 16; ++k) ok = ok && finite(T[k]);
  for (int k = 0; k < 6; ++k) ok = ok && finite(ev[k]);
  return ok;
}

// ---------------------------------------------------------------------------
// The solvers
// ---------------------------------------------------------------------------

// (H, g, e) at sh.T over the features whose flags hold `need`, into
// H[36] (lower triangle), g[6], e of thread 0; robust: raw residuals
// weighted on r / s with the modality's MAD scale
__device__ __noinline__ void normal_equations(const Feats& f, const Ctx& x,
                                 unsigned char need, bool robust,
                                 Shared& sh, float* H, float* g, float& e) {
  const float* T = sh.T;
  const float s_p = sh.s_p, s_l = sh.s_l;
  acc_t acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0;
  for (int i = threadIdx.x; i < f.Np; i += blockDim.x) {
    if ((f.pf[i] & need) != need) continue;
    float J[6];
    const float norm = point_term(T, x.cam, x.homog_th, f.px[i], f.py[i],
                                  f.pz[i], f.pu[i], f.pv[i], J);
    float r, w;
    if (robust) {
      r = norm;
      w = robust_weight(r / s_p, x.kernel);
    } else {
      r = norm * f.psq[i];
      w = robust_weight(r, x.kernel);
    }
    accumulate(acc, J, r, w);
  }
  block_sum(acc, sh.warp, sh.sum_p);
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0;
  for (int i = threadIdx.x; i < f.Nl; i += blockDim.x) {
    if ((f.lf[i] & need) != need) continue;
    float J[6], ov;
    const float norm = line_term(T, x.cam, x.homog_th, f.line(i), true, J,
                                 ov);
    float r, w;
    if (robust) {
      r = norm;
      w = robust_weight(r / s_l, x.kernel) * ov;
    } else {
      r = norm * f.lsq[i];
      w = robust_weight(r, x.kernel) * ov;
    }
    accumulate(acc, J, r, w);
  }
  block_sum(acc, sh.warp, sh.sum_l);
  if (threadIdx.x == 0) {
    int n = 0;
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j <= i; ++j, ++n) {
        H[i * 6 + j] = (float)sh.sum_p[n] + (float)sh.sum_l[n];
        H[j * 6 + i] = H[i * 6 + j];
      }
    for (int i = 0; i < 6; ++i)
      g[i] = (float)sh.sum_p[21 + i] + (float)sh.sum_l[21 + i];
    const float cnt = (float)sh.n_active;
    e = ((float)sh.sum_p[27] + (float)sh.sum_l[27]) / (cnt < 1.0f ? 1.0f
                                                                 : cnt);
  }
}

// per-modality MAD scales of the raw residual norms at sh.T (`_mad_scales`)
__device__ __noinline__ void mad_scales(const Feats& f, const Ctx& x, unsigned char need,
                           int np, int nl, Shared& sh) {
  for (int i = threadIdx.x; i < f.Np; i += blockDim.x)
    f.pr[i] = point_norm(sh.T, x.cam, f.px[i], f.py[i], f.pz[i], f.pu[i],
                         f.pv[i]);
  for (int i = threadIdx.x; i < f.Nl; i += blockDim.x) {
    float J[6], ov;
    f.lr[i] = line_term(sh.T, x.cam, x.homog_th, f.line(i), false, J, ov);
  }
  __syncthreads();
  const float sp = masked_stdv_mad(f.pr, f.pf, f.Np, np, need, sh);
  const float sl = masked_stdv_mad(f.lr, f.lf, f.Nl, nl, need, sh);
  if (threadIdx.x == 0) {
    sh.s_p = clamp2(sp, 1e-4f, SQRT_CHI2_995_3DOF);
    sh.s_l = clamp2(sl, 1e-4f, SQRT_CHI2_995_3DOF);
  }
  __syncthreads();
}

__device__ __forceinline__ float norm3(float a, float b, float c) {
  return sqrtf((a * a + b * b) + c * c);
}

// gauss_newton (robust=false) / the robust GN (robust=true) from T0 over
// the features whose flags hold `need`
__device__ __noinline__ void gauss_newton(const Feats& f, const Ctx& x, const float* T0,
                             unsigned char need, int max_iters, bool robust,
                             Shared& sh, Sol& out) {
  int np, nl;
  count2(f, need, sh, np, nl);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 16; ++k) sh.T[k] = T0[k];
    for (int k = 0; k < 36; ++k) sh.H[k] = (k % 7 == 0) ? 1.0f : 0.0f;
    sh.err = -1.0f;
    sh.err_prev = BIG_ERR;
    sh.it = 0;
    sh.status = 0;
    sh.n_active = np + nl;
  }
  __syncthreads();
  for (int iter = 0; iter < max_iters; ++iter) {
    if (sh.status != 0) break;
    if (robust) mad_scales(f, x, need, np, nl, sh);
    float H[36], g[6], e;
    normal_equations(f, x, need, robust, sh, H, g, e);
    if (threadIdx.x == 0) {
      const bool inc = robust ? false : e > sh.err_prev;
      const bool fail_first = robust ? false : inc && sh.it == 0;
      const bool small = (e < x.min_error)
                         || (fabsf(e - sh.err_prev) < x.mec);
      float dx[6];
      const bool ok = solve6(H, g, dx);
      const bool solver_fail = robust ? !ok : false;
      bool small_dx;
      if (robust) {
        float s = dx[0] * dx[0];
        for (int k = 1; k < 6; ++k) s = s + dx[k] * dx[k];
        small_dx = sqrtf(s) < x.mec;
      } else {
        small_dx = norm3(dx[0], dx[1], dx[2]) < x.mec
                   && norm3(dx[3], dx[4], dx[5]) < x.mec;
      }
      if (!(inc || small || solver_fail || fail_first)) {
        float Tn[16];
        se3_step(dx, sh.T, Tn);
        for (int k = 0; k < 16; ++k) sh.T[k] = Tn[k];
      }
      sh.status = (fail_first || solver_fail) ? 2
                  : ((inc || small || small_dx) ? 1 : 0);
      for (int k = 0; k < 36; ++k) sh.H[k] = H[k];
      sh.err = e;
      sh.err_prev = e;
      sh.it += 1;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const bool failed = sh.status == 2;
    if (failed) {
      for (int k = 0; k < 36; ++k) out.cov[k] = (k % 7 == 0) ? 1.0f : 0.0f;
      for (int k = 0; k < 16; ++k) out.T[k] = T0[k];
      out.err = -1.0f;
    } else {
      inv6(sh.H, out.cov);
      for (int k = 0; k < 16; ++k) out.T[k] = sh.T[k];
      out.err = sh.err;
    }
    out.iters = sh.it;
  }
  __syncthreads();
}

// levenberg_marquardt from T0
__device__ __noinline__ void levenberg_marquardt(const Feats& f, const Ctx& x,
                                    const float* T0, unsigned char need,
                                    int max_iters, Shared& sh, Sol& out) {
  int np, nl;
  count2(f, need, sh, np, nl);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 16; ++k) sh.T[k] = T0[k];
    sh.n_active = np + nl;
  }
  __syncthreads();
  float H[36], g[6], e;
  normal_equations(f, x, need, false, sh, H, g, e);
  if (threadIdx.x == 0) {
    float amax = fabsf(H[0]);
    for (int j = 1; j < 6; ++j) amax = max_nan(amax, fabsf(H[j * 7]));
    const float lam = 1e-9f * amax;
    float Hl[36], dx[6];
    for (int k = 0; k < 36; ++k) Hl[k] = (k % 7 == 0) ? H[k] + lam : H[k];
    solve6(Hl, g, dx);
    float Tn[16];
    se3_step(dx, T0, Tn);
    for (int k = 0; k < 16; ++k) sh.T[k] = Tn[k];
    for (int k = 0; k < 36; ++k) sh.H[k] = H[k];
    sh.err_prev = e;
    sh.lam = lam;
    sh.it = 1;
    sh.status = 0;
  }
  __syncthreads();
  for (int iter = 0; iter < max_iters - 1; ++iter) {
    if (sh.status != 0 || sh.it >= max_iters) break;
    normal_equations(f, x, need, false, sh, H, g, e);
    if (threadIdx.x == 0) {
      const bool small = (e < x.min_error)
                         || (fabsf(e - sh.err_prev) < x.mec);
      const float lam = sh.lam;
      float Hl[36], dx[6];
      for (int k = 0; k < 36; ++k) Hl[k] = (k % 7 == 0) ? H[k] + lam : H[k];
      solve6(Hl, g, dx);
      const bool worse = e > sh.err_prev;
      const float lam_new = worse ? lam / 4.0f : lam * 4.0f;
      const bool small_dx = norm3(dx[0], dx[1], dx[2]) < x.mec
                            && norm3(dx[3], dx[4], dx[5]) < x.mec;
      if (!small && !worse) {
        float Tn[16];
        se3_step(dx, sh.T, Tn);
        for (int k = 0; k < 16; ++k) sh.T[k] = Tn[k];
      }
      sh.lam = lam_new;
      for (int k = 0; k < 36; ++k) sh.H[k] = H[k];
      sh.err_prev = e;
      sh.it += 1;
      sh.status = (small || small_dx) ? 1 : 0;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    inv6(sh.H, out.cov);
    for (int k = 0; k < 16; ++k) out.T[k] = sh.T[k];
    out.err = sh.err_prev;
    out.iters = sh.it;
  }
  __syncthreads();
}

__device__ void solve(const Feats& f, const Ctx& x, int mode, const float* T0,
                      unsigned char need, int max_iters, Shared& sh,
                      Sol& out) {
  if (mode == 2)
    levenberg_marquardt(f, x, T0, need, max_iters, sh, out);
  else
    gauss_newton(f, x, T0, need, max_iters, mode == 1, sh, out);
}

// remove_outliers against the pose sh.T for one modality: flags gain
// F_INLIER2 where inlier and not (valid and |res - mean| > th)
__device__ __noinline__ void reject_outliers(float* res, unsigned char* fl, int N,
                                float inlier_k, bool apply, Shared& sh) {
  int n;
  {
    double c[1] = {0.0};
    for (int i = threadIdx.x; i < N; i += blockDim.x)
      c[0] += (fl[i] & F_VALID) ? 1.0 : 0.0;
    block_sum(c, sh.warp, sh.cnt);
    n = (int)sh.cnt[0];
    __syncthreads();
  }
  float mean = 0.0f, th = 0.0f;
  if (apply) {
    const float stdv = masked_stdv_mad(res, fl, N, n, F_VALID, sh);
    const float lim = 2.0f * stdv;
    double s[3] = {0.0, 0.0, 0.0};   // k, sum of the good, sum of all
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      if (!(fl[i] & F_VALID)) continue;
      const float r = res[i];
      if (r < lim) {
        s[0] += 1.0;
        s[1] += (double)r;
      }
      s[2] += (double)r;
    }
    block_sum(s, sh.warp, sh.cnt);
    const int k = (int)sh.cnt[0];
    const float sum_good = (float)sh.cnt[1], sum_all = (float)sh.cnt[2];
    __syncthreads();
    const bool trimmed = k >= (int)ceilf(0.2f * (float)n);
    mean = trimmed ? sum_good / (float)(k < 1 ? 1 : k)
                   : sum_all / (float)(n < 1 ? 1 : n);
    if (n == 0) mean = 0.0f;
    th = clamp_lo(inlier_k * stdv, 1e-4f);
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    unsigned char fi = fl[i];
    bool keep = (fi & F_INLIER) != 0;
    if (apply && (fi & F_VALID) && fabsf(res[i] - mean) > th) keep = false;
    fl[i] = keep ? (fi | F_INLIER2) : (fi & ~F_INLIER2);
  }
  __syncthreads();
}

}  // namespace

extern __shared__ __align__(16) unsigned char pose_smem[];

__global__ void __launch_bounds__(NT) pose_optim_kernel(PoseOptimArgs a) {
  __shared__ Shared sh;
  const int b = blockIdx.x;
  const int Np = a.Np, Nl = a.Nl;
  if (threadIdx.x == 0) {
    Feats& g = sh.f;
    g.Np = Np;
    g.Nl = Nl;
    float* fp = reinterpret_cast<float*>(pose_smem);
    g.px = fp; fp += Np;  g.py = fp; fp += Np;  g.pz = fp; fp += Np;
    g.pu = fp; fp += Np;  g.pv = fp; fp += Np;  g.psq = fp; fp += Np;
    g.pr = fp; fp += Np;
    g.sx = fp; fp += Nl;  g.sy = fp; fp += Nl;  g.sz = fp; fp += Nl;
    g.ex = fp; fp += Nl;  g.ey = fp; fp += Nl;  g.ez = fp; fp += Nl;
    g.spx = fp; fp += Nl; g.spy = fp; fp += Nl; g.epx = fp; fp += Nl;
    g.epy = fp; fp += Nl; g.la = fp; fp += Nl;  g.lb = fp; fp += Nl;
    g.lc = fp; fp += Nl;  g.lsq = fp; fp += Nl; g.lr = fp; fp += Nl;
    g.pf = reinterpret_cast<unsigned char*>(fp);
    g.lf = g.pf + Np;
    sh.x.cam = Cam{a.fx, a.fy, a.cx, a.cy};
    sh.x.homog_th = a.homog_th;
    sh.x.min_error = a.min_error;
    sh.x.mec = a.min_error_change;
    sh.x.kernel = a.robust_kernel;
  }
  __syncthreads();
  const Feats& f = sh.f;
  const Ctx& x = sh.x;

  // stage the lane's matches
  {
    const float* P = a.P + (size_t)b * Np * 3;
    const float* o = a.obs + (size_t)b * Np * 2;
    const float* s2 = a.p_sigma2 + (size_t)b * Np;
    const unsigned char* v = a.p_valid + (size_t)b * Np;
    const unsigned char* in = a.p_inlier + (size_t)b * Np;
    for (int i = threadIdx.x; i < Np; i += blockDim.x) {
      f.px[i] = P[i * 3];
      f.py[i] = P[i * 3 + 1];
      f.pz[i] = P[i * 3 + 2];
      f.pu[i] = o[i * 2];
      f.pv[i] = o[i * 2 + 1];
      f.psq[i] = sqrtf(s2[i]);
      f.pf[i] = (v[i] ? F_VALID : 0) | (in[i] ? F_INLIER : 0);
    }
  }
  {
    const size_t o3 = (size_t)b * Nl * 3, o2 = (size_t)b * Nl * 2;
    const unsigned char* v = a.l_valid + (size_t)b * Nl;
    const unsigned char* in = a.l_inlier + (size_t)b * Nl;
    for (int i = threadIdx.x; i < Nl; i += blockDim.x) {
      f.sx[i] = a.sP[o3 + i * 3];
      f.sy[i] = a.sP[o3 + i * 3 + 1];
      f.sz[i] = a.sP[o3 + i * 3 + 2];
      f.ex[i] = a.eP[o3 + i * 3];
      f.ey[i] = a.eP[o3 + i * 3 + 1];
      f.ez[i] = a.eP[o3 + i * 3 + 2];
      f.spx[i] = a.spl[o2 + i * 2];
      f.spy[i] = a.spl[o2 + i * 2 + 1];
      f.epx[i] = a.epl[o2 + i * 2];
      f.epy[i] = a.epl[o2 + i * 2 + 1];
      f.la[i] = a.le[o3 + i * 3];
      f.lb[i] = a.le[o3 + i * 3 + 1];
      f.lc[i] = a.le[o3 + i * 3 + 2];
      f.lsq[i] = sqrtf(a.l_sigma2[(size_t)b * Nl + i]);
      f.lf[i] = (v[i] ? F_VALID : 0) | (in[i] ? F_INLIER : 0);
    }
  }
  __syncthreads();

  const unsigned char NEED1 = F_VALID | F_INLIER;
  const unsigned char NEED2 = F_VALID | F_INLIER2;

  int np, nl;
  count2(f, NEED1, sh, np, nl);
  const bool enough = np + nl >= a.min_features;

  // DT_init: the previous increment where the motion model holds it good
  float ev[6];
  if (a.use_motion_model) {
    eigvalsh6(a.cov_prev + (size_t)b * 36, sh, ev);
    if (threadIdx.x == 0) {
      const float* Tp = a.DT_prev + (size_t)b * 16;
      if (is_good(Tp, ev, a.err_prev[b]))
        for (int k = 0; k < 16; ++k) sh.T0[k] = Tp[k];
      else
        set_eye4(sh.T0);
    }
  } else if (threadIdx.x == 0) {
    set_eye4(sh.T0);
  }
  __syncthreads();

  // stage 1
  solve(f, x, a.optim_mode, sh.T0, NEED1, a.max_iters, sh, sh.sol1);
  eigvalsh6(sh.sol1.cov, sh, ev);
  if (threadIdx.x == 0)
    sh.good1 = is_good(sh.sol1.T, ev, sh.sol1.err) ? 1 : 0;
  __syncthreads();
  const bool good1 = sh.good1 != 0;

  bool enough2 = false;
  if (good1) {
    // stage 2a: reject outliers against the stage-1 pose, refine from
    // DT_init
    if (threadIdx.x == 0)
      for (int k = 0; k < 16; ++k) sh.T[k] = sh.sol1.T[k];
    __syncthreads();
    for (int i = threadIdx.x; i < Np; i += blockDim.x)
      f.pr[i] = point_norm(sh.T, x.cam, f.px[i], f.py[i], f.pz[i], f.pu[i],
                           f.pv[i]) * f.psq[i];
    for (int i = threadIdx.x; i < Nl; i += blockDim.x) {
      float J[6], ov;
      f.lr[i] = line_term(sh.T, x.cam, x.homog_th, f.line(i), false, J, ov)
                * f.lsq[i];
    }
    __syncthreads();
    reject_outliers(f.pr, f.pf, Np, a.inlier_k, a.has_points != 0, sh);
    reject_outliers(f.lr, f.lf, Nl, a.inlier_k, a.has_lines != 0, sh);
    int np2, nl2;
    count2(f, NEED2, sh, np2, nl2);
    enough2 = np2 + nl2 >= a.min_features;
    solve(f, x, a.optim_mode, sh.T0, NEED2, a.max_iters_ref, sh, sh.sol2);
    if (!enough2 && threadIdx.x == 0) {
      set_eye4(sh.sol2.T);
      for (int k = 0; k < 36; ++k) sh.sol2.cov[k] = 0.0f;
      sh.sol2.err = -1.0f;
    }
  } else {
    // stage 2b: robust GN from DT_init
    gauss_newton(f, x, sh.T0, NEED1, a.max_iters_ref, true, sh, sh.sol2);
  }
  __syncthreads();

  const bool nontrivial = ((good1 && enough2) || !good1) && enough;
  if (!enough && threadIdx.x == 0) {
    set_eye4(sh.sol2.T);
    for (int k = 0; k < 36; ++k) sh.sol2.cov[k] = 0.0f;
    sh.sol2.err = -1.0f;
  }
  __syncthreads();
  eigvalsh6(sh.sol2.cov, sh, ev);

  const bool took_refine = good1 && enough;
  if (threadIdx.x == 0) {
    const Sol& s = sh.sol2;
    const bool good = is_good(s.T, ev, s.err) && nontrivial;
    float* DT = a.DT + (size_t)b * 16;
    float* cov = a.cov + (size_t)b * 36;
    float* eig = a.eig + (size_t)b * 6;
    if (good) {
      float Ti[16];
      inverse_se3(s.T, Ti);
      renormalize_se3(Ti, DT);
    } else {
      set_eye4(DT);
    }
    for (int k = 0; k < 36; ++k) cov[k] = good ? s.cov[k] : 0.0f;
    for (int k = 0; k < 6; ++k) eig[k] = good ? ev[k] : 0.0f;
    a.err[b] = good ? s.err : -1.0f;
    a.good[b] = good ? 1 : 0;
    a.iters[b] = sh.sol1.iters + s.iters;
  }
  // the output inlier masks and their counts
  const unsigned char bit = took_refine ? F_INLIER2 : F_INLIER;
  double c[2] = {0.0, 0.0};
  for (int i = threadIdx.x; i < Np; i += blockDim.x) {
    const bool in = (f.pf[i] & bit) != 0;
    a.p_inlier_out[(size_t)b * Np + i] = in ? 1 : 0;
    c[0] += (in && (f.pf[i] & F_VALID)) ? 1.0 : 0.0;
  }
  for (int i = threadIdx.x; i < Nl; i += blockDim.x) {
    const bool in = (f.lf[i] & bit) != 0;
    a.l_inlier_out[(size_t)b * Nl + i] = in ? 1 : 0;
    c[1] += (in && (f.lf[i] & F_VALID)) ? 1.0 : 0.0;
  }
  block_sum(c, sh.warp, sh.cnt);
  if (threadIdx.x == 0) {
    a.n_pt[b] = (long long)sh.cnt[0];
    a.n_ls[b] = (long long)sh.cnt[1];
  }
}

// ---------------------------------------------------------------------------
// Host entries
// ---------------------------------------------------------------------------

// The dynamic shared memory a launch needs and the most a block can have
// beside the kernel's static shared memory.
extern "C" int stvo_pose_optim_smem(int Np, int Nl, long long* need,
                                    long long* limit) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, pose_optim_kernel);
  if (e != cudaSuccess) return (int)e;
  *need = (long long)Np * 29 + (long long)Nl * 61;
  *limit = (long long)optin - (long long)attr.sharedSizeBytes;
  return 0;
}

extern "C" int stvo_pose_optim(const PoseOptimArgs* args, void* stream) {
  const PoseOptimArgs& a = *args;
  if (a.B < 1 || a.Np < 0 || a.Nl < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)a.Np * 29 + (size_t)a.Nl * 61;
  // the attribute is set once per device, at the first launch that needs
  // it (the warm-up before a capture)
  static size_t attr_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= 64 || smem > attr_set[dev])) {
    e = cudaFuncSetAttribute(pose_optim_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) attr_set[dev] = smem;
  }
  pose_optim_kernel<<<a.B, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
