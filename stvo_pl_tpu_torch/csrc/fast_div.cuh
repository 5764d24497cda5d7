// Division by a divisor known only at run time, for the kernels' index
// arithmetic: x / d for 0 <= x < 2^31 by one 32 x 32 -> 64-bit product and
// a shift, with m = ceil(2^(31 + l) / d) and l = ceil(log2 d), computed on
// the host (Granlund and Montgomery, "Division by invariant integers using
// multiplication", theorem 4.2).  tests/test_torch_kernel_designs.py holds
// the formula to integer division.

#pragma once

struct Div {
  unsigned d, m;
  int l;
};

inline Div make_div(unsigned d) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  return Div{d, (unsigned)(((1ull << (31 + l)) + d - 1) / d), l};
}

__device__ __forceinline__ unsigned div_of(unsigned x, const Div& v) {
  return (unsigned)(((unsigned long long)x * v.m) >> (31 + v.l));
}
