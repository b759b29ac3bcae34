// Element types of the port's maps: float, or bf16 (__nv_bfloat16), the
// JAX package's serving dtype. A kernel templated on the map's type T loads
// and stores T and computes in fp32 between the rounding points it names;
// rnd<T> is such a point (the identity for float, so a float form compiles
// to the code it had before the template).
//
// Four consecutive channels move in one access: a float4 (16 bytes) for
// float, a uint2 (8 bytes) of four bf16 for bf16, so the indexing in units
// of four channels is the same for both. load8 moves eight bf16 channels
// in 16 bytes (a uint4); loadv<N> / storev<N> move N channels in one access
// of N * sizeof(T) bytes, whichever of these widths that is. A bf16 is the
// upper half of a float's bits: widening is a shift, narrowing
// __float2bfloat16_rn (round to nearest even).
#pragma once

#include <type_traits>
#ifndef DYNMM_EMULATED
#include <cuda_bf16.h>
#endif

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <class T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// v rounded to T's precision, as a float
template <class T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// bf16 pair packed in 32 bits (element 0 low) <-> floats
__device__ __forceinline__ float bf_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ unsigned bf_pack(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// p[0..3] as floats: 16-byte aligned for float, 8-byte for bf16
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
}

// p[0..3] = v (rounded for bf16); ``stream``: a streaming store (st.cs)
__device__ __forceinline__ void store4(float* p, float4 v,
                                       bool stream = false) {
  if (stream) {
    __stcs(reinterpret_cast<float4*>(p), v);
  } else {
    *reinterpret_cast<float4*>(p) = v;
  }
}
__device__ __forceinline__ void store4(bf16* p, float4 v,
                                       bool stream = false) {
  const uint2 u = make_uint2(bf_pack(v.x, v.y), bf_pack(v.z, v.w));
  if (stream) {
    __stcs(reinterpret_cast<uint2*>(p), u);
  } else {
    *reinterpret_cast<uint2*>(p) = u;
  }
}

// p[0..7] as floats: 16 bytes of bf16, 16-byte aligned
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  v[0] = bf_lo(u.x);
  v[1] = bf_hi(u.x);
  v[2] = bf_lo(u.y);
  v[3] = bf_hi(u.y);
  v[4] = bf_lo(u.z);
  v[5] = bf_hi(u.z);
  v[6] = bf_lo(u.w);
  v[7] = bf_hi(u.w);
}

// p[0..N-1] as floats in one access of N * sizeof(T) bytes (2 to 16),
// aligned to that many bytes
template <int N, class T>
__device__ __forceinline__ void loadv(const T* p, float (&v)[N]) {
  static_assert(N * sizeof(T) <= 16, "one access moves at most 16 bytes");
  if constexpr (N == 8) {
    load8(p, v);
  } else if constexpr (N == 4) {
    const float4 f = load4(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else if constexpr (N == 2 && std::is_same<T, float>::value) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  } else if constexpr (N == 2) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    v[0] = bf_lo(u);
    v[1] = bf_hi(u);
  } else {
    v[0] = to_f(*p);
  }
}

// p[0..N-1] = v (rounded for bf16) in one access; N = 4, or 8 for bf16
template <int N, class T>
__device__ __forceinline__ void storev(T* p, const float (&v)[N]) {
  static_assert(N == 4 || (N == 8 && sizeof(T) == 2), "4 or 8 bf16 channels");
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(bf_pack(v[0], v[1]), bf_pack(v[2], v[3]),
                   bf_pack(v[4], v[5]), bf_pack(v[6], v[7]));
  } else {
    store4(p, make_float4(v[0], v[1], v[2], v[3]));
  }
}
