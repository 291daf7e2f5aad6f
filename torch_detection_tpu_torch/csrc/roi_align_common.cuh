// What the RoIAlign forward (roi_align_fwd.cu) and backward (roi_align_bwd.cu)
// kernels share: the level table, loads and stores of a vector of VEC
// channels in the feature dtype, and the sample grid along one axis. Both
// kernels take their sample positions from the same axis_sample, so the
// backward is the exact transpose of the forward.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace roi_align {

constexpr int kMaxLevels = 8;

// Per level: a device pointer P to its (batch, H, W, channels) contiguous map
// (the features for the forward, the gradient for the backward), its extent
// and 1 / stride. Every roi's level index is in range: the wrapper routes a
// non-finite roi to level 0.
template <typename P>
struct LevelTable {
  P data[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];
};

template <typename P>
inline LevelTable<P> make_levels(int num_levels, P const* ptrs, const int* heights,
                                 const int* widths, const float* scales) {
  LevelTable<P> levels = {};
  for (int l = 0; l < num_levels; ++l) {
    levels.data[l] = ptrs[l];
    levels.height[l] = heights[l];
    levels.width[l] = widths[l];
    levels.scale[l] = scales[l];
  }
  return levels;
}

// The unsigned type of `bytes` bytes, for one load or store of a channel
// vector: 16 bytes is 8 bf16 or 4 f32 channels.
template <int bytes> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// VEC channels of T as loaded, in the registers of their raw bits (4 for 8
// bf16 channels, not 8 floats); v[k] converts channel k to float.
template <typename T, int VEC>
struct Vec {
  typename Raw<sizeof(T) * VEC>::type raw;
  __device__ __forceinline__ float operator[](int k) const {
    return to_f32(reinterpret_cast<const T*>(&raw)[k]);
  }
};

// VEC channels at p (aligned to VEC elements), in one load.
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load_vec(const T* p) {
  return Vec<T, VEC>{*reinterpret_cast<const typename Raw<sizeof(T) * VEC>::type*>(p)};
}

// VEC floats rounded to T and stored at p (aligned to VEC elements), in one
// store.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  R raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < VEC; ++k) from_f32(&e[k], v[k]);
  *reinterpret_cast<R*>(p) = raw;
}

// One axis of a roi at its level: its start in level cells and the width of
// a bin.
struct Axis {
  float lo, bin;
};

// Index arithmetic follows ops/roi_align.py::axis_samples exactly (see
// axis_sample). Round-to-nearest intrinsics keep nvcc from contracting the
// coordinate into FMAs, matching the plain version's separate multiply and
// add.
__device__ __forceinline__ Axis roi_axis(float lo_img, float hi_img, float scale, int out_size) {
  const float lo = __fmul_rn(lo_img, scale);
  const float hi = __fmul_rn(hi_img, scale);
  const float extent = fmaxf(__fsub_rn(hi, lo), 1.0f);
  return Axis{lo, __fdiv_rn(extent, static_cast<float>(out_size))};
}

// Where sample i of a bin row or column lies inside the roi, in bins:
// (i + 0.5) / ratio.
__device__ __forceinline__ float sample_grid(int i, int ratio) {
  return __fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f), static_cast<float>(ratio));
}

// One sample along one axis: lower/upper cell index and the fractional
// weight of the upper cell, at `grid` (sample_grid) of axis a. The weight
// comes from the unclamped floor, the indices are clamped to [0, size-1],
// and the upper index is the clamped lower index + 1, clamped again. The
// coordinate grows with the sample, so both indices are non-decreasing in
// it: samples 0 and S-1 bound every cell a roi touches along the axis.
__device__ __forceinline__ void axis_sample(const Axis& a, float grid, int size, int* lo_idx,
                                            int* hi_idx, float* frac) {
  const float c = __fadd_rn(a.lo, __fmul_rn(a.bin, grid));
  const float c0 = floorf(c);
  // clamp in float before the conversion: equal to the int clamp for every
  // finite coordinate, and defined for any input
  const int i0 = static_cast<int>(fminf(fmaxf(c0, 0.0f), static_cast<float>(size - 1)));
  *lo_idx = i0;
  *hi_idx = min(i0 + 1, size - 1);
  *frac = __fsub_rn(c, c0);
}

}  // namespace roi_align
