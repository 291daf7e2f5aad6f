// What the RoIAlign forward (roi_align_fwd.cu) and backward (roi_align_bwd.cu)
// kernels share: the level table, the loads and stores in the feature dtype,
// the sample grid along one axis, and the launch geometry. Both kernels take
// their sample positions from the same axis_sample, so the backward is the
// exact transpose of the forward.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace roi_align {

constexpr int kMaxLevels = 8;

// Per level: a device pointer P to its (batch, H, W, channels) contiguous map
// (the features for the forward, the f32 gradient accumulator for the
// backward), its extent and 1 / stride. Every roi's level index is in range:
// the wrapper routes a non-finite roi to level 0.
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

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float2 load_f32x2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_f32x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_f32x2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store_f32x2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

// One axis of the sample grid: lower/upper cell index and the fractional
// weight of the upper cell, for sample i of S along [lo, hi) of a roi.
// Index arithmetic follows ops/roi_align.py::axis_samples exactly: the
// weight comes from the unclamped floor, the indices are clamped to
// [0, size-1], and the upper index is the clamped lower index + 1, clamped
// again. Round-to-nearest intrinsics keep nvcc from contracting the
// coordinate into FMAs, matching the plain version's separate multiply and
// add.
__device__ __forceinline__ void axis_sample(float lo_img, float hi_img, float scale,
                                            int size, int out_size, int ratio, int i,
                                            int* lo_idx, int* hi_idx, float* frac) {
  const float lo = __fmul_rn(lo_img, scale);
  const float hi = __fmul_rn(hi_img, scale);
  const float extent = fmaxf(__fsub_rn(hi, lo), 1.0f);
  const float bin = __fdiv_rn(extent, static_cast<float>(out_size));
  const float grid = __fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f), static_cast<float>(ratio));
  const float c = __fadd_rn(lo, __fmul_rn(bin, grid));
  const float c0 = floorf(c);
  // clamp in float before the conversion: equal to the int clamp for every
  // finite coordinate, and defined for any input
  const int i0 = static_cast<int>(fminf(fmaxf(c0, 0.0f), static_cast<float>(size - 1)));
  *lo_idx = i0;
  *hi_idx = min(i0 + 1, size - 1);
  *frac = __fsub_rn(c, c0);
}

// Shared memory a block needs for its roi's sample table: the lower and
// upper row and column indices and the upper cells' weights, S = out_size *
// ratio entries each.
inline size_t sample_table_bytes(int out_size, int ratio) {
  return 6 * static_cast<size_t>(out_size) * ratio * sizeof(int);
}

// Threads a block: one per channel (or channel pair), a multiple of 32,
// at least 32 and at most 256.
inline int block_threads(int channels, bool pairs) {
  const int work = pairs ? channels / 2 : channels;
  return std::min(256, std::max(32, (work + 31) / 32 * 32));
}

}  // namespace roi_align
