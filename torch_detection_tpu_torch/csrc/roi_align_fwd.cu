// FPN RoIAlign forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel torch_detection_tpu/ops/roi_align_pallas.py::
// _roi_window_interp_pallas (K1). It computes the semantics of the gather
// oracle torch_detection_tpu/ops/roi_align.py::multilevel_roi_align directly
// from the NHWC level maps: every roi is sampled on an (out*ratio)^2 grid at
// sub-bin centres (i + 0.5) / ratio of its routed level, bilinear with a
// border clamp, and each ratio x ratio group is averaged. The Mosaic tiling
// machinery of the TPU kernel (flattened transposed pyramid, 8-alignment,
// crop-shape set, roi grouping) is not carried over. Inside the TPU path's
// contract (a roi spans <= 39 cells at its level) the two are identical;
// outside it this kernel stays exact, where the TPU path clamps to its window.
//
// Index arithmetic follows ops/roi_align.py::_bilinear_sample exactly: the
// weights come from the unclamped floor, the indices are clamped to
// [0, size-1], and the upper index is the clamped lower index + 1, clamped
// again. Coordinates use round-to-nearest intrinsics so nvcc cannot contract
// them into FMAs, matching the plain version's separate multiply and add.
// The routed level of each roi is computed by the Python wrapper with the
// same tensor expression the plain version uses, so the two never route a
// boundary roi differently.
//
// Design: one block per (image, roi), one launch for the whole batch and all
// levels. Threads run across channels, two channels per thread (float2 or
// __nv_bfloat162 loads, so a warp reads a contiguous run of a corner's
// channel vector) or one when C is odd. Bins and sub-samples loop in
// registers with f32 accumulation, and each output element is stored once in
// the feature dtype. No atomics, so the result is deterministic.
//
// Bound on an H100 SXM at the Faster R-CNN slice (B=4, R=1000, out=7,
// ratio=2, C=256, bf16): the output is 100 MB, and the feature cells the
// rois touch are at most the 165 MB of P2-P5; the 4 f32 FMAs per sample and
// channel come to ~1.6 GFLOP, ~24 us at 67 TFLOP/s. So bytes bound it: on
// the order of 30-80 us at 3.35 TB/s. This simple kernel re-reads each
// corner from L1/L2 for every sample; staging a roi's window in shared
// memory with cp.async or TMA is the work of a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;

struct Levels {
  const void* feat[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];
};

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

template <typename T, bool kPairs>
__global__ void roi_align_fwd_kernel(Levels levels, const float* __restrict__ rois,
                                     const int* __restrict__ roi_level, int num_rois,
                                     int channels, int out_size, int ratio,
                                     T* __restrict__ out) {
  const int roi = blockIdx.x;  // image * num_rois + r
  const int image = roi / num_rois;
  const int lvl = roi_level[roi];
  const int h = levels.height[lvl];
  const int w = levels.width[lvl];
  const int S = out_size * ratio;

  extern __shared__ unsigned char smem[];
  int* y_lo = reinterpret_cast<int*>(smem);
  int* y_hi = y_lo + S;
  int* x_lo = y_hi + S;
  int* x_hi = x_lo + S;
  float* y_frac = reinterpret_cast<float*>(x_hi + S);
  float* x_frac = y_frac + S;

  const float* box = rois + static_cast<size_t>(roi) * 4;
  for (int t = threadIdx.x; t < 2 * S; t += blockDim.x) {
    if (t < S) {
      axis_sample(box[1], box[3], levels.scale[lvl], h, out_size, ratio, t,
                  &y_lo[t], &y_hi[t], &y_frac[t]);
    } else {
      axis_sample(box[0], box[2], levels.scale[lvl], w, out_size, ratio, t - S,
                  &x_lo[t - S], &x_hi[t - S], &x_frac[t - S]);
    }
  }
  __syncthreads();

  const T* feat = static_cast<const T*>(levels.feat[lvl]) +
                  static_cast<size_t>(image) * h * w * channels;
  T* dst = out + static_cast<size_t>(roi) * out_size * out_size * channels;
  const float count = static_cast<float>(ratio * ratio);
  constexpr int kVec = kPairs ? 2 : 1;

  for (int c = threadIdx.x * kVec; c < channels; c += blockDim.x * kVec) {
    for (int ph = 0; ph < out_size; ++ph) {
      for (int pw = 0; pw < out_size; ++pw) {
        float acc0 = 0.0f, acc1 = 0.0f;
        for (int iy = 0; iy < ratio; ++iy) {
          const int sy = ph * ratio + iy;
          const size_t row0 = static_cast<size_t>(y_lo[sy]) * w;
          const size_t row1 = static_cast<size_t>(y_hi[sy]) * w;
          const float ty = y_frac[sy];
          const float uy = 1.0f - ty;
          for (int ix = 0; ix < ratio; ++ix) {
            const int sx = pw * ratio + ix;
            const float tx = x_frac[sx];
            const float ux = 1.0f - tx;
            const T* p00 = feat + (row0 + x_lo[sx]) * channels + c;
            const T* p01 = feat + (row0 + x_hi[sx]) * channels + c;
            const T* p10 = feat + (row1 + x_lo[sx]) * channels + c;
            const T* p11 = feat + (row1 + x_hi[sx]) * channels + c;
            if constexpr (kPairs) {
              const float2 f00 = load_f32x2(p00), f01 = load_f32x2(p01);
              const float2 f10 = load_f32x2(p10), f11 = load_f32x2(p11);
              acc0 += f00.x * uy * ux + f01.x * uy * tx + f10.x * ty * ux + f11.x * ty * tx;
              acc1 += f00.y * uy * ux + f01.y * uy * tx + f10.y * ty * ux + f11.y * ty * tx;
            } else {
              acc0 += load_f32(p00) * uy * ux + load_f32(p01) * uy * tx +
                      load_f32(p10) * ty * ux + load_f32(p11) * ty * tx;
            }
          }
        }
        T* o = dst + (ph * out_size + pw) * channels + c;
        if constexpr (kPairs) {
          store_f32x2(o, make_float2(acc0 / count, acc1 / count));
        } else {
          store_f32(o, acc0 / count);
        }
      }
    }
  }
}

template <typename T>
void launch(bool pairs, const Levels& levels, const float* rois, const int* roi_level,
            int num_blocks, int num_rois, int channels, int out_size, int ratio, T* out,
            cudaStream_t stream) {
  const int work = pairs ? channels / 2 : channels;
  const int threads = min(256, max(32, (work + 31) / 32 * 32));
  const size_t smem = 6 * static_cast<size_t>(out_size) * ratio * sizeof(int);
  if (pairs) {
    roi_align_fwd_kernel<T, true><<<num_blocks, threads, smem, stream>>>(
        levels, rois, roi_level, num_rois, channels, out_size, ratio, out);
  } else {
    roi_align_fwd_kernel<T, false><<<num_blocks, threads, smem, stream>>>(
        levels, rois, roi_level, num_rois, channels, out_size, ratio, out);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. feats, heights, widths and scales are
// host arrays of num_levels entries; feats holds device pointers to
// (batch, H_l, W_l, channels) contiguous maps. rois (batch, num_rois, 4) f32,
// roi_level (batch, num_rois) int32 and out (batch, num_rois, out, out,
// channels) are device pointers. use_pairs needs an even channel count and
// every feature pointer aligned to two elements. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int roi_align_fwd(int dtype, int num_levels, const void* const* feats,
                             const int* heights, const int* widths, const float* scales,
                             const float* rois, const int* roi_level, int batch,
                             int num_rois, int channels, int out_size, int ratio,
                             int use_pairs, void* out, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || batch < 1 || num_rois < 1 ||
      channels < 1 || out_size < 1 || ratio < 1 || (use_pairs && channels % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels levels = {};
  for (int l = 0; l < num_levels; ++l) {
    levels.feat[l] = feats[l];
    levels.height[l] = heights[l];
    levels.width[l] = widths[l];
    levels.scale[l] = scales[l];
  }
  const int num_blocks = batch * num_rois;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(use_pairs != 0, levels, rois, roi_level, num_blocks, num_rois, channels,
                  out_size, ratio, static_cast<float*>(out), st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(use_pairs != 0, levels, rois, roi_level, num_blocks, num_rois,
                          channels, out_size, ratio, static_cast<__nv_bfloat16*>(out), st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
