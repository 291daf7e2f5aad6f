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
// The sample grid (roi_align_common.cuh::axis_sample) follows
// ops/roi_align.py::axis_samples exactly; the backward kernel
// roi_align_bwd.cu takes its samples from the same function. The routed
// level of each roi is computed by the Python wrapper with the same tensor
// expression the plain version uses, so the two never route a boundary roi
// differently.
//
// Bound on an H100 SXM at the Faster R-CNN slice (B=4, R=1000, out=7,
// ratio=2, C=256, bf16): the output is 100 MB and the feature cells the rois
// touch 136 MB; the f32 products take ~24 us at 67 TFLOP/s. So bytes bound
// it, at ~0.07 ms for 3.35 TB/s.
//
// What held the first version back: one thread carried two channels and
// issued 4 corner loads of 4 bytes for each of the 196 samples, each load
// feeding an FMA before the next was issued, and re-read every cell that
// neighbouring samples share. Latency and instruction count, not bytes, set
// its pace (f32 was only 5% slower than bf16).
//
// Design: the separable form the TPU kernel uses, in the roi's compact
// sample-index space. The ratio samples of a bin touch at most 2 * ratio
// distinct cells along each axis; bin_cells lists
// those cells with the sum of the bilinear weights its samples give them
// (the ratio mean folded into per-axis weights, as roi_align_pallas.py:24-29),
// for every bin and axis of the roi in a prologue. A bin's output is then
// sum_j sum_k wy_j wx_k F[row_j, col_k] with every distinct cell of the bin
// loaded once, as 16 bytes of channels a lane (8 bf16 or 4 f32), so one warp
// spans 256 bf16 channels of a cell; a lane issues 4 loads (kept as raw bits,
// 4 registers each for bf16) before their FMAs. One block per (image, roi),
// 8 warps on different bins; sums in f32, one rounding to the feature dtype
// at the store. No atomics, so the result is deterministic. Rois that share
// cells still read them once each: the design reads a bin's cells, not the
// level's.
//
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W, PERF.md): latency. Its
// time grows with the rois from a small fixed part (0.044 ms at 128 rois an
// image in bf16); at the slice it runs at about 3x its byte bound in bf16
// and 2.3x in f32: each warp's bins are a few rounds of dependent loads.

#include "roi_align_common.cuh"

namespace {

using Levels = roi_align::LevelTable<const void*>;
using roi_align::Axis;
using roi_align::axis_sample;
using roi_align::roi_axis;
using roi_align::sample_grid;
using roi_align::load_vec;
using roi_align::store_vec;

// The separable form of one bin along one axis: the distinct cells that the
// ratio samples of `bin` touch, each with the sum of the bilinear weights the
// samples give it (the ratio mean folded into per-axis weights, as
// roi_align_pallas.py:24-29 does). grid holds sample_grid(i, ratio) for the
// S samples. Returns the count, at most 2 * ratio. A bin's value is then
// sum_j sum_k wy_j wx_k F[row_j, col_k] over its two lists, the plain
// version's sum of products regrouped. A NaN weight stays NaN, so a
// non-finite roi spreads NaN to the cells the plain version does.
__device__ __forceinline__ int bin_cells(const Axis& a, const float* grid, int size, int ratio,
                                         int bin, int* cells, float* weights) {
  int n = 0;
  auto add = [&](int cell, float w) {
    for (int j = 0; j < n; ++j) {
      if (cells[j] == cell) {
        weights[j] += w;
        return;
      }
    }
    cells[n] = cell;
    weights[n] = w;
    ++n;
  };
  for (int k = 0; k < ratio; ++k) {
    int lo, hi;
    float f;
    axis_sample(a, grid[bin * ratio + k], size, &lo, &hi, &f);
    add(lo, 1.0f - f);
    add(hi, f);
  }
  return n;
}

constexpr int kWarps = 8;  // a block's warps, each on its own bins
constexpr int kBatch = 4;  // cells a lane loads before it adds them

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
roi_align_fwd_kernel(Levels levels, const float* __restrict__ rois,
                     const int* __restrict__ roi_level, int num_rois, int channels,
                     int out_size, int ratio, T* __restrict__ out) {
  const int roi = blockIdx.x;  // image * num_rois + r
  const int image = roi / num_rois;
  const int lvl = roi_level[roi];
  const int h = levels.height[lvl];
  const int w = levels.width[lvl];
  const int m = 2 * ratio;  // most cells a bin touches along an axis

  extern __shared__ int smem[];
  int* y_count = smem;
  int* x_count = y_count + out_size;
  int* y_cell = x_count + out_size;
  int* x_cell = y_cell + out_size * m;
  float* y_wt = reinterpret_cast<float*>(x_cell + out_size * m);
  float* x_wt = y_wt + out_size * m;
  float* grid = x_wt + out_size * m;  // sample_grid of the S samples

  for (int i = threadIdx.x; i < out_size * ratio; i += blockDim.x) grid[i] = sample_grid(i, ratio);
  __syncthreads();
  const float* box = rois + static_cast<size_t>(roi) * 4;
  const float scale = levels.scale[lvl];
  for (int t = threadIdx.x; t < 2 * out_size; t += blockDim.x) {
    if (t < out_size) {
      y_count[t] = bin_cells(roi_axis(box[1], box[3], scale, out_size), grid, h, ratio, t,
                             y_cell + t * m, y_wt + t * m);
    } else {
      const int p = t - out_size;
      x_count[p] = bin_cells(roi_axis(box[0], box[2], scale, out_size), grid, w, ratio, p,
                             x_cell + p * m, x_wt + p * m);
    }
  }
  __syncthreads();

  const T* feat = static_cast<const T*>(levels.data[lvl]) +
                  static_cast<size_t>(image) * h * w * channels;
  T* dst = out + static_cast<size_t>(roi) * out_size * out_size * channels;
  const float count = static_cast<float>(ratio * ratio);
  const int groups = channels / VEC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int bin = warp; bin < out_size * out_size; bin += kWarps) {
    const int ph = bin / out_size;
    const int pw = bin % out_size;
    const int nx = x_count[pw];
    const int items = y_count[ph] * nx;  // the bin's distinct cells, row-major
    const int* yc = y_cell + ph * m;
    const int* xc = x_cell + pw * m;
    const float* yw = y_wt + ph * m;
    const float* xw = x_wt + pw * m;
    for (int g = lane; g < groups; g += 32) {
      const T* base = feat + g * VEC;
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
      int j0 = 0, k0 = 0;  // the row and column of item i0
      for (int i0 = 0; i0 < items; i0 += kBatch) {
        roi_align::Vec<T, VEC> v[kBatch];
        float wgt[kBatch];
        int j = j0, k = k0;
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (i0 + b < items) {
            v[b] = load_vec<T, VEC>(base + (static_cast<size_t>(yc[j]) * w + xc[k]) * channels);
            wgt[b] = yw[j] * xw[k];
            if (++k == nx) {
              k = 0;
              ++j;
            }
          }
        }
        j0 = j;
        k0 = k;
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (i0 + b < items) {
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[q] += wgt[b] * v[b][q];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = acc[q] / count;
      store_vec<T, VEC>(dst + static_cast<size_t>(bin) * channels + g * VEC, acc);
    }
  }
}

template <typename T, int VEC>
void launch(const Levels& levels, const float* rois, const int* roi_level, int num_blocks,
            int num_rois, int channels, int out_size, int ratio, void* out, cudaStream_t stream) {
  const size_t smem = (2 * out_size + 4 * out_size * 2 * ratio + out_size * ratio) * sizeof(int);
  roi_align_fwd_kernel<T, VEC><<<num_blocks, kWarps * 32, smem, stream>>>(
      levels, rois, roi_level, num_rois, channels, out_size, ratio, static_cast<T*>(out));
}

template <typename T>
bool dispatch(int vec, const Levels& levels, const float* rois, const int* roi_level,
              int num_blocks, int num_rois, int channels, int out_size, int ratio, void* out,
              cudaStream_t st) {
  switch (vec) {
    case 1: launch<T, 1>(levels, rois, roi_level, num_blocks, num_rois, channels, out_size, ratio, out, st); return true;
    case 2: launch<T, 2>(levels, rois, roi_level, num_blocks, num_rois, channels, out_size, ratio, out, st); return true;
    case 4: launch<T, 4>(levels, rois, roi_level, num_blocks, num_rois, channels, out_size, ratio, out, st); return true;
    case 8:
      if constexpr (sizeof(T) == 2) {
        launch<T, 8>(levels, rois, roi_level, num_blocks, num_rois, channels, out_size, ratio, out, st);
        return true;
      }
      return false;
    default: return false;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. feats, heights, widths and scales are
// host arrays of num_levels entries; feats holds device pointers to
// (batch, H_l, W_l, channels) contiguous maps. rois (batch, num_rois, 4) f32,
// roi_level (batch, num_rois) int32 and out (batch, num_rois, out, out,
// channels) are device pointers. vec is the channels a load (1, 2, 4, or 8
// for bf16): it divides channels, and every feature pointer and out is
// aligned to vec elements. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int roi_align_fwd(int dtype, int num_levels, const void* const* feats,
                             const int* heights, const int* widths, const float* scales,
                             const float* rois, const int* roi_level, int batch,
                             int num_rois, int channels, int out_size, int ratio,
                             int vec, void* out, void* stream) {
  if (num_levels < 1 || num_levels > roi_align::kMaxLevels || batch < 1 || num_rois < 1 ||
      channels < 1 || out_size < 1 || ratio < 1 || vec < 1 || channels % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Levels levels = roi_align::make_levels(num_levels, feats, heights, widths, scales);
  const int num_blocks = batch * num_rois;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0) {
    ok = dispatch<float>(vec, levels, rois, roi_level, num_blocks, num_rois, channels, out_size,
                         ratio, out, st);
  } else if (dtype == 1) {
    ok = dispatch<__nv_bfloat16>(vec, levels, rois, roi_level, num_blocks, num_rois, channels,
                                 out_size, ratio, out, st);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
