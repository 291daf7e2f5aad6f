// FPN RoIAlign backward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel torch_detection_tpu/ops/roi_align_pallas.py::
// _roi_window_bwd_pallas (K2), the transpose of the forward: each roi's
// output cotangent g[bin, c], divided by the ratio x ratio sample count, is
// spread over the four bilinear corners of every sample of the bin, on the
// roi's routed level. Rois that overlap add up. The sample grid is the
// forward's (roi_align_common.cuh::axis_sample), so the kernel is the exact
// transpose of roi_align_fwd.cu for every roi, also outside the TPU path's
// 39-cell window. The TPU kernel's transposed pyramid, its serialized
// read-modify-write DMA and its crop-shape set are Mosaic's rules and are not
// carried over. The routed levels are the ones the forward used, computed by
// the Python wrapper.
//
// Design: one block per (image, roi), one launch for the whole batch and all
// levels. Threads run across channels, two per thread (float2 or
// __nv_bfloat162 loads of the cotangent) or one when C is odd. Every corner
// receives g / count * weight by an f32 atomicAdd into a float32 accumulator
// per level, which the wrapper zero-fills and, for bf16 features, casts to
// the feature dtype afterwards. The atomics make the order of the f32 sums
// vary from run to run.
//
// Bound on an H100 SXM at the training slice (B=4, R=512, out=7, ratio=2,
// C=256, bf16): the cotangent read once is 51.4 MB, the level gradients
// written once 165.4 MB (82.7 M cells of P2-P5), 216.8 MB in all, 0.065 ms
// at 3.35 TB/s; the 0.82 GFLOP of f32 products take 0.012 ms. So bytes bound
// it. This simple kernel also pays for the f32 accumulator's zero fill
// (331 MB), the atomics' read-modify-write traffic and the cast pass.
// Staging a roi's window in shared memory and flushing it once, or sorting
// the rois by level and tiling, is the work of a later change.

#include "roi_align_common.cuh"

namespace {

using Levels = roi_align::LevelTable<void*>;
using roi_align::axis_sample;
using roi_align::load_f32;
using roi_align::load_f32x2;

template <typename T, bool kPairs>
__global__ void roi_align_bwd_kernel(Levels levels, const float* __restrict__ rois,
                                     const int* __restrict__ roi_level, int num_rois,
                                     int channels, int out_size, int ratio,
                                     const T* __restrict__ grad) {
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

  float* acc = static_cast<float*>(levels.data[lvl]) +
               static_cast<size_t>(image) * h * w * channels;
  const T* g = grad + static_cast<size_t>(roi) * out_size * out_size * channels;
  const float count = static_cast<float>(ratio * ratio);
  constexpr int kVec = kPairs ? 2 : 1;

  for (int c = threadIdx.x * kVec; c < channels; c += blockDim.x * kVec) {
    for (int ph = 0; ph < out_size; ++ph) {
      for (int pw = 0; pw < out_size; ++pw) {
        const T* gp = g + (ph * out_size + pw) * channels + c;
        float g0, g1 = 0.0f;
        if constexpr (kPairs) {
          const float2 v = load_f32x2(gp);
          g0 = v.x / count;
          g1 = v.y / count;
        } else {
          g0 = load_f32(gp) / count;
        }
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
            float* p00 = acc + (row0 + x_lo[sx]) * channels + c;
            float* p01 = acc + (row0 + x_hi[sx]) * channels + c;
            float* p10 = acc + (row1 + x_lo[sx]) * channels + c;
            float* p11 = acc + (row1 + x_hi[sx]) * channels + c;
            atomicAdd(p00, g0 * uy * ux);
            atomicAdd(p01, g0 * uy * tx);
            atomicAdd(p10, g0 * ty * ux);
            atomicAdd(p11, g0 * ty * tx);
            if constexpr (kPairs) {
              atomicAdd(p00 + 1, g1 * uy * ux);
              atomicAdd(p01 + 1, g1 * uy * tx);
              atomicAdd(p10 + 1, g1 * ty * ux);
              atomicAdd(p11 + 1, g1 * ty * tx);
            }
          }
        }
      }
    }
  }
}

template <typename T>
void launch(bool pairs, const Levels& levels, const float* rois, const int* roi_level,
            int num_blocks, int num_rois, int channels, int out_size, int ratio,
            const T* grad, cudaStream_t stream) {
  const int threads = roi_align::block_threads(channels, pairs);
  const size_t smem = roi_align::sample_table_bytes(out_size, ratio);
  if (pairs) {
    roi_align_bwd_kernel<T, true><<<num_blocks, threads, smem, stream>>>(
        levels, rois, roi_level, num_rois, channels, out_size, ratio, grad);
  } else {
    roi_align_bwd_kernel<T, false><<<num_blocks, threads, smem, stream>>>(
        levels, rois, roi_level, num_rois, channels, out_size, ratio, grad);
  }
}

}  // namespace

// dtype (of the cotangent): 0 = float32, 1 = bfloat16. accums, heights,
// widths and scales are host arrays of num_levels entries; accums holds
// device pointers to zero-filled (batch, H_l, W_l, channels) float32 maps,
// which receive the gradient. rois (batch, num_rois, 4) f32, roi_level
// (batch, num_rois) int32 and grad (batch, num_rois, out, out, channels) are
// device pointers. use_pairs needs an even channel count and grad aligned to
// two elements. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int roi_align_bwd(int dtype, int num_levels, void* const* accums,
                             const int* heights, const int* widths, const float* scales,
                             const float* rois, const int* roi_level, int batch,
                             int num_rois, int channels, int out_size, int ratio,
                             int use_pairs, const void* grad, void* stream) {
  if (num_levels < 1 || num_levels > roi_align::kMaxLevels || batch < 1 || num_rois < 1 ||
      channels < 1 || out_size < 1 || ratio < 1 || (use_pairs && channels % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Levels levels = roi_align::make_levels(num_levels, accums, heights, widths, scales);
  const int num_blocks = batch * num_rois;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(use_pairs != 0, levels, rois, roi_level, num_blocks, num_rois, channels,
                  out_size, ratio, static_cast<const float*>(grad), st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(use_pairs != 0, levels, rois, roi_level, num_blocks, num_rois,
                          channels, out_size, ratio, static_cast<const __nv_bfloat16*>(grad),
                          st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
