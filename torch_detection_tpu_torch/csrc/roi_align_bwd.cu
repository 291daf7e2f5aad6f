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
// Bound on an H100 SXM at the training slice (B=4, R=512, out=7, ratio=2,
// C=256, bf16): the cotangent read once is 51.4 MB, the level gradients
// written once 165.4 MB (82.7 M cells of P2-P5), 216.8 MB in all, 0.065 ms
// at 3.35 TB/s; the 0.82 GFLOP of f32 products take 0.012 ms. So bytes bound
// it.
//
// What held the first version back: one block per roi sent every sample
// corner to an f32 atomicAdd in device memory, 411 M atomics a step at about
// 0.3 G a ms, into a float32 buffer for all levels (331 MB) that the wrapper
// zero-filled before and, for bf16, cast afterwards: about 1 GB moved for a
// 0.22 GB result, and serialized wherever sampled rois overlap.
//
// Design: output-stationary, no atomics. Three kernels on the stream:
//
// 1. For every roi, its two axes and its footprint at its level: the cells
//    of samples 0 and S-1. axis_sample is non-decreasing in the sample, so
//    these bound every cell the roi touches, also for a padded all-zero roi
//    (cells 0..1), a NaN roi (clamped to cells 0..1, which get NaN as in the
//    plain version) and a roi larger than its level. Each roi also adds an
//    estimate of its items to the work of every tile it meets.
// 2. One block orders the tiles by the power of two of their work, largest
//    first (a bucket sort).
// 3. One block a tile: 8 x 8 cells of one (image, level) and 256 channels.
//    Warp w owns tile row w and keeps its 8 cells x 8 channels a lane of f32
//    sums in registers. The block walks the image's rois in index order,
//    256 at a time: four integer compares a roi find those routed to its
//    level whose footprint meets the tile, compacted in order with their
//    axes. For 16 hits at a time the block computes, one (hit, bin, axis) a
//    thread, each bin column's folded weights on the tile's 8 columns and
//    each bin row's on its 8 rows (the ratio samples summed, as the forward's
//    bin_cells does). Each warp lists its row's (hit, bin row, bin
//    column) items, loads their cotangent vectors four at a time (16 bytes a
//    lane: 8 bf16 or 4 f32 channels), and adds each to the cells it reaches
//    with 64 independent FMAs a lane, skipping the cells its weights leave at
//    exactly zero. At the end each tile is written once, zeros included, in
//    the cotangent's dtype with 16-byte stores.
//
// The sums of a cell run in a fixed order whatever the launch order, so K2 is
// bitwise deterministic. The wrapper allocates the gradients with
// torch.empty: there is no fill, no f32 buffer and no cast.
//
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W, PERF.md): latency, at
// about 5x its byte bound in bf16. A tile is a chain of dependent steps (the
// scan's loads, the tables, the cotangent loads) and 128 registers a thread
// let two blocks reside on an SM. The longest tile sets the kernel's time:
// a tile's rows run in parallel but its rois in sequence, and where many
// rois pile onto a few cells (padded all-zero rois at the origin, or 512
// copies of one roi, 4.3 ms) one warp adds them all. Launching the longest
// tiles first keeps them off the end of the kernel.

#include "roi_align_common.cuh"

namespace {

using Levels = roi_align::LevelTable<void*>;
using roi_align::Axis;
using roi_align::axis_sample;
using roi_align::roi_axis;
using roi_align::sample_grid;
using roi_align::load_vec;
using roi_align::store_vec;

constexpr int kTileH = 8;  // tile rows, one warp each
constexpr int kTileW = 8;  // tile columns, held in each lane's registers
constexpr int kThreads = kTileH * 32;
constexpr int kLaneChannels = 8;  // channels a lane sums for each tile cell
constexpr int kSlice = 32 * kLaneChannels;  // channels a block owns
constexpr int kBatch = 4;   // cotangent vectors a lane loads before it adds them
constexpr int kSub = 16;    // hits whose tables the block holds at once
constexpr int kItems = 64;  // a warp's (hit, bin) list, in windows of this size
static_assert(kSub <= 32, "a warp lists the items of a sub-chunk one lane a hit");

// Which tiles belong to which level: tiles [first, first + count) cover
// level l as (image, tile row, tile column). A block is (tile, channel
// slice); the blocks take the tiles in the order the second kernel sets.
struct TileGrid {
  int first[roi_align::kMaxLevels];
  int count[roi_align::kMaxLevels];
  int tiles_y[roi_align::kMaxLevels];
  int tiles_x[roi_align::kMaxLevels];
};

// The first kernel: for every roi its two axes at its routed level
// (x lo, x bin, y lo, y bin) and its footprint there (first row, last row,
// first column, last column: the cells of samples 0 and S-1, which bound
// every cell the roi touches), so that the tiles test rois with four integer
// compares. It also adds the roi's share to the work of each tile it meets:
// an estimate of the items of the tile row that loads the most, bins a row
// times bins inside the tile's columns. A roi whose footprint is a few
// cells (a padded all-zero roi, or one clamped at the border) puts all its
// bins on those cells, so its tile's rows each load every bin.
__global__ void roi_footprint_kernel(Levels levels, TileGrid tiles, const float* __restrict__ rois,
                                     const int* __restrict__ roi_level, int total, int num_rois,
                                     int out_size, int ratio, float4* __restrict__ axes,
                                     int4* __restrict__ footprints, int* __restrict__ work) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= total) return;
  const int lvl = roi_level[r];
  const float4 box = reinterpret_cast<const float4*>(rois)[r];
  const Axis ax = roi_axis(box.x, box.z, levels.scale[lvl], out_size);
  const Axis ay = roi_axis(box.y, box.w, levels.scale[lvl], out_size);
  const float first = sample_grid(0, ratio), last = sample_grid(out_size * ratio - 1, ratio);
  int4 fp;
  int unused;
  float f;
  axis_sample(ay, first, levels.height[lvl], &fp.x, &unused, &f);
  axis_sample(ay, last, levels.height[lvl], &unused, &fp.y, &f);
  axis_sample(ax, first, levels.width[lvl], &fp.z, &unused, &f);
  axis_sample(ax, last, levels.width[lvl], &unused, &fp.w, &f);
  axes[r] = make_float4(ax.lo, ax.bin, ay.lo, ay.bin);
  footprints[r] = fp;

  const int rows = fp.y - fp.x + 1, cols = fp.w - fp.z + 1;
  const int per_row = min(out_size, (out_size + rows - 1) / rows + 1);
  const int base = tiles.first[lvl] + (r / num_rois) * tiles.tiles_y[lvl] * tiles.tiles_x[lvl];
  for (int ty = fp.x / kTileH; ty <= fp.y / kTileH; ++ty) {
    for (int tx = fp.z / kTileW; tx <= fp.w / kTileW; ++tx) {
      const int inside = min(fp.w, tx * kTileW + kTileW - 1) - max(fp.z, tx * kTileW) + 1;
      const int bins = min(out_size, (out_size * inside + cols - 1) / cols + 1);
      atomicAdd(&work[base + ty * tiles.tiles_x[lvl] + tx], per_row * bins);
    }
  }
}

// The second kernel, one block: the tiles in decreasing order of their work's
// power of two, so that the longest tiles start first and do not finish
// after all others. Within a bucket the order is the atomics', which changes
// nothing a block computes.
__global__ void tile_order_kernel(const int* __restrict__ work, int num_tiles,
                                  int* __restrict__ order) {
  __shared__ int count[33], start[33];
  auto bucket = [](int w) { return w > 0 ? 32 - __clz(w) : 0; };
  for (int b = threadIdx.x; b < 33; b += blockDim.x) count[b] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < num_tiles; t += blockDim.x) atomicAdd(&count[bucket(work[t])], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int pos = 0;
    for (int b = 32; b >= 0; --b) {
      start[b] = pos;
      pos += count[b];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < num_tiles; t += blockDim.x) {
    order[atomicAdd(&start[bucket(work[t])], 1)] = t;
  }
}

// The folded weights of the ratio samples of `bin` on the n cells
// [first, first + n) of one axis (n is kTileH or kTileW): the sum of
// (1 - frac) over the samples whose lower cell is there and of frac over
// those whose upper cell is. A cell no sample touches gets exactly 0, one
// that a NaN roi touches NaN.
template <int n>
__device__ __forceinline__ void tile_weights(const Axis& a, const float* grid, int size,
                                             int ratio, int bin, int first, float* out) {
  float wt[n];
#pragma unroll
  for (int c = 0; c < n; ++c) wt[c] = 0.0f;
  for (int k = 0; k < ratio; ++k) {
    int lo, hi;
    float f;
    axis_sample(a, grid[bin * ratio + k], size, &lo, &hi, &f);
#pragma unroll
    for (int c = 0; c < n; ++c) {
      if (lo == first + c) wt[c] += 1.0f - f;
      if (hi == first + c) wt[c] += f;
    }
  }
#pragma unroll
  for (int c = 0; c < n; ++c) out[c] = wt[c];
}

// Shared memory of a block: the chunk's hits (roi index and axes), the
// warps' hit counts, the sample grid, the tables of kSub hits (per hit and
// bin column its weights on the tile's columns and whether any is nonzero;
// per hit and bin row its weights on the tile's rows, over the sample
// count), and per warp a window of its list of (hit, bin row, bin column)
// items.
struct Smem {
  size_t axes, hits, warp_hits, grid, x_any, x_wt, y_wt, items, total;
  __host__ __device__ Smem(int out_size, int ratio) {
    const size_t bins = kSub * static_cast<size_t>(out_size);  // (hit, bin) pairs of a sub-chunk
    axes = 0;
    hits = axes + kThreads * sizeof(float4);
    warp_hits = hits + kThreads * sizeof(int);
    grid = warp_hits + kTileH * sizeof(int);
    x_any = grid + out_size * ratio * sizeof(float);
    x_wt = x_any + bins * sizeof(int);
    y_wt = x_wt + bins * kTileW * sizeof(float);
    items = y_wt + bins * kTileH * sizeof(float);
    total = items + kTileH * kItems * sizeof(int);
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
roi_align_bwd_kernel(Levels levels, TileGrid tiles, int num_levels, const int* __restrict__ order,
                     const float4* __restrict__ roi_axes, const int4* __restrict__ footprints,
                     const int* __restrict__ roi_level, int num_rois, int channels,
                     int out_size, int ratio, const T* __restrict__ grad) {
  constexpr int kGroups = kLaneChannels / VEC;  // channel vectors a lane owns
  const int slices = (channels + kSlice - 1) / kSlice;
  const int tile = order[blockIdx.x / slices];
  const int s = blockIdx.x % slices;
  int lvl = 0;
  for (int l = 0; l < num_levels; ++l) {
    if (tile >= tiles.first[l] && tile < tiles.first[l] + tiles.count[l]) lvl = l;
  }
  int local = tile - tiles.first[lvl];
  const int tx = local % tiles.tiles_x[lvl];
  local /= tiles.tiles_x[lvl];
  const int ty = local % tiles.tiles_y[lvl];
  const int image = local / tiles.tiles_y[lvl];

  const int h = levels.height[lvl];
  const int w = levels.width[lvl];
  const int y0 = ty * kTileH, x0 = tx * kTileW;
  const int y1 = min(y0 + kTileH, h) - 1, x1 = min(x0 + kTileW, w) - 1;  // last cells inside
  const int c0 = s * kSlice;
  const int groups = min(kSlice, channels - c0) / VEC;  // channel vectors of this slice
  const int S = out_size * ratio;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int y = y0 + warp;  // the tile row this warp owns

  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  const Smem layout(out_size, ratio);
  float4* hit_axes = reinterpret_cast<float4*>(base + layout.axes);
  int* hits = reinterpret_cast<int*>(base + layout.hits);
  int* warp_hits = reinterpret_cast<int*>(base + layout.warp_hits);
  float* grid = reinterpret_cast<float*>(base + layout.grid);
  int* x_any = reinterpret_cast<int*>(base + layout.x_any);    // (kSub, out)
  float* x_wt = reinterpret_cast<float*>(base + layout.x_wt);  // (kSub, out, kTileW)
  float* y_wt = reinterpret_cast<float*>(base + layout.y_wt);  // (kSub, out, kTileH)
  int* items = reinterpret_cast<int*>(base + layout.items) + warp * kItems;

  // the sums of this warp's tile row: cell, channel vector, channel
  float acc[kTileW][kGroups][VEC];
#pragma unroll
  for (int c = 0; c < kTileW; ++c) {
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[c][gi][k] = 0.0f;
    }
  }
  for (int i = threadIdx.x; i < S; i += kThreads) grid[i] = sample_grid(i, ratio);
  const float count = static_cast<float>(ratio * ratio);
  const T* g_image = grad + static_cast<size_t>(image) * num_rois * out_size * out_size * channels + c0;

  for (int chunk = 0; chunk < num_rois; chunk += kThreads) {
    // the rois of this chunk routed to lvl whose footprint meets the tile,
    // compacted in index order
    const int r = chunk + threadIdx.x;
    bool hit = false;
    float4 a;
    if (r < num_rois) {
      const size_t at = static_cast<size_t>(image) * num_rois + r;
      const int4 fp = footprints[at];
      a = roi_axes[at];
      hit = roi_level[at] == lvl && fp.x <= y1 && fp.y >= y0 && fp.z <= x1 && fp.w >= x0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
    for (int i = 0; i < kTileH; ++i) {
      offset += i < warp ? warp_hits[i] : 0;
      total += warp_hits[i];
    }
    if (hit) {
      const int at = offset + __popc(ballot & ((1u << lane) - 1u));
      hits[at] = r;
      hit_axes[at] = a;
    }
    __syncthreads();

    for (int sub = 0; sub < total; sub += kSub) {
      const int nsub = min(kSub, total - sub);
      // the tables of hits sub .. sub + nsub, one (hit, bin, axis) a thread
      for (int t = threadIdx.x; t < nsub * 2 * out_size; t += kThreads) {
        const int hh = t / (2 * out_size);
        const int p = t % (2 * out_size);
        const float4 a = hit_axes[sub + hh];
        const int hb = hh * out_size;
        if (p < out_size) {
          float* wx = x_wt + (hb + p) * kTileW;
          tile_weights<kTileW>(Axis{a.x, a.y}, grid, w, ratio, p, x0, wx);
          bool any = false;
#pragma unroll
          for (int c = 0; c < kTileW; ++c) any = any || wx[c] != 0.0f;
          x_any[hb + p] = any;
        } else {
          const int ph = p - out_size;
          float* wy = y_wt + (hb + ph) * kTileH;
          tile_weights<kTileH>(Axis{a.z, a.w}, grid, h, ratio, ph, y0, wy);
#pragma unroll
          for (int c = 0; c < kTileH; ++c) wy[c] = wy[c] / count;
        }
      }
      __syncthreads();

      if (y <= y1) {
        // lane hh lists the items of hit sub + hh on row y: every bin row
        // with a weight there (a NaN weight is kept) times the bin columns
        // with a weight in the tile, a contiguous range as the cells grow
        // with the sample
        int n_items = 0, pw_first = 0, pw_last = -1;
        if (lane < nsub) {
          pw_first = out_size;
          for (int p = 0; p < out_size; ++p) {
            if (x_any[lane * out_size + p]) {
              pw_first = min(pw_first, p);
              pw_last = p;
            }
          }
          int rows = 0;
          for (int ph = 0; ph < out_size; ++ph) rows += y_wt[(lane * out_size + ph) * kTileH + warp] != 0.0f;
          n_items = pw_last >= pw_first ? rows * (pw_last - pw_first + 1) : 0;
        }
        int end_item = n_items;  // inclusive scan over the lanes
        for (int d = 1; d < 32; d *= 2) {
          const int up = __shfl_up_sync(0xffffffffu, end_item, d);
          if (lane >= d) end_item += up;
        }
        const int num_items = __shfl_sync(0xffffffffu, end_item, 31);
        const int first_item = end_item - n_items;
        for (int w0 = 0; w0 < num_items; w0 += kItems) {
          if (n_items > 0 && first_item < w0 + kItems && end_item > w0) {
            int k = first_item;
            for (int ph = 0; ph < out_size; ++ph) {
              if (y_wt[(lane * out_size + ph) * kTileH + warp] == 0.0f) continue;
              for (int pw = pw_first; pw <= pw_last; ++pw, ++k) {
                if (k >= w0 && k < w0 + kItems) items[k - w0] = (lane << 16) | (ph << 8) | pw;
              }
            }
          }
          __syncwarp();
          const int n = min(kItems, num_items - w0);
          for (int i0 = 0; i0 < n; i0 += kBatch) {
            roi_align::Vec<T, VEC> v[kBatch][kGroups];
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
              if (i0 + b < n) {
                const int it = items[i0 + b];
                const T* g = g_image + ((static_cast<size_t>(hits[sub + (it >> 16)]) * out_size +
                                         ((it >> 8) & 255)) * out_size + (it & 255)) * channels;
#pragma unroll
                for (int gi = 0; gi < kGroups; ++gi) {
                  if (lane + 32 * gi < groups) v[b][gi] = load_vec<T, VEC>(g + (lane + 32 * gi) * VEC);
                }
              }
            }
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
              if (i0 + b < n) {
                const int it = items[i0 + b];
                const int hb = (it >> 16) * out_size;
                const float wy = y_wt[(hb + ((it >> 8) & 255)) * kTileH + warp];
                const float* wx = x_wt + (hb + (it & 255)) * kTileW;
#pragma unroll
                for (int c = 0; c < kTileW; ++c) {
                  const float wc = wx[c];
                  if (wc == 0.0f) continue;  // no sample of the bin column on cell c
                  const float sc = wy * wc;
#pragma unroll
                  for (int gi = 0; gi < kGroups; ++gi) {
                    if (lane + 32 * gi < groups) {
#pragma unroll
                      for (int k = 0; k < VEC; ++k) acc[c][gi][k] += v[b][gi][k] * sc;
                    }
                  }
                }
              }
            }
          }
          __syncwarp();
        }
      }
      __syncthreads();
    }
  }

  if (y <= y1) {
    T* dst = static_cast<T*>(levels.data[lvl]) +
             ((static_cast<size_t>(image) * h + y) * w + x0) * channels + c0;
#pragma unroll
    for (int c = 0; c < kTileW; ++c) {
      if (x0 + c > x1) break;
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        if (lane + 32 * gi < groups) {
          store_vec<T, VEC>(dst + static_cast<size_t>(c) * channels + (lane + 32 * gi) * VEC,
                            acc[c][gi]);
        }
      }
    }
  }
}

template <typename T, int VEC>
int launch(const Levels& levels, const TileGrid& tiles, int num_levels, int num_blocks,
           const int* order, const float4* roi_axes, const int4* footprints, const int* roi_level, int num_rois,
           int channels, int out_size, int ratio, const void* grad, cudaStream_t stream) {
  const size_t smem = Smem(out_size, ratio).total;
  auto kernel = roi_align_bwd_kernel<T, VEC>;
  if (smem > 48 * 1024) {  // a large out_size: above 48 KB a block must opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<num_blocks, kThreads, smem, stream>>>(levels, tiles, num_levels, order, roi_axes, footprints,
                                                  roi_level, num_rois, channels, out_size, ratio,
                                                  static_cast<const T*>(grad));
  return 0;
}

template <typename T>
int dispatch(int vec, const Levels& levels, const TileGrid& tiles, int num_levels, int num_blocks,
             const int* order, const float4* roi_axes, const int4* footprints, const int* roi_level, int num_rois,
             int channels, int out_size, int ratio, const void* grad, cudaStream_t st) {
  switch (vec) {
    case 1: return launch<T, 1>(levels, tiles, num_levels, num_blocks, order, roi_axes, footprints, roi_level, num_rois, channels, out_size, ratio, grad, st);
    case 2: return launch<T, 2>(levels, tiles, num_levels, num_blocks, order, roi_axes, footprints, roi_level, num_rois, channels, out_size, ratio, grad, st);
    case 4: return launch<T, 4>(levels, tiles, num_levels, num_blocks, order, roi_axes, footprints, roi_level, num_rois, channels, out_size, ratio, grad, st);
    case 8:
      if constexpr (sizeof(T) == 2) {
        return launch<T, 8>(levels, tiles, num_levels, num_blocks, order, roi_axes, footprints, roi_level, num_rois, channels, out_size, ratio, grad, st);
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tiles of every level, counted as the kernels count them.
TileGrid tile_grid(int num_levels, const int* heights, const int* widths, int batch,
                   int* num_tiles) {
  TileGrid tiles = {};
  int n = 0;
  for (int l = num_levels - 1; l >= 0; --l) {
    tiles.tiles_y[l] = (heights[l] + kTileH - 1) / kTileH;
    tiles.tiles_x[l] = (widths[l] + kTileW - 1) / kTileW;
    tiles.first[l] = n;
    tiles.count[l] = batch * tiles.tiles_y[l] * tiles.tiles_x[l];
    n += tiles.count[l];
  }
  *num_tiles = n;
  return tiles;
}

}  // namespace

// Bytes of the scratch buffer roi_align_bwd needs: the first kernel's axes
// and footprints (32 bytes a roi), then each tile's work and the tiles'
// order (4 bytes a tile each).
extern "C" long long roi_align_bwd_scratch_bytes(int num_levels, const int* heights,
                                                 const int* widths, int batch, int num_rois) {
  if (num_levels < 1 || num_levels > roi_align::kMaxLevels) return -1;
  int num_tiles;
  tile_grid(num_levels, heights, widths, batch, &num_tiles);
  return 32LL * batch * num_rois + 8LL * num_tiles;
}

// dtype (of the cotangent and the gradients): 0 = float32, 1 = bfloat16.
// outs, heights, widths and scales are host arrays of num_levels entries;
// outs holds device pointers to (batch, H_l, W_l, channels) maps, which the
// kernel writes whole (no fill needed). rois (batch, num_rois, 4) f32,
// roi_level (batch, num_rois) int32 and grad (batch, num_rois, out, out,
// channels) are device pointers; rois is aligned to 16 bytes. vec is the
// channels a load (1, 2, 4, or 8 for bf16): it divides channels, and grad
// and every out pointer are aligned to vec elements. scratch is a device
// buffer of roi_align_bwd_scratch_bytes, aligned to 16 bytes. Three kernels
// run on the stream: footprints and tile work, the tile order, the tiles.
// Returns the launches' CUDA error (0 on success).
extern "C" int roi_align_bwd(int dtype, int num_levels, void* const* outs,
                             const int* heights, const int* widths, const float* scales,
                             const float* rois, const int* roi_level, int batch,
                             int num_rois, int channels, int out_size, int ratio,
                             int vec, const void* grad, void* scratch, void* stream) {
  if (num_levels < 1 || num_levels > roi_align::kMaxLevels || batch < 1 || num_rois < 1 ||
      channels < 1 || out_size < 1 || out_size > 255 || ratio < 1 || vec < 1 ||
      channels % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Levels levels = roi_align::make_levels(num_levels, outs, heights, widths, scales);
  int num_tiles;
  const TileGrid tiles = tile_grid(num_levels, heights, widths, batch, &num_tiles);
  const int slices = (channels + kSlice - 1) / kSlice;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int total = batch * num_rois;
  float4* axes = static_cast<float4*>(scratch);
  int4* footprints = reinterpret_cast<int4*>(axes + total);
  int* work = reinterpret_cast<int*>(footprints + total);
  int* order = work + num_tiles;
  cudaError_t err = cudaMemsetAsync(work, 0, num_tiles * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  roi_footprint_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      levels, tiles, rois, roi_level, total, num_rois, out_size, ratio, axes, footprints, work);
  tile_order_kernel<<<1, 1024, 0, st>>>(work, num_tiles, order);
  int rc;
  if (dtype == 0) {
    rc = dispatch<float>(vec, levels, tiles, num_levels, num_tiles * slices, order, axes,
                         footprints, roi_level, num_rois, channels, out_size, ratio, grad, st);
  } else if (dtype == 1) {
    rc = dispatch<__nv_bfloat16>(vec, levels, tiles, num_levels, num_tiles * slices, order, axes,
                                 footprints, roi_level, num_rois, channels, out_size, ratio, grad,
                                 st);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
