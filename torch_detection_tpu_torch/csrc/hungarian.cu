// Exact linear sum assignment for Hopper (sm_90a), bound to Python through
// ctypes.
//
// Replaces torch_detection_tpu/ops/hungarian.py::linear_sum_assignment,
// batched by batched_linear_sum_assignment. That is not a Pallas kernel but
// a lax.while_loop the reference keeps inside its jitted step, so that the
// set losses' matching costs no host round trip. Eager PyTorch would sync the
// host at every Dijkstra step's test of its sink (hundreds to thousands of
// syncs a training step), so on the card the whole loop is this kernel.
//
// Algorithm, step for step the reference's (shortest augmenting path,
// Jonker-Volgenant, as scipy): the valid rows are moved to the front in
// their order, NaN and +inf costs become 1e9 and -inf -1e9, and each of the
// n valid rows is augmented by one Dijkstra over the columns, then the dual
// update and the swap along the alternating path. Every float operation is
// an add, a subtract or a compare, evaluated in the reference's order with
// the round-to-nearest intrinsics, and the argmin takes the lowest index
// among equal values, as jnp.argmin: the kernel gives the plain version's
// col4row bit for bit.
//
// Design (simple and right first): one thread block a problem, one thread a
// column (Q <= 1024), so a Dijkstra step relaxes every unscanned column at
// once and picks the cheapest with a warp-shuffle argmin and a second pass
// over the warps' results. u, v, the shortest path costs, the path, the
// scanned flags and both assignment maps live in shared memory; the cost row
// of the step's row is read from global memory (L2), 4 * Q bytes a step. The
// augmentation is one thread's serial walk, at most G swaps.
//
// What bounds it: latency, by nature. A training step's problems (6 stages
// x 8 images, 100 x 100, 1-20 valid rows) read 1.9 MB of costs once, 0.6 us
// at 3.35 TB/s; the kernel instead runs a chain of dependent Dijkstra steps,
// each two block barriers and a reduction, and its time is the longest
// problem's chain (PERF.md).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxCols = 1024;
constexpr float kBig = 1e9f;

// the reference's nan_to_num(nan=1e9, posinf=1e9, neginf=-1e9)
__device__ __forceinline__ float clean(float x) {
  if (x != x) return kBig;
  if (fabsf(x) == INFINITY) return x > 0.f ? kBig : -kBig;
  return x;
}

// (val, idx) becomes the smaller of itself and (oval, oidx), the lower index
// on equal values.
__device__ __forceinline__ void keep_min(float& val, int& idx, float oval, int oidx) {
  if (oval < val || (oval == val && oidx < idx)) {
    val = oval;
    idx = oidx;
  }
}

__device__ __forceinline__ void warp_min(float& val, int& idx) {
  for (int off = 16; off > 0; off >>= 1) {
    const float oval = __shfl_down_sync(0xffffffffu, val, off);
    const int oidx = __shfl_down_sync(0xffffffffu, idx, off);
    keep_min(val, idx, oval, oidx);
  }
}

__global__ void __launch_bounds__(kMaxCols)
    hungarian_kernel(const float* __restrict__ cost, const unsigned char* __restrict__ row_valid,
                     int g, int q, int* __restrict__ out) {
  __shared__ float u[kMaxCols], v[kMaxCols], spc[kMaxCols];
  __shared__ int path[kMaxCols], row4col[kMaxCols], col4row[kMaxCols], order[kMaxCols];
  __shared__ unsigned char sr[kMaxCols], sc[kMaxCols];
  __shared__ float warp_val[32];
  __shared__ int warp_idx[32];
  __shared__ float best_val;
  __shared__ int best_idx, n_valid;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const float* c = cost + static_cast<size_t>(blockIdx.x) * g * q;
  const unsigned char* valid =
      row_valid ? row_valid + static_cast<size_t>(blockIdx.x) * g : nullptr;

  if (tid == 0) {  // valid rows first, each group in its order (a stable argsort)
    int k = 0;
    for (int i = 0; i < g; ++i)
      if (!valid || valid[i]) order[k++] = i;
    n_valid = k;
    for (int i = 0; i < g; ++i)
      if (valid && !valid[i]) order[k++] = i;
  }
  if (tid < g) {
    u[tid] = 0.f;
    col4row[tid] = -1;
  }
  if (tid < q) {
    v[tid] = 0.f;
    row4col[tid] = -1;
  }
  __syncthreads();
  const int n_rows = n_valid;

  for (int cur = 0; cur < n_rows; ++cur) {
    if (tid < q) {
      sc[tid] = 0;
      spc[tid] = INFINITY;
      path[tid] = -1;
    }
    if (tid < g) sr[tid] = 0;
    __syncthreads();

    // Dijkstra from row cur; i, min_val and sink are the same in every thread
    int i = cur, sink = -1;
    float min_val = 0.f;
    while (sink < 0) {
      if (tid == 0) sr[i] = 1;
      float masked = INFINITY;
      int idx = tid;  // a thread past the last column holds +inf at an index above them all
      if (tid < q && !sc[tid]) {
        const float cij = clean(c[static_cast<size_t>(order[i]) * q + tid]);
        // the reference's min_val + c[i] - u[i] - v, left to right
        const float r = __fsub_rn(__fsub_rn(__fadd_rn(min_val, cij), u[i]), v[tid]);
        if (r < spc[tid]) {
          spc[tid] = r;
          path[tid] = i;
        }
        masked = spc[tid];
      }
      warp_min(masked, idx);
      if (lane == 0) {
        warp_val[warp] = masked;
        warp_idx[warp] = idx;
      }
      __syncthreads();
      if (warp == 0) {
        float val = lane < warps ? warp_val[lane] : INFINITY;
        int at = lane < warps ? warp_idx[lane] : INT_MAX;
        warp_min(val, at);
        if (lane == 0) {
          best_val = val;
          best_idx = at;
        }
      }
      __syncthreads();
      const int j = best_idx;
      min_val = best_val;
      if (tid == j) sc[j] = 1;  // read next by this thread alone, until the barrier below
      const int owner = row4col[j];
      if (owner < 0) {
        sink = j;
      } else {
        i = owner;
      }
    }
    __syncthreads();

    // dual update: u[cur] += min_val; every other scanned row moves by
    // min_val - spc at its column; every scanned column by spc - min_val
    if (tid < g) {
      if (tid == cur) {
        u[tid] = __fadd_rn(u[tid], min_val);
      } else if (sr[tid]) {
        const int col = min(max(col4row[tid], 0), q - 1);
        u[tid] = __fadd_rn(u[tid], __fsub_rn(min_val, spc[col]));
      }
    }
    if (tid < q && sc[tid]) v[tid] = __fsub_rn(v[tid], __fsub_rn(min_val, spc[tid]));
    __syncthreads();

    if (tid == 0) {  // augment along the alternating path, at most G swaps
      int j = sink;
      while (true) {
        const int r = path[j];
        row4col[j] = r;
        const int next = col4row[r];
        col4row[r] = j;
        if (r == cur) break;
        j = next;
      }
    }
    __syncthreads();
  }

  // back to the caller's row order; rows left out are -1
  if (tid < g) {
    out[static_cast<size_t>(blockIdx.x) * g + order[tid]] = tid < n_rows ? col4row[tid] : -1;
  }
}

}  // namespace

// col4row (problems, rows) int32 of each (rows, cols) float32 problem of
// cost, rows <= cols <= 1024; row_valid (problems, rows) uint8 or NULL (all
// rows valid). Launches on stream and returns cudaGetLastError().
extern "C" int hungarian(const float* cost, const unsigned char* row_valid, int problems, int rows,
                         int cols, int* col4row, void* stream) {
  if (problems < 1 || rows < 1 || cols < 1 || cols > kMaxCols || rows > cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (cols + 31) / 32 * 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  hungarian_kernel<<<problems, threads, 0, st>>>(cost, row_valid, rows, cols, col4row);
  return static_cast<int>(cudaGetLastError());
}
