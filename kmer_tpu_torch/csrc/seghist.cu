// Segment-length histogram over sorted keys, in one pass.
//
// Replaces the Pallas kernel kmer_tpu/kernels/seghist.py:63
// (_seg_emit_kernel, reached via segment_bins_sorted) together with the
// histogram that follows it (kmer_tpu/table/compactor.py:202-217,
// segops.histogram_by_matmul).  Over sorted biased int64 keys, each
// maximal run of one key (a segment) has a total: its lane count, or the
// sum of its weights (uint32 bits in int32 lanes) mod 2^32, read as
// uint32 as the JAX package's XLA histogram reads it (_hist_xla_core,
// compactor.py:250-267; the TPU kernel's int32 sum, seghist.py:105, would
// drop a total in [2^31, 2^32)).  Every segment whose key is not the
// sentinel (INT64_MAX, so only the last segment can be one) and whose
// total e >= min_keep (unsigned) adds one to bin min(e, max_count,
// n_bins - 1); bin 0 stays 0 and n_distinct counts what was added.  The
// TPU form emits one bin per lane, histograms that plane and adds the
// still-open final run on the host; here the final run is a segment like
// any other.
//
// Bound on the H100: memory.  Each key is read once (8 B a lane, 12 B
// with weights) and n_bins int64 counters are written: 2.15 GB, 0.64 ms
// at 2^28 lanes.  The first port read the keys twice (a reduce pass and
// an emit pass of a three-phase scan), wrote a byte a lane of bins and
// left them to torch.bincount (23.5 ms at 2^28 lanes).
//
// Design: a persistent grid (as many blocks as fit on the SMs); block b
// walks a contiguous run of tiles of 4096 lanes in order, carrying the
// open run from one tile to the next as the TPU kernel carries it from
// one grid step to the next (seghist.py:79-83, 134-145), and keeps one
// histogram for all its tiles.
//   seg_hist_tiles  a block stages a tile's keys in shared memory
//                   (16-byte coalesced loads; one pad lane every 16
//                   keeps a warp's reads of 16 consecutive lanes a thread
//                   off one bank).  Each thread owns 16 consecutive
//                   lanes and reads their keys once, into three 16-bit
//                   masks: a segment starts at the lane, ends there, its
//                   key is not the sentinel.  It reduces its lanes to a
//                   segmented-scan aggregate (f = a segment starts here,
//                   v = the open run), the block scans the 256
//                   aggregates, and each thread walks its masks again
//                   from the carry.  A segment that starts and ends in
//                   the block's tiles is binned at its last lane.  The
//                   block records for the stitch its aggregate (has a
//                   start, run open at its end) and, when its first
//                   lanes continue a segment from an earlier block, the
//                   lanes up to that segment's end and whether its key is
//                   a real one.
//   stitch_tiles    one block scans the blocks' aggregates (a segmented
//                   scan, log-depth across 1024 threads) and bins each
//                   segment that crossed into a block at the block that
//                   ends it: carry + prefix.  A segment spanning every
//                   tile (k = 32) costs the scan nothing extra.
// Contention: at 0.5% read errors most segments land in bin 1, so each
// thread tallies bin 1 in a register and each warp adds its tallies
// with one atomic at the end; the other bins take one shared-memory
// atomic a segment.  Up to kSharedBins bins the histogram lives in
// shared memory and is flushed with one 64-bit atomicAdd per nonzero
// bin per block; above that (the wrapper allows 2^15) the adds go to
// device memory directly (global atomics), which is slower but never on
// the tools' paths (kc: 256 bins, yak-count: 1024).  Decoupled look-back
// would save the stitch launch; the stitch reads 12 bytes a block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;
constexpr int kPadded = kTile + kTile / 16;
constexpr int kSharedBins = 1024;
constexpr int kStitchThreads = 1024;
constexpr int kMaxDevices = 64;  // grid sizes cached a device
constexpr uint32_t kHasStart = 1;  // tile flags
constexpr uint32_t kCloses = 2;    // the tile ends a real crossing segment

struct Cfg {
  int n_bins, max_count, min_keep;  // max_count < 0: no clamp
};

__device__ __forceinline__ int pad(int p) { return p + (p >> 4); }

// The bin of a segment total, or -1 when it is not counted.  The total
// is compared and clamped as uint32 (min_keep, max_count and n_bins - 1
// are below 2^31), so one in [2^31, 2^32) lands in the last bin.
__device__ __forceinline__ int bin_of(uint32_t total, Cfg cfg) {
  if (total < static_cast<uint32_t>(cfg.min_keep)) return -1;
  if (cfg.max_count >= 0 && total > static_cast<uint32_t>(cfg.max_count))
    total = static_cast<uint32_t>(cfg.max_count);
  if (total > static_cast<uint32_t>(cfg.n_bins - 1))
    total = static_cast<uint32_t>(cfg.n_bins - 1);
  return total >= 1 ? static_cast<int>(total) : -1;
}

// Segmented-scan combine: (f, v) then (f2, v2).
__device__ __forceinline__ void combine(uint32_t& f, uint32_t& v, uint32_t f2,
                                        uint32_t v2) {
  v = f2 ? v2 : v + v2;
  f |= f2;
}

// Add one segment to bin b (b < 0: none).  Bin 1 takes most segments
// (k-mers seen once: read errors), so a thread tallies it in a register
// and the warp adds the tallies once, at the flush; the other bins,
// spread thin, take an atomic each.
template <bool kShared>
__device__ __forceinline__ void add_bin(int b, uint32_t* sh,
                                        unsigned long long* hist,
                                        unsigned& ones, unsigned& counted) {
  if (b == 1) {
    ++ones;
  } else if (b > 1) {
    if (kShared)
      atomicAdd(sh + b, 1u);
    else
      atomicAdd(hist + b, 1ull);
    ++counted;
  }
}

// Block-wide: zero the shared histogram.
template <bool kShared>
__device__ __forceinline__ void hist_zero(uint32_t* sh, Cfg cfg) {
  if (kShared)
    for (int b = threadIdx.x; b < cfg.n_bins; b += blockDim.x) sh[b] = 0;
}

// Block-wide, after a __syncthreads: flush the bin-1 tallies, then the
// shared histogram, and the block's count of added segments.
template <bool kShared>
__device__ __forceinline__ void hist_flush(uint32_t* sh, Cfg cfg,
                                           unsigned long long* hist,
                                           unsigned long long* n_counted,
                                           unsigned ones, unsigned counted) {
  ones = __reduce_add_sync(0xffffffffu, ones);
  counted = __reduce_add_sync(0xffffffffu, counted) + ones;
  if ((threadIdx.x & 31) == 0 && ones) {
    if (kShared)
      atomicAdd(sh + 1, ones);
    else
      atomicAdd(hist + 1, static_cast<unsigned long long>(ones));
  }
  if ((threadIdx.x & 31) == 0 && counted)
    atomicAdd(n_counted, static_cast<unsigned long long>(counted));
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < cfg.n_bins; b += blockDim.x)
      if (sh[b]) atomicAdd(hist + b, static_cast<unsigned long long>(sh[b]));
  }
}

template <bool kShared, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
seg_hist_tiles(const int64_t* __restrict__ keys,
               const int32_t* __restrict__ weights, int64_t n,
               int64_t n_tiles, Cfg cfg, unsigned long long* __restrict__ hist,
               unsigned long long* __restrict__ n_counted,
               uint32_t* __restrict__ block_flags,
               uint32_t* __restrict__ block_run,
               uint32_t* __restrict__ block_pre) {
  __shared__ int64_t s[kPadded];
  __shared__ uint32_t sh[kShared ? kSharedBins : 1];
  __shared__ uint32_t wf[kWarps], wv[kWarps];
  __shared__ int64_t before, after;  // the keys just outside the tile
  __shared__ uint32_t closes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = threadIdx.x * kPerThread;  // this thread's first lane
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(weights)) &
       15) == 0;
  hist_zero<kShared>(sh, cfg);
  if (threadIdx.x == 0) closes = 0;
  unsigned ones = 0, counted = 0;
  // this block's tiles, in order, and the run carried from one to the next
  const int64_t tile_lo = blockIdx.x * n_tiles / gridDim.x;
  const int64_t tile_hi = (blockIdx.x + 1) * n_tiles / gridDim.x;
  uint32_t carry_f = 0, carry_v = 0;

  for (int64_t tile = tile_lo; tile < tile_hi; ++tile) {
    const int64_t t0 = tile * kTile;
    const int len = static_cast<int>(n - t0 < kTile ? n - t0 : kTile);
    const bool first_tile = t0 == 0, last_tile = t0 + len == n;
    __syncthreads();  // the previous tile is done with s, wf, wv
    if (aligned && len == kTile) {  // 16-byte loads
      const longlong2* k2 = reinterpret_cast<const longlong2*>(keys + t0);
      for (int q = threadIdx.x; q < kTile / 2; q += kThreads) {
        const longlong2 v = k2[q];
        s[pad(2 * q)] = v.x;
        s[pad(2 * q + 1)] = v.y;
      }
    } else {
      for (int p = threadIdx.x; p < len; p += kThreads)
        s[pad(p)] = keys[t0 + p];
    }
    if (threadIdx.x == 0) {
      before = first_tile ? 0 : keys[t0 - 1];
      after = last_tile ? 0 : keys[t0 + len];
    }
    uint32_t w[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) w[j] = 1u;
    if (kWeighted) {
      if (aligned && len == kTile) {
        const uint4* w4 = reinterpret_cast<const uint4*>(weights + t0 + p0);
#pragma unroll
        for (int q = 0; q < kPerThread / 4; ++q) {
          const uint4 v = w4[q];
          w[4 * q] = v.x, w[4 * q + 1] = v.y, w[4 * q + 2] = v.z,
                  w[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPerThread; ++j)
          if (p0 + j < len) w[j] = static_cast<uint32_t>(weights[t0 + p0 + j]);
      }
    }
    __syncthreads();

    // masks over this thread's lanes: bit j of `st` = lane p0 + j starts
    // a segment (bit kPerThread: the lane after the last, so that lane j
    // ends a segment when bit j + 1 is set); `real` = its key is not the
    // sentinel; `live` = the lane is in the tile
    const int live_n = len - p0 < 0 ? 0 : (len - p0 < kPerThread ? len - p0
                                                                 : kPerThread);
    const uint32_t live = (1u << live_n) - 1;
    uint32_t st = 0, real = 0;
    if (live_n > 0) {
      int64_t prev = p0 == 0 ? before : s[pad(p0 - 1)];
#pragma unroll
      for (int j = 0; j <= kPerThread; ++j) {
        const int p = p0 + j;
        bool start;
        int64_t key;
        if (p < len) {
          key = s[pad(p)];
          start = (p == 0 && first_tile) || key != prev;
        } else {  // only p == len matters: does lane len - 1 end?
          key = after;
          start = last_tile || prev != after;
        }
        st |= static_cast<uint32_t>(start) << j;
        real |= static_cast<uint32_t>(key != INT64_MAX) << j;
        prev = key;
      }
    }
    const uint32_t starts = st & live, ends = (st >> 1) & live;

    // this thread's aggregate, then the block's exclusive scan of them
    uint32_t f = starts != 0, v = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if ((live >> j) & 1) v = ((starts >> j) & 1) ? w[j] : v + w[j];
    uint32_t fi = f, vi = v;  // inclusive within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t uf = __shfl_up_sync(0xffffffffu, fi, off);
      const uint32_t uv = __shfl_up_sync(0xffffffffu, vi, off);
      if (lane >= off) {
        uint32_t cf = uf, cv = uv;
        combine(cf, cv, fi, vi);
        fi = cf;
        vi = cv;
      }
    }
    if (lane == 31) {
      wf[warp] = fi;
      wv[warp] = vi;
    }
    __syncthreads();
    uint32_t started = carry_f, run = carry_v;  // before this warp
    for (int u = 0; u < warp; ++u) combine(started, run, wf[u], wv[u]);
    const uint32_t ef = __shfl_up_sync(0xffffffffu, fi, 1);
    const uint32_t ev = __shfl_up_sync(0xffffffffu, vi, 1);
    if (lane > 0) combine(started, run, ef, ev);  // before this thread

    // walk the lanes again: bin the segments that started in this
    // block's tiles
    if (ends) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (!((live >> j) & 1)) continue;
        if ((starts >> j) & 1) {
          run = w[j];
          started = 1;
        } else {
          run += w[j];
        }
        if ((ends >> j) & 1) {
          const bool is_real = (real >> j) & 1;
          if (started) {
            if (is_real) add_bin<kShared>(bin_of(run, cfg), sh, hist, ones,
                                          counted);
          } else {  // the segment came in from an earlier block
            block_pre[blockIdx.x] = run;
            if (is_real) closes = 1;
          }
        }
      }
    }
    for (int u = 0; u < kWarps; ++u) combine(carry_f, carry_v, wf[u], wv[u]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    block_flags[blockIdx.x] = (carry_f ? kHasStart : 0) | (closes ? kCloses : 0);
    block_run[blockIdx.x] = carry_v;
  }
  hist_flush<kShared>(sh, cfg, hist, n_counted, ones, counted);
}

// One block: carry[b] = the run open before block b's first tile (a
// segmented scan of the blocks' aggregates); each block that ends a
// segment from an earlier block bins carry[b] + its prefix.
template <bool kShared>
__global__ void __launch_bounds__(kStitchThreads)
stitch_tiles(const uint32_t* __restrict__ block_flags,
             const uint32_t* __restrict__ block_run,
             const uint32_t* __restrict__ block_pre, int64_t n_blocks, Cfg cfg,
             unsigned long long* __restrict__ hist,
             unsigned long long* __restrict__ n_counted) {
  __shared__ uint32_t sf[kStitchThreads], sv[kStitchThreads];
  __shared__ uint32_t sh[kShared ? kSharedBins : 1];
  const int t = threadIdx.x;
  hist_zero<kShared>(sh, cfg);
  const int64_t per = (n_blocks + kStitchThreads - 1) / kStitchThreads;
  const int64_t lo = t * per;
  const int64_t hi = lo + per < n_blocks ? lo + per : n_blocks;
  uint32_t f = 0, v = 0;
  for (int64_t j = lo; j < hi; ++j)
    combine(f, v, block_flags[j] & kHasStart, block_run[j]);
  sf[t] = f;
  sv[t] = v;
  __syncthreads();
  for (int off = 1; off < kStitchThreads; off <<= 1) {
    uint32_t pf = 0, pv = 0;
    if (t >= off) {
      pf = sf[t - off];
      pv = sv[t - off];
    }
    __syncthreads();
    if (t >= off) {
      uint32_t cf = pf, cv = pv;
      combine(cf, cv, sf[t], sv[t]);
      sf[t] = cf;
      sv[t] = cv;
    }
    __syncthreads();
  }
  uint32_t run = t > 0 ? sv[t - 1] : 0u;  // exclusive prefix
  unsigned ones = 0, counted = 0;
  for (int64_t j = lo; j < hi; ++j) {
    const uint32_t flags = block_flags[j];
    if (flags & kCloses)
      add_bin<kShared>(bin_of(run + block_pre[j], cfg), sh, hist, ones,
                       counted);
    run = (flags & kHasStart) ? block_run[j] : run + block_run[j];
  }
  __syncthreads();
  hist_flush<kShared>(sh, cfg, hist, n_counted, ones, counted);
}

template <bool kShared, bool kWeighted>
cudaError_t run_seghist(const int64_t* keys, const int32_t* weights,
                        int64_t n, Cfg cfg, unsigned long long* hist,
                        unsigned long long* n_counted, uint32_t* scratch,
                        cudaStream_t stream) {
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  // a persistent grid: as many blocks as the current device's SMs hold
  // at once, cached a device
  static int grid_caps[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int sms = 0, per_sm = 0, grid_cap = dev < kMaxDevices ? grid_caps[dev] : 0;
  if (grid_cap == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, seg_hist_tiles<kShared, kWeighted>, kThreads, 0);
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) grid_caps[dev] = grid_cap;
  }
  const int64_t grid = n_tiles < grid_cap ? n_tiles : grid_cap;
  seg_hist_tiles<kShared, kWeighted>
      <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
          keys, weights, n, n_tiles, cfg, hist, n_counted, scratch,
          scratch + grid, scratch + 2 * grid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stitch_tiles<kShared><<<1, kStitchThreads, 0, stream>>>(
      scratch, scratch + grid, scratch + 2 * grid, grid, cfg, hist, n_counted);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ktt_seghist_tile_lanes() { return kTile; }

// keys: sorted int64[n], n >= 1; weights: int32[n] or null; out:
// int64[n_bins + 1] zeroed by the caller (the histogram, then the number
// of segments it counts); scratch: uint32[3 * ceil(n / tile lanes)] (the
// blocks' aggregates: the grid never has more blocks than tiles).
// 1 <= n_bins <= 2^15, min_keep >= 1, max_count < 0 for no clamp.
extern "C" int ktt_seghist(const void* keys, const void* weights, int64_t n,
                           int n_bins, int max_count, int min_keep, void* out,
                           void* scratch, void* stream) {
  const Cfg cfg{n_bins, max_count, min_keep};
  const auto* k = static_cast<const int64_t*>(keys);
  const auto* w = static_cast<const int32_t*>(weights);
  auto* hist = static_cast<unsigned long long*>(out);
  auto* counted = hist + n_bins;
  auto* sc = static_cast<uint32_t*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  const bool shared = n_bins <= kSharedBins;
  cudaError_t err;
  if (shared)
    err = w ? run_seghist<true, true>(k, w, n, cfg, hist, counted, sc, s)
            : run_seghist<true, false>(k, w, n, cfg, hist, counted, sc, s);
  else
    err = w ? run_seghist<false, true>(k, w, n, cfg, hist, counted, sc, s)
            : run_seghist<false, false>(k, w, n, cfg, hist, counted, sc, s);
  return static_cast<int>(err);
}
