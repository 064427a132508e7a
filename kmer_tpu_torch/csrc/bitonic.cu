// Bitonic merge of two sorted halves, for three lane types.
//
// Replaces six Pallas kernels of kmer_tpu/kernels/bitonic.py, one tile
// kernel and one cross-tile stage kernel per lane type:
//
//   lane type                      tile kernel               cross-tile stage
//   biased int64 key (two-plane)   _merge_tile_kernel :194   _xstage_kernel :103
//   int32 key (one-plane, k<=15)   _merge_tile_kernel1 :277  _xstage_kernel1 :138
//   (int64 key, int64 lane index)  _merge_tile_kernel3 :232  _xstage_kernel3 :121
//
// Together a pair turns a bitonic sequence of n = 2^m lanes (an ascending
// half, then a descending one: the caller reverses the second half) into
// ascending order: stage s compare-exchanges lane i with lane i ^ s and
// keeps the minimum where bit s of i is 0.  The compare-exchange is
// written once (`exchange`), templated over a plane set that knows how to
// load, store and order one lane:
//   * Plane<int64_t>: one int64 compare replaces the TPU's lexicographic
//     (hi, lo) u32 compare (keys are biased, kernels/keys.py);
//   * Plane<int32_t>: the TPU's one-plane u32 lo compare; data keys are
//     < 2^30 and the sentinel is INT32_MAX, so signed order is the same;
//   * KeyIdx: the TPU's (hi, lo, idx) compare as (int64 key, int64 lane
//     index), two planes, lexicographic.  The index is int64 because the
//     JAX u32 index reaches 2^32 - 2^26, which int32 would turn negative.
//
// Bound on the H100: memory.  A stage moves 2 x the lane's bytes per lane
// for one compare: 16 B/lane (int64), 8 (int32), 32 (key, index).  The
// TPU's 2^18-lane tile (2^17 for three planes) does not fit in shared
// memory, so every tile here is 32 KB of static shared memory (under the
// 48 KB static limit, no opt-in needed):
//   * int64      2^12 lanes x 8 B;
//   * int32      2^13 lanes x 4 B;
//   * key, index 2^11 lanes x 16 B (2^12 would be 64 KB, over the static
//     limit; a smaller tile costs one more global stage per merge).
// `merge_xstage*` runs one global stage per launch, in place, one thread
// per compare-exchange pair, for every stride >= the tile; `merge_tiles*`
// loads each tile into shared memory once and runs the remaining stages
// there, so those cost one pass of device memory instead of one a stage.
// Both work in place: each pair is owned by exactly one thread.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

template <typename T>
struct Plane {
  using Lane = T;
  T* x;
  __device__ __forceinline__ Lane load(int64_t i) const { return x[i]; }
  __device__ __forceinline__ void store(int64_t i, const Lane& v) const {
    x[i] = v;
  }
  static __device__ __forceinline__ bool less(const Lane& a, const Lane& b) {
    return a < b;
  }
};

struct KeyIdxLane {
  int64_t key, idx;
};

struct KeyIdx {
  using Lane = KeyIdxLane;
  int64_t* key;
  int64_t* idx;
  __device__ __forceinline__ Lane load(int64_t i) const {
    return {key[i], idx[i]};
  }
  __device__ __forceinline__ void store(int64_t i, const Lane& v) const {
    key[i] = v.key;
    idx[i] = v.idx;
  }
  static __device__ __forceinline__ bool less(const Lane& a, const Lane& b) {
    return a.key < b.key || (a.key == b.key && a.idx < b.idx);
  }
};

// Lane i of pair p at stride s, and its partner i | s.
__device__ __forceinline__ int64_t pair_lane(int64_t p, int64_t s) {
  return ((p & ~(s - 1)) << 1) | (p & (s - 1));
}

// The compare-exchange: keep the smaller lane in a, the larger in b;
// true when they swapped.
template <class P>
__device__ __forceinline__ bool exchange(typename P::Lane& a,
                                         typename P::Lane& b) {
  if (!P::less(b, a)) return false;
  const typename P::Lane t = a;
  a = b;
  b = t;
  return true;
}

template <class P>
__global__ void merge_xstage(P planes, int64_t n_pairs, int64_t stride) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  const int64_t i = pair_lane(p, stride);
  const int64_t j = i | stride;
  typename P::Lane a = planes.load(i), b = planes.load(j);
  if (exchange<P>(a, b)) {
    planes.store(i, a);
    planes.store(j, b);
  }
}

template <class P, int kTileBits>
__global__ void merge_tiles(P planes, int tile_bits) {
  using L = typename P::Lane;
  __shared__ L s[1 << kTileBits];
  const int tile = 1 << tile_bits;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * tile;
  for (int j = threadIdx.x; j < tile; j += blockDim.x) s[j] = planes.load(g + j);
  __syncthreads();
  for (int st = tile >> 1; st > 0; st >>= 1) {
    for (int p = threadIdx.x; p < (tile >> 1); p += blockDim.x) {
      const int i = static_cast<int>(pair_lane(p, st));
      exchange<P>(s[i], s[i | st]);
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < tile; j += blockDim.x) planes.store(g + j, s[j]);
}

template <class P>
int launch_xstage(P planes, int64_t n, int64_t stride, void* stream) {
  const int64_t pairs = n / 2;
  const int64_t blocks = (pairs + kThreads - 1) / kThreads;
  merge_xstage<P><<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(planes, pairs, stride);
  return static_cast<int>(cudaGetLastError());
}

template <class P, int kTileBits>
int launch_tiles(P planes, int64_t n, int tile_bits, void* stream) {
  if (tile_bits < 1 || tile_bits > kTileBits)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = 1 << tile_bits;
  const int threads = tile / 2 < kThreads ? tile / 2 : kThreads;
  merge_tiles<P, kTileBits><<<static_cast<unsigned>(n / tile), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(planes,
                                                                   tile_bits);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kTileBits64 = 12;
constexpr int kTileBits32 = 13;
constexpr int kTileBitsKeyIdx = 11;

}  // namespace

// Each *_tile_bits() gives log2 of its tile kernel's lanes.  Each xstage
// runs one compare-exchange stage at `stride` (a power of two) over n
// lanes; each tiles call runs every stage at strides < 2^tile_bits, tile
// by tile (n a multiple of the tile).

extern "C" int ktt_merge_tile_bits() { return kTileBits64; }

extern "C" int ktt_merge_xstage(void* x, int64_t n, int64_t stride,
                                void* stream) {
  return launch_xstage(Plane<int64_t>{static_cast<int64_t*>(x)}, n, stride,
                       stream);
}

extern "C" int ktt_merge_tiles(void* x, int64_t n, int tile_bits,
                               void* stream) {
  return launch_tiles<Plane<int64_t>, kTileBits64>(
      Plane<int64_t>{static_cast<int64_t*>(x)}, n, tile_bits, stream);
}

extern "C" int ktt_merge_tile_bits1() { return kTileBits32; }

extern "C" int ktt_merge_xstage1(void* x, int64_t n, int64_t stride,
                                 void* stream) {
  return launch_xstage(Plane<int32_t>{static_cast<int32_t*>(x)}, n, stride,
                       stream);
}

extern "C" int ktt_merge_tiles1(void* x, int64_t n, int tile_bits,
                                void* stream) {
  return launch_tiles<Plane<int32_t>, kTileBits32>(
      Plane<int32_t>{static_cast<int32_t*>(x)}, n, tile_bits, stream);
}

extern "C" int ktt_merge_tile_bits3() { return kTileBitsKeyIdx; }

extern "C" int ktt_merge_xstage3(void* key, void* idx, int64_t n,
                                 int64_t stride, void* stream) {
  return launch_xstage(KeyIdx{static_cast<int64_t*>(key),
                              static_cast<int64_t*>(idx)},
                       n, stride, stream);
}

extern "C" int ktt_merge_tiles3(void* key, void* idx, int64_t n,
                                int tile_bits, void* stream) {
  return launch_tiles<KeyIdx, kTileBitsKeyIdx>(
      KeyIdx{static_cast<int64_t*>(key), static_cast<int64_t*>(idx)}, n,
      tile_bits, stream);
}
