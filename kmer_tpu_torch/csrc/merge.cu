// One-pass merge of two sorted runs (merge path), for three lane types.
//
// Replaces the bitonic pairs of kmer_tpu/kernels/bitonic.py, a tile
// kernel and a cross-tile stage kernel per lane type (csrc/bitonic.cu
// ports them stage by stage; no path runs those any more):
//
//   lane type                      tile kernel               cross-tile stage
//   biased int64 key (two-plane)   _merge_tile_kernel :194   _xstage_kernel :103
//   int32 key (one-plane, k<=15)   _merge_tile_kernel1 :277  _xstage_kernel1 :138
//   (int64 key, int64 lane index)  _merge_tile_kernel3 :232  _xstage_kernel3 :121
//
// `merge_partition` takes the place of the cross-tile stages (it decides
// which lanes of each input reach each output tile), `merge_path` the
// place of the tile pass.  The function is the same: two ascending runs
// in, one ascending run out.  Each order is total up to identical lanes
// ((key, index) lanes order by key, then index), so the merge has one
// correct output and every histogram and admission count stays
// byte-identical.
//
// Bound on the H100: memory.  The merge reads each input lane once and
// writes each output lane once: 16 B per output lane for int64 (0.16 ms
// for 2^25 lanes at 3.35 TB/s), 8 B for int32 (0.08 ms), 32 B for (key,
// index) (0.32 ms).  The TPU chose a bitonic network because it has no
// gather or scatter and its tiles live in VMEM; on this card the bitonic
// merge of n lanes costs a flip and a concatenation, then log2(n) -
// tile_bits global stages (one pass of device memory each) and a tile
// pass.  A merge path makes one pass:
//
//   merge_partition  one thread per output tile boundary d (every kTile
//                    lanes) binary-searches the diagonal i + j = d for
//                    the split (i lanes of a, j of b), ties to a: log2(n)
//                    loads a tile, int64 splits[n_tiles + 1] out.
//   merge_path       one block per output tile of kTile = kThreads x
//                    kPerThread lanes.  The block loads a[i0:i1] and
//                    b[j0:j1] into shared memory with coalesced loads
//                    (any alignment), each thread finds its own diagonal
//                    in shared memory and merges its kPerThread lanes in
//                    registers, writes them back into the same buffer, and
//                    the block stores its tile coalesced, 16 bytes a
//                    thread (a full tile starts 16-byte aligned).
//
// (key, index) lanes keep two planes in global and in shared memory.  The
// key decides; the index is read only on a key tie (in the partition's
// global search too) and once more for the lane a thread takes.  At
// k = 32 every key is one constant and the index decides every compare.
//
// Shared memory is dynamic: kTile lanes of every plane plus one pad lane
// every kPerThread.  Without the pad, thread t reads and writes lane
// kPerThread * t + k in one instruction and a warp hits one or two
// banks; with it, lane p sits at p + p / kPerThread, a stride of
// kPerThread + 1 (odd) lanes between threads, and the warp spreads over
// all banks for 4-byte and for 8-byte lanes.  A tile above 48 KB opts in
// with cudaFuncSetAttribute.  The ragged last tile is masked; either run
// may be empty.  Ties go to a (take a[i] when a[i] <= b[j]): the stable
// merge, as the plain versions in kernels/merge.py compute it.
//
// The tile shapes below are what measured best on one H100
// (scripts/tune_merge.py builds this file with other shapes through the
// KTT_MERGE* macros and times them side by side).
#include <cstdint>
#include <cuda_runtime.h>

#ifndef KTT_MERGE_THREADS
#define KTT_MERGE_THREADS 256
#endif
#ifndef KTT_MERGE_PER_THREAD
#define KTT_MERGE_PER_THREAD 16
#endif
#ifndef KTT_MERGE1_THREADS
#define KTT_MERGE1_THREADS 512
#endif
#ifndef KTT_MERGE1_PER_THREAD
#define KTT_MERGE1_PER_THREAD 16
#endif
#ifndef KTT_MERGE3_THREADS
#define KTT_MERGE3_THREADS 256
#endif
#ifndef KTT_MERGE3_PER_THREAD
#define KTT_MERGE3_PER_THREAD 16
#endif

namespace {

constexpr int kPartitionThreads = 256;

// One lane type's tile: K is the key plane's type, kIdx says whether an
// int64 index plane rides along and breaks key ties.
template <typename K, bool kIdx, int kThreadsT, int kPerThreadT>
struct Shape {
  using Key = K;
  static constexpr bool kHasIdx = kIdx;
  static constexpr int kThreads = kThreadsT;
  static constexpr int kPerThread = kPerThreadT;
  static constexpr int kTile = kThreads * kPerThread;  // output lanes a block
  static constexpr int kPadded = kTile + kThreads;
  static constexpr int kSharedBytes =
      kPadded * (static_cast<int>(sizeof(K)) + (kIdx ? 8 : 0));
  static_assert(kPerThread % 2 == 0, "the pad stride must be odd");
  static_assert(!kIdx || sizeof(K) == 8, "index planes ride int64 keys");
};

using Int64Shape = Shape<int64_t, false, KTT_MERGE_THREADS, KTT_MERGE_PER_THREAD>;
using Int32Shape = Shape<int32_t, false, KTT_MERGE1_THREADS, KTT_MERGE1_PER_THREAD>;
using KeyIdxShape = Shape<int64_t, true, KTT_MERGE3_THREADS, KTT_MERGE3_PER_THREAD>;

// A run's planes, in global memory or (padded, from lane `base` of the
// tile's buffer) in shared memory.  idx is null without an index plane.
template <typename K>
struct GlobalRun {
  const K* k;
  const int64_t* x;
  __device__ __forceinline__ K key(int64_t i) const { return k[i]; }
  __device__ __forceinline__ int64_t idx(int64_t i) const { return x[i]; }
};

template <typename K, int kPerThread>
struct SharedRun {
  const K* k;
  const int64_t* x;
  int base;
  static __device__ __forceinline__ int pad(int p) {
    return p + static_cast<int>(static_cast<unsigned>(p) / kPerThread);
  }
  __device__ __forceinline__ K key(int i) const { return k[pad(base + i)]; }
  __device__ __forceinline__ int64_t idx(int i) const {
    return x[pad(base + i)];
  }
};

// a[i] <= b[j] given both keys: by key, and by index on a key tie.
template <bool kIdx, class K, class A, class B, class I>
__device__ __forceinline__ bool a_first(K ka, K kb, const A& a, I i,
                                        const B& b, I j) {
  if constexpr (kIdx)
    return ka < kb || (ka == kb && a.idx(i) <= b.idx(j));
  else
    return ka <= kb;
}

// The number of lanes of a among the first d lanes of the stable merge
// of a (na lanes) and b (nb): the smallest i with b[d - 1 - i] < a[i].
template <bool kIdx, class A, class B, class I>
__device__ __forceinline__ I diagonal_split(const A& a, I na, const B& b,
                                            I nb, I d) {
  I lo = d > nb ? d - nb : 0;
  I hi = d < na ? d : na;
  while (lo < hi) {
    const I i = (lo + hi) >> 1;
    const I j = d - 1 - i;
    if (a_first<kIdx>(a.key(i), b.key(j), a, i, b, j))
      lo = i + 1;
    else
      hi = i;
  }
  return lo;
}

template <class S>
__global__ void merge_partition(GlobalRun<typename S::Key> a, int64_t na,
                                GlobalRun<typename S::Key> b, int64_t nb,
                                int64_t* __restrict__ splits,
                                int64_t n_splits) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_splits) return;
  const int64_t n = na + nb;
  const int64_t d = t * S::kTile < n ? t * S::kTile : n;
  splits[t] = diagonal_split<S::kHasIdx>(a, na, b, nb, d);
}

// The block's tile out of shared memory: 16 bytes a thread for a full
// tile (it starts at a multiple of kTile lanes of a 512-byte-aligned
// allocation), lane by lane for the ragged last one.
template <class S, typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ o, const T* s,
                                           int len) {
  constexpr int kVec = 16 / sizeof(T);
  struct alignas(16) Vec {
    T v[kVec];
  };
  using Sh = SharedRun<T, S::kPerThread>;
  if (len == S::kTile) {
    Vec* ov = reinterpret_cast<Vec*>(o);
    for (int q = threadIdx.x; q < S::kTile / kVec; q += S::kThreads) {
      Vec v;
#pragma unroll
      for (int e = 0; e < kVec; ++e) v.v[e] = s[Sh::pad(kVec * q + e)];
      ov[q] = v;
    }
  } else {
    for (int p = threadIdx.x; p < len; p += S::kThreads) o[p] = s[Sh::pad(p)];
  }
}

template <class S>
__global__ void __launch_bounds__(S::kThreads)
merge_path(GlobalRun<typename S::Key> a, int64_t na,
           GlobalRun<typename S::Key> b, int64_t nb,
           const int64_t* __restrict__ splits,
           typename S::Key* __restrict__ out_key,
           int64_t* __restrict__ out_idx) {
  using K = typename S::Key;
  using Sh = SharedRun<K, S::kPerThread>;
  constexpr bool kIdx = S::kHasIdx;
  constexpr int kPerThread = S::kPerThread;
  // the index plane first (8-byte lanes), then the key plane
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* sx = reinterpret_cast<int64_t*>(smem);
  K* sk = reinterpret_cast<K*>(smem + (kIdx ? S::kPadded * 8 : 0));

  const int64_t tile = blockIdx.x;
  const int64_t d0 = tile * S::kTile;
  const int64_t n = na + nb;
  const int len = static_cast<int>((n - d0) < S::kTile ? n - d0 : S::kTile);
  const int64_t i0 = splits[tile];
  const int64_t j0 = d0 - i0;
  const int ta = static_cast<int>(splits[tile + 1] - i0);  // lanes of a
  const int tb = len - ta;                                  // lanes of b

  // the tile's inputs: a[i0:i0+ta] then b[j0:j0+tb].  4-byte lanes load
  // in one loop a run, 8-byte lanes in one loop over the tile: on the
  // H100 each form measured 7-20% ahead of the other for its lane size
  if constexpr (sizeof(K) == 4) {
#pragma unroll 4
    for (int p = threadIdx.x; p < ta; p += S::kThreads)
      sk[Sh::pad(p)] = a.k[i0 + p];
#pragma unroll 4
    for (int p = threadIdx.x; p < tb; p += S::kThreads)
      sk[Sh::pad(ta + p)] = b.k[j0 + p];
  } else {
    for (int p = threadIdx.x; p < len; p += S::kThreads) {
      sk[Sh::pad(p)] = p < ta ? a.k[i0 + p] : b.k[j0 + (p - ta)];
      if constexpr (kIdx)
        sx[Sh::pad(p)] = p < ta ? a.x[i0 + p] : b.x[j0 + (p - ta)];
    }
  }
  __syncthreads();

  const int diag = threadIdx.x * kPerThread;
  K vk[kPerThread];
  int64_t vx[kIdx ? kPerThread : 1];
  if (diag < len) {
    const Sh sa{sk, sx, 0}, sb{sk, sx, ta};
    int ia = diagonal_split<kIdx>(sa, ta, sb, tb, diag);
    int ib = diag - ia;
    K va = ia < ta ? sa.key(ia) : K(0);
    K vb = ib < tb ? sb.key(ib) : K(0);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      // past the ragged tile's end both runs are spent: the lane taken
      // then is never stored
      const bool take_a =
          ib >= tb || (ia < ta && a_first<kIdx>(va, vb, sa, ia, sb, ib));
      vk[k] = take_a ? va : vb;
      if (take_a) {
        if constexpr (kIdx) vx[k] = sa.idx(ia);
        ++ia;
        va = ia < ta ? sa.key(ia) : K(0);
      } else {
        if constexpr (kIdx) vx[k] = sb.idx(ib);
        ++ib;
        vb = ib < tb ? sb.key(ib) : K(0);
      }
    }
  }
  __syncthreads();  // every thread has read its inputs
  if (diag < len) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      sk[Sh::pad(diag + k)] = vk[k];
      if constexpr (kIdx) sx[Sh::pad(diag + k)] = vx[k];
    }
  }
  __syncthreads();

  store_tile<S>(out_key + d0, sk, len);
  if constexpr (kIdx) store_tile<S>(out_idx + d0, sx, len);
}

template <class S>
int launch_partition(const void* ka, const void* xa, int64_t na,
                     const void* kb, const void* xb, int64_t nb, void* splits,
                     void* stream) {
  using K = typename S::Key;
  const int64_t n_splits = (na + nb + S::kTile - 1) / S::kTile + 1;
  const int64_t blocks = (n_splits + kPartitionThreads - 1) / kPartitionThreads;
  merge_partition<S><<<static_cast<unsigned>(blocks), kPartitionThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      GlobalRun<K>{static_cast<const K*>(ka), static_cast<const int64_t*>(xa)},
      na,
      GlobalRun<K>{static_cast<const K*>(kb), static_cast<const int64_t*>(xb)},
      nb, static_cast<int64_t*>(splits), n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <class S>
int launch_path(const void* ka, const void* xa, int64_t na, const void* kb,
                const void* xb, int64_t nb, const void* splits, void* out_key,
                void* out_idx, void* stream) {
  using K = typename S::Key;
  if constexpr (S::kSharedBytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        merge_path<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kSharedBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int64_t tiles = (na + nb + S::kTile - 1) / S::kTile;
  merge_path<S><<<static_cast<unsigned>(tiles), S::kThreads, S::kSharedBytes,
                  static_cast<cudaStream_t>(stream)>>>(
      GlobalRun<K>{static_cast<const K*>(ka), static_cast<const int64_t*>(xa)},
      na,
      GlobalRun<K>{static_cast<const K*>(kb), static_cast<const int64_t*>(xb)},
      nb, static_cast<const int64_t*>(splits), static_cast<K*>(out_key),
      static_cast<int64_t*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Per lane type (no suffix: int64; 1: int32; 3: int64 key + int64 index):
// *_tile_lanes gives the output lanes of one merge_path block (the
// partition's tile); *_partition writes int64 splits[ceil((na + nb) /
// tile) + 1]; *_path merges into out[na + nb] (na + nb > 0) given those
// splits.

extern "C" int ktt_merge_tile_lanes() { return Int64Shape::kTile; }

extern "C" int ktt_merge_partition(const void* a, int64_t na, const void* b,
                                   int64_t nb, void* splits, void* stream) {
  return launch_partition<Int64Shape>(a, nullptr, na, b, nullptr, nb, splits,
                                      stream);
}

extern "C" int ktt_merge_path(const void* a, int64_t na, const void* b,
                              int64_t nb, const void* splits, void* out,
                              void* stream) {
  return launch_path<Int64Shape>(a, nullptr, na, b, nullptr, nb, splits, out,
                                 nullptr, stream);
}

extern "C" int ktt_merge_tile_lanes1() { return Int32Shape::kTile; }

extern "C" int ktt_merge_partition1(const void* a, int64_t na, const void* b,
                                    int64_t nb, void* splits, void* stream) {
  return launch_partition<Int32Shape>(a, nullptr, na, b, nullptr, nb, splits,
                                      stream);
}

extern "C" int ktt_merge_path1(const void* a, int64_t na, const void* b,
                               int64_t nb, const void* splits, void* out,
                               void* stream) {
  return launch_path<Int32Shape>(a, nullptr, na, b, nullptr, nb, splits, out,
                                 nullptr, stream);
}

extern "C" int ktt_merge_tile_lanes3() { return KeyIdxShape::kTile; }

extern "C" int ktt_merge_partition3(const void* key_a, const void* idx_a,
                                    int64_t na, const void* key_b,
                                    const void* idx_b, int64_t nb,
                                    void* splits, void* stream) {
  return launch_partition<KeyIdxShape>(key_a, idx_a, na, key_b, idx_b, nb,
                                       splits, stream);
}

extern "C" int ktt_merge_path3(const void* key_a, const void* idx_a,
                               int64_t na, const void* key_b,
                               const void* idx_b, int64_t nb,
                               const void* splits, void* out_key,
                               void* out_idx, void* stream) {
  return launch_path<KeyIdxShape>(key_a, idx_a, na, key_b, idx_b, nb, splits,
                                  out_key, out_idx, stream);
}
