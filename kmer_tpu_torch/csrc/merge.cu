// One-pass merge of two sorted int64 runs (merge path).
//
// Replaces, on the two-plane path (biased int64 keys, kernels/keys.py),
// the bitonic pair of kmer_tpu/kernels/bitonic.py: `_merge_tile_kernel`
// (:194) and `_xstage_kernel` (:103), which csrc/bitonic.cu ports as
// `merge_tiles<Plane<int64_t>>` and `merge_xstage<Plane<int64_t>>`.
// `merge_partition` takes the place of the cross-tile stages (it decides
// which lanes of each input reach each output tile), `merge_path` the
// place of the tile pass.  The function is the same: two ascending runs
// in, one ascending run out, and a merge of sorted int64 runs has one
// correct output, so every histogram stays byte-identical.
//
// Bound on the H100: memory.  The merge reads each input lane once and
// writes each output lane once: 16 B per output lane, 0.16 ms for 2^25
// lanes at 3.35 TB/s.  The TPU chose a bitonic network because it has
// no gather or scatter and its tiles live in VMEM; on this card the
// bitonic merge of n lanes costs a flip and a concatenation, then
// log2(n) - 12 global stages (one pass of device memory each) and a tile
// pass: 13 passes at 2^25 lanes (2.3 ms measured).  A merge path makes
// one pass:
//
//   merge_partition  one thread per output tile boundary d (every kTile
//                    lanes) binary-searches the diagonal i + j = d for
//                    the split (i lanes of a, j of b), ties to a: log2(n)
//                    loads a tile, int64 splits[n_tiles + 1] out.
//   merge_path       one block per output tile of kTile = 4096 lanes
//                    (256 threads x 16 lanes).  The block loads
//                    a[i0:i1] and b[j0:j1] into shared memory with
//                    coalesced 8-byte loads (any alignment), each thread
//                    finds its own diagonal in shared memory and merges
//                    its 16 lanes in registers, writes them back into the
//                    same buffer, and the block stores its tile coalesced,
//                    16 bytes a thread (the tile starts 32 KB-aligned).
//
// Shared memory: 4096 lanes plus one pad lane every 16 (34 KB, static,
// under the 48 KB limit).  Without the pad, thread t reads and writes
// lane 16t + k in one instruction: all 32 threads of a warp hit one bank.
// With it, lane p sits at p + p/16, and the warp spreads over the banks.
// The ragged last tile is masked; either run may be empty.  Ties go to a
// (take a[i] when a[i] <= b[j]): the stable merge, as the plain version
// in kernels/merge.py computes it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;  // output lanes of a block
constexpr int kPadded = kTile + kTile / 16;

__device__ __forceinline__ int pad(int p) { return p + (p >> 4); }

// The number of lanes of a among the first d lanes of the stable merge
// of a (na lanes) and b (nb): the smallest i with b[d - 1 - i] < a[i].
// a(i) and b(j) read a lane of either run (global or shared memory).
template <class A, class B>
__device__ __forceinline__ int64_t diagonal_split(A a, int64_t na, B b,
                                                  int64_t nb, int64_t d) {
  int64_t lo = d > nb ? d - nb : 0;
  int64_t hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t i = (lo + hi) >> 1;
    if (a(i) <= b(d - 1 - i))
      lo = i + 1;
    else
      hi = i;
  }
  return lo;
}

__global__ void merge_partition(const int64_t* __restrict__ a, int64_t na,
                                const int64_t* __restrict__ b, int64_t nb,
                                int64_t* __restrict__ splits,
                                int64_t n_splits) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_splits) return;
  const int64_t n = na + nb;
  const int64_t d = t * kTile < n ? t * kTile : n;
  splits[t] = diagonal_split([=](int64_t i) { return a[i]; }, na,
                             [=](int64_t j) { return b[j]; }, nb, d);
}

__global__ void __launch_bounds__(kThreads)
merge_path(const int64_t* __restrict__ a, int64_t na,
           const int64_t* __restrict__ b, int64_t nb,
           const int64_t* __restrict__ splits, int64_t* __restrict__ out) {
  __shared__ int64_t s[kPadded];
  const int64_t tile = blockIdx.x;
  const int64_t d0 = tile * kTile;
  const int64_t n = na + nb;
  const int len = static_cast<int>((n - d0) < kTile ? n - d0 : kTile);
  const int64_t i0 = splits[tile];
  const int64_t j0 = d0 - i0;
  const int ta = static_cast<int>(splits[tile + 1] - i0);  // lanes of a
  const int tb = len - ta;                                  // lanes of b

  // the tile's inputs: a[i0:i0+ta] then b[j0:j0+tb]
  for (int p = threadIdx.x; p < len; p += kThreads)
    s[pad(p)] = p < ta ? a[i0 + p] : b[j0 + (p - ta)];
  __syncthreads();

  const int diag = threadIdx.x * kPerThread;
  int64_t v[kPerThread];
  if (diag < len) {
    auto sa = [&](int i) { return s[pad(i)]; };
    auto sb = [&](int j) { return s[pad(ta + j)]; };
    int ia = static_cast<int>(diagonal_split(sa, ta, sb, tb, diag));
    int ib = diag - ia;
    int64_t va = ia < ta ? sa(ia) : 0;
    int64_t vb = ib < tb ? sb(ib) : 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const bool take_a = ib >= tb || (ia < ta && va <= vb);
      v[k] = take_a ? va : vb;
      if (take_a) {
        ++ia;
        va = ia < ta ? sa(ia) : 0;
      } else {
        ++ib;
        vb = ib < tb ? sb(ib) : 0;
      }
    }
  }
  __syncthreads();  // every thread has read its inputs
  if (diag < len) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) s[pad(diag + k)] = v[k];
  }
  __syncthreads();

  int64_t* o = out + d0;
  if (len == kTile) {
    // full tile: 16-byte stores (d0 is a multiple of 4096 lanes and
    // PyTorch's allocations are 512-byte aligned)
    longlong2* o2 = reinterpret_cast<longlong2*>(o);
    for (int q = threadIdx.x; q < kTile / 2; q += kThreads)
      o2[q] = make_longlong2(s[pad(2 * q)], s[pad(2 * q + 1)]);
  } else {
    for (int p = threadIdx.x; p < len; p += kThreads) o[p] = s[pad(p)];
  }
}

}  // namespace

// Output lanes per merge_path block (the partition's tile).
extern "C" int ktt_merge_tile_lanes() { return kTile; }

// splits: int64[ceil((na + nb) / kTile) + 1].
extern "C" int ktt_merge_partition(const void* a, int64_t na, const void* b,
                                   int64_t nb, void* splits, void* stream) {
  const int64_t n_splits = (na + nb + kTile - 1) / kTile + 1;
  const int64_t blocks = (n_splits + kThreads - 1) / kThreads;
  merge_partition<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), na, static_cast<const int64_t*>(b), nb,
      static_cast<int64_t*>(splits), n_splits);
  return static_cast<int>(cudaGetLastError());
}

// out: int64[na + nb], na + nb > 0; splits from ktt_merge_partition.
extern "C" int ktt_merge_path(const void* a, int64_t na, const void* b,
                              int64_t nb, const void* splits, void* out,
                              void* stream) {
  const int64_t tiles = (na + nb + kTile - 1) / kTile;
  merge_path<<<static_cast<unsigned>(tiles), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), na, static_cast<const int64_t*>(b), nb,
      static_cast<const int64_t*>(splits), static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
