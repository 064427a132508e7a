// The blocked bloom filter's test-and-set on a bit-packed bits array.
//
// Replaces no Pallas kernel: the JAX package (kmer_tpu/kernels/bloom.py
// insert, insert_sequential) keeps one byte a bit and resolves a block's
// sequential verdicts by one sort of (bit << 32 | lane) entries, which
// bounds a bloom to 2^31 bits.  Here the bits are packed, 2^(S - 3) bytes
// for a bloom of 2^S bits (16 GiB at -b37), bit b at byte b >> 3, bit
// b & 7 (read as little-endian 32-bit words: word b >> 5, bit b & 31),
// and a bit index is 64 bits wide.
//
// What it computes, for one block of biased int64 keys (INT64_MAX, or a
// false `valid`, marks an invalid lane): each valid lane's n_hash probe
// bits (yak's double hashing inside one 512-bit block, kernels/bloom.py
// probe_indices), whether they were all set, and every probe bit set
// after the call.  Sequentially (yak_bf_insert, yak-count.c:91-108) a
// probe counts as set when its bit was set before the call or by an
// earlier probe in (lane, probe) order, the same lane's earlier probes
// included (`cnt += !!(*q & u); *q |= u;`); batched (the JAX package's
// `insert`) only when it was set before the call.  A lane is admitted iff
// all its probes count.
//
// Bound on the H100: memory latency, not bandwidth.  The least traffic is
// the key (8 B), the 64-byte bloom block its probes lie in, and what it
// writes: a verdict (1 B), or the admitted key (8 B) on yak-count's path;
// each probe is a random access into a 16 GiB array.
//
// Design: the sequential order matters only among probes of one bit, so
// each bit newly set in the call records its first setter, the least
// rank = lane * n_hash + probe, in a hash table keyed by the bit, and
// every probe then compares its own rank with its bit's first setter's.
// No sort, so a hot key that probes one bloom block a million times costs
// a million atomics on one slot and no serial walk.
//   bloom_clear_kernel   zeroes the table: a slot's tag is bit + 1 (0:
//                        free) and its rank ~rank, 32 bits, so the least
//                        rank holds the most.
//   bloom_probe_kernel   reads the bits before the call; every probe of
//                        an unset bit claims its bit's slot (linear
//                        probing, atomicCAS on the tag) and takes the
//                        least rank there (atomicMax of its complement).
//   bloom_admit_kernel   a probe whose bit has no slot was set before
//                        the call; one that has counts, sequentially,
//                        when the slot's first setter ranks below it, and
//                        the first setter sets the bit (atomicOr).  It
//                        writes every lane's verdict and, when asked,
//                        the admitted keys (the key, or INT64_MAX).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlkShift = 9;
constexpr uint32_t kBlkMask = (1u << kBlkShift) - 1;
constexpr int64_t kSent = INT64_MAX;
constexpr uint64_t kTop = 1ull << 63;  // keys are biased: raw = key ^ kTop

struct Geometry {
  int pre;         // prefix bits (2^pre subtables)
  int n_shift;     // total bloom bits, log2, across every subtable
  int n_hash;      // probes a key
  int owner_bits;  // the mesh's share of the subtables (0 on one device)
};

struct Probe {
  uint64_t base;  // the key's 512-bit block, as a bit index
  uint32_t z, h2;
};

// kernels/bloom.py probe_indices: the JAX package's block index is the
// low 32 bits of x masked to xs bits; every shift here is logical.
__device__ __forceinline__ Probe probe_of(int64_t key, const Geometry& g) {
  const uint64_t k = static_cast<uint64_t>(key) ^ kTop;
  const int local = g.n_shift - g.pre;
  const int xs = local - kBlkShift;
  const uint64_t pre_idx = (k & ((1ull << g.pre) - 1)) >> g.owner_bits;
  const uint64_t x = k >> g.pre;
  const uint64_t blk = x & ((1ull << (xs < 32 ? xs : 32)) - 1);
  Probe p;
  p.z = static_cast<uint32_t>(x >> xs) & kBlkMask;
  uint32_t h2 = static_cast<uint32_t>(x >> local) & kBlkMask;
  p.h2 = (h2 & 31) == 0 ? (h2 + 1) & kBlkMask : h2;
  p.base = (pre_idx << local) + (blk << kBlkShift);
  return p;
}

__device__ __forceinline__ bool lane_valid(const int64_t* keys,
                                           const bool* valid, int64_t i) {
  return keys[i] != kSent && (valid == nullptr || valid[i]);
}

__device__ __forceinline__ uint64_t slot_of(uint64_t bit, uint64_t mask) {
  return (bit * 0x9E3779B97F4A7C15ull >> 20) & mask;
}

// The slot of `bit`, claimed if it has none.
__device__ __forceinline__ uint64_t claim(unsigned long long* tags,
                                         uint64_t mask, uint64_t bit) {
  const unsigned long long want = bit + 1;
  for (uint64_t s = slot_of(bit, mask);; s = (s + 1) & mask) {
    unsigned long long t = tags[s];
    if (t == 0) t = atomicCAS(tags + s, 0ull, want);  // 0: it was free
    if (t == 0 || t == want) return s;
  }
}

// The slot of `bit`, or -1: after the probe kernel every bit unset before
// the call has one, and no slot changes.
__device__ __forceinline__ int64_t find(const unsigned long long* tags,
                                        uint64_t mask, uint64_t bit) {
  const unsigned long long want = bit + 1;
  for (uint64_t s = slot_of(bit, mask);; s = (s + 1) & mask) {
    const unsigned long long t = tags[s];
    if (t == want) return static_cast<int64_t>(s);
    if (t == 0) return -1;
  }
}

__global__ void bloom_clear_kernel(unsigned long long* tags, unsigned* ranks,
                                   int64_t size) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < size; i += stride) {
    tags[i] = 0;
    ranks[i] = 0;
  }
}

__global__ void bloom_probe_kernel(const int64_t* __restrict__ keys,
                                   const bool* __restrict__ valid, int64_t n,
                                   Geometry g,
                                   const uint32_t* __restrict__ words,
                                   unsigned long long* tags,
                                   unsigned* ranks, uint64_t mask) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += stride) {
    if (!lane_valid(keys, valid, i)) continue;
    Probe p = probe_of(keys[i], g);
    const uint32_t rank0 = static_cast<uint32_t>(i) * g.n_hash;
    for (int h = 0; h < g.n_hash; ++h) {
      const uint64_t bit = p.base + p.z;
      if (!(words[bit >> 5] >> (bit & 31) & 1u)) {
        atomicMax(ranks + claim(tags, mask, bit), ~(rank0 + h));
      }
      p.z = (p.z + p.h2) & kBlkMask;
    }
  }
}

template <bool kSequential>
__global__ void bloom_admit_kernel(const int64_t* __restrict__ keys,
                                   const bool* __restrict__ valid, int64_t n,
                                   Geometry g, uint32_t* words,
                                   const unsigned long long* tags,
                                   const unsigned* ranks, uint64_t mask,
                                   bool* preset, int64_t* admitted) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += stride) {
    const int64_t key = keys[i];
    bool all = false;
    if (lane_valid(keys, valid, i)) {
      Probe p = probe_of(key, g);
      const uint32_t rank0 = static_cast<uint32_t>(i) * g.n_hash;
      int cnt = 0;
      for (int h = 0; h < g.n_hash; ++h) {
        const uint64_t bit = p.base + p.z;
        const int64_t s = find(tags, mask, bit);
        if (s < 0) {
          ++cnt;  // set before the call
        } else {
          if (~ranks[s] == rank0 + h)
            atomicOr(words + (bit >> 5), 1u << (bit & 31));
          else if (kSequential)
            ++cnt;  // an earlier probe of this call set it
        }
        p.z = (p.z + p.h2) & kBlkMask;
      }
      all = cnt == g.n_hash;
    }
    if (preset != nullptr) preset[i] = all;
    if (admitted != nullptr) admitted[i] = all ? key : kSent;
  }
}

unsigned grid_for(int64_t n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  return static_cast<unsigned>(want < cap ? want : cap);
}

}  // namespace

// keys: int64[n] biased (INT64_MAX: invalid); valid: bool[n] or null;
// words: the packed bits, 2^(n_shift - owner_bits - 3) bytes, 4-byte
// aligned; tags: uint64[mask + 1], ranks: uint32[mask + 1] (scratch),
// mask + 1 a power of two above the probes of unset bits; preset: bool[n]
// or null; admitted: int64[n] or null.  n * n_hash < 2^32.
// sequential != 0: yak_bf_insert's order, else the batched one.
extern "C" int ktt_bloom_insert(const void* keys, const void* valid,
                                int64_t n, int pre, int n_shift, int n_hash,
                                int owner_bits, int sequential, void* words,
                                void* tags, void* ranks, int64_t mask,
                                void* preset, void* admitted,
                                void* stream) {
  if (n > 0) {
    const Geometry g{pre, n_shift, n_hash, owner_bits};
    const auto* k = static_cast<const int64_t*>(keys);
    const auto* v = static_cast<const bool*>(valid);
    auto* w = static_cast<uint32_t*>(words);
    auto* t = static_cast<unsigned long long*>(tags);
    auto* r = static_cast<unsigned*>(ranks);
    auto* out = static_cast<bool*>(preset);
    auto* adm = static_cast<int64_t*>(admitted);
    const auto m = static_cast<uint64_t>(mask);
    const unsigned blocks = grid_for(n);
    auto s = static_cast<cudaStream_t>(stream);
    bloom_clear_kernel<<<grid_for(mask + 1), kThreads, 0, s>>>(t, r,
                                                               mask + 1);
    bloom_probe_kernel<<<blocks, kThreads, 0, s>>>(k, v, n, g, w, t, r, m);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (sequential)
      bloom_admit_kernel<true><<<blocks, kThreads, 0, s>>>(
          k, v, n, g, w, t, r, m, out, adm);
    else
      bloom_admit_kernel<false><<<blocks, kThreads, 0, s>>>(
          k, v, n, g, w, t, r, m, out, adm);
  }
  return static_cast<int>(cudaGetLastError());
}
