// Slot resolution of the open-addressing count table: every round of a
// call in one persistent, cooperative launch.
//
// Replaces the `while_loop` of kmer_tpu/table/count_table.py:74-159
// (`resolve_slots`; plain XLA there, not a Pallas kernel): every valid
// lane maps its key to its slot, claiming an EMPTY slot when create_new
// is set.  A round of that loop, for each active lane:
//   * idx = (slot_mix32(key) + off) & (cap - 1);
//   * FULL with the lane's own key: resolved (found);
//   * EMPTY: with create_new the lane proposes itself by a scatter-max of
//     tag = round * m + lane + 1 (uint32, wrapping; m is the length of
//     the lane plane); the highest tag wins, writes its key and FULL and
//     is resolved, the others stay and read the now-FULL slot again next
//     round.  Without create_new the key is absent (slot = cap);
//   * FULL with another key, or DELETED: advance (off + 1).
// The ticket plane is zeroed once a call and never reset: a slot is
// contested in one round at most, as it is FULL after it.
//
// The arbitration is deterministic, and this kernel reproduces it
// exactly: the same slot for every key, the same state / key planes, the
// same slot, found, created, rounds and probes, so a table built on the
// card equals the JAX package's plane for plane (checkpoints cross
// between the two).  A round's result does not depend on the order in
// which its lanes are visited (atomicMax does not; every decision is per
// lane), so a round works over a list of the active lanes in any order.
//
// Design: one launch a call (cudaLaunchCooperativeKernel), a grid of as
// many blocks as the SMs hold at once (cached a device), the loop on the
// card as JAX's loop is on the device:
//
//   round 0   the blocks walk the m lanes in tiles; a valid lane probes
//             (reads the state byte and, when FULL, the 8-byte key at its
//             slot; claims an EMPTY slot with atomicMax on the ticket) and
//             keeps its case beside it.  Grid barrier.  Every lane writes
//             its slot and found; a claim that holds the ticket's value
//             won and writes key, FULL and created; the survivors (lost
//             claims, advances) are appended to the next list, one
//             atomicAdd a block a tile of a lane a thread.
//   round r   the same over the list of round r - 1's survivors.  A list
//             entry carries the lane's key and offset beside its index
//             (16 bytes, read and written in order), so a round reads no
//             lane plane at random, and the decide phase derives the slot
//             again from them instead of reading a slot the probe kept.
//             Two grid barriers a round: after the probes (every claim is
//             in, no state byte of the round written yet), after the
//             appends (the next list complete).
//   the tail  once a round's survivors fit one block (kTail lanes), every
//             block but block 0 leaves; block 0 finishes with the list in
//             shared memory and each thread's slots and cases in
//             registers, two __syncthreads a round.  The 100+ rounds a
//             tombstoned table or a lookup batch takes then cost a block
//             barrier each, not a grid barrier.
//
// The survivor counts live in two device counters that alternate between
// rounds (the one a round reads is zeroed in its decide phase, after
// every block has read it).  Block 0 writes rounds, probes and a flag
// for the round limit (the caller's 2 * cap + 2: JAX's loop spins there,
// the port raises) into the call's control words: the host reads them
// once.
//
// Bound on the H100: memory, in random 32-byte sectors.  Each probe of a
// listed lane reads the sector of its state byte and, for a FULL slot,
// the sector of its key; a claim adds the ticket's sector, a win the
// sectors of its key, state and created.  Lanes, lists and cases are
// read and written in order.  The first rounds carry most of the probes;
// the rest is latency: a round's dependent loads and its barriers.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// the block's threads, and the lanes a thread takes in the one-block
// tail (which starts at threads x this many survivors)
#ifndef KTT_RESOLVE_THREADS
#define KTT_RESOLVE_THREADS 256
#endif
#ifndef KTT_RESOLVE_TAIL_PER_THREAD
#define KTT_RESOLVE_TAIL_PER_THREAD 2
#endif

namespace {

constexpr int kThreads = KTT_RESOLVE_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kTailPer = KTT_RESOLVE_TAIL_PER_THREAD;
constexpr int kTail = kThreads * kTailPer;
constexpr int kMaxDevices = 64;  // grid sizes cached a device
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");

constexpr uint8_t kEmpty = 0;
constexpr uint8_t kFull = 1;
// a lane's case after its probe
constexpr uint8_t kCaseEmpty = 0;
constexpr uint8_t kCaseMatch = 1;
constexpr uint8_t kCaseOther = 2;
constexpr uint8_t kCaseInvalid = 3;  // round 0: not a valid lane

// the call's control words (int64, zeroed by the caller): words 0 and 1
// count the survivors appended to list 0 (rounds 1, 3, ...) and list 1
// (rounds 0, 2, ...)
enum : int {
  kValid = 2,   // valid lanes, counted in round 0
  kRounds = 3,  // out: the rounds run
  kProbes = 4,  // out: the lanes probed over all rounds
  kOver = 5,    // out: 1 when lanes were still active at the round limit
};

// kmer_tpu/kernels/hash64.py:50-64 on the unbiased key's halves
__device__ __forceinline__ uint32_t slot_mix32(int64_t biased) {
  const uint64_t raw = static_cast<uint64_t>(biased) ^ (1ull << 63);
  uint32_t x = static_cast<uint32_t>(raw) ^
               (static_cast<uint32_t>(raw >> 32) * 0x9E3779B9u);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// an active lane: its key, index and probe offset
struct alignas(16) Entry {
  int64_t key;
  int32_t lane;
  uint32_t off;
};

struct Args {
  const int64_t* keys;  // [m] biased keys of the batch
  const bool* valid;    // [m]
  uint32_t m;           // the lane plane's length (the tag's stride)
  uint32_t cap_mask;    // cap - 1
  int64_t cap;
  int64_t limit;        // the round limit
  uint8_t* state;       // [cap] EMPTY / FULL / DELETED
  int64_t* tkey;        // [cap] the table's keys
  uint32_t* ticket;     // [cap] zeroed by the caller (create_new only)
  Entry* list[2];       // [m] each: the active lanes, by round parity
  uint8_t* pos_case;    // [m] a probed lane's case, kept for its decide
  int64_t* slot;        // [m] cap until resolved
  bool* found;          // [m]
  bool* created;        // [cap] zeroed by the caller
  unsigned long long* ctl;  // [6]
  bool create_new;
};

// Lists and cases are written by other blocks during the call: they are
// read from L2 (__ldcg), never from a possibly stale L1 line; so are the
// table's planes.
__device__ __forceinline__ Entry ld_entry(const Entry* p) {
  const longlong2 v = __ldcg(reinterpret_cast<const longlong2*>(p));
  const auto hi = static_cast<unsigned long long>(v.y);
  return Entry{v.x, static_cast<int32_t>(hi & 0xffffffffu),
               static_cast<uint32_t>(hi >> 32)};
}

__device__ __forceinline__ void st_entry(Entry* p, const Entry& e) {
  *reinterpret_cast<longlong2*>(p) = make_longlong2(
      e.key, static_cast<long long>(
                 (static_cast<unsigned long long>(e.off) << 32) |
                 static_cast<uint32_t>(e.lane)));
}

__device__ __forceinline__ uint32_t slot_of(const Args& a, const Entry& e) {
  return (slot_mix32(e.key) + e.off) & a.cap_mask;
}

__device__ __forceinline__ uint32_t tag_of(int64_t round, uint32_t m,
                                           int32_t lane) {
  return static_cast<uint32_t>(round) * m + static_cast<uint32_t>(lane) + 1u;
}

// One probe: the lane's case at idx, its claim placed on an EMPTY slot.
__device__ __forceinline__ uint8_t probe(const Args& a, int64_t key,
                                         uint32_t idx, uint32_t tag) {
  const uint8_t st = __ldcg(a.state + idx);
  if (st == kEmpty) {
    if (a.create_new) atomicMax(a.ticket + idx, tag);
    return kCaseEmpty;
  }
  if (st == kFull && static_cast<int64_t>(__ldcg(
                         reinterpret_cast<const long long*>(a.tkey + idx))) ==
                         key)
    return kCaseMatch;
  return kCaseOther;
}

// One decide for a lane whose probe gave case c at idx (not Invalid); a
// won claim writes key, FULL and created.
enum Outcome { kHit, kStays, kAbsent };
__device__ __forceinline__ Outcome decide(const Args& a, int64_t key,
                                          uint32_t idx, uint8_t c,
                                          uint32_t tag) {
  if (c == kCaseMatch) return kHit;
  if (c != kCaseEmpty) return kStays;  // advances
  if (!a.create_new) return kAbsent;   // slot stays cap
  if (__ldcg(a.ticket + idx) != tag) return kStays;  // lost: read it again
  a.tkey[idx] = key;
  a.state[idx] = kFull;
  a.created[idx] = true;
  return kHit;
}

// A lane of round r >= 1 after its decide: a resolved one writes its
// slot and found (round 0 writes every lane's); true when it stays.
__device__ __forceinline__ bool settle(const Args& a, int32_t lane,
                                       uint32_t idx, uint8_t c, Outcome d) {
  if (d == kHit) {
    a.slot[lane] = idx;
    if (c == kCaseMatch) a.found[lane] = true;
  }
  return d == kStays;
}

// A surviving lane's next entry: its offset advanced unless it lost a
// claim.
__device__ __forceinline__ Entry moved(Entry e, uint8_t c) {
  e.off += c == kCaseOther;
  return e;
}

// The block's exclusive offset for `mine` entries, from one atomicAdd on
// *count a block (shared or global); `sw` alternates between two
// buffers of kWarps ints so that one call needs two barriers.
__device__ __forceinline__ uint32_t block_reserve(
    int mine, unsigned long long* count, int* sw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) sw[warp] = incl;
  __syncthreads();
  __shared__ uint32_t base;
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int v = sw[w];
      sw[w] = run;
      run += v;
    }
    base = run ? static_cast<uint32_t>(atomicAdd(
                     count, static_cast<unsigned long long>(run)))
               : 0u;
  }
  __syncthreads();
  return base + static_cast<uint32_t>(sw[warp] + incl - mine);
}

struct Shared {
  Entry list[2][kTail];
  unsigned long long count[2];
  int scan[2][kWarps];
};
static_assert(sizeof(Shared) <= 48 * 1024, "static shared memory");

// Round 0 over the m lanes of the batch, a lane a thread (indices stay
// below 2^31 + a block: uint32).
__device__ void round0(const Args& a, cg::grid_group& grid, Shared& s) {
  const uint32_t tiles = (a.m + kThreads - 1) / kThreads;
  for (uint32_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const uint32_t i = t * kThreads + threadIdx.x;
    if (i >= a.m) continue;
    uint8_t c = kCaseInvalid;
    if (a.valid[i]) {
      const int64_t key = a.keys[i];
      c = probe(a, key, slot_mix32(key) & a.cap_mask,
                tag_of(0, a.m, static_cast<int32_t>(i)));
    }
    a.pos_case[i] = c;
  }
  grid.sync();
  int n_valid = 0, flip = 0;
  for (uint32_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const uint32_t i = t * kThreads + threadIdx.x;
    uint8_t c = kCaseInvalid;
    int64_t key = 0;
    bool keep = false;
    if (i < a.m) {
      c = __ldcg(a.pos_case + i);
      Outcome d = kAbsent;
      uint32_t idx = 0;
      if (c != kCaseInvalid) {
        ++n_valid;
        key = a.keys[i];
        idx = slot_mix32(key) & a.cap_mask;
        d = decide(a, key, idx, c, tag_of(0, a.m, static_cast<int32_t>(i)));
      }
      a.slot[i] = d == kHit ? static_cast<int64_t>(idx) : a.cap;
      a.found[i] = c == kCaseMatch;
      keep = d == kStays;
    }
    const uint32_t at = block_reserve(keep, a.ctl + 1, s.scan[flip]);
    flip ^= 1;
    if (keep)
      st_entry(a.list[1] + at, Entry{key, static_cast<int32_t>(i),
                                     c == kCaseOther ? 1u : 0u});
  }
  block_reserve(n_valid, a.ctl + kValid, s.scan[flip]);
  grid.sync();
}

// Round r >= 1 over the n lanes of list[r & 1], on the whole grid.
__device__ void grid_round(const Args& a, cg::grid_group& grid, Shared& s,
                           int64_t r, uint32_t n) {
  const Entry* cur = a.list[r & 1];
  Entry* next = a.list[(r + 1) & 1];
  const uint32_t tiles = (n + kThreads - 1) / kThreads;
  for (uint32_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const uint32_t i = t * kThreads + threadIdx.x;
    if (i >= n) continue;
    const Entry e = ld_entry(cur + i);
    a.pos_case[i] = probe(a, e.key, slot_of(a, e), tag_of(r, a.m, e.lane));
  }
  grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) a.ctl[r & 1] = 0;  // read by all
  int flip = 0;
  for (uint32_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const uint32_t i = t * kThreads + threadIdx.x;
    Entry e{};
    uint8_t c = kCaseInvalid;
    bool keep = false;
    if (i < n) {
      e = ld_entry(cur + i);
      c = __ldcg(a.pos_case + i);
      const uint32_t idx = slot_of(a, e);
      keep = settle(a, e.lane, idx, c,
                    decide(a, e.key, idx, c, tag_of(r, a.m, e.lane)));
    }
    const uint32_t at =
        block_reserve(keep, a.ctl + ((r + 1) & 1), s.scan[flip]);
    flip ^= 1;
    if (keep) st_entry(next + at, moved(e, c));
  }
  grid.sync();
}

// Block 0 alone from round r on, the n <= kTail lanes of list[r & 1]
// (round r already checked against the limit and counted in probes).
__device__ void tail(const Args& a, Shared& s, int64_t r, uint32_t n,
                     int64_t& probes, bool& over) {
  const Entry* src = a.list[r & 1];
  for (uint32_t i = threadIdx.x; i < n; i += kThreads)
    s.list[0][i] = ld_entry(src + i);
  if (threadIdx.x == 0) s.count[1] = 0;
  __syncthreads();
  int b = 0, flip = 0;
  for (;;) {
    uint32_t idx[kTailPer];
    uint8_t cs[kTailPer];
#pragma unroll
    for (int j = 0; j < kTailPer; ++j) {
      const uint32_t i = threadIdx.x + j * kThreads;
      cs[j] = kCaseInvalid;
      idx[j] = 0;
      if (i >= n) continue;
      const Entry e = s.list[b][i];
      idx[j] = slot_of(a, e);
      cs[j] = probe(a, e.key, idx[j], tag_of(r, a.m, e.lane));
    }
    __syncthreads();
    if (threadIdx.x == 0) s.count[b] = 0;  // n was read by every thread
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kTailPer; ++j) {
      if (cs[j] == kCaseInvalid) continue;
      const Entry e = s.list[b][threadIdx.x + j * kThreads];
      if (settle(a, e.lane, idx[j], cs[j],
                 decide(a, e.key, idx[j], cs[j], tag_of(r, a.m, e.lane))))
        ++mine;
      else
        cs[j] = kCaseInvalid;
    }
    uint32_t at = block_reserve(mine, &s.count[b ^ 1], s.scan[flip]);
    flip ^= 1;
#pragma unroll
    for (int j = 0; j < kTailPer; ++j)
      if (cs[j] != kCaseInvalid)
        s.list[b ^ 1][at++] =
            moved(s.list[b][threadIdx.x + j * kThreads], cs[j]);
    __syncthreads();
    n = static_cast<uint32_t>(s.count[b ^ 1]);
    b ^= 1;
    ++r;
    if (n == 0) break;
    if (r >= a.limit) {
      over = true;
      break;
    }
    probes += n;
  }
  if (threadIdx.x == 0) {
    a.ctl[kRounds] = static_cast<unsigned long long>(r);
    a.ctl[kProbes] = static_cast<unsigned long long>(probes);
    a.ctl[kOver] = over ? 1ull : 0ull;
  }
}

// The kernel's parameter block is read in place (__grid_constant__): the
// device functions take it by reference without a copy on the stack.
__global__ void __launch_bounds__(kThreads)
    resolve(const __grid_constant__ Args a) {
  __shared__ Shared s;
  cg::grid_group grid = cg::this_grid();
  round0(a, grid, s);
  volatile unsigned long long* ctl = a.ctl;
  const int64_t n_valid = static_cast<int64_t>(ctl[kValid]);
  uint32_t n = static_cast<uint32_t>(ctl[1]);
  int64_t r = n_valid > 0 ? 1 : 0;  // round 0 counts when a lane probed
  int64_t probes = n_valid;
  bool over = false;
  while (n > 0) {
    if (r >= a.limit) {
      over = true;
      break;
    }
    probes += n;
    if (n <= kTail) {
      // every block takes this branch on the same count: none calls a
      // grid barrier after it
      if (blockIdx.x == 0) tail(a, s, r, n, probes, over);
      return;
    }
    grid_round(a, grid, s, r, n);
    n = static_cast<uint32_t>(ctl[(r + 1) & 1]);
    ++r;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.ctl[kRounds] = static_cast<unsigned long long>(r);
    a.ctl[kProbes] = static_cast<unsigned long long>(probes);
    a.ctl[kOver] = over ? 1ull : 0ull;
  }
}

// the cooperative grid of the current device: (blocks a SM, SMs),
// cached a device
cudaError_t grid_shape(int* per_sm, int* sms) {
  static int cached[kMaxDevices][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev][0] > 0) {
    *per_sm = cached[dev][0];
    *sms = cached[dev][1];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, resolve,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (dev < kMaxDevices) {
    cached[dev][0] = *per_sm;
    cached[dev][1] = *sms;
  }
  return cudaSuccess;
}

}  // namespace

// The kernel's shape on the current device: out int64[6] = blocks a SM,
// SMs, the cooperative grid's most blocks, registers a thread, lanes of
// the one-block tail, threads a block.
extern "C" int ktt_resolve_info(void* out) {
  int per_sm = 0, sms = 0;
  cudaError_t err = grid_shape(&per_sm, &sms);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr{};
  err = cudaFuncGetAttributes(&attr, resolve);
  if (err != cudaSuccess) return err;
  auto* o = static_cast<int64_t*>(out);
  o[0] = per_sm;
  o[1] = sms;
  o[2] = static_cast<int64_t>(per_sm) * sms;
  o[3] = attr.numRegs;
  o[4] = kTail;
  o[5] = kThreads;
  return cudaSuccess;
}

// Every round of one call, at most `limit` rounds: keys: int64[m],
// valid: bool[m], m < 2^31; state: uint8[cap], tkey: int64[cap], cap a
// power of two <= 2^31;
// ticket: uint32[cap] zeroed (create_new only); lists: 16-byte aligned,
// 32 * m bytes (two lists of m entries); pos_case: uint8[m]; slot:
// int64[m]; found: bool[m]; created: bool[cap] zeroed; ctl: int64[6]
// zeroed, whose words 3-5 hold rounds, probes and the round-limit flag
// after the call.
extern "C" int ktt_resolve(const void* keys, const void* valid, int64_t m,
                           int64_t cap, int64_t limit, void* state,
                           void* tkey, void* ticket, void* lists,
                           void* pos_case, void* slot, void* found,
                           void* created, void* ctl, int create_new,
                           void* stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = grid_shape(&per_sm, &sms);
  if (err != cudaSuccess) return err;
  const int64_t most = static_cast<int64_t>(per_sm) * sms;
  const int64_t tiles = (m + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(tiles < 1 ? 1 : (tiles < most ? tiles : most));
  auto* l = static_cast<Entry*>(lists);
  Args a{static_cast<const int64_t*>(keys),
         static_cast<const bool*>(valid),
         static_cast<uint32_t>(m),
         static_cast<uint32_t>(cap - 1),
         cap,
         limit,
         static_cast<uint8_t*>(state),
         static_cast<int64_t*>(tkey),
         static_cast<uint32_t*>(ticket),
         {l, l + m},
         static_cast<uint8_t*>(pos_case),
         static_cast<int64_t*>(slot),
         static_cast<bool*>(found),
         static_cast<bool*>(created),
         static_cast<unsigned long long*>(ctl),
         create_new != 0};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(resolve),
                                    dim3(blocks), dim3(kThreads), params, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
