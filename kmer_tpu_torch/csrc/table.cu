// Slot resolution of the open-addressing count table, one round at a
// time over a compacted list of the lanes still active.
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
// same slot, found and created outputs, so a table built on the card
// equals the JAX package's plane for plane (checkpoints cross between the
// two).  A round's result does not depend on the order in which its
// lanes are visited (atomicMax does not; every decision is per lane), so
// a round works over the list of active lanes in any order:
//
//   resolve_probe   one thread a listed lane: read the state byte and,
//                   when FULL, the 8-byte key at its slot; claim an EMPTY
//                   slot with atomicMax on the ticket; record the slot
//                   and the lane's case (empty / match / other) beside
//                   the list, coalesced.
//   resolve_decide  one thread a listed lane: a match writes slot and
//                   found; a claim that holds the ticket's value won and
//                   writes key, FULL, created and slot; a lost claim
//                   stays; other advances.  The survivors are appended
//                   to the next round's list with one atomicAdd a warp
//                   (ballot, popc, shfl).
//
// The host reads the survivor count (4 bytes) after each round and
// launches the next round over that many lanes.  So round r costs the
// lanes still active in it, where the plain form of the loop makes about
// ten masked passes over all m lanes every round.
//
// Bound on the H100: memory, in random 32-byte sectors.  Each probe of a
// listed lane reads the sector of its state byte and, for a FULL slot,
// the sector of its key; a claim adds the ticket's sector.  The lists,
// slots and cases are coalesced.  At one probe a lane (a fresh table)
// the sectors dominate; each further round adds the latecomers' probes
// and two launches (the launch-latency floor of a round).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint8_t kEmpty = 0;
constexpr uint8_t kFull = 1;
// a listed lane's case after the probe
constexpr uint8_t kCaseEmpty = 0;
constexpr uint8_t kCaseMatch = 1;
constexpr uint8_t kCaseOther = 2;

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

struct Round {
  const int64_t* keys;  // [m] biased keys of the batch
  uint32_t m;           // the lane plane's length (the tag's stride)
  uint32_t cap_mask;    // cap - 1
  uint8_t* state;       // [cap] EMPTY / FULL / DELETED
  int64_t* tkey;        // [cap] the table's keys
  uint32_t* ticket;     // [cap] zeroed once a call (create_new only)
  uint32_t* off;        // [m] probe offsets
  const int32_t* list;  // [n] this round's active lanes
  int64_t n;
  int32_t* next;        // the next round's list
  int32_t* next_n;      // its length, zeroed before the round
  uint32_t* pos_slot;   // [n] a listed lane's slot this round
  uint8_t* pos_case;    // [n] its case
  int64_t* slot;        // [m] cap until resolved
  bool* found;          // [m]
  bool* created;        // [cap]
  uint32_t round;       // mod 2^32, as the tag's arithmetic is
  bool create_new;
};

__global__ void resolve_probe(Round r) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= r.n) return;
  const int32_t lane = r.list[i];
  const int64_t key = r.keys[lane];
  const uint32_t idx = (slot_mix32(key) + r.off[lane]) & r.cap_mask;
  const uint8_t st = r.state[idx];
  uint8_t c = kCaseOther;
  if (st == kEmpty) {
    c = kCaseEmpty;
    if (r.create_new)
      atomicMax(&r.ticket[idx], r.round * r.m + static_cast<uint32_t>(lane) + 1u);
  } else if (st == kFull && r.tkey[idx] == key) {
    c = kCaseMatch;
  }
  r.pos_slot[i] = idx;
  r.pos_case[i] = c;
}

__global__ void resolve_decide(Round r) {
  // every thread of a warp reaches the ballot: no early return
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  bool keep = false;
  int32_t lane = 0;
  if (i < r.n) {
    lane = r.list[i];
    const uint32_t idx = r.pos_slot[i];
    const uint8_t c = r.pos_case[i];
    if (c == kCaseMatch) {
      r.slot[lane] = idx;
      r.found[lane] = true;
    } else if (c == kCaseEmpty) {
      // without create_new an EMPTY slot means absent: slot stays cap
      if (r.create_new) {
        if (r.ticket[idx] ==
            r.round * r.m + static_cast<uint32_t>(lane) + 1u) {
          r.tkey[idx] = r.keys[lane];
          r.state[idx] = kFull;
          r.created[idx] = true;
          r.slot[lane] = idx;
        } else {
          keep = true;  // lost: the slot is FULL now, read it again
        }
      }
    } else {
      r.off[lane] += 1u;
      keep = true;
    }
  }
  const unsigned mask = __ballot_sync(0xffffffffu, keep);
  if (mask == 0u) return;
  const int me = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int32_t base = 0;
  if (me == leader) base = atomicAdd(r.next_n, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (keep) r.next[base + __popc(mask & ((1u << me) - 1u))] = lane;
}

}  // namespace

// One round over the n >= 1 lanes of `list`: zero *next_n, probe,
// decide.  keys: int64[m], m < 2^31; state: uint8[cap], tkey:
// int64[cap], ticket: uint32[cap] (unused without create_new), cap a
// power of two <= 2^31; off: uint32[m]; list, next: int32[>= n];
// next_n: int32[1]; pos_slot: uint32[>= n]; pos_case: uint8[>= n];
// slot: int64[m]; found: bool[m]; created: bool[cap].
extern "C" int ktt_resolve_round(const void* keys, int64_t m, int64_t cap,
                                 void* state, void* tkey, void* ticket,
                                 void* off, const void* list, int64_t n,
                                 void* next, void* next_n, void* pos_slot,
                                 void* pos_case, void* slot, void* found,
                                 void* created, int64_t round, int create_new,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Round r{static_cast<const int64_t*>(keys),
                static_cast<uint32_t>(m),
                static_cast<uint32_t>(cap - 1),
                static_cast<uint8_t*>(state),
                static_cast<int64_t*>(tkey),
                static_cast<uint32_t*>(ticket),
                static_cast<uint32_t*>(off),
                static_cast<const int32_t*>(list),
                n,
                static_cast<int32_t*>(next),
                static_cast<int32_t*>(next_n),
                static_cast<uint32_t*>(pos_slot),
                static_cast<uint8_t*>(pos_case),
                static_cast<int64_t*>(slot),
                static_cast<bool*>(found),
                static_cast<bool*>(created),
                static_cast<uint32_t>(round),
                create_new != 0};
  cudaError_t err = cudaMemsetAsync(next_n, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  resolve_probe<<<blocks, kThreads, 0, s>>>(r);
  resolve_decide<<<blocks, kThreads, 0, s>>>(r);
  return cudaGetLastError();
}
