"""yak-count's bloom geometry and its single-file stderr simulation (port
of kmer_tpu/pipeline/yak.py: the constants, `_clamp_bf_shift`,
`_bloom_geometry_ok`, `_make_bloom` without a bits array, `YakSimTap`).

Single-file yak-count counts on the sort engine (pipeline/counter.py);
`YakSimTap` rides the engine's extracted key planes and gives the
reference's per-batch `[M] processed N sequences; M distinct k-mers in
the hash table` totals through the deferred admission engine
(pipeline/yak_admit.py).  The table engines and the two-file engine
(`YakEngine`, `SortYakEngine`, the mesh engines) are not ported yet.
"""

from __future__ import annotations

import os

from ..kernels.bloom import BLK_SHIFT, BloomSpec
from ..utils.log import warn

YAK_COUNTER_BITS = 10  # yak-count.c:9
YAK_N_COUNTS = 1 << YAK_COUNTER_BITS
YAK_MAX_COUNT = YAK_N_COUNTS - 1


def _clamp_bf_shift(bf_shift: int, owner_bits: int = 0) -> int:
    """The largest bloom is 2^31 bits per device (the JAX package's
    byte-per-bit layout, kept so both admit the same keys); a larger -b
    clamps with a warning (yak.py:105-124).  Single-file output does not
    depend on the bloom's size."""
    cap = 31 + owner_bits
    if bf_shift > cap:
        warn("yak_count",
             f"bloom size 2^{bf_shift} exceeds the per-device budget; "
             f"using 2^{cap} bits")
        return cap
    return bf_shift


def _bloom_geometry_ok(bf_shift: int, pre: int, owner_bits: int = 0) -> bool:
    """True when the (possibly clamped) bloom still holds at least one
    512-bit block per -p subtable; else the bloom is disabled with a
    warning (yak.py:141-155)."""
    clamped = min(bf_shift, 31 + owner_bits)
    if clamped - pre >= BLK_SHIFT:
        return True
    warn("yak_count",
         f"clamped bloom (2^{clamped} bits) leaves fewer than one "
         f"512-bit block per -p{pre} subtable; bloom prefilter disabled")
    return False


def _make_bloom(pre: int, bf_shift: int, bf_n_hash: int):
    """The bloom-geometry gate (yak.py:160-183, make_bits_array=False):
    (use_bloom, bf_shift, spec or None).  The gates mirror yak_ch_init
    (n_shift > pre) and yak_bf_init (BLK_SHIFT <= n_shift - pre)."""
    use_bloom = (
        bf_n_hash > 0
        and bf_shift > pre
        and (bf_shift - pre) >= BLK_SHIFT
        and _bloom_geometry_ok(bf_shift, pre)
    )
    if not use_bloom:
        return False, bf_shift, None
    bf_shift = _clamp_bf_shift(bf_shift)
    return True, bf_shift, BloomSpec(pre, bf_shift, bf_n_hash)


class YakSimTap:
    """Single-file stderr progress simulation (yak.py:263-327): per
    block, record the key plane in the deferred admission engine; at the
    end, resolve every batch's admitted-distinct total and call
    log(n_seqs, running_total) once per batch.

    KMER_TPU_TAP_BUDGET (bytes, default 2 GiB) is the admission
    compactor's budget, as in the JAX package.  `device` is the engine's;
    `plain_kernels` makes the admission merges use the plain PyTorch
    version (kernels/merge.py), as the engine's own switch does."""

    def __init__(self, pre=10, bf_shift=0, bf_n_hash=4, log=None,
                 device=None, plain_kernels: bool = False):
        from .. import default_device
        from .yak_admit import DeferredYakAdmission

        self.log = log
        self.use_bloom, _bf, self.spec = _make_bloom(pre, bf_shift, bf_n_hash)
        budget = int(os.environ.get("KMER_TPU_TAP_BUDGET", str(2 << 30)))
        self.adm = DeferredYakAdmission(
            self.spec, self.use_bloom, budget_bytes=budget,
            device=device if device is not None else default_device(),
            plain_kernels=plain_kernels)
        self.tot = 0
        self.batch_seq_counts = []
        self._batch_seqs = 0

    def begin_batches(self) -> None:
        self.batch_seq_counts = []
        self._batch_seqs = 0

    def ingest_planes(self, keys, n_valid, n_seqs, batch_end) -> None:
        """The engine's tap: one block's key plane (count_paths)."""
        self.adm.add_block(keys, bool(batch_end))
        self._batch_seqs += int(n_seqs)
        if batch_end:
            self.batch_seq_counts.append(self._batch_seqs)
            self._batch_seqs = 0

    def finish_batches(self) -> None:
        if self._batch_seqs or self.adm._pending:
            self.batch_seq_counts.append(self._batch_seqs)
            self._batch_seqs = 0
        per_batch, self.tot = self.adm.finish()
        if self.log is not None:
            running = 0
            for n_seqs, new in zip(self.batch_seq_counts, per_batch):
                running += int(new)
                self.log(n_seqs, running)

    @property
    def budget_trips(self) -> int:
        return self.adm.fs.trips

