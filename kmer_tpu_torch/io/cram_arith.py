"""CRAM 3.1 adaptive codecs: arith (block method 6) and fqzcomp quality
(block method 7) (a copy of kmer_tpu/io/cram_arith.py).

Formats follow htscodecs' adaptive range coder as vendored in the
reference (behavioral reference:
the reference's htslib/htscodecs/htscodecs/arith_dynamic.c,
c_range_coder.h, c_simple_model.h, fqzcomp_qual.c) — re-derived here in
Python around one parameterised adaptive model class instead of the
macro-generated per-NSYM C variants.

The arith container mirrors the rANS Nx16 transform set (STRIPE / PACK
/ RLE / CAT / NOSZ) with two differences: RLE is folded into the
entropy coder itself (literal + run models, not a separate meta
stream), and X_EXT (0x04) hands the body to an external codec selected
by magic number (htslib builds only bzip2 in; so do we, via the stdlib
bz2 module).

fqzcomp is a quality-string codec: per-base adaptive models over a
16-bit context mixing previous quality, position, delta and selector
(fqz_update_ctx), with read lengths, optional dedup, reverse flags and
multi-parameter selectors decoded in-stream.  One vendored-version
quirk is replicated deliberately: the per-base context update and qmap
always use parameter block 0 — the selector only picks the block used
for the starting context / fixed-len / dedup decisions
(uncompress_block_fqz2f keeps `pm = &gp.p[0]` across records).

htslib only emits methods 6/7 at the samtools "small"/"archive"
profiles, so these decoders favour clarity over speed (pure Python,
adaptive models are inherently serial); QS blocks a few MB decode in
seconds, which is acceptable for the archival profiles they appear in.
"""

from __future__ import annotations

import struct
from typing import List, Optional

_TOP = 1 << 24
_M32 = 0xFFFFFFFF
_MAX_FREQ = (1 << 16) - 17
_STEP = 16


class _RC:
    """Carry-less range decoder (c_range_coder.h RC_* decode side)."""

    __slots__ = ("d", "o", "end", "range", "code", "err")

    def __init__(self, data, o, end):
        self.d = data
        self.o = o
        self.end = end
        self.range = _M32
        self.code = 0
        self.err = 0
        if o + 5 > end:
            self.o = end  # prevent decode
            return
        c = 0
        for _ in range(5):
            c = ((c << 8) | data[self.o]) & 0xFFFFFFFFFF
            self.o += 1
        self.code = c & _M32

    def get_freq(self, tot: int) -> int:
        if tot and self.range >= tot:
            self.range //= tot
            return self.code // self.range
        return 0

    def decode(self, cum: int, freq: int) -> None:
        self.code = (self.code - cum * self.range) & _M32
        self.range = (self.range * freq) & _M32
        while self.range < _TOP:
            if self.o >= self.end:
                self.err = -1
                return
            self.code = ((self.code << 8) + self.d[self.o]) & _M32
            self.o += 1
            self.range = (self.range << 8) & _M32


class _Model:
    """Adaptive symbol model (c_simple_model.h SIMPLE_MODEL): symbols
    kept approximately frequency-sorted with a one-step bubble per
    update; freqs renormalised by halving past MAX_FREQ.  Index 0 is
    the MAX_FREQ sentinel so the bubble swap never crosses the front."""

    __slots__ = ("freq", "sym", "tot", "nsym")

    def __init__(self, nsym: int, max_sym: int):
        self.freq = [_MAX_FREQ] + [1] * max_sym + [0] * (nsym - max_sym)
        self.sym = [0] + list(range(nsym))
        self.tot = max_sym
        self.nsym = nsym

    def decode(self, rc: _RC) -> int:
        if rc.err:
            # the C decoders set the flag and keep producing garbage
            # until their (caller-bounded) output fills, then reject at
            # RC_FinishDecode; failing at first underrun gives the same
            # rejection without letting a corrupt stored length drive a
            # multi-GB garbage loop
            raise ValueError("adaptive stream truncated")
        f = rc.get_freq(self.tot)
        if f > _MAX_FREQ:
            return 0
        freq = self.freq
        acc = 0
        i = 1
        while True:
            acc += freq[i]
            if acc > f:
                break
            i += 1
            if i > self.nsym + 0:
                return 0
        acc -= freq[i]
        rc.decode(acc, freq[i])
        freq[i] += _STEP
        self.tot += _STEP
        if self.tot > _MAX_FREQ:
            t = 0
            j = 1
            while j <= self.nsym and freq[j]:
                freq[j] -= freq[j] >> 1
                t += freq[j]
                j += 1
            self.tot = t
        out = self.sym[i]
        if freq[i] > freq[i - 1]:  # i-1 == 0 is the sentinel: never true
            freq[i], freq[i - 1] = freq[i - 1], freq[i]
            self.sym[i], self.sym[i - 1] = self.sym[i - 1], self.sym[i]
        return out


def _u7(data, o):
    """Big-endian uint7 varint (htscodecs varint.h under BIG_END);
    returns (value, next_offset)."""
    v = 0
    while True:
        c = data[o]
        o += 1
        v = (v << 7) | (c & 0x7F)
        if not c & 0x80:
            return v, o


_MAX_RUN = 4


def _arith_o0(data, o, out_sz: int, rle: bool) -> bytes:
    m = data[o] or 256
    byte_model = _Model(256, m)
    rc = _RC(data, o + 1, len(data))
    out = bytearray(out_sz)
    if not rle:
        for i in range(out_sz):
            out[i] = byte_model.decode(rc)
    else:
        run_models = [_Model(258, _MAX_RUN) for _ in range(258)]
        i = 0
        while i < out_sz:
            last = out[i] = byte_model.decode(rc)
            i += 1
            run = 0
            rctx = last
            while True:
                r = run_models[rctx].decode(rc)
                rctx = 256 if rctx == last else rctx + (rctx < 257)
                run += r
                if r != _MAX_RUN - 1 or run >= out_sz:
                    break
            while run and i < out_sz:
                run -= 1
                out[i] = last
                i += 1
    if rc.err:
        raise ValueError("arith stream truncated")
    return bytes(out)


def _arith_o1(data, o, out_sz: int, rle: bool) -> bytes:
    m = data[o] or 256
    byte_models = [_Model(256, m) for _ in range(256)]
    rc = _RC(data, o + 1, len(data))
    out = bytearray(out_sz)
    last = 0
    if not rle:
        for i in range(out_sz):
            last = out[i] = byte_models[last].decode(rc)
    else:
        run_models = [_Model(258, _MAX_RUN) for _ in range(258)]
        i = 0
        while i < out_sz:
            last = out[i] = byte_models[last].decode(rc)
            i += 1
            run = 0
            rctx = last
            while True:
                r = run_models[rctx].decode(rc)
                rctx = 256 if rctx == last else rctx + (rctx < 257)
                run += r
                if r != _MAX_RUN - 1 or run >= out_sz:
                    break
            while run and i < out_sz:
                run -= 1
                out[i] = last
                i += 1
    if rc.err:
        raise ValueError("arith stream truncated")
    return bytes(out)


def arith_decode(data: bytes, out_size: Optional[int]) -> bytes:
    """Decode one arith container (arith_uncompress_to)."""
    try:
        out = _arith_container(data, out_size)
    except (IndexError, KeyError, struct.error, MemoryError) as e:
        raise ValueError(
            f"truncated or corrupt arith block ({len(data)} bytes)"
        ) from e
    if out_size not in (None, len(out)):
        raise ValueError(
            f"arith block decoded to {len(out)} bytes, expected {out_size}")
    return out


def _arith_container(data, out_size: Optional[int]) -> bytes:
    if not data:
        raise ValueError("empty arith block")
    flags = data[0]
    if flags & 0x08:  # X_STRIPE: J sub-containers, byte-interleaved
        from .cram31 import _stripe_decode

        return _stripe_decode(data, out_size, _arith_container, "arith")

    o = 1
    order = flags & 3
    do_pack = flags & 0x80
    do_rle = flags & 0x40
    do_cat = flags & 0x20
    do_ext = flags & 0x04
    if not flags & 0x10:
        osz, o = _u7(data, o)
        if out_size is not None and osz != out_size:
            raise ValueError(
                f"arith block stored size {osz} != expected {out_size}")
    else:
        if out_size is None:
            raise ValueError("arith NOSZ block without expected size")
        osz = out_size
    if out_size is None and osz > (1 << 28):
        raise ValueError(f"arith block stored size {osz} implausible")

    pmap = None
    nsym = 0
    core_sz = osz
    if do_pack:
        from .cram31 import _pack_arity

        nsym, n_eff = _pack_arity(data[o])
        o += 1
        if nsym != 1:
            pmap = data[o : o + n_eff]
            if len(pmap) != n_eff:
                raise ValueError("arith pack map truncated")
            o += n_eff
        else:
            pmap = b""
        core_sz, o = _u7(data, o)
        if core_sz > osz:  # unpack only expands (C: osz > tmp1_size)
            raise ValueError(
                f"arith packed size {core_sz} exceeds block size {osz}")

    if core_sz == 0 or o >= len(data):
        cur = b""
        core_sz = 0
    elif do_cat:
        cur = bytes(data[o : o + core_sz])
        if len(cur) != core_sz:
            raise ValueError("arith CAT body truncated")
    elif do_ext:
        import bz2

        try:
            cur = bz2.decompress(bytes(data[o:]))
        except OSError as e:
            raise ValueError(f"arith external (bz2) body corrupt: {e}") from e
        if len(cur) != core_sz:
            raise ValueError("arith external (bz2) size mismatch")
    elif order == 1:
        cur = _arith_o1(data, o, core_sz, bool(do_rle))
    else:
        cur = _arith_o0(data, o, core_sz, bool(do_rle))

    if do_pack and nsym != 1:
        from .cram31 import _unpack

        cur = _unpack(cur, osz, nsym, pmap)
    if len(cur) != osz:
        raise ValueError(
            f"arith block decoded to {len(cur)} bytes, expected {osz}")
    return cur


# ---------------------------------------------------------------------------
# fqzcomp quality codec (block method 7)

_FQZ_VERS = 5
_CTX_SIZE = 1 << 16
_GFLAG_MULTI_PARAM = 1
_GFLAG_HAVE_STAB = 2
_GFLAG_DO_REV = 4
_PFLAG_DO_DEDUP = 2
_PFLAG_DO_LEN = 4
_PFLAG_DO_SEL = 8
_PFLAG_HAVE_QMAP = 16
_PFLAG_HAVE_PTAB = 32
_PFLAG_HAVE_DTAB = 64
_PFLAG_HAVE_QTAB = 128


def _read_array(data, o, size: int) -> tuple:
    """Two-level run-length coded table (fqzcomp_qual.c read_array);
    returns (array, next_offset)."""
    R = []
    z = 0
    last = -1
    i = o
    end = len(data)
    while z < size and i < end:
        run = data[i]
        i += 1
        R.append(run)
        z += run
        if run == last:
            if i >= end:
                raise ValueError("fqzcomp table truncated")
            copy = data[i]
            i += 1
            z += run * copy
            while copy and z <= size and len(R) < 1024:
                R.append(run)
                copy -= 1
        if len(R) >= 1024:
            raise ValueError("fqzcomp table overflow")
        last = run
    nb = i - o

    arr = []
    zi = 0
    val = 0
    while len(arr) < size:
        if zi >= len(R):
            raise ValueError("fqzcomp table underrun")
        run_len = 0
        while True:
            part = R[zi]
            zi += 1
            run_len += part
            if part != 255 or zi >= len(R):
                break
        if part == 255:
            raise ValueError("fqzcomp table underrun")
        while run_len and len(arr) < size:
            run_len -= 1
            arr.append(val)
        val += 1
    return arr, o + nb


class _FqzParam:
    __slots__ = ("context", "pflags", "use_qtab", "use_dtab", "use_ptab",
                 "do_sel", "fixed_len", "do_dedup", "store_qmap", "max_sym",
                 "qbits", "qmask", "qshift", "qloc", "sloc", "ploc", "dloc",
                 "qmap", "qtab", "ptab", "dtab")


def _fqz_read_param1(data, o) -> tuple:
    pm = _FqzParam()
    pm.context = data[o] | (data[o + 1] << 8)
    o += 2
    pf = pm.pflags = data[o]
    o += 1
    pm.use_qtab = pf & _PFLAG_HAVE_QTAB
    pm.use_dtab = pf & _PFLAG_HAVE_DTAB
    pm.use_ptab = pf & _PFLAG_HAVE_PTAB
    pm.do_sel = pf & _PFLAG_DO_SEL
    pm.fixed_len = pf & _PFLAG_DO_LEN
    pm.do_dedup = pf & _PFLAG_DO_DEDUP
    pm.store_qmap = pf & _PFLAG_HAVE_QMAP
    pm.max_sym = data[o]
    o += 1
    pm.qbits = data[o] >> 4
    pm.qmask = (1 << pm.qbits) - 1
    pm.qshift = data[o] & 15
    o += 1
    pm.qloc = data[o] >> 4
    pm.sloc = data[o] & 15
    o += 1
    pm.ploc = data[o] >> 4
    pm.dloc = data[o] & 15
    o += 1

    if pm.store_qmap:
        pm.qmap = list(data[o : o + pm.max_sym])
        if len(pm.qmap) != pm.max_sym:
            raise ValueError("fqzcomp qmap truncated")
        o += pm.max_sym
    else:
        pm.qmap = list(range(256))

    if pm.qbits and pm.use_qtab:
        pm.qtab, o = _read_array(data, o, 256)
    else:
        pm.qtab = list(range(256))

    if pm.use_ptab:
        pm.ptab, o = _read_array(data, o, 1024)
    else:
        pm.ptab = [0] * 1024

    if pm.use_dtab:
        pm.dtab, o = _read_array(data, o, 256)
    else:
        pm.dtab = [0] * 256
    return pm, o


def fqz_decode(data: bytes, out_size: Optional[int]) -> bytes:
    """Decode one fqzcomp quality block (uncompress_block_fqz2f)."""
    try:
        out = _fqz_decode(data, out_size)
    except (IndexError, KeyError, struct.error, MemoryError) as e:
        raise ValueError(
            f"truncated or corrupt fqzcomp block ({len(data)} bytes)"
        ) from e
    if out_size not in (None, len(out)):
        raise ValueError(
            f"fqzcomp block decoded to {len(out)} bytes, expected {out_size}")
    return out


def _fqz_decode(data: bytes, out_size: Optional[int] = None) -> bytes:
    length, o = _u7(data, 0)
    if out_size is not None and length != out_size:
        raise ValueError(
            f"fqzcomp stored size {length} != expected {out_size}")
    if out_size is None and length > (1 << 28):
        raise ValueError(f"fqzcomp stored size {length} implausible")
    vers = data[o]
    o += 1
    if vers != _FQZ_VERS:
        raise ValueError(f"fqzcomp version {vers} unsupported (expect 5)")
    gflags = data[o]
    o += 1
    nparam = 1
    if gflags & _GFLAG_MULTI_PARAM:
        nparam = data[o]
        o += 1
    if nparam <= 0:
        raise ValueError("fqzcomp with zero parameter blocks")
    max_sel = nparam if nparam > 1 else 0
    if gflags & _GFLAG_HAVE_STAB:
        max_sel = data[o]
        o += 1
        stab, o = _read_array(data, o, 256)
    else:
        stab = [min(i, nparam - 1) for i in range(256)]

    params: List[_FqzParam] = []
    max_sym = 0
    for _ in range(nparam):
        pm, o = _fqz_read_param1(data, o)
        if pm.do_sel and max_sel == 0:
            raise ValueError("fqzcomp selector without selector table")
        params.append(pm)
        max_sym = max(max_sym, pm.max_sym)

    # factor the final shifts into the tables (decoder fast path)
    for pm in params:
        pm.ptab = [v << pm.ploc for v in pm.ptab]
        pm.dtab = [v << pm.dloc for v in pm.dtab]

    qual_models = [_Model(256, max_sym + 1) for _ in range(_CTX_SIZE)]
    len_models = [_Model(256, 256) for _ in range(4)]
    rev_model = _Model(2, 2)
    dup_model = _Model(2, 2)
    sel_model = _Model(256, max_sel + 1) if max_sel > 0 else None

    rc = _RC(data, o, len(data))
    out = bytearray(length)

    # state (fqz_state)
    s_delta = 0
    s_prevq = 0
    s_qctx = 0
    s_p = 0
    s_sel = 0
    first_len = True
    last_len = 0
    last = 0
    rev_flags: List[int] = []
    len_list: List[int] = []

    # the vendored decoder's pm for the per-base loop is ALWAYS block 0
    pm0 = params[0]
    qmap0 = pm0.qmap
    qtab0 = pm0.qtab
    ptab0 = pm0.ptab
    dtab0 = pm0.dtab
    i = 0
    while i < length:
        if s_p == 0:
            # --- decompress_new_read ---
            s_sel = sel_model.decode(rc) if pm0.do_sel else 0
            x = stab[min(255, s_sel)] if gflags & _GFLAG_HAVE_STAB else s_sel
            if x >= nparam:
                raise ValueError("fqzcomp selector out of range")
            pm = params[x]
            ln = last_len
            if not pm.fixed_len or first_len:
                ln = len_models[0].decode(rc)
                ln |= len_models[1].decode(rc) << 8
                ln |= len_models[2].decode(rc) << 16
                ln |= len_models[3].decode(rc) << 24
                first_len = False
                last_len = ln
            if ln > length - i or ln <= 0:
                raise ValueError("fqzcomp bad read length")
            if gflags & _GFLAG_DO_REV:
                rev_flags.append(rev_model.decode(rc))
                len_list.append(ln)
            if pm.do_dedup and dup_model.decode(rc):
                if ln > i:
                    raise ValueError("fqzcomp dup before first read")
                out[i : i + ln] = out[i - ln : i]
                i += ln
                continue
            s_p = ln
            s_delta = 0
            s_prevq = 0
            s_qctx = 0
            last = pm.context
        while True:
            q = qual_models[last].decode(rc)
            # fqz_update_ctx(pm0, ...)
            s_qctx = ((s_qctx << pm0.qshift) + qtab0[q]) & 0xFFFFFFFF
            last = ((s_qctx & pm0.qmask) << pm0.qloc)
            last += ptab0[min(1023, s_p)]
            last += dtab0[min(255, s_delta)]
            last += s_sel << pm0.sloc
            last &= _CTX_SIZE - 1
            s_delta += s_prevq != q
            s_prevq = q
            s_p -= 1
            out[i] = qmap0[q]
            i += 1
            if s_p == 0 or i >= length:
                break

    if gflags & _GFLAG_DO_REV:
        i = 0
        for rev, ln in zip(rev_flags, len_list):
            if rev:
                out[i : i + ln] = out[i : i + ln][::-1]
            i += ln
    if rc.err:
        raise ValueError("fqzcomp stream truncated")
    return bytes(out)
