"""CRAM 3.1 entropy codecs: rANS Nx16 (block method 5) and the name
tokenizer (method 8) (a copy of kmer_tpu/io/cram31.py).

Formats follow the CRAM 3.1 codec specification as implemented by
htslib's htscodecs (behavioral reference:
the reference's htslib/htscodecs/htscodecs/rANS_static4x16pr.c,
rANS_static32x16pr.c, pack.c, rle.c, tokenise_name3.c) — re-derived
here in Python, structured around a single N-state decoder rather than
htscodecs' unrolled per-width C variants.

The rANS Nx16 container is a flag byte, then optional transforms
wrapped around an order-0/1 interleaved-state rANS core:

  bit 0     ORDER   order-1 context modelling (else order-0)
  0x04      X32     32 interleaved states (else 4) — the SIMD layout
  0x08      STRIPE  J interleaved sub-streams, each its own container
  0x10      NOSZ    uncompressed size omitted (caller supplies it)
  0x20      CAT     payload stored raw
  0x40      RLE     run-length transform (meta: runs stream + symbol set)
  0x80      PACK    bit-pack 1/2/4-bit symbols (meta: value map)

States renormalize 16 bits at a time against a 2^15 lower bound;
frequency tables are uint7 varints over a run-length-coded alphabet,
normalized to 2^12 (order-0) or 2^shift (order-1, shift in the table's
leading byte, which may itself be order-0-rANS compressed).

The name tokenizer (tok3) splits read names into per-position token
streams (type / string / char / digits / delta ...), each compressed
with the rANS Nx16 codec above (use_arith=0) or the adaptive range
coder (use_arith=1, the "small"/"archive" profiles — cram_arith.py).
fqzcomp (method 7) and arith (6) containers live in cram_arith.py.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

_RANS_LOW = 1 << 15  # Nx16 renormalization lower bound


class _Cur:
    __slots__ = ("d", "o")

    def __init__(self, data, o=0):
        self.d = data
        self.o = o

    def u8(self):
        v = self.d[self.o]
        self.o += 1
        return v

    def u7(self):
        """uint7 varint: BIG-endian 7-bit groups, high bit = more
        (htscodecs varint.h var_get_u32 under BIG_END — most significant
        group first; NOT the little-endian #else variant in that file)."""
        v = 0
        while True:
            c = self.d[self.o]
            self.o += 1
            v = (v << 7) | (c & 0x7F)
            if not c & 0x80:
                return v

    def take(self, n):
        b = self.d[self.o : self.o + n]
        if len(b) != n:
            raise ValueError("truncated rANS Nx16 stream")
        self.o += n
        return b




def _pack_arity(n: int):
    """PACK symbol-count byte -> (values-per-byte code, effective map
    size): <=1 sym: constant fill; <=2: 8/byte; <=4: 4/byte; <=16:
    2/byte; else no packing and NO map bytes (hts_unpack_meta, pack.c).
    Shared by the rANS Nx16 and arith containers."""
    n_eff = n or 256
    if n_eff <= 1:
        return 0, n_eff
    if n_eff <= 2:
        return 8, n_eff
    if n_eff <= 4:
        return 4, n_eff
    if n_eff <= 16:
        return 2, n_eff
    return 1, n_eff


def _stripe_decode(data, out_sz, sub_decode, label: str) -> bytes:
    """STRIPE container body: [u7 ulen][u8 N][u7 clen x N][sub-streams],
    each sub-stream its own container decoded by `sub_decode`, outputs
    byte-interleaved (utils.h unstripe).  Shared by the rANS Nx16 and
    arith containers — the geometry (per-stream lengths, interleave) is
    identical in both (rANS_static4x16pr.c / arith_dynamic.c)."""
    c = _Cur(data, 1)
    ulen = c.u7()
    if out_sz is not None and ulen != out_sz:
        raise ValueError(f"{label} stripe size {ulen} != expected {out_sz}")
    if out_sz is None and ulen > (1 << 28):
        raise ValueError(f"{label} stripe size {ulen} implausible")
    n_sub = c.u8()
    if n_sub < 1:
        raise ValueError(f"{label} stripe with zero sub-streams")
    clens = [c.u7() for _ in range(n_sub)]
    out = bytearray(ulen)
    for j in range(n_sub):
        sub_len = ulen // n_sub + (1 if (ulen % n_sub) > j else 0)
        sub = sub_decode(c.take(clens[j]), sub_len)
        if len(sub) != sub_len:
            raise ValueError(f"{label} stripe sub-stream size mismatch")
        out[j::n_sub] = sub
    return bytes(out)


def _decode_alphabet(c: _Cur) -> List[int]:
    """Present-symbol list: explicit symbol bytes, where sym followed by
    sym+1 introduces an RLE run byte covering consecutive symbols;
    terminates on symbol 0 (rANS_static16_int.h decode_alphabet)."""
    syms = []
    rle = 0
    j = c.u8()
    while True:
        syms.append(j)
        if rle:
            rle -= 1
            j += 1
        elif c.d[c.o] == j + 1:
            j = c.u8()
            rle = c.u8()
        else:
            j = c.u8()
        if j == 0:
            break
    return syms


def _norm_shift(freq: List[int], total: int, target: int) -> None:
    """Scale power-of-two totals up to the table size by shifting."""
    if total and total != target:
        sh = 0
        while total < target:
            total <<= 1
            sh += 1
        for i in range(256):
            freq[i] <<= sh


def _build_lut(freq: List[int], bits: int):
    """slot -> (symbol, freq, slot_base) over the 2^bits table."""
    size = 1 << bits
    ssym = bytearray(size)
    sfreq = [0] * size
    sbase = [0] * size
    x = 0
    for s in range(256):
        f = freq[s]
        if f:
            if f > size - x:
                raise ValueError("rANS Nx16 frequency table overflow")
            for y in range(f):
                ssym[x + y] = s
                sfreq[x + y] = f
                sbase[x + y] = y
            x += f
    if x != size:
        raise ValueError("rANS Nx16 frequency table does not sum to table size")
    return bytes(ssym), sfreq, sbase


def _o0_decode(data, out_sz: int, n_states: int) -> bytes:
    """Raw order-0 body (freq table + N states), no flag byte."""
    if out_sz == 0:
        return b""
    c = _Cur(data)
    freq = [0] * 256
    total = 0
    for s in _decode_alphabet(c):
        freq[s] = f = c.u7()
        total += f
    _norm_shift(freq, total, 1 << 12)
    ssym, sfreq, sbase = _build_lut(freq, 12)
    cum = [0] * 256
    x = 0
    for s in range(256):
        cum[s] = x
        x += freq[s]
    R = list(struct.unpack_from("<%dI" % n_states, c.d, c.o))
    c.o += 4 * n_states
    d, o = c.d, c.o
    end = len(d)
    out = bytearray(out_sz)
    for i in range(out_sz):
        x = R[i % n_states]
        m = x & 0xFFF
        s = ssym[m]
        out[i] = s
        x = sfreq[m] * (x >> 12) + m - cum[s]
        # safe renorm (RansDecRenormSafe): stop feeding at buffer end —
        # the tail symbols' states legitimately run dry there
        if x < _RANS_LOW and o + 1 < end:
            x = (x << 16) | d[o] | (d[o + 1] << 8)
            o += 2
        R[i % n_states] = x
    return bytes(out)


def _o1_decode(data, out_sz: int, n_states: int) -> bytes:
    """Order-1 body: shift/comp byte, alphabet + per-context tables
    (optionally order-0-compressed), N contiguous output fragments with
    the remainder decoded by the last state."""
    if out_sz == 0:
        return b""
    c = _Cur(data)
    b0 = c.u8()
    shift = b0 >> 4
    if b0 & 1:
        # the compressed table is a RAW order-0 body with 4 states — no
        # container flag byte, regardless of the outer block's X32 flag
        # (rans_uncompress_O1_4x16 and _32x16 both call
        # rans_uncompress_O0_4x16 on it, rANS_static4x16pr.c:583,
        # rANS_static32x16pr.c:598)
        u_sz = c.u7()
        c_sz = c.u7()
        tab = _Cur(_o0_decode(c.take(c_sz), u_sz, 4))
    else:
        tab = c
    syms = _decode_alphabet(tab)
    present = [False] * 256
    for s in syms:
        present[s] = True
    # per-context tables; zero freqs for present symbols are run-length
    # coded (decode_freq_d: f==0 is followed by an extra-zeros count)
    tables: Dict[int, Tuple[bytes, List[int], List[int], List[int]]] = {}
    for i in syms:
        freq = [0] * 256
        total = 0
        dz = 0
        for j in range(256):
            if not present[j]:
                continue
            if dz:
                dz -= 1
                continue
            f = tab.u7()
            if f == 0:
                dz = tab.u8()
            freq[j] = f
            total += f
        if not total:
            continue
        _norm_shift(freq, total, 1 << shift)
        ssym, sfreq, sbase = _build_lut(freq, shift)
        cum = [0] * 256
        x = 0
        for s in range(256):
            cum[s] = x
            x += freq[s]
        tables[i] = (ssym, sfreq, sbase, cum)
    R = list(struct.unpack_from("<%dI" % n_states, c.d, c.o))
    c.o += 4 * n_states
    d, o = c.d, c.o
    end = len(d)
    out = bytearray(out_sz)
    mask = (1 << shift) - 1
    isz = out_sz // n_states
    pos = [z * isz for z in range(n_states)]
    ctx = [0] * n_states
    for _ in range(isz):
        for z in range(n_states):
            ssym, sfreq, sbase, cum = tables[ctx[z]]
            x = R[z]
            m = x & mask
            s = ssym[m]
            out[pos[z]] = s
            pos[z] += 1
            x = sfreq[m] * (x >> shift) + m - cum[s]
            if x < _RANS_LOW and o + 1 < end:  # safe renorm
                x = (x << 16) | d[o] | (d[o + 1] << 8)
                o += 2
            R[z] = x
            ctx[z] = s
    z = n_states - 1  # remainder rides the last state's context chain
    x = R[z]
    last = ctx[z]
    for i in range(n_states * isz, out_sz):
        ssym, sfreq, sbase, cum = tables[last]
        m = x & mask
        s = ssym[m]
        out[i] = s
        x = sfreq[m] * (x >> shift) + m - cum[s]
        if x < _RANS_LOW and o + 1 < end:  # safe renorm
            x = (x << 16) | d[o] | (d[o + 1] << 8)
            o += 2
        last = s
    return bytes(out)


def _unpack(data, out_len: int, nsym: int, pmap) -> bytes:
    """Expand bit-packed values, low bits first (pack.c hts_unpack)."""
    out = bytearray(out_len)
    i = 0
    if nsym == 0:
        return bytes([pmap[0]]) * out_len
    if nsym == 8:
        for b in data:
            for k in range(8):
                if i >= out_len:
                    break
                out[i] = pmap[(b >> k) & 1]
                i += 1
    elif nsym == 4:
        for b in data:
            for k in range(0, 8, 2):
                if i >= out_len:
                    break
                out[i] = pmap[(b >> k) & 3]
                i += 1
    elif nsym == 2:
        for b in data:
            for k in (0, 4):
                if i >= out_len:
                    break
                out[i] = pmap[(b >> k) & 15]
                i += 1
    else:
        raise ValueError(f"bad pack arity {nsym}")
    if i < out_len:
        raise ValueError("packed stream too short")
    return bytes(out)


def _unrle(lit, runs, rle_syms, out_len_hint: int) -> bytes:
    """Expand literals + per-symbol run lengths (rle.c hts_rle_decode:
    a literal in the run-symbol set consumes one uint7 run length and
    repeats rlen additional times)."""
    in_set = [False] * 256
    for s in rle_syms:
        in_set[s] = True
    rc = _Cur(runs)
    out = bytearray()
    for b in lit:
        if in_set[b]:
            rlen = rc.u7()
            out += bytes([b]) * (rlen + 1)
        else:
            out.append(b)
        # hts_rle_decode bounds expansion by out_end; a corrupt run
        # length must not balloon memory before the post-hoc size check
        if len(out) > out_len_hint:
            raise ValueError("rANS Nx16 RLE expansion exceeds block size")
    return bytes(out)


def _uncompress_container(data, out_sz: Optional[int]) -> bytes:
    """Full rANS Nx16 container: flag byte, transforms, core decode.
    out_sz is the caller's expected size (needed when NOSZ is set)."""
    if not data:
        raise ValueError("empty rANS Nx16 block")
    flags = data[0]
    if flags & 0x08:  # STRIPE: J sub-containers, byte-interleaved
        return _stripe_decode(data, out_sz, _uncompress_container,
                              "rANS Nx16")

    c = _Cur(data, 1)
    order = flags & 1
    n_states = 32 if flags & 0x04 else 4
    do_pack = flags & 0x80
    do_rle = flags & 0x40
    do_cat = flags & 0x20
    if not flags & 0x10:
        osz = c.u7()
        if out_sz is not None and osz != out_sz:
            raise ValueError(
                f"rANS Nx16 stored size {osz} != expected {out_sz}")
        if out_sz is None and osz > (1 << 28):
            raise ValueError(f"rANS Nx16 stored size {osz} implausible")
    else:
        if out_sz is None:
            raise ValueError("rANS Nx16 NOSZ block without expected size")
        osz = out_sz

    pmap = None
    nsym = 0
    core_sz = osz
    if do_pack:
        nsym, n_eff = _pack_arity(c.u8())
        pmap = c.take(n_eff) if nsym != 1 else b""
        core_sz = c.u7()
        if core_sz > osz:  # unpack only expands (C: osz > tmp1_size)
            raise ValueError(
                f"rANS Nx16 packed size {core_sz} exceeds block size {osz}")

    rle_syms = runs = None
    if do_rle:
        u_meta = c.u7()
        rle_len = c.u7()
        if rle_len > osz:  # "should never grow" (rANS_static4x16pr.c)
            raise ValueError(
                f"rANS Nx16 RLE size {rle_len} exceeds block size {osz}")
        if u_meta & 1:
            meta = c.take(u_meta // 2)
        else:
            c_meta = c.u7()
            meta = _o0_decode(c.take(c_meta), u_meta // 2, n_states)
        n_rs = meta[0] or 256
        rle_syms = meta[1 : 1 + n_rs]
        runs = meta[1 + n_rs :]
        core_sz = rle_len

    rest = c.d[c.o :]
    if core_sz == 0:
        cur = b""
    elif do_cat:
        cur = bytes(rest[:core_sz])
    elif order:
        cur = _o1_decode(rest, core_sz, n_states)
    else:
        cur = _o0_decode(rest, core_sz, n_states)

    if do_rle:
        cur = _unrle(cur, runs, rle_syms, osz)
    if do_pack and nsym != 1:
        cur = _unpack(cur, osz, nsym, pmap)
    if len(cur) != osz:
        raise ValueError(
            f"rANS Nx16 block decoded to {len(cur)} bytes, expected {osz}"
        )
    return cur


def rans_nx16_decode(data: bytes, out_size: int) -> bytes:
    """Decode one CRAM 3.1 rANS Nx16 block (block method 5)."""
    try:
        out = _uncompress_container(data, out_size)
    except (IndexError, KeyError, struct.error, MemoryError) as e:
        raise ValueError(
            f"truncated or corrupt rANS Nx16 block ({len(data)} bytes, "
            f"expected {out_size} uncompressed)"
        ) from e
    if len(out) != out_size:
        raise ValueError(
            f"rANS Nx16 block decoded to {len(out)} bytes, "
            f"expected {out_size}"
        )
    return out


# ---------------------------------------------------------------------------
# tok3 name tokenizer (block method 8)

# token types (tokenise_name3.c enum name_type)
_T_TYPE, _T_ALPHA, _T_CHAR, _T_DIGITS0, _T_DZLEN, _T_DUP, _T_DIFF = range(7)
_T_DIGITS, _T_DDELTA, _T_DDELTA0, _T_MATCH, _T_NOP, _T_END = range(7, 13)


class _Stream:
    __slots__ = ("buf", "pos")

    def __init__(self, buf=b""):
        self.buf = buf
        self.pos = 0

    def byte(self):
        if self.pos >= len(self.buf):
            return -1
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self):
        if self.pos + 4 > len(self.buf):
            raise ValueError("tok3 stream underrun")
        v = struct.unpack_from("<I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def cstr(self):
        end = self.buf.index(0, self.pos)
        s = self.buf[self.pos : end]
        self.pos = end + 1
        return s


def tok3_decode_names(data: bytes, out_size: int) -> bytes:
    """Decode a tok3-compressed read-name block into the \\0-separated
    names buffer the RN data series expects.  Layout: u32 ulen, u32
    nreads, u8 use_arith, then a sequence of token streams, each a
    descriptor byte (0x80 = new token position, 0x40 = duplicate of an
    earlier stream, low 4 bits = token type) followed by either a
    2-byte source id (dup) or a uint7 clen + rANS Nx16 container."""
    try:
        return _tok3_decode_names(data, out_size)
    except (IndexError, KeyError, struct.error, MemoryError) as e:
        raise ValueError(
            f"truncated or corrupt tok3 name block ({len(data)} bytes)"
        ) from e


def _tok3_decode_names(data: bytes, out_size: int) -> bytes:
    if len(data) < 9:
        raise ValueError("truncated tok3 name block")
    ulen, nreads = struct.unpack_from("<II", data, 0)
    use_arith = data[8]
    if use_arith:
        # the small/archive profiles' token streams use the adaptive
        # range coder (tokenise_name3.c:1215 arith_uncompress_to)
        from .cram_arith import arith_decode as _container
    else:
        _container = _uncompress_container
    desc: Dict[int, _Stream] = {}
    o = 9
    tnum = -1
    max_tok = 0
    while o < len(data):
        ttype = data[o]
        o += 1
        if ttype & 128:
            tnum += 1
            max_tok = tnum + 1
        if tnum < 0:
            raise ValueError("tok3 stream before first token marker")
        # a new token position whose FIRST stream is not the type stream
        # implies every name shares that type: synthesize the type stream
        if (ttype & 15) and (ttype & 128):
            desc[tnum << 4] = _Stream(
                bytes([ttype & 15]) + bytes([_T_MATCH]) * (nreads - 1)
            )
        i = (tnum << 4) | (ttype & 15)
        if ttype & 64:  # duplicate of an earlier stream
            j = (data[o] << 4) + data[o + 1]
            o += 2
            if j not in desc:
                raise ValueError("tok3 duplicate of a missing stream")
            desc[i] = _Stream(desc[j].buf)
            continue
        c = _Cur(data, o)
        clen = c.u7()
        nb = c.o - o
        # the container's own size field (flag byte, then uint7 ulen --
        # the tokenizer never sets NOSZ/STRIPE at top level, but the
        # parse below handles both since ulen follows the flag byte
        # either way)
        sub = data[o + nb : o + nb + clen]
        sc = _Cur(sub, 1)
        s_ulen = sc.u7()
        desc[i] = _Stream(_container(sub, s_ulen))
        o += nb + clen

    # reconstruct names (tokenise_name3.c decode_name)
    names: List[bytes] = []
    toks: List[List[Tuple[int, int, int]]] = []  # per name: (type, int, str)
    out = bytearray()
    while len(out) < ulen:
        cnum = len(names)
        t0 = desc.get(0, _Stream()).byte()
        if t0 < 0 or t0 >= max_tok * 16:
            break
        dist = desc[t0].u32()
        pnum = max(cnum - dist, 0)
        if t0 == _T_DUP:
            if pnum == cnum:
                raise ValueError("tok3 self-duplicate name")
            names.append(names[pnum])
            toks.append(toks[pnum])
            out += names[pnum] + b"\0"
            continue
        name = bytearray()
        cur: List[Tuple[int, int, int]] = [(_T_TYPE, 0, 0)]
        ntok = 1
        while True:
            tok = desc.get(ntok << 4, _Stream()).byte()
            if tok == _T_CHAR:
                v = desc[(ntok << 4) | _T_CHAR].byte()
                if v < 0:
                    raise ValueError("tok3 char stream underrun")
                name.append(v)
                cur.append((_T_CHAR, v, 0))
            elif tok == _T_ALPHA:
                s = desc[(ntok << 4) | _T_ALPHA].cstr()
                cur.append((_T_ALPHA, len(s), len(name)))
                name += s
            elif tok == _T_DIGITS0:
                vl = desc[(ntok << 4) | _T_DZLEN].byte()
                v = desc[(ntok << 4) | _T_DIGITS0].u32()
                name += b"%0*d" % (vl, v)
                cur.append((_T_DIGITS0, v, vl))
            elif tok == _T_DDELTA0:
                d = desc[(ntok << 4) | _T_DDELTA0].byte()
                pt, pv, pl = toks[pnum][ntok]
                v = (pv + d) & 0xFFFFFFFF
                name += b"%0*d" % (pl, v)
                cur.append((_T_DIGITS0, v, pl))
            elif tok == _T_DIGITS:
                v = desc[(ntok << 4) | _T_DIGITS].u32()
                name += b"%d" % v
                cur.append((_T_DIGITS, v, 0))
            elif tok == _T_DDELTA:
                d = desc[(ntok << 4) | _T_DDELTA].byte()
                pt, pv, pl = toks[pnum][ntok]
                v = (pv + d) & 0xFFFFFFFF
                name += b"%d" % v
                cur.append((_T_DIGITS, v, 0))
            elif tok == _T_NOP:
                cur.append((_T_NOP, 0, 0))
            elif tok == _T_MATCH:
                pt, pv, pl = toks[pnum][ntok]
                if pt == _T_CHAR:
                    name.append(pv)
                    cur.append((_T_CHAR, pv, 0))
                elif pt == _T_ALPHA:
                    s = names[pnum][pl : pl + pv]
                    cur.append((_T_ALPHA, pv, len(name)))
                    name += s
                elif pt == _T_DIGITS:
                    name += b"%d" % pv
                    cur.append((_T_DIGITS, pv, 0))
                elif pt == _T_DIGITS0:
                    name += b"%0*d" % (pl, pv)
                    cur.append((_T_DIGITS0, pv, pl))
                else:
                    raise ValueError("tok3 match against unmatched token")
            else:  # N_END or an elided end
                cur.append((_T_END, 0, 0))
                break
            ntok += 1
            if ntok >= max_tok:
                raise ValueError("tok3 name with no end token")
        names.append(bytes(name))
        toks.append(cur)
        out += name + b"\0"
    if len(out) != ulen:
        raise ValueError(
            f"tok3 names decoded to {len(out)} bytes, header says {ulen}"
        )
    if out_size not in (None, len(out)):
        raise ValueError(
            f"tok3 block raw size {out_size} != decoded {len(out)}"
        )
    return bytes(out)
