"""The shared fast path: dense bitmap filters + sparse exact verification.

The five reference algorithms' branchy skip loops and pointer-chasing
table walks do not vectorize; one shared scan built from two primitives
replaces them —

  1. DENSE stage: per-window keys (exact packed window ids when
     sigma^m <= 2^16, else 16-bit polynomial fingerprints combined into k
     derived stage keys) tested against small bitmaps by one gather each.
     The exact tier is one fused XLA pass; the fingerprint tier runs as one
     Pallas kernel on the Triton route on a GPU (ops/triton_filter.py),
     which also compacts the survivors, or as tiled XLA elsewhere.
  2. SPARSE stage: candidates (CAP-bounded) verified exactly by XLA
     (window-byte compares against fingerprint-bucketed patterns).

Backend choice: default_backend() — the one place it is made.

When the window id is exact (e.g. DNA m<=8, binary m<=16), stage 1 alone is
the complete engine — the bitmap is literally the final-state table of the
complete window automaton (an AC DFA over all sigma^m window states whose
transition is a shift — no gathers needed for transitions at all).

Counts are the shared semantics of all five reference engines (SURVEY.md §7):
number of window positions with >= 1 exact pattern occurrence.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from smatcher.ops.lookup import bitmap_test, pack_bitmap
from smatcher.automata.verify import pack_rows

BITMAP_BITS = 1 << 16
#: fingerprint multipliers per stage (odd => invertible mod 2^16)
FP_MULTS = (0x9E37, 0x6A09, 0xB2D1, 0x85EB, 0xC2B3,
            0x2545, 0x9B61, 0x6C89, 0x5BD1, 0xA511)
#: per-stage derivation constants: stage s tests key_s = (fp0 + C_s*fp1 +
#: D_s*fp2) mod stage_bits (Kirsch-Mitzenmacher double/triple hashing).
#: Only THREE base fingerprints are ever computed — the same fp0/fp1/fp2
#: the verification buckets already need — so adding a stage costs only a
#: few ALU ops + its bank gathers, not another fingerprint pass.  Triple
#: (not double) derivation keeps the full-collision probability at
#: stage_bits^-3: with two bases, fp0/fp1 colliding mod stage_bits makes a
#: window pass EVERY stage, and at p=10k that alone would eat the candidate
#: budget.  Odd constants avoid mod-2^k degeneracies.
#: For WIDE stages (stage_bits > 2^16, large pattern sets) the (0,0)/(1,0)
#: head is skipped: key 0 = fp0 alone only reaches the low 2^16 bits of a
#: wider bitmap (fp0 < 2^16), and (1,0) only 2^17 — every wide stage needs
#: a multiplier C >= 2^(b-16) so fp0 + C*fp1 covers all 2^b values.  All
#: constants below the head satisfy that through b = 26.
STAGE_CD = ((0, 0), (1, 0),
            (0x2FE9, 0x33C9), (0xA909, 0xBA4D), (0xF4D9, 0xE2A9),
            (0x073F, 0x26A7), (0xA38D, 0x1817), (0xA017, 0xBB4B),
            (0x63D9, 0x9A23), (0x0C7B, 0x234D), (0xB145, 0xF907),
            (0xB2B9, 0x6B23), (0x41C9, 0xDB41), (0xB39F, 0xFB23),
            (0x891D, 0x7965), (0xA797, 0x8E7D), (0xA5D5, 0x0F9F),
            (0xD951, 0xC47B), (0x3F3B, 0xA4E3), (0x934B, 0x6D3D),
            (0xBACD, 0x1523), (0x09E9, 0x7D65), (0x3AC3, 0x0C85),
            (0xDB3D, 0xE503), (0x3941, 0x29FD), (0x45AD, 0x89F3),
            (0x6E65, 0x071F), (0xDDEB, 0x9D6B), (0xE22B, 0x9FFB),
            (0xA845, 0x325F), (0xCA45, 0x1C1B), (0x4219, 0xB033))
DEFAULT_TILE = 1 << 24
DEFAULT_CAP = 1 << 16
#: joint-FPR correlation of the derived filter stages (all affine in the
#: same 3 base fingerprints) over the independence product of the stage
#: fills — an UNMEASURED default: it only sizes how many stages build_fast
#: builds, never a count
STAGE_CF = 5.0


def _bits_per_char(sigma: int) -> int:
    return max(1, (sigma - 1).bit_length())


def exact_wid_supported(sigma: int, m: int) -> bool:
    return m * _bits_per_char(sigma) <= 16


def _wid_keys_np(patterns: np.ndarray, sigma: int) -> np.ndarray:
    bits = _bits_per_char(sigma)
    w = np.zeros(len(patterns), np.int64)
    for i in range(patterns.shape[1]):
        w = (w << bits) | patterns[:, i]
    return w


def _fp_keys_np(patterns: np.ndarray, mult: int) -> np.ndarray:
    fp = np.zeros(len(patterns), np.int64)
    rp = 1
    for i in range(patterns.shape[1]):
        fp = (fp + patterns[:, i].astype(np.int64) * rp) & 0xFFFF
        rp = (rp * mult) & 0xFFFF
    return fp


@dataclasses.dataclass
class FastTables:
    exact: bool
    m: int
    sigma: int
    n_stages: int           # default stage count for fixed-tile (XLA) scans
    bitmaps: tuple          # derived-stage bitmaps, (stage_bits/32,) int32
                            # words; stage s holds keys fp0 + C_s*fp1 +
                            # D_s*fp2 mod stage_bits (STAGE_CD); enough
                            # stages for n = 2^31 are built at construction
    # verification tables (None when exact):
    bucket_ids: object      # (2^(16+eb) * L,) int32 device, -1 padded
    lmax: int
    packed: object          # (p, W) int32 device
    words: int
    eb: int = 0             # bucket-key extension bits taken from fp1
    density: float = 0.0    # stage-0 bitmap fill fraction (per-stage FPR)
    bucket_fp2: object = None   # (2^(16+eb) * L,) int32: fp2 per slot, -1 pad
    slot_ok: bool = False   # fp2 unique within every bucket -> slot-select
                            # verify (one full compare instead of lmax)
    stage_bits: int = BITMAP_BITS   # bits per fingerprint-stage bitmap
    stage_fills: tuple = ()  # TRUE fill fraction of each built stage bitmap
                             # (density is stage 0 only; derived stages run
                             # slightly denser — measured 0.48 vs 0.46 at
                             # p=10k/16384 bits — and the per-block slot
                             # budget must use the real prefix product)
    stage_cd: tuple = ()     # the (C, D) derivation constants actually used
                             # per built stage: STAGE_CD for 16-bit stages,
                             # STAGE_CD[2:] for wide ones (see STAGE_CD)
    # device-side pattern-id attribution (count_per_pattern/matches — the
    # reference's verify loops identify the pattern but only count it,
    # wu/wu.c:184-201):
    orig_ids: object = None  # (p_dedup,) int32 device: internal (deduped)
                             # id -> smallest ORIGINAL pattern id
    wid_pids: object = None  # exact tier: (nbits,) int32 device: window id
                             # -> smallest original pattern id (-1 = none)
    n_orig: int = 0          # original pattern count (histogram length)

    def cd(self, k: int) -> tuple:
        """(C, D) constants of the first k stages (prefix of stage_cd; the
        STAGE_CD head for tables built before the field existed).  Deep
        tuples: the result is a static jit argument, and checkpoint
        round-trips restore stage_cd as JSON lists."""
        base = self.stage_cd or STAGE_CD
        return tuple((int(c), int(d)) for c, d in base[:k])


def cap_for(ft: FastTables) -> int:
    """Default candidate cap, scaled to the pattern count: reference-corpus
    pattern sets are extracted FROM the text (execute.sh), so ~every
    pattern is present and matches alone approach p — at p = 100k
    (main.c:372-373) a fixed 2^16 cap would overflow on every scan of a big
    corpus and send it through the retry ladder.  4x headroom over p,
    bounded to 2^20 (verify cost follows the TRUE candidate count via
    verify_chunked, so a larger static cap costs only buffer size)."""
    if ft.exact or ft.packed is None:
        return DEFAULT_CAP
    p = int(ft.packed.shape[0])
    return max(DEFAULT_CAP, min(1 << 20, 1 << (4 * p - 1).bit_length()))


def stages_for(ft: FastTables, n: int, cap: int) -> int:
    """Stage count so (a) expected false candidates over n positions fit
    well inside the candidate cap (n * density^k <= cap/4) and (b) the
    candidate rate per position stays below 1/256.  Uses the independence
    estimate: the 4x cap margin absorbs the stages' joint correlation (the
    256 MiB DNA m=32 p=10k scan passes 26,577 candidates at k=13 against
    an 11k estimate, well inside its 65,536 cap).  An FP-driven overflow
    adds stages at run time (FastScanner._async_retry)."""
    if ft.exact:
        return 1
    k = 1
    while ((n * ft.density ** k > cap / 4 or ft.density ** k > 1 / 256)
           and k < len(ft.bitmaps)):
        k += 1
    return k


def build_fast(patterns: np.ndarray, sigma: int, *,
               n_stages: int | None = None,
               stage_bits: int | None = None) -> FastTables:
    """stage_bits= overrides the measured cost model (tests force WIDE
    stages — > 2^16 bits — on pattern sets too small to trigger them)."""
    patterns = np.asarray(patterns, np.uint8)
    n_orig = patterns.shape[0]
    if exact_wid_supported(sigma, patterns.shape[1]):
        m0 = patterns.shape[1]
        nbits = max(4096, 1 << (m0 * _bits_per_char(sigma)))
        keys = _wid_keys_np(patterns, sigma)
        bm = pack_bitmap(keys, nbits)
        # window id -> smallest original pattern id (descending-id writes:
        # the last write per key wins)
        wid_pids = np.full((nbits,), -1, np.int32)
        order = np.argsort(-np.arange(n_orig))
        wid_pids[keys[order]] = order.astype(np.int32)
        return FastTables(True, m0, sigma, 1,
                          (jnp.asarray(bm),), None, 0, None, 0,
                          wid_pids=jnp.asarray(wid_pids), n_orig=n_orig)
    # duplicate patterns cannot change the count (>=1 occurrence per window)
    # and would defeat the per-bucket fp2 uniqueness below — drop them,
    # but keep each deduped row's smallest original id for attribution
    patterns, inv = np.unique(patterns, axis=0, return_inverse=True)
    orig_ids = np.full((patterns.shape[0],), n_orig, np.int64)
    np.minimum.at(orig_ids, inv.reshape(-1), np.arange(n_orig))
    p, m = patterns.shape

    # All filter stages are DERIVED from the three base fingerprints via
    # STAGE_CD (key_s = fp0 + C_s*fp1 + D_s*fp2 mod stage_bits), so a stage
    # costs a few ALU ops plus one gather per 4096-bit bank; scans pick how
    # many stages to apply (stages_for).  stage_bits minimizes a cost model
    # of filter cost per bit of filtering: per-stage cost ~ C_ALU +
    # B*C_GATHER (B = stage_bits/4096), information = -log2(fill).  C_ALU
    # and C_GATHER are UNMEASURED DEFAULTS: they only set how many stages
    # of which width are built, never a count.  At p=10k they pick 16384
    # bits (fill 0.46, 13 stages).
    fps = [_fp_keys_np(patterns, FP_MULTS[s]) for s in range(3)]

    def key0_for(sb):
        # the fill of stage 0 at sb bits: 16-bit tables test fp0 directly;
        # WIDE tables (> 2^16 bits — large pattern sets saturate the 16-bit
        # space, the reference takes p up to 100,000: main.c:372-373) use
        # the triple-mixed head of STAGE_CD[2:] (fp0 alone cannot reach
        # bits >= 2^16)
        if sb <= BITMAP_BITS:
            return fps[0] & (sb - 1)
        C, D = STAGE_CD[2]
        return (fps[0] + C * fps[1] + D * fps[2]) & (sb - 1)

    C_ALU, C_GATHER = 0.3, 1.0
    if stage_bits is None:
        stage_bits, density, best_cost = 0, 1.0, None
        for sb in (4096, 8192, 16384, 32768, 65536, 131072, 262144):
            bm0 = pack_bitmap(key0_for(sb), sb)
            d = float(np.count_nonzero(
                np.unpackbits(bm0.view(np.uint8)))) / sb
            if d >= 0.98:
                continue
            cost = (C_ALU + (sb // 4096) * C_GATHER) / -math.log2(d)
            if best_cost is None or cost < best_cost:
                stage_bits, density, best_cost = sb, d, cost
        if stage_bits == 0:             # p ~ 2^18 patterns: take the widest
            stage_bits = 262144
    bm0 = pack_bitmap(key0_for(stage_bits), stage_bits)
    density = float(np.count_nonzero(
        np.unpackbits(bm0.view(np.uint8)))) / stage_bits
    cd_table = STAGE_CD if stage_bits <= BITMAP_BITS else STAGE_CD[2:]

    # build enough stages for the worst supported scan (n = 2^31 starts,
    # candidate budget DEFAULT_CAP/4, measured stage correlation STAGE_CF);
    # stages_for picks the prefix to apply
    need = (math.log(max(DEFAULT_CAP / 4 / (1 << 31) / STAGE_CF, 1e-12))
            / math.log(density)) if 0 < density < 1 else 1
    k_build = int(min(len(cd_table), max(3, math.ceil(need) + 1)))
    smask = stage_bits - 1
    bitmaps = []
    stage_fills = []
    for s in range(k_build):
        C, D = cd_table[s]
        key = (fps[0] + C * fps[1] + D * fps[2]) & smask
        bm_s = pack_bitmap(key, stage_bits)
        stage_fills.append(float(np.count_nonzero(
            np.unpackbits(bm_s.view(np.uint8)))) / stage_bits)
        bitmaps.append(jnp.asarray(bm_s))

    if n_stages is None:
        k, prod = 1, stage_fills[0]
        while prod * STAGE_CF * DEFAULT_TILE > DEFAULT_CAP / 4 and k < k_build:
            prod *= stage_fills[min(k, len(stage_fills) - 1)]
            k += 1
        n_stages = k
    n_stages = min(n_stages, k_build)

    # verification buckets keyed by fp0 plus eb low bits of fp1, sized so
    # buckets outnumber patterns ~8x (keeps lmax, and so verify gathers, low)
    eb = max(0, (8 * p - 1).bit_length() - 16) if p > 0 else 0
    eb = min(eb, 8)
    nbuckets = BITMAP_BITS << eb
    key = fps[0] | ((fps[1] & ((1 << eb) - 1)) << 16) if eb else fps[0]
    size = np.bincount(key, minlength=nbuckets)
    lmax = max(1, int(size.max(initial=0)))
    bucket = np.full((nbuckets, lmax), -1, np.int32)
    bucket_fp2 = np.full((nbuckets, lmax), -1, np.int32)
    fp2 = fps[2]
    slot = np.zeros(nbuckets, np.int64)
    for j in range(p):
        h = int(key[j])
        bucket[h, slot[h]] = j
        bucket_fp2[h, slot[h]] = fp2[j]
        slot[h] += 1
    # slot-select verify is exact iff fp2 is unique within every bucket
    # (patterns are deduped above, so only true fp collisions can conflict)
    slot_ok = len(np.unique(key.astype(np.int64) * 65536 + fp2)) == p
    packed = pack_rows(patterns)
    return FastTables(False, m, sigma, n_stages,
                      tuple(bitmaps), jnp.asarray(bucket.reshape(-1)), lmax,
                      jnp.asarray(packed), packed.shape[1], eb, density,
                      jnp.asarray(bucket_fp2.reshape(-1)), slot_ok, stage_bits,
                      tuple(stage_fills), tuple(cd_table[:k_build]),
                      orig_ids=jnp.asarray(orig_ids.astype(np.int32)),
                      n_orig=n_orig)


# ---------------------------------------------------------------------------
# dense key computation (traceable)
# ---------------------------------------------------------------------------

def _wid_keys(chunk: jnp.ndarray, n_starts: int, m: int, sigma: int) -> jnp.ndarray:
    """Packed window ids, O(log m) segment doubling (ops/keys.py)."""
    from smatcher.ops import keys as keys_mod
    return keys_mod.wid_keys(chunk.astype(jnp.int32), m,
                             _bits_per_char(sigma))[:n_starts]


def _fp_keys(chunk: jnp.ndarray, n_starts: int, m: int, mult: int) -> jnp.ndarray:
    """16-bit polynomial fingerprints, segment doubling (ops/keys.py)."""
    from smatcher.ops import keys as keys_mod
    return keys_mod.fp_keys(chunk.astype(jnp.int32), m, mult)[:n_starts]


def _pad_guard(chunk: jnp.ndarray, n_starts: int, m: int, sigma: int) -> jnp.ndarray:
    """(n_starts,) bool: window holds only real chars (< sigma) — see
    ops/keys.py:max_keys for why exact-tier scans must mask by this."""
    from smatcher.ops import keys as keys_mod
    return keys_mod.max_keys(chunk.astype(jnp.int32), m)[:n_starts] < sigma


def _fp_filter(chunk, n_starts: int, ft: FastTables, cd: tuple):
    """(n_starts,) bool: windows passing the first len(cd) derived stages,
    plus fp0 and fp1 (the verify bucket key needs them)."""
    m = ft.m
    smask = ft.stage_bits - 1
    fp0 = _fp_keys(chunk, n_starts, m, FP_MULTS[0])
    fp1 = (_fp_keys(chunk, n_starts, m, FP_MULTS[1])
           if ft.eb or any(c for c, _ in cd) else None)
    fp2 = (_fp_keys(chunk, n_starts, m, FP_MULTS[2])
           if any(d for _, d in cd) else None)
    cand = None
    for s, (C, D) in enumerate(cd):
        key = fp0
        if C:
            key = key + C * fp1
        if D:
            key = key + D * fp2
        hit = bitmap_test(ft.bitmaps[s], key & smask) == 1
        cand = hit if cand is None else cand & hit
    return cand


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

def fast_count_core(text: jnp.ndarray, ft: FastTables, *, tile: int = DEFAULT_TILE,
                    cap: int = DEFAULT_CAP, n_stages: int | None = None,
                    guard: bool = False):
    """Traceable plain-XLA scan: returns (count, overflowed) — overflowed=1
    means some tile had more than `cap` candidates and the count may
    undercount; callers fall back to smaller pieces in that case (never
    silently wrong).  n_stages defaults to ft.n_stages."""
    n = text.shape[0]
    m = ft.m
    if n < m:
        return jnp.int32(0), jnp.int32(0)
    if ft.exact:
        # one fused pass over the whole text: window id, one bitmap gather,
        # sum — nothing to bound, so no tiles (and no padded copy)
        keys = _wid_keys(text, n - m + 1, m, ft.sigma)
        hit = bitmap_test(ft.bitmaps[0], keys)
        if guard:
            hit = jnp.where(_pad_guard(text, n - m + 1, m, ft.sigma), hit, 0)
        return jnp.sum(hit, dtype=jnp.int32), jnp.int32(0)
    num_tiles = max(1, -(-(n - m + 1) // tile))
    padded_len = num_tiles * tile + m - 1
    padded = jnp.zeros((padded_len,), jnp.uint8).at[:n].set(text[:n])
    n_valid_total = n - m + 1     # number of real window starts
    cd = ft.cd(min(n_stages or ft.n_stages, len(ft.bitmaps)))

    def per_tile(i, carry):
        count, overflow = carry
        chunk = jax.lax.dynamic_slice(padded, (i * tile,), (tile + m - 1,))
        # valid starts in this tile
        limit = jnp.clip(n_valid_total - i * tile, 0, tile)
        valid = jax.lax.broadcasted_iota(jnp.int32, (tile, 1), 0).reshape(-1) < limit
        cand = _fp_filter(chunk, tile, ft, cd) & valid
        n_cand = jnp.sum(cand, dtype=jnp.int32)
        idxs = nonzero_scatter(cand, cap, -1)
        matched = _verify_matched(
            chunk, idxs, ft.bucket_ids, ft.packed, ft.bucket_fp2, m=m,
            words=ft.words, lmax=ft.lmax, eb=ft.eb, n_starts=tile,
            slot_ok=ft.slot_ok)
        return (count + jnp.sum(matched, dtype=jnp.int32),
                overflow | jnp.int32(n_cand > cap))

    return jax.lax.fori_loop(0, num_tiles, per_tile,
                             (jnp.int32(0), jnp.int32(0)))


def nonzero_scatter(mask, size: int, fill: int):
    """Indices of set elements, like jnp.nonzero(mask, size=, fill_value=),
    via cumsum + unique-index scatter."""
    n = mask.shape[0]
    m32 = mask.astype(jnp.int32)
    cum = jnp.cumsum(m32)
    iota = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).reshape(-1)
    # dropped indices are made DISTINCT (size + n + iota) so
    # unique_indices=True is honest even when MORE than `size` elements are
    # set (overflowing set elements land in [size, size + n), disjoint from
    # the dropped band [size + n, size + 2n)) — with duplicate indices the
    # mode="drop" result would be implementation-defined
    pos = jnp.where(m32 > 0, cum - 1, size + n + iota)
    out = jnp.full((size,), fill, jnp.int32)
    return out.at[pos].set(iota, mode="drop", unique_indices=True)


@functools.partial(jax.jit, static_argnames=("m", "words", "lmax", "eb",
                                              "n_starts", "slot_ok"))
def verify_at(text, idxs, bucket_ids, packed, bucket_fp2, *, m, words,
              lmax, eb, n_starts, slot_ok=False):
    return _verify_matched(text, idxs, bucket_ids, packed, bucket_fp2,
                           m=m, words=words, lmax=lmax, eb=eb,
                           n_starts=n_starts, slot_ok=slot_ok
                           ).sum(dtype=jnp.int32)


#: cond chunks of verify_chunked: 4 x 16K-candidate chunks at the default
#: 64K cap.  More chunks track the true candidate count finer but each
#: chunk compiles its own verify branch.
VERIFY_CHUNKS = 4


def verify_chunked(text, idxs, n_cand, ft: FastTables, *, n_starts: int,
                   chunks: int = VERIFY_CHUNKS):
    """Cond-gated chunked verification: verify the densely packed idxs in
    static slices, each behind lax.cond(n_cand > chunk_start), so verify
    cost scales with the TRUE candidate count at runtime instead of the
    static cap.  XLA compiles every branch once but executes only the
    populated chunks (candidates are packed at the front; chunk 0 always
    runs)."""
    cap = int(idxs.shape[0])
    verify = functools.partial(
        verify_at, bucket_ids=ft.bucket_ids, packed=ft.packed,
        bucket_fp2=ft.bucket_fp2, m=ft.m, words=ft.words, lmax=ft.lmax,
        eb=ft.eb, n_starts=n_starts, slot_ok=ft.slot_ok)
    if chunks <= 1 or cap < 2 * (cap // chunks):
        return verify(text, idxs)
    # chunk sizes grow GEOMETRICALLY past the base granularity: p-scaled
    # caps (cap_for, up to 2^20) would need 64 equal 16K chunks — each a
    # compiled cond branch — while doubling keeps the fine granularity
    # where candidate counts usually land and covers any cap in ~log2
    # branches
    cs0 = cap // chunks
    sizes, s, nxt = [cs0], cs0, cs0
    while s < cap:
        sz = min(nxt, cap - s)
        sizes.append(sz)
        s += sz
        nxt *= 2
    c = verify(text, idxs[:cs0])
    s = cs0
    for sz in sizes[1:]:
        c = c + jax.lax.cond(n_cand > s,
                             lambda s=s, sz=sz: verify(text, idxs[s:s + sz]),
                             lambda: jnp.int32(0))
        s += sz
    return c


@functools.partial(jax.jit, static_argnames=("m", "sigma"))
def _exact_attr(piece, idxs, wid_pids, *, m, sigma):
    """(cap,) smallest-original-pattern id per matched idx (-1 padding) for
    the exact tier: recompute the packed window id at each match position
    (m <= 16 byte gathers over the candidate set only) and look it up in
    the wid -> pid value table."""
    live = idxs >= 0
    idc = jnp.clip(idxs, 0, jnp.maximum(piece.shape[0] - m, 0))
    bits = _bits_per_char(sigma)
    key = jnp.zeros(idxs.shape, jnp.int32)
    t32 = piece.astype(jnp.int32)
    for i in range(m):
        key = (key << bits) | t32[idc + i]
    pid = wid_pids[jnp.clip(key, 0, wid_pids.shape[0] - 1)]
    return jnp.where(live, pid, -1)


@functools.partial(jax.jit, static_argnames=("n_orig",))
def _hist_delta(pids, *, n_orig):
    """(n_orig,) int32 histogram of non-negative pids (a per-piece delta;
    negatives — unmatched slots — are dropped by the guarded scatter)."""
    idx = jnp.where(pids >= 0, pids, n_orig)
    return jnp.zeros((n_orig,), jnp.int32).at[idx].add(1, mode="drop")


@functools.partial(jax.jit, static_argnames=("m", "sigma", "n_orig"))
def _exact_hist(text, wid_pids, *, m, sigma, n_orig):
    """Exact-tier per-pattern histogram WITHOUT match enumeration: every
    window's 16-bit id determines its pattern (or none), so histogram the
    ids themselves — one device sort + 65536 searchsorted edges — and push
    the wid counts through the wid->pid value table.  A match-dense corpus
    would otherwise be enumerated through many cap-sized attribution
    pieces."""
    n = text.shape[0]
    wids = _wid_keys(text, n - m + 1, m, sigma)
    s = jnp.sort(wids)
    nb = wid_pids.shape[0]
    edges = jnp.arange(nb + 1, dtype=jnp.int32)
    # int32 throughout: any bin count <= n_starts < 2^31 (check_count32)
    wc = jnp.diff(jnp.searchsorted(s, edges)).astype(jnp.int32)
    bins = jnp.where(wid_pids < 0, n_orig, wid_pids)
    return jnp.zeros((n_orig + 1,), jnp.int32).at[bins].add(
        wc, mode="drop")[:n_orig]


def _verify_matched(text, idxs, bucket_ids, packed, bucket_fp2, *, m,
                    words, lmax, eb, n_starts, slot_ok=False,
                    return_pid=False):
    """Exact verification at candidate starts of the uint8 `text` (idxs
    padded with -1; starts >= n_starts are dead).  return_pid=True also
    returns the matching pattern's INTERNAL (deduped) id per candidate (-1
    where unmatched) — each window matches at most one deduped
    equal-length pattern, so the id is unique.

    Gathers the m window bytes of every candidate, packs them into the
    pattern word layout (automata.verify.pack_rows), recomputes fp0/fp1/fp2
    from them, and compares against the fingerprint-bucketed patterns.
    With slot_ok (fp2 unique within every bucket) the bucket slot is
    selected by fp2 and only ONE full word compare runs."""
    live = (idxs >= 0) & (idxs < n_starts)
    idxs = jnp.clip(idxs, 0, jnp.maximum(n_starts - 1, 0))
    cap = idxs.shape[0]
    bytes2d = text[idxs[:, None] + jnp.arange(m, dtype=jnp.int32)[None, :]
                   ].astype(jnp.int32)                      # (cap, m)
    shifts = jnp.tile(jnp.array([0, 8, 16, 24], jnp.int32), words)
    padded = jnp.pad(bytes2d, ((0, 0), (0, 4 * words - m)))
    vals2d = jnp.sum((padded << shifts[None, :]).reshape(cap, words, 4),
                     axis=2, dtype=jnp.int32)               # (cap, W)

    def fpvec(mult):
        rp = np.ones((m,), np.int64)
        for i in range(1, m):
            rp[i] = (rp[i - 1] * mult) & 0xFFFF
        rpj = jnp.asarray(rp.astype(np.int32))
        return jnp.sum(bytes2d * rpj[None, :], axis=1, dtype=jnp.int32)

    key = fpvec(FP_MULTS[0]) & 0xFFFF
    if eb:
        key = key | ((fpvec(FP_MULTS[1]) & ((1 << eb) - 1)) << 16)

    def full_eq(pid_c):
        rows = packed[pid_c, :]                            # (cap, W) gather
        return jnp.all(rows == vals2d, axis=1)

    if slot_ok:
        fp2 = fpvec(FP_MULTS[2]) & 0xFFFF
        slot = jnp.zeros((cap,), jnp.int32)
        found = jnp.zeros((cap,), bool)
        for l in range(lmax):
            hit = bucket_fp2[key * lmax + l] == fp2    # unique per bucket
            slot = jnp.where(hit, l, slot)
            found |= hit
        pid = bucket_ids[key * lmax + slot]
        ok = live & found & (pid >= 0)
        matched = ok & full_eq(jnp.maximum(pid, 0))
        if return_pid:
            return matched, jnp.where(matched, pid, -1)
        return matched

    matched = jnp.zeros((cap,), bool)
    sel_pid = jnp.full((cap,), -1, jnp.int32)
    for l in range(lmax):
        pid = bucket_ids[key * lmax + l]
        ok = live & (pid >= 0) & ~matched
        hit = ok & full_eq(jnp.maximum(pid, 0))
        matched |= hit
        if return_pid:
            sel_pid = jnp.where(hit, pid, sel_pid)
    if return_pid:
        return matched, sel_pid
    return matched


def _positions_piece_xla(piece, ft: FastTables, *, cap: int, n_stages: int):
    """Traceable plain-XLA positions of one piece: (idxs (cap,) int32
    matched starts with -1 padding, internal pattern ids aligned with
    idxs (-1 on the exact tier, whose ids come from _exact_attr),
    overflow).  Every window start of `piece` is owned (n_starts =
    len - m + 1); the caller offsets by the piece base."""
    n = piece.shape[0]
    m = ft.m
    n_starts = n - m + 1
    if ft.exact:
        # the exact tier has no verification to reject pad-contaminated
        # window ids (ops/keys.py:max_keys): guard them
        keys = _wid_keys(piece, n_starts, m, ft.sigma)
        cand = ((bitmap_test(ft.bitmaps[0], keys) == 1)
                & _pad_guard(piece, n_starts, m, ft.sigma))
    else:
        cand = _fp_filter(piece, n_starts, ft, ft.cd(n_stages))
    n_cand = jnp.sum(cand, dtype=jnp.int32)
    idxs = nonzero_scatter(cand, cap, -1)
    if ft.exact:
        return idxs, jnp.full((cap,), -1, jnp.int32), jnp.int32(n_cand > cap)
    matched, pid = _verify_matched(
        piece, idxs, ft.bucket_ids, ft.packed, ft.bucket_fp2, m=m,
        words=ft.words, lmax=ft.lmax, eb=ft.eb, n_starts=n_starts,
        slot_ok=ft.slot_ok, return_pid=True)
    return (jnp.where(matched, idxs, -1), pid, jnp.int32(n_cand > cap))


def make_repeat(fn, reps: int):
    """jit a loop running the traceable (count, overflow) scan `fn` reps
    times back-to-back on one input, returning (the count of one scan,
    OR'd overflow).  Every rep scans the same input, so a summed count
    would only add a way to wrap int32.  The optimization barrier makes
    each rep's input depend on the previous rep's count, so XLA cannot
    hoist the loop-invariant scan (without it all reps collapse to one
    scan)."""

    @jax.jit
    def repeat(t):
        def body(i, carry):
            t2, _ = jax.lax.optimization_barrier((t, carry[0]))
            c, o = fn(t2)
            return jnp.int32(c), carry[1] | jnp.int32(o)
        return jax.lax.fori_loop(0, reps, body,
                                 (jnp.int32(0), jnp.int32(0)))

    return repeat


class ScanFuture:
    """Handle for an in-flight device scan (count_async/scan_many).

    The count and overflow flag stay on the device until result() is
    called, so many scans can be queued back-to-back and pay the host
    round-trip once — the reference amortizes per-kernel timing the same
    way across reps (cuda/cuda_wm.cu:269-302).  On candidate-cap overflow
    result() transparently re-runs the synchronous retry path (exact
    counts, never an undercount)."""

    __slots__ = ("_co", "_retry")

    def __init__(self, count_dev, overflow_dev, retry=None):
        self._co = jnp.stack([jnp.int32(count_dev), jnp.int32(overflow_dev)])
        self._retry = retry

    def result(self) -> int:
        co = np.asarray(self._co)
        if co[1]:
            if self._retry is None:
                raise OverflowError("candidate cap exceeded; raise cap=")
            return self._retry()
        return int(co[0])


#: the scan backends: the Triton fingerprint kernel (ops/triton_filter.py)
#: and the plain XLA scan (fast_count_core); the exact tier is plain XLA
#: on both
BACKENDS = ("triton", "xla")


def default_backend() -> str:
    """The one place the scan backend is chosen: the Triton kernel when
    this process's first device is a GPU, the plain XLA scan otherwise
    (the CPU, where tests run the kernel explicitly in interpret mode)."""
    return "triton" if jax.devices()[0].platform == "gpu" else "xla"


class FastScanner:
    """Shared fast backend; counts equal every engine's count.

    backend: one of BACKENDS, default default_backend().  interpret=True
    runs the Triton kernel in the Pallas interpreter (tests on the CPU)."""

    def __init__(self, ft: FastTables, *, tile: int = DEFAULT_TILE,
                 cap: int | None = None, backend: str | None = None,
                 interpret: bool = False):
        backend = backend or default_backend()
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        self.ft = ft
        self.tile = tile
        self.cap = cap_for(ft) if cap is None else cap
        self.m = ft.m
        self.sigma = ft.sigma
        self.backend = backend
        self.interpret = interpret
        #: fingerprint tier on the Triton kernel (the exact tier is XLA)
        self._triton = backend == "triton" and not ft.exact
        self._jits = {}
        #: async-overflow retries taken (diagnostics; the adaptation must
        #: converge — chip_smoke.py asserts this stops growing)
        self._retries = 0
        #: extra filter stages beyond the static budgets; bumped on an
        #: FP-driven async overflow (_async_retry), so a pattern set whose
        #: correlated-stage FPR beats the estimates converges to a
        #: non-overflowing configuration instead of retrying every scan
        self._k_extra = 0

    def _jit(self, name, fn):
        """fn jitted once per (name, extra-stage count)."""
        key = (name, self._k_extra)
        if key not in self._jits:
            self._jits[key] = jax.jit(fn)
        return self._jits[key]

    def _stages(self, n: int) -> int:
        """Filter stages for an n-byte Triton scan (stages_for's budget
        plus the adaptive extra stages)."""
        return min(stages_for(self.ft, n, self.cap) + self._k_extra,
                   len(self.ft.bitmaps))

    def _candidates(self, text):
        """Triton path: (idxs, n_cand) of the fingerprint filter."""
        from smatcher.ops.triton_filter import fp_candidates
        k = self._stages(int(text.shape[0]))
        return fp_candidates(text, self.ft.bitmaps[:k], m=self.m,
                             cd=self.ft.cd(k), cap=self.cap,
                             interpret=self.interpret)

    def _device_count(self, text, guard: bool = False):
        """Traceable (count, overflow) over every window start of text —
        the one device scan behind count/count_async/scan_many/core.
        guard masks pad-contaminated windows on the exact tier (shards and
        halos padded with the out-of-alphabet symbol)."""
        n = text.shape[0]
        if n < self.m:
            return jnp.int32(0), jnp.int32(0)
        if self._triton:
            idxs, n_cand = self._candidates(text)
            c = verify_chunked(text, idxs, n_cand, self.ft,
                               n_starts=n - self.m + 1)
            return c, jnp.int32(n_cand > self.cap)
        return fast_count_core(
            text, self.ft, tile=self.tile, cap=self.cap,
            n_stages=min(self.ft.n_stages + self._k_extra,
                         len(self.ft.bitmaps)), guard=guard)

    def core(self, ext):
        """Traceable per-shard (count, overflow) for distribution: the
        overflow flag rides the psum so distributed scans re-run the exact
        ladder instead of silently undercounting (parallel/dist.py)."""
        return self._device_count(ext, guard=True)

    def _dispatch(self, text, fn):
        """(uint8 device text, *fn(text)) after the int32 length check."""
        from smatcher.ops.common import check_count32
        text = jnp.asarray(text, jnp.uint8)
        check_count32(int(text.shape[0]))
        return (text, *fn(text))

    def count_with_overflow(self, text) -> tuple[int, bool]:
        """The RAW single-dispatch (count, overflow flag) — no retry."""
        _, c, o = self._dispatch(text, self._jit("count", self._device_count))
        return int(c), bool(o)

    def count(self, text) -> int:
        return self.count_async(text).result()

    def _count_retry(self, text) -> int:
        """The synchronous path: if candidates overflow the cap (dense-match
        corpora), falls back to budget-sized piece scanning — counts are
        total functions of the input, never an error about its density."""
        c, o = self.count_with_overflow(text)
        if o:
            return self._count_chunked(text)
        return c

    def _async_retry(self, text) -> int:
        """ScanFuture overflow fallback: count exactly via the synchronous
        ladder, then adapt the scanner so later scans stop overflowing.
        An FP-driven overflow (false candidates beat the stage budget) adds
        a filter stage (`_k_extra`, bounded; one retrace per bump).  A
        MATCH-driven one (true matches alone exceed cap/4) does not: no
        stage can reject a match, so every such scan takes the pieces."""
        self._retries += 1
        c = self._count_retry(text)
        if not self.ft.exact and c <= self.cap // 4 and self._k_extra < 4:
            self._k_extra += 1
        return c

    def count_repeat_async(self, text, reps: int) -> ScanFuture:
        """Scan the SAME text `reps` times back-to-back inside ONE device
        dispatch (lax.fori_loop over the traceable scan) and return the
        count of one scan as a future — device time with no host work
        between scans (bench.py).  An overflow retries exactly, like
        count_async."""
        key = (("repeat", reps), self._k_extra)
        if key not in self._jits:
            self._jits[key] = make_repeat(self._device_count, reps)
        text, c, o = self._dispatch(text, self._jits[key])
        return ScanFuture(c, o, retry=functools.partial(self._async_retry,
                                                        text))

    def count_async(self, text) -> ScanFuture:
        """Dispatch a scan and return immediately; the count stays on the
        device until ScanFuture.result().  Queue many scans back-to-back to
        pay the host round-trip once."""
        text, c, o = self._dispatch(text, self._jit("count",
                                                     self._device_count))
        return ScanFuture(c, o, retry=functools.partial(self._async_retry,
                                                        text))

    def _count_chunked(self, text, *, depth: int = 4) -> int:
        """Exact count when candidates overflow the cap: scan in (m-1)-halo
        pieces sized to the budget, splitting any piece that still
        overflows (pieces of <= cap/4 starts cannot).  Dense-match corpora
        (the reference counts millions per corpus, main.c:656) therefore
        always count exactly — OverflowError is never a function of the
        corpus."""
        text = jnp.asarray(text, jnp.uint8)
        n = int(text.shape[0])
        m = self.m
        min_chunk = max(self.cap // 4, 1)
        fn = self._jit("count", self._device_count)
        work = [(0, n - m + 1)]
        inflight, total = [], 0
        while work or inflight:
            while work and len(inflight) < depth:
                start, owned = work.pop()
                piece = jax.lax.slice(text, (start,),
                                      (min(start + owned + m - 1, n),))
                c_d, o_d = fn(piece)
                inflight.append((start, owned, c_d, o_d))
            start, owned, c_d, o_d = inflight.pop(0)
            co = np.asarray(jnp.stack([jnp.int32(c_d), jnp.int32(o_d)]))
            if co[1]:
                if owned <= min_chunk:
                    raise AssertionError(
                        "count piece overflowed below the guaranteed size "
                        "— this is a bug")
                half = max(min_chunk, owned // 2)
                for s in range(start, start + owned, half):
                    work.append((s, min(half, start + owned - s)))
            else:
                total += int(co[0])
        return total

    def scan_many(self, texts) -> list[int]:
        """Counts for a batch of texts, pipelined: all scans are dispatched
        before any result is fetched, so N scans cost N device-times plus
        ONE host round-trip instead of N.  Equal-length texts reuse one
        compiled program (jit caches per shape)."""
        return [f.result() for f in [self.count_async(t) for t in texts]]

    def count_file(self, path: str, *, chunk: int = 1 << 28,
                   depth: int = 3) -> int:
        """Stream a pre-encoded corpus file through the scanner in `chunk`
        byte pieces without loading it fully ((m-1)-halo pieces, up to
        `depth` in flight so disk reads, host->device copies and device
        scans overlap; every interior piece has identical shape and reuses
        one compiled program) — see common.stream_count_file."""
        from smatcher.ops.common import stream_count_file
        return stream_count_file(self.count_async, self.m, path,
                                 chunk=chunk, depth=depth)

    def positions_file(self, path: str, *, chunk: int = 1 << 28) -> np.ndarray:
        """All match start positions of a corpus file, sorted, streamed in
        `chunk`-byte (m-1)-halo pieces (each unbounded via positions()'s
        split-on-overflow pipeline); int64 offsets, so files >= 2^31 bytes
        stream fine — see common.stream_positions_file."""
        from smatcher.ops.common import stream_positions_file
        return stream_positions_file(self.positions, self.m, path,
                                     chunk=chunk)

    def piece_matches(self, piece):
        """Traceable (idxs (cap,) matched starts of `piece`, -1 padded, in
        no particular order; pids (cap,) ORIGINAL pattern ids aligned with
        idxs; overflow) — every window start of the piece is owned."""
        ft = self.ft
        n = piece.shape[0]
        if self._triton:
            idxs, n_cand = self._candidates(piece)
            matched, pid = _verify_matched(
                piece, idxs, ft.bucket_ids, ft.packed, ft.bucket_fp2,
                m=ft.m, words=ft.words, lmax=ft.lmax, eb=ft.eb,
                n_starts=n - ft.m + 1, slot_ok=ft.slot_ok, return_pid=True)
            idxs = jnp.where(matched, idxs, -1)
            o = jnp.int32(n_cand > self.cap)
        else:
            idxs, pid, o = _positions_piece_xla(
                piece, ft, cap=self.cap,
                n_stages=stages_for(ft, n, self.cap))
        if ft.exact:
            pid_orig = _exact_attr(piece, idxs, ft.wid_pids, m=ft.m,
                                   sigma=ft.sigma)
        else:
            pid_orig = jnp.where(pid >= 0,
                                 ft.orig_ids[jnp.maximum(pid, 0)], -1)
        return idxs, pid_orig, o

    def _drive(self, text, on_piece, *, chunk: int | None = None,
               depth: int = 4):
        """The split-on-overflow piece pipeline behind positions(),
        matches() and count_per_pattern(): on_piece(start, idxs_dev,
        pids_dev) is called for every non-overflowing piece.  Pieces of
        <= cap/2 starts cannot overflow, so enumeration always
        terminates."""
        from smatcher.ops.common import check_count32
        text = jnp.asarray(text, jnp.uint8)
        n = int(text.shape[0])
        check_count32(n)      # positions ride int32 until the host append
        m = self.m
        if n < m:
            return
        total_starts = n - m + 1
        min_chunk = max(self.cap // 2, 1)
        fn = self._jit("matches", self.piece_matches)
        work = []                        # (start, owned) pieces to scan
        if chunk is None:
            work.append((0, total_starts))
        else:
            chunk = max(int(chunk), min_chunk)
            work.extend((s, min(chunk, total_starts - s))
                        for s in range(0, total_starts, chunk))
        work.reverse()                   # pop() scans in text order
        inflight = []
        guess = None                     # density-derived chunk after 1st ovf
        while work or inflight:
            while work and len(inflight) < depth:
                start, owned = work.pop()
                piece = jax.lax.slice(text, (start,),
                                      (min(start + owned + m - 1, n),))
                inflight.append((start, owned, *fn(piece)))
            start, owned, idxs_d, pids_d, o_d = inflight.pop(0)
            if not bool(np.asarray(o_d)):
                on_piece(start, idxs_d, pids_d)
                continue
            if owned <= min_chunk:
                raise AssertionError(
                    "positions piece overflowed below the guaranteed size "
                    "— this is a bug")
            if guess is None and owned == total_starts:
                # size pieces from the global density (few shapes to
                # compile) instead of blind halving
                total = max(self.count(text), 1)
                guess = int(max(min_chunk,
                                min(owned // 2,
                                    (self.cap // 2) * owned // total)))
            split = max(min_chunk, min(guess or owned // 2, owned // 2))
            for s in range(start, start + owned, split):
                work.append((s, min(split, start + owned - s)))

    def positions(self, text, *, chunk: int | None = None,
                  depth: int = 4) -> np.ndarray:
        """Sorted start positions of ALL matching windows — unbounded.

        The reference computes positions internally but only counts them
        (SURVEY.md: the column loops in cuda_*/search_*); here they are a
        first-class output.  The text is scanned in pieces with an (m-1)
        overlap, up to `depth` pieces pipelined on-device; any piece whose
        matches exceed the per-piece device cap is split and rescanned —
        dense corpora with millions of matches stream to the host with no
        global cap.  chunk= presizes the pieces (in window starts) when the
        density is known; otherwise the first overflow picks a chunk from
        the measured global match count."""
        out = []

        def on_piece(start, idxs_d, pids_d):
            idxs = np.asarray(idxs_d)
            idxs = idxs[idxs >= 0]
            if idxs.size:
                out.append(idxs.astype(np.int64) + start)

        self._drive(text, on_piece, chunk=chunk, depth=depth)
        if not out:
            return np.empty((0,), np.int64)
        return np.sort(np.concatenate(out))

    def matches(self, text):
        """(positions (n,) int64 sorted, pattern_ids (n,) int64): every
        match start plus the ORIGINAL id of the matching pattern (smallest
        id for byte-identical duplicates).  Attribution is DEVICE-side —
        the pid the verify stage already selects, not a host
        re-derivation; the reference's verify loops identify the pattern
        but only count it (wu/wu.c:184-201)."""
        pos_out, id_out = [], []

        def on_piece(start, idxs_d, pids_d):
            idxs = np.asarray(idxs_d)
            live = idxs >= 0
            if live.any():
                pos_out.append(idxs[live].astype(np.int64) + start)
                id_out.append(np.asarray(pids_d)[live].astype(np.int64))

        self._drive(text, on_piece)
        if not pos_out:
            return np.empty((0,), np.int64), np.empty((0,), np.int64)
        pos = np.concatenate(pos_out)
        ids = np.concatenate(id_out)
        order = np.argsort(pos, kind="stable")
        return pos[order], ids[order]

    def count_per_pattern(self, text):
        """(p,) int64 per-pattern match-start counts, aggregated ON DEVICE.
        Totals sum to count(text); duplicates credit the smallest id.

        Exact tier on a match-dense corpus: enumeration-free wid-histogram
        path (_exact_hist — window ids sorted once, counts pushed through
        the wid->pid table).  Otherwise (sparse matches, or the fp tier
        whose pid needs the verify stage): the positions piece pipeline
        with per-piece device histograms — O(matches) device work either
        way, never the O(matches x m) host numpy of datagen.match_ids."""
        ft = self.ft
        n_orig = ft.n_orig
        if ft.exact:
            n = int(jnp.asarray(text).shape[0])
            if n >= ft.m and self.count(text) > self.cap // 2:
                # match-dense: one sort beats splitting into ~2*matches/cap
                # dispatch-bound pieces
                return np.asarray(_exact_hist(
                    jnp.asarray(text, jnp.uint8), ft.wid_pids, m=ft.m,
                    sigma=ft.sigma, n_orig=n_orig)).astype(np.int64)
        acc = [jnp.zeros((n_orig,), jnp.int32)]

        def on_piece(start, idxs_d, pids_d):
            acc[0] = acc[0] + _hist_delta(pids_d, n_orig=n_orig)

        self._drive(text, on_piece)
        return np.asarray(acc[0]).astype(np.int64)
