"""Aho-Corasick table builder.

Builds the reference's flat-table ABI — ``state_transition`` (-1 = missing,
root row defaults 0), ``state_supply`` (failure links), ``state_final``
(ac/ac.c:127-196 + ac_maketree:79-124, layout allocated at main.c:409-425) —
*plus* extras the reference computes at runtime instead:

  - ``delta``: the completed DFA next-state table (failure chains resolved at
    build time), so the scan kernel is a single gather per byte with no
    data-dependent while-loop (the reference's GPU hot loop,
    cuda/cuda_ac.cu:90-94, walks supply links per byte at runtime);
  - a fused ``delta_packed = delta * 2 + final[delta]`` so one gather yields
    both next state and terminal flag;
  - optional multi-character stepping tables (q bytes per gather) that pack
    (next_state, #terminal visits along the q steps) — exact count
    preservation with 1/q as many serial gathers.

A padding symbol ``sigma`` is appended as an extra column that resets to the
root (never terminal), so kernels can right-pad text tiles safely.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ACTables:
    transition: np.ndarray   # (S, sigma) int32, -1 missing (root row: 0)
    supply: np.ndarray       # (S,) int32 failure links
    final: np.ndarray        # (S,) uint8 terminal flags
    delta: np.ndarray        # (S, sigma + 1) int32 completed DFA (+pad col -> 0)
    depth: np.ndarray        # (S,) int32 trie depth of each state
    n_states: int
    sigma: int
    m: int

    @property
    def delta_packed(self) -> np.ndarray:
        """(S, sigma+1) int32: next*2 | final[next]."""
        nxt = self.delta
        return (nxt.astype(np.int32) << 1) | self.final[nxt].astype(np.int32)

    def save(self, path: str) -> None:
        np.savez_compressed(path, transition=self.transition, supply=self.supply,
                            final=self.final, delta=self.delta, depth=self.depth,
                            n_states=self.n_states, sigma=self.sigma, m=self.m)

    @staticmethod
    def load(path: str) -> "ACTables":
        z = np.load(path)
        return ACTables(z["transition"], z["supply"], z["final"], z["delta"],
                        z["depth"], int(z["n_states"]), int(z["sigma"]), int(z["m"]))


def _build_trie(patterns: np.ndarray, sigma: int):
    """Forward trie over the pattern rows; returns (children dicts, final, depth)."""
    goto = [dict()]
    final = [False]
    depth = [0]
    for pat in patterns:
        s = 0
        for c in pat:
            c = int(c)
            nxt = goto[s].get(c)
            if nxt is None:
                goto.append(dict())
                final.append(False)
                depth.append(depth[s] + 1)
                nxt = len(goto) - 1
                goto[s][c] = nxt
            s = nxt
        final[s] = True
    return goto, final, depth


def build_ac(patterns: np.ndarray, sigma: int, native: bool | str = "auto") -> ACTables:
    patterns = np.asarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    if native:
        from smatcher import native as nat
        r = nat.build_ac_native(patterns, sigma)
        if r is not None:
            transition, supply, final, delta, depth, n = r
            return ACTables(transition, supply, final, delta, depth, n, sigma, m)
        if native is True:
            raise RuntimeError("native builder requested but unavailable")
    goto, final_l, depth_l = _build_trie(patterns, sigma)
    S = len(goto)

    transition = np.full((S, sigma), -1, dtype=np.int32)
    transition[0, :] = 0                      # root row defaults (ac_init)
    for s, edges in enumerate(goto):
        for c, t in edges.items():
            transition[s, c] = t

    final = np.asarray(final_l, dtype=np.uint8)
    depth = np.asarray(depth_l, dtype=np.int32)

    # Failure links, level by level (BFS equivalent: depth order).
    supply = np.zeros(S, dtype=np.int32)
    # Completed DFA. delta[0] = transition row 0 with missing -> 0 already.
    delta = np.zeros((S, sigma + 1), dtype=np.int32)
    delta[0, :sigma] = transition[0]
    order = np.argsort(depth, kind="stable")
    # group state ids by depth for vectorized per-level updates
    max_depth = int(depth.max(initial=0))
    by_depth = [order[depth[order] == d] for d in range(max_depth + 1)]
    # Depth-1 states fail to the root; deeper states get their failure link
    # when their parent's level resolves: fail(t) = delta[fail(s), c].
    for d in range(1, max_depth + 1):
        states = by_depth[d]
        if states.size == 0:
            continue
        rows = transition[states]                       # (k, sigma)
        fallback = delta[supply[states]][:, :sigma]     # (k, sigma) — complete (< d)
        delta[states, :sigma] = np.where(rows >= 0, rows, fallback)
        for s in states.tolist():
            fs = supply[s]
            for c, t in goto[s].items():
                supply[t] = delta[fs, c]
    # pad column: any out-of-alphabet byte resets to root
    delta[:, sigma] = 0
    return ACTables(transition, supply, final, delta, depth, S, sigma, m)


def multi_step_tables(ac: ACTables, q: int) -> tuple[np.ndarray, int]:
    """Compose the DFA q steps: returns (table, count_bits) where
    ``table[s, g]`` for a q-gram ``g`` (base sigma+1, last char = least
    significant digit... i.e. g = c_{t} * (sigma+1)^{q-1} + ... hmm — we use
    g = sum_j c_j * (sigma+1)^(q-1-j) for chars consumed in order j=0..q-1)
    packs ``next_state << count_bits | terminal_visits``.

    Exact: terminal_visits is the number of terminal states visited over the
    q transitions, preserving the per-position counting semantics.
    """
    if q < 1:
        raise ValueError("q >= 1")
    sig_p = ac.sigma + 1
    count_bits = max(1, (q).bit_length())
    # one-step packed: next, count
    nxt1 = ac.delta.astype(np.int64)                     # (S, sig_p)
    cnt1 = ac.final[ac.delta].astype(np.int64)
    nxt = nxt1
    cnt = cnt1
    for _ in range(q - 1):
        # compose: step existing (nxt, cnt) with one more char
        S, G = nxt.shape
        # new gram g' = g * sig_p + c
        nxt_new = nxt1[nxt.reshape(-1)].reshape(S, G * sig_p)
        cnt_new = (cnt.reshape(S, G, 1) + cnt1[nxt.reshape(-1)].reshape(S, G, sig_p)).reshape(S, G * sig_p)
        nxt, cnt = nxt_new, cnt_new
    table = (nxt << count_bits) | cnt
    if int(nxt.max()) << count_bits > np.iinfo(np.int32).max:
        return table.astype(np.int64), count_bits
    return table.astype(np.int32), count_bits
