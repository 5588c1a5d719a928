"""Plain PyTorch version of merge_fix: the classic merge_and_fix tail —
alphas from the edge activations, then the expanded interval durations
``len * max(alpha, 1)`` (Lemma 6).  The port's copy of
``repro/kernels/merge_fix/ref.py::merge_fix_ref``, on tensors.  A CPU
tensor runs it; ``chip_smoke.py`` holds the CUDA kernel against it on the
card.

Also here: ``tile_layout``, the tiling the kernel runs with (the wrapper
passes it to the kernel and sizes its scratch from it), and
``merge_fix_tiled``, a plain emulation of the kernel's tiled algorithm for
the tests; it is on no path."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..coflow_merge.ops import carry_levels
from ..coflow_merge.ref import alphas_ref, build_delta

ROWS = 32            # rows a tile: merge_scan.cuh's kRows
PORT_TILE = 512      # ports a port tile: merge_scan.cuh's kPortTile
MAX_BINS = 12000     # bins a chunk counts in shared memory (48 KB)
CHUNK_EDGES = 1024   # edges a chunk takes at least (two a thread)
MAX_CHUNKS = 512     # chunks at most: merge_fix.cu's kMaxChunks


class TileLayout(NamedTuple):
    T: int       # tiles of `rows` rows: one block each
    lg: int      # a bin holds 2**lg tiles
    nbins: int
    Ec: int      # edges a chunk
    C: int       # chunks
    nb: int      # buckets of the events' times: 2**k >= K + 1


def tile_layout(K: int, E: int, *, rows: int = ROWS,
                max_bins: int = MAX_BINS,
                chunk_edges: int = CHUNK_EDGES) -> TileLayout:
    """The tiling of K intervals and E edges: tiles of `rows` rows (one
    block each of the last launch); bins of 2**lg tiles, so that a chunk's
    counts of its endpoints per bin fit its shared memory (`max_bins`); the
    edges cut into at most MAX_CHUNKS chunks of at least `chunk_edges`;
    the events' times in 2**k >= K + 1 buckets."""
    T = -(-K // rows)
    lg = 0
    while -(-T // (1 << lg)) > max_bins:
        lg += 1
    Ec = max(chunk_edges, -(-E // MAX_CHUNKS))
    return TileLayout(T, lg, -(-T // (1 << lg)), Ec, max(1, -(-E // Ec)),
                      1 << K.bit_length())


def merge_fix_ref(
    events: torch.Tensor,  # (K+1,) int64 sorted unique interval boundaries
    t0: torch.Tensor,      # (E,) int64 edge activation start times
    t1: torch.Tensor,      # (E,) int64 edge activation end times (exclusive)
    s: torch.Tensor,       # (E,) int64 sender port
    r: torch.Tensor,       # (E,) int64 receiver port
    m: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (alphas (K,) int64, deltas (K,) int64); the deltas cumsum to
    merge_and_fix's ``exp`` (before the origin shift)."""
    K = int(events.numel()) - 1
    if K < 1:
        z = torch.zeros(0, dtype=torch.int64, device=events.device)
        return z, z.clone()
    si = torch.searchsorted(events, t0)
    ei = torch.searchsorted(events, t1)
    alphas = alphas_ref(build_delta(si, ei, s, r, K, m)).to(torch.int64)
    lens = events[1:] - events[:-1]
    return alphas, lens * alphas.clamp(min=1)


def merge_fix_tiled(events: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor,
                    s: torch.Tensor, r: torch.Tensor, m: int, *,
                    rows: int = ROWS, port_tile: int = PORT_TILE,
                    max_bins: int = MAX_BINS, chunk_edges: int = CHUNK_EDGES
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``merge_fix_ref`` computed the way ``csrc/merge_fix.cu`` computes it,
    on CPU tensors, with tiles of `rows` rows.  Launch 2: each chunk of
    edges bins its kept endpoints (row < K) by bin of tiles and orders its
    records by bin.  Launch 3, per tile: its column totals from its records
    from every chunk are published at level 0 of the carry and summed into
    its blocks of 8**l tiles above; its carry is the sum, at each level, of
    the blocks below its own within its block of 8; its records go into a
    [rows, port tile] array whose columns are scanned on from the carry,
    and each row's max is taken over the port tiles."""
    K, E, P = int(events.numel()) - 1, int(t0.numel()), 2 * m
    if K < 1:
        z = torch.zeros(0, dtype=torch.int64)
        return z, z.clone()
    lay = tile_layout(K, E, rows=rows, max_bins=max_bins,
                      chunk_edges=chunk_edges)
    bin_rows = rows << lay.lg
    si = torch.searchsorted(events, t0)
    ei = torch.searchsorted(events, t1)
    # launch 2: per chunk, records (row in bin, sign, s, r) in bin order
    # and the offsets of each bin
    chunks = []
    for c in range(lay.C):
        e = torch.arange(c * lay.Ec, min(E, (c + 1) * lay.Ec))
        row = torch.cat([si[e], ei[e]])
        sign = torch.cat([torch.ones_like(e), -torch.ones_like(e)])
        ps, pr = torch.cat([s[e], s[e]]), torch.cat([r[e], r[e]])
        kept = row < K
        row, sign, ps, pr = row[kept], sign[kept], ps[kept], pr[kept]
        b = row // bin_rows
        order = torch.argsort(b, stable=True)
        seg = torch.zeros(lay.nbins + 1, dtype=torch.int64)
        seg[1:] = torch.bincount(b, minlength=lay.nbins).cumsum(0)
        chunks.append((seg, (row % bin_rows)[order], sign[order],
                       ps[order], m + pr[order]))

    def tile_records(t):
        bn, tib = t >> lay.lg, t & ((1 << lay.lg) - 1)
        rib, sg, ps, pr = (torch.cat(x) for x in zip(*(
            [a[seg[bn]:seg[bn + 1]] for a in rest]
            for seg, *rest in chunks)))
        mine = rib // rows == tib
        return rib[mine] % rows, sg[mine], (ps[mine], pr[mine])

    # launch 3: every tile publishes its totals before any waits
    lv = [torch.zeros((-(-lay.T // 8 ** lvl), P), dtype=torch.int64)
          for lvl in range(carry_levels(lay.T))]
    for t in range(lay.T):
        _, sg, ports = tile_records(t)
        for q in ports:
            for lvl, a in enumerate(lv):
                a[t >> 3 * lvl].index_add_(0, q, sg)
    # then each tile's carry and scan, in any order
    PT = min(-(-P // 32) * 32, port_tile)
    alphas = torch.empty(K, dtype=torch.int64)
    for t in range(lay.T):
        carry = sum(a[(t >> 3 * lvl) & ~7:t >> 3 * lvl].sum(0)
                    for lvl, a in enumerate(lv))
        rit, sg, ports = tile_records(t)
        n = min(rows, K - t * rows)
        best = torch.full((n,), torch.iinfo(torch.int64).min)
        for p0 in range(0, P, PT):
            np_ = min(PT, P - p0)
            cells = torch.zeros((rows, PT), dtype=torch.int64)
            for q in ports:
                w = (q >= p0) & (q < p0 + PT)
                cells.index_put_((rit[w], q[w] - p0), sg[w], accumulate=True)
            scan = carry[p0:p0 + np_] + cells[:n, :np_].cumsum(0)
            best = torch.maximum(best, scan.amax(1))
        alphas[t * rows:t * rows + n] = best
    lens = events[1:] - events[:-1]
    return alphas, lens * alphas.clamp(min=1)
