"""Serial oracle extractor (pure numpy) — ground truth for the agent-based extractor;
the port's own copy of ``repro/core/vlsi/reference.py``.

Semantics (paper §3): each contiguous conductor region on a layer is one node. POLY
overlapping DIFF forms a transistor: the overlap is the gate; it splits the diff wire
into source/drain segments (diff conductor = DIFF & ~POLY; poly conducts through the
gate). A contact connects the METAL1 node to the node of the single other conductor
layer overlapping the contact area. PSEL over a gate makes the device a PFET.

Output mirrors the paper's statement forms:
    FET(pol, s, d, g, l, w)  -- s/d unordered; l = min bbox dim, w = max bbox dim
    EQUIV(a, b)              -- (layer, node) pairs, unordered
"""
from __future__ import annotations

from collections import deque
from typing import NamedTuple

import numpy as np

from .layout import CONTACT, DIFF, M1, M2, POLY, PSEL

# conductor layer indices used in node ids
CONDUCTORS = (M1, M2, POLY, DIFF)


class Fet(NamedTuple):
    pol: str                  # 'n' | 'p'
    sd: frozenset             # {(layer, comp), (layer, comp)} -- source/drain nodes
    g: tuple                  # (layer, comp)
    l: int
    w: int


class Equiv(NamedTuple):
    nodes: frozenset          # {(layer, comp), (layer, comp)}


class Netlist(NamedTuple):
    fets: frozenset
    equivs: frozenset
    num_nodes: int


def conductor_mask(grid: np.ndarray, layer: int) -> np.ndarray:
    if layer == DIFF:
        return (grid[DIFF] > 0) & (grid[POLY] == 0)
    return grid[layer] > 0


def label_components(mask: np.ndarray) -> tuple[np.ndarray, int]:
    """4-connected component labelling; labels 1..n, 0 = background."""
    h, w = mask.shape
    labels = np.zeros((h, w), np.int32)
    n = 0
    for r in range(h):
        for c in range(w):
            if mask[r, c] and labels[r, c] == 0:
                n += 1
                q = deque([(r, c)])
                labels[r, c] = n
                while q:
                    rr, cc = q.popleft()
                    for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                        r2, c2 = rr + dr, cc + dc
                        if 0 <= r2 < h and 0 <= c2 < w and mask[r2, c2] and labels[r2, c2] == 0:
                            labels[r2, c2] = n
                            q.append((r2, c2))
    return labels, n


def extract(grid: np.ndarray) -> Netlist:
    grid = np.asarray(grid)
    comp = {}
    counts = {}
    for layer in CONDUCTORS:
        comp[layer], counts[layer] = label_components(conductor_mask(grid, layer))

    # --- transistors: components of the poly∩diff overlap -------------------------
    gate_mask = (grid[POLY] > 0) & (grid[DIFF] > 0)
    gate_comp, n_gates = label_components(gate_mask)
    fets = set()
    for gid in range(1, n_gates + 1):
        cells = np.argwhere(gate_comp == gid)
        rs, cs = cells[:, 0], cells[:, 1]
        g_node = (POLY, int(comp[POLY][rs[0], cs[0]]))
        sd = set()
        for r, c in cells:
            for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                r2, c2 = r + dr, c + dc
                if 0 <= r2 < grid.shape[1] and 0 <= c2 < grid.shape[2]:
                    d = comp[DIFF][r2, c2]
                    if d > 0:
                        sd.add((DIFF, int(d)))
        h = int(rs.max() - rs.min() + 1)
        w = int(cs.max() - cs.min() + 1)
        pol = 'p' if grid[PSEL][rs[0], cs[0]] > 0 else 'n'
        fets.add(Fet(pol=pol, sd=frozenset(sd), g=g_node, l=min(h, w), w=max(h, w)))

    # --- contacts: components of the contact plane --------------------------------
    con_comp, n_cons = label_components(grid[CONTACT] > 0)
    equivs = set()
    for cid in range(1, n_cons + 1):
        cells = np.argwhere(con_comp == cid)
        r, c = cells[0]
        m1 = comp[M1][r, c]
        other = None
        for layer in (M2, POLY, DIFF):
            v = comp[layer][r, c]
            if v > 0:
                assert other is None, "design-rule violation: contact over >2 conductors"
                other = (layer, int(v))
        assert m1 > 0 and other is not None, "design-rule violation: dangling contact"
        equivs.add(Equiv(nodes=frozenset({(M1, int(m1)), other})))

    num_nodes = sum(counts[layer] for layer in CONDUCTORS)
    return Netlist(fets=frozenset(fets), equivs=frozenset(equivs), num_nodes=num_nodes)
