"""Synthetic CMOS layout generation (paper §3); the port's own copy of
``repro/core/vlsi/layout.py`` (numpy only).

A layout is a 6-plane int32 bitmap ``(6, H, W)`` with planes METAL1, METAL2, POLY, DIFF,
PSEL, CONTACT. Wires are filled rectangles; a transistor is formed wherever POLY overlaps
DIFF (the overlap is the gate / channel region and splits the diff wire); a contact
electrically connects METAL1 to exactly one other overlapping layer (design rule: no
direct poly-diff contacts).

We generate standard-cell-like layouts programmatically:
  * ``nand_cell``   — the paper's 4-transistor NAND (2 parallel PFETs, 2 series NFETs)
  * ``inverter_cell`` — 2 transistors
  * ``via_cell``    — routing-only cell (m1-m2 via + m1-diff contact), no transistors
  * ``nand_layout`` — one NAND with margin (the paper's Fig. 1 / Fig. 4 workload)
  * ``dff_layout``  — an 8-NAND tile: 32 transistors, >=100 contacts (Fig. 3 scale)
  * ``random_layout`` — random tiling of cells (property tests)

Ground truth is defined by ``repro_torch.core.vlsi.reference`` (the serial
oracle). The ``*_layout`` generators leave the outer rows and columns empty
(a 3-cell margin), which the extractor requires (``extractor.make_grid``).
"""
from __future__ import annotations

import numpy as np

M1, M2, POLY, DIFF, PSEL, CONTACT = range(6)
NUM_LAYERS = 6


class LayoutBuilder:
    def __init__(self, h: int, w: int):
        self.h, self.w = h, w
        self.grid = np.zeros((NUM_LAYERS, h, w), np.int32)

    def rect(self, layer: int, r0: int, c0: int, r1: int, c1: int) -> "LayoutBuilder":
        """Filled rectangle, inclusive coordinates."""
        assert 0 <= r0 <= r1 < self.h and 0 <= c0 <= c1 < self.w, (r0, c0, r1, c1)
        self.grid[layer, r0:r1 + 1, c0:c1 + 1] = 1
        return self

    def contact(self, r: int, c: int, size: int = 2) -> "LayoutBuilder":
        """size x size contact region with upper-left corner (r, c)."""
        return self.rect(CONTACT, r, c, r + size - 1, c + size - 1)

    def paste(self, cell: np.ndarray, r: int, c: int) -> "LayoutBuilder":
        _, ch, cw = cell.shape
        self.grid[:, r:r + ch, c:c + cw] |= cell
        return self


def nand_cell(double_contacts: bool = True) -> np.ndarray:
    """34x26 CMOS NAND: inputs A, B; 2 parallel PFETs (top, under PSEL), 2 series NFETs.

    With ``double_contacts`` the power/output connections use paired contacts — the
    paper notes real layouts connect node pairs through multiple contacts, producing
    redundant equivalence statements (the extractor must tolerate them).
    """
    b = LayoutBuilder(34, 26)
    # polysilicon inputs (width 2, vertical)
    b.rect(POLY, 4, 8, 29, 9)      # input A
    b.rect(POLY, 4, 16, 29, 17)    # input B
    # p-diffusion (top) + select, n-diffusion (bottom)
    b.rect(DIFF, 6, 4, 8, 21)
    b.rect(PSEL, 4, 2, 10, 23)
    b.rect(DIFF, 24, 4, 26, 21)
    # metal1: VDD rail + stubs onto pdiff left/right segments
    b.rect(M1, 1, 0, 2, 25)
    b.rect(M1, 1, 4, 8, 5); b.contact(6, 4)
    b.rect(M1, 1, 20, 8, 21); b.contact(6, 20)
    # metal1: GND rail + stub onto ndiff left segment
    b.rect(M1, 31, 0, 32, 25)
    b.rect(M1, 24, 4, 32, 5); b.contact(24, 4)
    # metal1: output — pdiff middle segment down and across to ndiff right segment
    b.rect(M1, 6, 12, 22, 13); b.contact(6, 12)
    b.rect(M1, 21, 12, 22, 21)
    b.rect(M1, 21, 20, 26, 21); b.contact(24, 20)
    # metal1: inputs A and B contacting the poly lines
    b.rect(M1, 14, 0, 18, 9); b.contact(14, 8)
    b.rect(M1, 14, 16, 18, 25); b.contact(14, 16)
    if double_contacts:
        # enlarged power/output contacts (merge with the base ones into one area each)
        b.contact(7, 4); b.contact(7, 20); b.contact(25, 4); b.contact(7, 12)
        b.contact(25, 20)
        # genuinely redundant (disjoint) contact areas on the same node pairs — the
        # paper notes these produce redundant equivalence statements the extractor
        # emits and the harvester deduplicates.
        b.contact(17, 8)      # second input-A contact (one-row gap from the first)
        b.contact(17, 16)     # second input-B contact
    return b.grid


def inverter_cell() -> np.ndarray:
    """34x18 CMOS inverter: one input poly line, 1 PFET + 1 NFET."""
    b = LayoutBuilder(34, 18)
    b.rect(POLY, 4, 8, 29, 9)
    b.rect(DIFF, 6, 4, 8, 13)
    b.rect(PSEL, 4, 2, 10, 15)
    b.rect(DIFF, 24, 4, 26, 13)
    b.rect(M1, 1, 0, 2, 17)
    b.rect(M1, 1, 4, 8, 5); b.contact(6, 4)
    b.rect(M1, 31, 0, 32, 17)
    b.rect(M1, 24, 4, 32, 5); b.contact(24, 4)
    b.rect(M1, 6, 12, 26, 13); b.contact(6, 12); b.contact(24, 12)
    b.rect(M1, 14, 0, 15, 9); b.contact(14, 8)
    return b.grid


def via_cell() -> np.ndarray:
    """20x16 routing cell: an m1 wire connected to an m2 wire by a via, and to a diff
    stub by a contact. No transistors."""
    b = LayoutBuilder(20, 16)
    b.rect(M1, 4, 2, 5, 13)
    b.rect(M2, 2, 6, 17, 7)
    b.contact(4, 6)                 # m1-m2 via
    b.rect(DIFF, 10, 2, 17, 3)
    b.rect(M1, 4, 2, 11, 3)
    b.contact(10, 2)                # m1-diff contact
    return b.grid


def _with_margin(cell: np.ndarray, margin: int = 3) -> np.ndarray:
    _, h, w = cell.shape
    g = np.zeros((NUM_LAYERS, h + 2 * margin, w + 2 * margin), np.int32)
    g[:, margin:margin + h, margin:margin + w] = cell
    return g


def nand_layout(double_contacts: bool = True) -> np.ndarray:
    """The paper's NAND workload (Fig. 1 / Fig. 4)."""
    return _with_margin(nand_cell(double_contacts))


def dff_layout() -> np.ndarray:
    """Fig.-3-scale workload: 2x4 tile of NANDs -> 32 transistors, 72 contact areas.

    (The paper's D-flip-flop has 32 transistors and 120 contacts; we match the
    transistor count exactly and the contact count in scale — population dynamics
    depend on workload volume, not on inter-cell routing.)
    """
    cell = nand_cell(double_contacts=True)
    _, ch, cw = cell.shape
    rows, cols, gap, margin = 2, 4, 6, 3
    h = margin * 2 + rows * ch + (rows - 1) * gap
    w = margin * 2 + cols * cw + (cols - 1) * gap
    b = LayoutBuilder(h, w)
    for i in range(rows):
        for j in range(cols):
            b.paste(cell, margin + i * (ch + gap), margin + j * (cw + gap))
    return b.grid


def random_layout(rng: np.random.Generator, rows: int = 1, cols: int = 2) -> np.ndarray:
    """Random tiling of well-formed cells — used by property tests."""
    cells = [nand_cell(True), nand_cell(False), inverter_cell(), via_cell()]
    ch = max(c.shape[1] for c in cells)
    cw = max(c.shape[2] for c in cells)
    gap, margin = 6, 3
    h = margin * 2 + rows * ch + (rows - 1) * gap
    w = margin * 2 + cols * cw + (cols - 1) * gap
    b = LayoutBuilder(h, w)
    for i in range(rows):
        for j in range(cols):
            cell = cells[rng.integers(len(cells))]
            b.paste(cell, margin + i * (ch + gap), margin + j * (cw + gap))
    return b.grid
