"""Operations and bytes of one expert layer's three products (SwiGLU: gate,
up and down, each 2 D F multiply-adds a row), from its shape and the rows
of the expert buffer that hold an assignment (so padding rows, which an
implementation may or may not compute, count for nothing).

Operations: 6 D F a live row. Bytes: each live row read once (D) and its
output written once (D), and every expert's three weight matrices read
once; the intermediate activations are not counted (a fused kernel need
not write them)."""


def flops(d_model: int, d_ff: int, rows: float) -> float:
    return 6.0 * d_model * d_ff * rows


def nbytes(d_model: int, d_ff: int, experts: int, rows: float,
           elem: int = 2) -> float:
    return float((2 * rows * d_model + 3 * experts * d_model * d_ff) * elem)
