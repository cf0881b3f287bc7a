"""K1, ``csrc/fused_linear.cu``: softplus((x @ w) * a + c) [* gate] for
every member, one launch a layer. Operations and bytes of one launch,
counted as the kernel's inputs read once and its output written once.

The lin1 body (``small_k``) and the lin2/lin3 body run under different
kernel names; both start with ``fused_linear_``."""

NAMES = ("fused_linear_",)


def launch(m: int, r: int, k: int, n: int, elem_bytes: int, gate_rows: int = 0, gate_bytes: int = 4):
    """(operations, bytes) of one launch: x (m, r, k) and w (m, k, n) of
    ``elem_bytes``, the float32 affine a and c (m, n), an optional gate
    (m, gate_rows, n), the output (m, r, n)."""
    ops = 2 * m * r * k * n
    n_bytes = (m * r * k + m * k * n + m * r * n) * elem_bytes + 2 * m * n * 4 + m * gate_rows * n * gate_bytes
    return ops, n_bytes


def eps_launches(m: int, batch: int, trials: int, y_dim: int, features: int, elem_bytes: int):
    """The three launches of one eps step of the float chain, by name:
    lin1 (K = 2 y_dim, its gate the features a row an image, float32) and
    lin2, lin3 (K = N = features)."""
    r = trials * batch
    return {
        "lin1": launch(m, r, 2 * y_dim, features, elem_bytes, gate_rows=batch, gate_bytes=4),
        "lin2": launch(m, r, features, features, elem_bytes),
        "lin3": launch(m, r, features, features, elem_bytes),
    }
