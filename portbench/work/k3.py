"""K3, ``csrc/attention.cu``: softmax(q k^T / sqrt(d)) v. Operations and
bytes of one launch (q, k, v read once, the output written once)."""

NAMES = ("attention_",)


def launch(b: int, n: int, h: int, d: int, elem_bytes: int):
    ops = 4 * b * h * n * n * d
    return ops, 4 * b * n * h * d * elem_bytes
