"""The int8 GEMMs of the eps network's lin2 and lin3: ``torch._int_mm``
(cuBLAS; the ``serving`` preset's route) or the port's K4/K5
(``csrc/int8_gemm.cuh``). Operations and bytes of one member's product:
int8 codes (r, k) and (k, n) read once, the int32 (r, n) written once.

Names: the port's kernel, and the fragments cuBLAS's int8 kernels carry on
Hopper (which kernel cuBLAS picks is its own choice)."""

NAMES = ("int8_gemm_kernel", "s8s8", "i8i8", "imma", "igemm")


def gemm(r: int, k: int, n: int):
    return 2 * r * k * n, r * k + k * n + 4 * r * n


def chain_ops(m: int, batch: int, trials: int, features: int, steps: int) -> int:
    """int8 operations of lin2 and lin3 over a whole strided chain."""
    return 2 * m * steps * gemm(trials * batch, features, features)[0]
