"""The 3xTF32 split of the port's tensor-core kernels, emulated on the CPU.

B2's f32 kernel, B3's f32 pass A and B4a/B4b split every f32 operand a of
their products into big = a rounded to TF32 as cvt.rna.tf32.f32 rounds (to
nearest, ties away from zero) and small = a - big, which the tensor core
reads as TF32 by dropping its low 13 bits, and sum small*big + big*small +
big*big on the tensor cores in f32 (``csrc/tensor_core.cuh``'s ``split``).
TF32 products are exact in f32 (11-bit significands); an emulation that sums
them in float64 and rounds once to f32 leaves out the tensor cores' f32
accumulation error, which the chip check covers.

    from tf32_emulation import three_tf32, tf32_rna, tf32_split
"""

import torch


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: f32 rounded to 10 mantissa bits, to nearest, ties
    away from zero (half an ulp added to the magnitude's bits, then the low
    13 bits cleared), as the kernel computes it."""
    bits = a.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_read(a: torch.Tensor) -> torch.Tensor:
    """An f32 register as an mma.sync TF32 operand: its low 13 bits
    dropped."""
    return (a.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def tf32_split(a: torch.Tensor):
    """(big, small) as the tensor cores see the kernel's split of a."""
    big = tf32_rna(a)
    return big, tf32_read(a - big)


def three_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: both operands split, the three TF32
    products summed in float64 and rounded once to f32."""
    (ab, as_), (bb, bs) = tf32_split(a), tf32_split(b)
    return (as_.double() @ bb.double() + ab.double() @ bs.double()
            + ab.double() @ bb.double()).float()
