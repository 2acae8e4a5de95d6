# ruff: noqa
"""Deliberately broken toy kernels (PyTorch): every trace invariant of
``repro_torch.analysis.verifier`` must fire on them.

Loaded by path (never on sys.path) from the verifier self-test and the unit
tests.  Each function reproduces one class of datapath bug the verifier
exists to catch; if a change to the taint walk stops detecting any of them,
``python -m repro_torch.analysis --self-test`` fails.  Packed operands are
int32 words, named packed by the caller (``packed_argnums``).
"""

import torch

from repro_torch.core import marks
from repro_torch.core.packing import popcount32


def leak_packed_to_float(packed):
    """INV-PACKED-FLOAT: treats int32 bit-plane *storage* as numbers."""
    return packed.to(torch.float32) * 2.0


def accumulate_in_bf16(a_packed, b_packed):
    """INV-ACCUM-LOWFP: popcount accumulator rounded through bfloat16."""
    counts = popcount32(a_packed & b_packed)
    return torch.sum(counts.to(torch.bfloat16), dim=-1)


@marks.boundary(marks.KERNEL)
def bad_fused_kernel(a_packed, b_packed):
    return torch.sum(popcount32(a_packed & b_packed).to(torch.bfloat16), dim=-1, keepdim=True)


def fused_kernel_lowfp(a_packed, b_packed):
    """INV-ACCUM-LOWFP at the kernel boundary: a kernel fed packed
    bit-planes finishes its accumulation in bfloat16 instead of returning an
    integer accumulator or an f32 fused epilogue."""
    return bad_fused_kernel(a_packed, b_packed)


def binary_attn_lowfp(q_planes, k_planes):
    """INV-ACCUM-LOWFP on the attention-scores path: AND-popcount counts
    over packed rank-4 Q/K bit-planes accumulated through bfloat16 instead
    of int32 with an f32 epilogue exit."""
    joint = q_planes[:, :, :, None, :] & k_planes[:, :, None, :, :]
    counts = popcount32(joint)
    return torch.sum(counts.to(torch.bfloat16), dim=-1)


def int_dot_low_precision(a, b):
    """INV-INT-DOT: int8 x int8 matmul accumulates in int8 (PyTorch returns
    the operands' dtype) and wraps past 127."""
    return torch.matmul(a, b)


def init_cache(batch, seq, d, device="cpu"):
    return {
        "k": torch.zeros((batch, seq, d), dtype=torch.float32, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def drifting_step(cache, x):
    """INV-CACHE-DTYPE: the PR 6 bug class -- a step that writes the slot
    back in bfloat16 when init_cache allocated float32."""
    return dict(cache, k=cache["k"].to(torch.bfloat16))


def growing_step(cache, x):
    """INV-CACHE-SHAPE: appends instead of writing into fixed capacity."""
    return dict(cache, k=torch.cat([cache["k"], x[:, None, :]], dim=1), pos=cache["pos"] + 1)
