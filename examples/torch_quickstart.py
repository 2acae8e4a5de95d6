"""Quickstart on the PyTorch/CUDA port: BETA's computation-flow abstraction
and QMM engine (``examples/quickstart.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py                 # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Walks the paper's Fig. 2 example end to end: affine-quantized operands, the
naive full-precision flow, the abstracted integer flow (on the plain
``mxu`` core and on the hand-written kernels, ``pallas``), the engine's
precision modes, act x act, and the packed-weight serving layout.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import flow_abstraction as FA
from repro_torch.core import qmm as QE
from repro_torch.core import quantization as Q
from repro_torch.core.precision import MODES


def run(device="cuda") -> dict:
    """Print each step; returns the errors and sizes it printed."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32)).to(device)
    w = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32)).to(device)
    out = {}

    # 1) affine-quantize: activation -> alpha*X + gamma (W1A4 mode), weight
    #    -> sign-binary (the paper's (aA + g*1) x bW example)
    xq = Q.quantize_activation(x, bits=4)
    wq = Q.binarize_weight(w)
    print(f"activation: {xq.bits}-bit mantissa, scale={float(xq.scale):.4f}")
    print(f"weight:     {wq.bits}-bit mantissa, per-channel scales {tuple(wq.scale.shape)}")

    # 2) the naive flow the paper replaces: dequantize -> float matmul
    naive = FA.qmm_dequant_reference(xq, wq)

    # 3) the abstracted flow: integer MM + rank-1 corrections (exact)
    flow = QE.qmm(xq, wq, backend="mxu")
    out["flow_err"] = float((flow - naive).abs().max())
    print("max |flow - naive| =", out["flow_err"])
    # ... and on the hand-written kernels (K1 here: int8 activations x packed
    # 1-bit weights), the same integer product, so the same bits
    kern = QE.qmm(xq, wq.pack(axis=0), backend="pallas")
    out["kernel_equal"] = bool(torch.equal(kern, flow))
    print("pallas (binary_qmm) bitwise equal to mxu:", out["kernel_equal"])

    # 4) op accounting (Fig. 2): N^3 Op -> 2N^3 Iop + (3N^2+2) Op
    n = 64
    print("naive:", FA.op_counts_naive(n, n, n))
    print("flow: ", FA.op_counts_abstracted(n, n, n))

    # 5) engine modes (Fig. 4): one datapath, four precisions
    out["mode_err"] = {}
    for name, mode in MODES.items():
        xq_m = Q.quantize_activation(x, mode.act_bits)
        y = QE.qmm(xq_m, wq, backend="mxu", mode=mode)
        err = float((y - x @ w).abs().max())
        out["mode_err"][name] = err
        print(f"{name}: pack_factor={mode.pack_factor} "
              f"bitserial={mode.bitserial_cycles} quant_err={err:.3f}")

    # 6) both QMM types: act x act (Q @ K^T) through the same engine
    q_ = Q.quantize_activation(torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32)).to(device), 8)
    k_ = Q.quantize_activation(torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32)).to(device), 8)
    out["act_act_err"] = float((QE.qmm(q_, k_) - FA.qmm_dequant_reference(q_, k_)).abs().max())
    print("act x act err:", out["act_act_err"])

    # 7) serving layout: weights bit-packed 32 to a word
    packed = wq.pack(axis=0)
    dense, words = w.numel() * 4, packed.mantissa.numel() * 4
    out["pack_ratio"] = dense / words
    print(f"packed weights: {tuple(packed.mantissa.shape)} int32 words "
          f"({dense}B fp32 -> {words}B packed, {out['pack_ratio']:.0f}x)")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run(ap.parse_args().device)


if __name__ == "__main__":
    main()
