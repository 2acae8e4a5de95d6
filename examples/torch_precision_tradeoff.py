"""Fig. 5's other axis on the PyTorch/CUDA port: accuracy against activation
precision, by QAT (``examples/precision_tradeoff.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_precision_tradeoff.py [--steps 120]          # on the card
    PYTHONPATH=src python examples/torch_precision_tradeoff.py --steps 20 --device cpu

Trains the same tiny LM at W1A8 / W1A4 / W1A2 / W1A1 and prints its final
loss beside the calibrated BETA model's throughput and efficiency for that
mode on the paper's ZCU102 FPGA (``core/energy_model.py``; not the card's
figures: ``chip_smoke.py`` phase [17c] measures those) -- the trade-off of
the paper's Fig. 5: efficiency rises, accuracy falls as activation bits
shrink.
"""

import argparse
import dataclasses

from repro_torch.configs.base import ArchConfig, QuantConfig
from repro_torch.core import energy_model as em
from repro_torch.core.precision import MODES
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop as TL


def build_cfg(act_bits: int) -> ArchConfig:
    return ArchConfig(
        name=f"tiny-lm-a{act_bits}",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        pattern_period=("g",),
        ffn_type="gelu",
        quant=QuantConfig(act_bits=act_bits, attn_act_bits=act_bits),
        max_seq=512,
    )


def train_one(cfg, steps: int, device="cuda", seed: int = 0) -> float:
    tcfg = TL.TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps))
    step = TL.make_train_step(cfg, tcfg, device=device)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8, seed=seed))
    params, opt = TL.init_train_state(seed, cfg, device=device)
    last = float("nan")
    for _ in range(steps):
        params, opt, m = step(params, opt, pipe.next())
        last = float(m["loss"])
    return last


def run(cfg, steps: int, device="cuda") -> list:
    """QAT of ``cfg`` at each mode's activation bits; returns (mode, final
    loss, ZCU102 GOPS, ZCU102 GOPS/W) rows."""
    wl = em.bert_base_qmm_workload()
    oh = em.BENCHMARK_OVERHEADS["BiT"]
    print(f"{'mode':6s} {'final_loss':>10s} {'GOPS':>8s} {'GOPS/W':>8s}   (GOPS, GOPS/W: BETA on the ZCU102)")
    results = []
    for name in ("W1A8", "W1A4", "W1A2", "W1A1"):
        mode = MODES[name]
        q = dataclasses.replace(cfg.quant, act_bits=mode.act_bits, attn_act_bits=mode.act_bits)
        mcfg = dataclasses.replace(cfg, name=f"{cfg.name}-{name}", quant=q)
        loss = train_one(mcfg, steps, device)
        gops, _ = em.throughput_gops(wl, mode, em.ZCU102_BETA, oh)
        eff = em.energy_efficiency(wl, mode, em.ZCU102_BETA, oh)
        results.append((name, loss, gops, eff))
        print(f"{name:6s} {loss:10.4f} {gops:8.1f} {eff:8.1f}")
    losses = [r[1] for r in results]
    effs = [r[3] for r in results]
    print("[tradeoff] efficiency rises monotonically:",
          all(effs[i] < effs[i + 1] for i in range(len(effs) - 1)))
    print("[tradeoff] accuracy (lower loss) degrades toward W1A1:", losses[-1] >= min(losses))
    return results


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    run(build_cfg(8), args.steps, args.device)


if __name__ == "__main__":
    main()
