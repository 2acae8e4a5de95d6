"""Two card-side checks of the port's training step (PyTorch only, no JAX).

  python scripts/card_train_checks.py gaps [--arch gemma3-27b ...]
  python scripts/card_train_checks.py depth [--layers 16 20 24]

``gaps``: one smoke train step (batch 4 x 64, seed 0 params, ``remat``
off so each block runs once) on the CPU and on the card from the same
params and tokens, layer by layer: each block's output (forward) and the
gradient of the loss at each block's input (backward), as the largest gap
of the CPU's largest magnitude and the share of elements that differ;
then every gradient leaf's gap, the worst five named.  Variants of each
model (other token batches, qk-norm off, fewer layers) say what the gap
follows.  ``depth``: internvl2-2b at full width, one train step of 4 x 512
tokens with its 256 x 1,024 patch frontend at each of ``--layers``,
smallest first; the peak allocated or the out-of-memory error of each.

Both print one JSON line per reading (prefixed ``[gaps]`` / ``[depth]``)
and need a CUDA device.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_variant  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import train_loop as TL  # noqa: E402


def _to(node, device):
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, device) for v in node]
    return node.to(device)


def _gap(a: torch.Tensor, b: torch.Tensor):
    """(largest |a - b| of b's largest magnitude, share of elements that
    differ), both on the CPU."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return (float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30),
            float((a != b).float().mean()))


def traced_step(params, batch, cfg, device):
    """One value-and-grad step on ``device`` with each block's output and
    the gradient at each block's input recorded, in call order (decoder
    blocks last for an encoder-decoder)."""
    outs, grads = [], []
    real = T.block_apply

    def block(p, x, *args, **kwargs):
        if x.requires_grad:
            slot = len(grads)
            grads.append(None)
            x.register_hook(lambda g, slot=slot: grads.__setitem__(slot, g.detach().cpu()))
        y, extra = real(p, x, *args, **kwargs)
        outs.append(y.detach().cpu())
        return y, extra

    T.block_apply = block
    try:
        metrics, g = TL.value_and_grad(_to(params, device), {k: torch.as_tensor(v).to(device) for k, v in batch.items()},
                                       cfg, TL.TrainConfig(remat=False))
    finally:
        T.block_apply = real
    return metrics, g, outs, grads


def gaps(cfg, params, batch, device, tag: str) -> dict:
    m_cpu, g_cpu, o_cpu, d_cpu = traced_step(params, batch, cfg, "cpu")
    m_dev, g_dev, o_dev, d_dev = traced_step(params, batch, cfg, device)
    leaf = {p: _gap(a, b)[0] for (p, a), b in zip(tree.leaves_with_paths(g_dev), tree.leaves(g_cpu))}
    worst = sorted(leaf, key=leaf.get, reverse=True)[:5]
    out = dict(
        tag=tag, layers=cfg.n_layers, kinds="".join(cfg.layer_kinds),
        loss_gap=abs(float(m_dev["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"])),
        forward=[_gap(a, b) for a, b in zip(o_dev, o_cpu)],
        backward=[_gap(a, b) if a is not None and b is not None else None for a, b in zip(d_dev, d_cpu)],
        worst_leaves={p: leaf[p] for p in worst},
        leaves_equal=sum(torch.equal(a.cpu(), b) for a, b in zip(tree.leaves(g_dev), tree.leaves(g_cpu))),
        leaves=len(leaf),
    )
    print("[gaps] " + json.dumps(out), flush=True)
    return out


def run_gaps(archs, device) -> None:
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    print(f"[gaps] torch {torch.__version__}, cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    for name in archs:
        cfg = smoke_variant(get_config(name))
        variants = [("seed 1", cfg, 1), ("seed 2", cfg, 2), ("seed 3", cfg, 3)]
        if cfg.qk_norm:
            variants.append(("qk_norm off, seed 1", dataclasses.replace(cfg, qk_norm=False), 1))
        if cfg.prefix_layers:
            variants.append(("period only, seed 1", dataclasses.replace(
                cfg, prefix_layers=(), n_layers=len(cfg.pattern_period)), 1))
        for tag, vcfg, seed in variants:
            params = Z.init_params(0, vcfg, device="cpu")
            batch = TokenPipeline(DataConfig(vocab_size=vcfg.vocab_size, seq_len=64, global_batch=4,
                                             seed=seed)).next()
            gaps(vcfg, params, batch, device, f"{name} {tag}")


def run_depth(layer_counts, device) -> None:
    base = get_config("internvl2-2b")
    enc = base.encoder
    for layers in sorted(layer_counts):
        cfg = dataclasses.replace(base, n_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        row = dict(layers=layers)
        try:
            params, opt = TL.init_train_state(0, cfg, device=device)
            row["latents"] = sum(p.numel() for p in tree.leaves(params))
            step = TL.make_train_step(cfg, TL.TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                                                       total_steps=2)),
                                      device=device)
            pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=512, global_batch=4, seed=0,
                                            frontend_positions=enc.n_positions, frontend_dim=enc.d_input))
            for i in range(2):
                t = time.perf_counter()
                params, opt, metrics = step(params, opt, pipe.next())
                torch.cuda.synchronize()
                row[f"step{i}_ms"] = (time.perf_counter() - t) * 1e3
            row.update(loss=float(metrics["loss"]), peak_bytes=torch.cuda.max_memory_allocated(),
                       bytes_per_latent=torch.cuda.max_memory_allocated() / row["latents"])
        except torch.cuda.OutOfMemoryError as e:
            row["oom"] = str(e).splitlines()[0][:200]
        print("[depth] " + json.dumps(row), flush=True)
        params = opt = step = None
        if "oom" in row:
            break


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("check", choices=("gaps", "depth"))
    ap.add_argument("--arch", nargs="+", default=["gemma3-27b", "granite-8b"])
    ap.add_argument("--layers", nargs="+", type=int, default=[16, 20, 24])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("card_train_checks: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    if args.check == "gaps":
        run_gaps(args.arch, device)
    else:
        run_depth(args.layers, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
