"""End-to-end serving on the PyTorch/CUDA port: batched requests against a
binary Transformer (``examples/serve_binary_lm.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_serve_binary_lm.py                # on the card
    PYTHONPATH=src python examples/torch_serve_binary_lm.py --device cpu

Takes a model at init, runs the offline weight pipeline (sign-binarize ->
bit-pack 32 to a word -> fold the colsum corrections, the paper's
"performed offline" coefficients), then serves a queue of batched requests
through slot-based continuous batching on the integer QMM datapath with an
int8 KV cache.
"""

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.smoke import smoke_variant
from repro_torch.core import tree
from repro_torch.models import model_zoo as Z
from repro_torch.runtime.serve_loop import Request, ServeEngine


def run(cfg, steps: int = 12, device="cuda") -> list:
    """Serve 10 requests of ``steps`` new tokens each; returns them done."""
    print(f"[serve] arch {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"mode {cfg.quant.mode_name}, int8 KV cache, on {device}")

    params = Z.init_params(0, cfg, device=device)
    serving = Z.prepare_serving_params(params, cfg)

    def nbytes(t):
        return sum(x.numel() * x.element_size() for x in tree.leaves(t))

    print(f"[serve] weight pipeline: {nbytes(params)/1e6:.1f} MB latent fp32 "
          f"-> {nbytes(serving)/1e6:.1f} MB packed serving")

    rng = np.random.default_rng(1)
    requests = [
        Request(
            prompt=rng.integers(0, cfg.vocab_size, size=(rng.integers(4, 12),)).astype(np.int32),
            max_new_tokens=steps,
            temperature=0.8 if i % 2 else 0.0,
        )
        for i in range(10)
    ]
    engine = ServeEngine(cfg, serving, batch_slots=4, max_len=64, device=device)
    t0 = time.perf_counter()
    done = engine.run(requests)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.output) for r in done)
    print(f"[serve] {len(done)} requests -> {tokens} tokens in {dt:.1f}s")
    for i, r in enumerate(done[:5]):
        mode = "greedy" if r.temperature == 0 else f"T={r.temperature}"
        print(f"  req{i} ({mode}): {r.output}")
    assert all(r.output and len(r.output) == r.max_new_tokens for r in done)
    print("[serve] all requests completed")
    return done


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run(smoke_variant(get_config("granite-8b")), device=ap.parse_args().device)


if __name__ == "__main__":
    main()
