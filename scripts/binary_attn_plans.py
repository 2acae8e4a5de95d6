"""The scores kernel on the card: chip_smoke.py's [12a] cases of a tree, and
the key tiles a block walks (PyTorch only, no JAX).

  python scripts/binary_attn_plans.py smoke [--src DIR] [--tag NAME]
  python scripts/binary_attn_plans.py walk

``smoke``: [12a] of ``chip_smoke.py`` (``check_binary_attn``: each case
bitwise against the plain version, its plan, ms, bound, plain and
``torch.bmm`` ms) run with the ``repro_torch`` package under ``DIR/src``
(default: this tree's).  To hold two trees on one card, unpack the other
into an ignored directory (``git archive <commit> src | tar -x -C
build/parent``) and run both in turns (other, this, this, other).  A tree
whose ``plan`` predates its ``dw`` argument is called without it.

``walk``: long prefills and decodes at the plan's tile, each block walking
1, 2, 4 or 8 key tiles through a ring of ``min(3, n)`` K tiles, each
bitwise against the plain version, beside ``out.fill_`` of the same output
(the rate device memory takes writes) and the bytes bound.

Both print one JSON line per reading, prefixed ``[smoke]`` / ``[walk]``,
and need a CUDA device.
"""

import argparse
import inspect
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

# (tag, (B, H, S), (B, G, T), dh): prefills whose output bounds them, and
# decodes over long caches whose K tiles weigh as much as their output
WALK_SHAPES = [
    ("GQA prefill 1024", (1, 32, 1024), (1, 8, 1024), 128),
    ("bit-bert prefill 512", (1, 12, 512), (1, 12, 512), 64),
    ("MHA prefill 2048", (1, 12, 2048), (1, 12, 2048), 64),
    ("GQA prefill 4096", (1, 32, 4096), (1, 8, 4096), 128),
    ("MLA latent decode 32k", (4, 16, 1), (4, 1, 32768), 512),
    ("GQA decode 32k", (4, 32, 1), (4, 8, 32768), 128),
    ("bit-bert decode 8k", (4, 12, 1), (4, 12, 8192), 64),
    ("GQA decode 8 x 4k", (8, 32, 1), (8, 8, 4096), 128),
]


def smoke(src: str, tag: str) -> None:
    sys.path.insert(0, os.path.join(os.path.abspath(src), "src"))
    from repro_torch.kernels import binary_attn as K5  # before chip_smoke puts this tree's src first

    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from repro_torch.kernels import build

    if len(inspect.signature(K5.plan).parameters) == 5:
        plan = K5.plan
        K5.plan = lambda b, h, g, s, t, dw: plan(b, h, g, s, t)
    smi = chip_smoke.nvidia_smi()
    build.load("binary_attn")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for row in chip_smoke.check_binary_attn(gen):
        print("[smoke] " + json.dumps(dict(tag=tag, src=K5.__file__, card=smi, **row)), flush=True)


def walk() -> None:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from repro_torch.core import packing
    from repro_torch.kernels import binary_attn as K5
    from repro_torch.kernels import build, ref

    smi = chip_smoke.nvidia_smi()
    build.load("binary_attn")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    plan = K5.plan
    for tag, (b, h, s), (_, g, t), dh in WALK_SHAPES:
        dw = packing.packed_len(dh, 1)
        q = packing.pack_bits(torch.randint(0, 2, (b, s, h, dh), generator=gen, device="cuda"), 1).transpose(1, 2)
        k = packing.pack_bits(torch.randint(0, 2, (b, t, g, dh), generator=gen, device="cuda"), 1).permute(0, 2, 1, 3)
        want = ref.binary_attn_scores_ref(q, k, dh)
        p0 = plan(b, h, g, s, t, dw)
        out = torch.empty_like(want)
        fill_ms = chip_smoke.device_ms([lambda: out.fill_(7)], 10)
        del out
        bound_ms = chip_smoke.bound(4 * (q.numel() + k.numel() + want.numel()), 0)[0]
        ms = {}
        try:
            for per in (1, 2, 4, 8):
                K5.plan = lambda *a, per=per: {**plan(*a), "tiles_per_block": per, "stages": min(3, per)}
                got = K5.binary_attn_scores_planes(q, k, dh=dh)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{tag}: {per} key tiles a block != plain")
                del got
                ms[per] = chip_smoke.device_ms([lambda: K5.binary_attn_scores_planes(q, k, dh=dh)], 10)
        finally:
            K5.plan = plan
        print("[walk] " + json.dumps(dict(
            case=tag, card=smi, tile=[p0["rows"], p0["keys"]], planned=p0["tiles_per_block"],
            ms_by_tiles_a_block=ms, fill_ms=fill_ms, bound_ms=bound_ms)), flush=True)
        del q, k, want
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["smoke", "walk"])
    ap.add_argument("--src", default=ROOT, help="tree whose src/repro_torch runs (smoke)")
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args()
    smoke(args.src, args.tag) if args.mode == "smoke" else walk()


if __name__ == "__main__":
    main()
