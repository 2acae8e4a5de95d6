"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version on the card, and the serving path on the card against the same
path on the CPU.  Marked ``cuda``; without a CUDA device (and ``nvcc``)
they skip from inside the fixture.  This file imports no JAX, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

K1, K3 and K4 are integer (exact); K2 rounds every epilogue product and
sum on its own in the plain version's order, so it is bitwise equal too.  The model check
allows CROSS_DEVICE_TOL on logits: float functions (exp, rsqrt, the float32
unembed) differ in their last bits between devices, which can flip a bf16
rounding and one 8-bit bucket of the next per-token quantization.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.smoke import smoke_variant
from repro_torch.core import packing
from repro_torch.core import qmm as QE
from repro_torch.core import quantization as Q
from repro_torch.core import tree
from repro_torch.kernels import binary_qmm as K1
from repro_torch.kernels import bitserial_qmm as K4
from repro_torch.kernels import fused_qmm as K2
from repro_torch.kernels import popcount_qmm as K3
from repro_torch.kernels import ref
from repro_torch.models import model_zoo as Z

CROSS_DEVICE_TOL = 0.03
SHAPES = [(1, 32, 1), (4, 64, 48), (37, 300, 45), (130, 513, 129), (4, 4096, 14336), (128, 4096, 4096)]

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# K1's tiles (16 x 64 up to M = 16; above, 128 x 128 at long K and wide N,
# else 32 x 128) and K splits, ragged M / N, and its activation copies:
# 16-byte (K % 16 == 0), 4-byte (K = 100, 300, 1000) and byte loads
# (K = 513); bit-bert-base's prefill up and decode down sites
BINARY_SHAPES = SHAPES + [
    (m, k, n) for m in (16, 17, 35, 64, 65, 130) for k in (100, 1000, 4096, 14336)
    for n in (33, 72, 1024, 4500)
] + [(128, 768, 3072), (1, 3072, 768), (4, 4096, 1024)]
# (K, N) of every QMM site of the dense GQA families beside granite-8b:
# attn.q, attn.k / v, attn.o, ffn.up / gate, ffn.down
FAMILY_SITES = {
    "gemma3-27b": [(5376, 4096), (5376, 2048), (4096, 5376), (5376, 21504), (21504, 5376)],
    "qwen3-32b": [(5120, 8192), (5120, 1024), (8192, 5120), (5120, 25600), (25600, 5120)],
    "mistral-nemo-12b": [(5120, 4096), (5120, 1024), (4096, 5120), (5120, 14336), (14336, 5120)],
}


# (K, N) of every QMM site of deepseek-v2-lite-16b: attn.q (2048 -> 16 x
# 192), attn.kv_down, attn.k_rope, attn.o, attn.k_up / v_up (512 -> 16 x
# 128), the dense layer's ffn.up / gate and down, the shared experts' up /
# gate and down, and a routed expert's up / gate and down
DEEPSEEK_SITES = [(2048, 3072), (2048, 512), (2048, 64), (2048, 2048), (512, 2048),
                  (2048, 10944), (10944, 2048), (2048, 2816), (2816, 2048),
                  (2048, 1408), (1408, 2048)]


# (K, N) of every QMM site of the recurrent families: recurrentgemma-2b's
# RG-LRU in_x / in_gate / gate_a / gate_i / out and attn.q / o (2560x2560),
# attn.k / v (2560x256), ffn.up / gate (2560x7680) and down (7680x2560);
# mamba2-130m's in_proj (768 -> 2 x 1536 + 2 x 128 + 24 = 3352, not a
# multiple of K1's N tile) and out_proj (1536x768)
RECURRENT_SITES = {
    "recurrentgemma-2b": [(2560, 2560), (2560, 256), (2560, 7680), (7680, 2560)],
    "mamba2-130m": [(768, 3352), (1536, 768)],
}


# (M, K, N) of the encoder families' K1 sites: internvl2-2b's attn.q / o,
# attn.k / v, ffn.up / gate and down at a 4-slot decode, and up / gate in
# its 320-token image prefill; whisper-tiny's cross-attention k / v over 4 x
# 1,500 encoder rows (every decode step) and its decode ffn.up and down
ENCODER_SITES = [(4, 2048, 2048), (4, 2048, 1024), (4, 2048, 8192), (4, 8192, 2048),
                 (320, 2048, 8192), (6000, 384, 384), (4, 384, 1536), (4, 1536, 384)]


@pytest.mark.parametrize("m,k,n", BINARY_SHAPES)
def test_binary_qmm_equals_plain(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m * 7 + n)
    a = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    wp = packing.pack_bits(torch.randint(0, 2, (k, n), generator=g, device=dev), 1, axis=0)
    before = K1.binary_qmm.launches
    got = K1.binary_qmm(a, wp, k)
    assert K1.binary_qmm.launches == before + 1
    assert torch.equal(got, ref.binary_qmm_ref(a, wp, k))


@pytest.mark.parametrize("m", [4, 128])  # a 4-slot decode tick, a 128-token prefill
@pytest.mark.parametrize("name,k,n", [(name, k, n) for name, sites in FAMILY_SITES.items()
                                      for k, n in sites])
def test_binary_qmm_equals_plain_at_family_sites(dev, name, k, n, m):
    test_binary_qmm_equals_plain(dev, m, k, n)


@pytest.mark.parametrize("m", [4, 128])  # a 4-slot decode tick, a 128-token prefill
@pytest.mark.parametrize("name,k,n", [(name, k, n) for name, sites in RECURRENT_SITES.items()
                                      for k, n in sites])
def test_binary_qmm_equals_plain_at_recurrent_sites(dev, name, k, n, m):
    test_binary_qmm_equals_plain(dev, m, k, n)


@pytest.mark.parametrize("m,k,n", ENCODER_SITES)
def test_binary_qmm_equals_plain_at_encoder_sites(dev, m, k, n):
    test_binary_qmm_equals_plain(dev, m, k, n)


@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("k,n", DEEPSEEK_SITES)
def test_binary_qmm_equals_plain_at_deepseek_sites(dev, k, n, m):
    test_binary_qmm_equals_plain(dev, m, k, n)


@pytest.mark.parametrize("c", [1, 15, 176])  # capacity at a 4-slot tick, 128- and 1,500-token prompts
@pytest.mark.parametrize("k,n", [(2048, 1408), (1408, 2048)])
def test_expert_loop_equals_plain(dev, c, k, n):
    """deepseek-v2-lite's 64 routed experts: one K1 launch per expert into
    its slice of one (E, C, N) buffer, equal to the plain product expert
    by expert; then ``expert_qlinear`` on K1 bitwise equal to the plain
    integer backend (the epilogue runs once, batched over the experts)."""
    from repro_torch.models import moe as M

    e = 64
    g = torch.Generator(device=dev).manual_seed(c * 3 + k)
    a = torch.randint(-128, 128, (e, c, k), generator=g, device=dev, dtype=torch.int8)
    wp = packing.pack_bits(torch.randint(0, 2, (e, k, n), generator=g, device=dev), 1, axis=1)
    x = Q.QuantTensor(mantissa=a, scale=torch.ones(()), offset=torch.zeros(()), bits=8)
    w = Q.QuantTensor(mantissa=wp, scale=torch.ones(()), offset=torch.zeros(()), bits=1,
                      packed=True, packed_axis=1, length=k)
    before = K1.binary_qmm.launches
    got = M._experts_k1(x, w)
    assert K1.binary_qmm.launches == before + e
    for i in range(e):
        assert torch.equal(got[i], ref.binary_qmm_ref(a[i], wp[i], k)), f"expert {i}"
    p = M.pack_experts_for_serving({"w": torch.randn((e, k, n), generator=g, device=dev)},
                                   get_config("deepseek-v2-lite-16b").quant)
    h = torch.randn((e, c, k), generator=g, device=dev).to(torch.bfloat16)
    quant = get_config("deepseek-v2-lite-16b").quant
    on_k1 = M.expert_qlinear(p, h, dataclasses.replace(quant, backend="pallas"), k)
    plain = M.expert_qlinear(p, h, dataclasses.replace(quant, backend="mxu"), k)
    assert torch.equal(on_k1, plain)


# K2's tile paths (16 rows up to M = 64, with 32 or 64 columns; 32 or 64
# rows above) and their edges: M = 16 / 17 / 130, K past a whole word (K =
# 100, 1000), Kw not a multiple of 4 (K = 300, 513: the 4-byte copy path),
# N not a multiple of 8 or 16 (33, 45, 72, 129, 4500); and granite-8b's
# decode down and ragged k/v prefill sites
FUSED_SHAPES = SHAPES + [
    (16, 1000, 72), (17, 100, 33), (130, 1000, 4500), (35, 4096, 1024), (4, 14336, 4096)
]


@pytest.mark.parametrize("m,k,n", FUSED_SHAPES)
@pytest.mark.parametrize("a_bits,b_bits", [(8, 1), (4, 1), (8, 8), (1, 1), (2, 1), (3, 5)])
def test_fused_qmm_bitwise_equals_plain(dev, m, k, n, a_bits, b_bits):
    g = torch.Generator(device=dev).manual_seed(m * 5 + n + a_bits)
    x = torch.randint(0, 2**a_bits, (m, k), generator=g, device=dev)
    w = torch.randint(0, 2**b_bits, (k, n), generator=g, device=dev)
    ap = packing.pack_bitplanes(x, a_bits, axis=-1)
    bp = packing.pack_bitplanes(w, b_bits, axis=-2)
    coeffs = [torch.randn(s, generator=g, device=dev) for s in ((m, 1), (m, 1), (1, n), (1, n))]
    before = K2.fused_qmm.launches
    got = K2.fused_qmm(ap, bp, *coeffs, k)
    assert K2.fused_qmm.launches == before + 1
    assert torch.equal(got, ref.fused_qmm_ref(ap, bp, *coeffs, k))


# bit-bert-base's sites (K = 768 / 3072) at prefill and decode, plus ragged
POPCOUNT_SHAPES = [(1, 32, 1), (7, 100, 33), (130, 513, 129), (4, 768, 3072), (128, 3072, 768)]
# K3's plan classes -- 32 x 64 tiles (the grid fills the SMs), 16 x 32
# tiles, 16 x 32 with K split over 2 and over 5 blocks (a ragged last
# split) -- and K words not a multiple of the 8-word K step: 32 words with
# a ragged last word (K = 1000), 10 (4-byte copies) and 63
POPCOUNT_PLAN_SHAPES = [(128, 768, 3072), (128, 768, 768), (4, 4096, 1024), (1, 14336, 768),
                        (16, 1000, 72), (33, 300, 40), (5, 2000, 100)]


@pytest.mark.parametrize("m,k,n", POPCOUNT_SHAPES + POPCOUNT_PLAN_SHAPES)
def test_popcount_qmm_equals_plain(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m * 3 + n)
    ap = packing.pack_bits(torch.randint(0, 2, (m, k), generator=g, device=dev), 1, axis=-1)
    bp = packing.pack_bits(torch.randint(0, 2, (k, n), generator=g, device=dev), 1, axis=0)
    before = K3.popcount_qmm.launches
    got = K3.popcount_qmm(ap, bp)
    assert K3.popcount_qmm.launches == before + 1
    assert torch.equal(got, ref.popcount_qmm_ref(ap, bp, k))


def test_popcount_qmm_plan_classes(dev):
    """The shapes above reach every tile and split class of the plan."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if sms != 132:  # the plan's classes follow the SM count
        pytest.skip(f"POPCOUNT_PLAN_SHAPES were chosen for the H100 SXM's 132 SMs, not {sms}")
    plans = [K3.plan(m, k, n, dev) for m, k, n in POPCOUNT_PLAN_SHAPES]
    assert (32, 64, 1) in plans and (16, 32, 1) in plans and (16, 32, 2) in plans
    assert max(splits for _, _, splits in plans) > 2


# K4's tiles (short K, 16 rows up to M = 64, 32 or 64 rows above), its 4-byte
# copy path (Kw % 4 != 0) and every pairing of one plane and 2 .. 8 planes
@pytest.mark.parametrize(
    "m,k,n",
    [(1, 32, 1), (7, 100, 33), (128, 64, 128), (128, 768, 3072), (35, 4096, 1024),
     (130, 513, 129), (16, 1000, 72)],
)
@pytest.mark.parametrize(
    "a_bits,b_bits", [(2, 2), (4, 4), (8, 8), (1, 4), (3, 5), (1, 8), (8, 1), (1, 1)]
)
def test_bitserial_qmm_equals_plain(dev, m, k, n, a_bits, b_bits):
    g = torch.Generator(device=dev).manual_seed(m * 11 + n + a_bits)
    ap = packing.pack_bitplanes(torch.randint(0, 2**a_bits, (m, k), generator=g, device=dev), a_bits, axis=-1)
    bp = packing.pack_bitplanes(torch.randint(0, 2**b_bits, (k, n), generator=g, device=dev), b_bits, axis=-2)
    before = K4.bitserial_qmm.launches
    got = K4.bitserial_qmm(ap, bp)
    assert K4.bitserial_qmm.launches == before + 1
    assert torch.equal(got, ref.bitserial_qmm_ref(ap, bp, k))


@pytest.mark.parametrize("bits", [4, 8])
def test_act_act_pallas_equals_popcount_backend(dev, bits):
    """``qmm(backend="pallas")`` on two multi-bit activations goes through K4
    and equals the plain ``popcount`` backend bitwise (same unsigned
    mantissas, same epilogue)."""
    g = torch.Generator(device=dev).manual_seed(bits)
    x = Q.quantize_activation(torch.randn(128, 64, generator=g, device=dev), bits, per_channel_axis=0)
    y = Q.quantize_activation(torch.randn(64, 128, generator=g, device=dev), bits, per_channel_axis=-1)
    before = K4.bitserial_qmm.launches
    got = QE.qmm(x, y, backend="pallas")
    assert K4.bitserial_qmm.launches == before + 1
    assert torch.equal(got, QE.qmm(x, y, backend="popcount"))


def test_wrappers_refuse_mixed_devices(dev):
    a = torch.zeros(2, 64, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="operands on"):
        K1.binary_qmm(a, torch.zeros(2, 4, dtype=torch.int32), 64)
    with pytest.raises(ValueError, match="operands on"):
        K3.popcount_qmm(a.view(torch.int32), torch.zeros(16, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="operands on"):
        K4.bitserial_qmm(a.view(torch.int32)[None], torch.zeros(1, 16, 4, dtype=torch.int32))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_smoke_model_card_matches_cpu(dev, backend):
    base = smoke_variant(get_config("granite-8b"))
    cfg = dataclasses.replace(base, quant=dataclasses.replace(base.quant, backend=backend))
    params = Z.init_serving_params(3, cfg, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, 256, size=(1, 20)))
    runs = []
    for device, p in (("cpu", params), (dev, _to(params, dev))):
        cache = Z.init_cache(1, 48, cfg, device=device)
        logits, cache = Z.prefill(p, prompt.to(device), cfg, cache)
        out, toks = [logits.cpu()], []
        for _ in range(8):
            toks.append(int(out[-1].argmax()))
            logits, cache = Z.decode_step(p, torch.tensor([toks[-1]], device=device), cfg, cache)
            out.append(logits.cpu())
        runs.append((out, toks))
    (want, want_toks), (got, got_toks) = runs
    assert got_toks == want_toks
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= CROSS_DEVICE_TOL


@pytest.mark.parametrize("path", ["stateless", "cross"])
def test_encoder_attention_card_matches_cpu(dev, path):
    """whisper's attention paths over 1,500 encoder rows, on the card
    against the CPU port on the same inputs: the encoder's stateless
    self-attention (the integer path, non-causal, float32 in and out) and
    the decoder's cross-attention (float32 scores, bf16 P.V).  Within
    CROSS_DEVICE_TOL of the largest |output|: float32 exp and products
    differ in their last bits between devices, which can move one 8-bit
    bucket of a per-token quantization downstream."""
    from repro_torch.models import attention as A

    cfg = smoke_variant(get_config("whisper-tiny"))
    cfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend="pallas"))
    params = Z.init_serving_params(4, cfg, device="cpu")
    rng = np.random.default_rng(4)
    frames = 1500
    if path == "stateless":
        p, acfg = params["encoder"]["layers"][0]["attn"], Z._encoder_cfg(cfg)
        x = torch.from_numpy(rng.standard_normal((2, frames, cfg.d_model)).astype(np.float32))
        pos = torch.arange(frames).broadcast_to(2, frames)
        kv = None
    else:
        p, acfg = params["layers"][0]["cross_attn"], cfg
        x = torch.from_numpy(rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)).bfloat16()
        pos = torch.zeros((2, 3), dtype=torch.int64)
        kv = [torch.from_numpy(rng.standard_normal((2, frames, cfg.n_kv_heads, cfg.d_head)).astype(np.float32))
              .bfloat16() for _ in range(2)]
    outs = []
    for device in ("cpu", dev):
        override = None if kv is None else tuple(t.to(device) for t in kv)
        out, cache = A.attention(_to(p, device), x.to(device), acfg, "g", pos.to(device), None,
                                 kv_override=override, causal=False if kv is not None else None)
        assert cache is None and out.dtype == x.dtype and out.shape == x.shape
        outs.append(out.float().cpu())
    want, got = outs
    assert bool(torch.isfinite(got).all()) and float(want.abs().max()) > 0
    assert float((got - want).abs().max()) <= CROSS_DEVICE_TOL * float(want.abs().max())


# ---- the compiled serving steps: replayed CUDA graphs against the eager step

def deepseek_k1_per_forward(cfg, prefill: bool = False) -> int:
    """K1 launches of one MLA + MoE forward: each layer's q (or q_down and
    q_up), kv_down, k_rope and o, plus k_up and v_up in a prefill; a dense
    layer's FFN up / gate / down, or an MoE layer's shared experts' 3 and
    3 per routed expert."""
    attn = (5 if cfg.mla.q_lora_rank else 4) + (2 if prefill else 0)
    ffn = 3
    moe = (3 if cfg.moe.n_shared else 0) + 3 * cfg.moe.n_routed
    return sum(attn + (moe if kind == "Mm" else ffn) for kind in cfg.layer_kinds)


def recurrent_k1_per_forward(cfg) -> int:
    """K1 launches of one forward of a recurrent family: an RG-LRU layer's
    5 sites and its FFN's 3, an attention layer's 4 and its FFN's 3, an SSD
    layer's in_proj and out_proj."""
    return sum({"r": 8, "l": 7, "s": 2}[kind] for kind in cfg.layer_kinds)


STEP_MODELS = {  # name -> (config name, backend, kernel its forwards launch, sites a layer)
    # window 8 in the smoke: a ring beside global layers; _filled_cache's
    # 9-token row has wrapped, its 6-token row wraps on the third tick
    "gemma3-pallas": ("gemma3-27b", "pallas", "binary_qmm", 7),
    "granite-pallas": ("granite-8b", "pallas", "binary_qmm", 7),
    "granite-fused": ("granite-8b", "fused", "fused_qmm", 7),
    "bitbert-a1": ("bit-bert-base", "pallas", "popcount_qmm", 6),
    "bitbert-a8": ("bit-bert-base-a8", "pallas", "binary_qmm", 6),
    # MLA + MoE (capacity 1 at 2 slots, top-2 of 8: routes drop); the
    # sites vary by layer kind (deepseek_k1_per_forward)
    "deepseek-v2-pallas": ("deepseek-v2-lite-16b", "pallas", "binary_qmm", deepseek_k1_per_forward),
    "deepseek-v3-pallas": ("deepseek-v3-671b", "pallas", "binary_qmm", deepseek_k1_per_forward),
    # recurrent states written in place beside a window-8 ring (recurrentgemma)
    # and the SSD state alone (mamba2, one layer in the smoke)
    "recurrentgemma-pallas": ("recurrentgemma-2b", "pallas", "binary_qmm", recurrent_k1_per_forward),
    "mamba2-pallas": ("mamba2-130m", "pallas", "binary_qmm", recurrent_k1_per_forward),
    # cross-attention onto the cache's encoder_out (whisper: self + cross
    # attention and a gelu FFN, 10 sites a layer), and a patch stub's
    # plain decoder (internvl2)
    "whisper-pallas": ("whisper-tiny", "pallas", "binary_qmm", 10),
    "internvl2-pallas": ("internvl2-2b", "pallas", "binary_qmm", 7),
}
STEP_MAX_LEN = 48
WRAPPERS = {k.__name__: k for k in (K1.binary_qmm, K2.fused_qmm, K3.popcount_qmm, K4.bitserial_qmm)}


def _step_model(name, dev):
    """(cfg, params, {kernel: launches one forward makes})."""
    cfg_name, backend, kernel, sites = STEP_MODELS[name]
    cfg = smoke_variant(get_config(cfg_name))
    if cfg_name.startswith("bit-bert"):
        cfg = dataclasses.replace(cfg, n_layers=2)
    cfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend=backend))
    params = Z.init_serving_params(5, cfg, device=dev)
    per_forward = {k: 0 for k in WRAPPERS}
    per_forward[kernel] = sites(cfg) if callable(sites) else sites * cfg.n_layers
    return cfg, params, per_forward


def _launches():
    return {name: k.launches for name, k in WRAPPERS.items()}


def _filled_cache(cfg, params, dev, lens=(6, 9)):
    cache = Z.init_cache(len(lens), STEP_MAX_LEN, cfg, device=dev)
    firsts = []
    for i, n in enumerate(lens):
        prompt = torch.from_numpy(np.random.default_rng(n).integers(0, 256, size=(1, n))).to(dev)
        slot = Z.init_slot_cache(STEP_MAX_LEN, cfg, device=dev)
        logits, slot = Z.prefill(params, prompt, cfg, slot)
        Z.cache_insert(cache, slot, i)
        firsts.append(int(logits.argmax()))
    return cache, torch.tensor(firsts)


@pytest.mark.parametrize("name", sorted(STEP_MODELS))
def test_replayed_decode_step_bitwise_equals_eager(dev, name):
    """One capture, then 5 replays: logits and every cache leaf equal the
    eager step's bit for bit at every tick.  The capturing call goes
    through the path's kernel wrapper twice per site and layer (warm-up
    run, capture); a replay makes no wrapper call."""
    from repro_torch.runtime.serve_loop import make_decode_step

    cfg, params, per_forward = _step_model(name, dev)
    eager, toks = _filled_cache(cfg, params, dev)
    graphed = Z.cache_copy(eager)
    step = make_decode_step(cfg, 2, STEP_MAX_LEN, device=dev)
    held, calls = [], []
    for tick in range(6):
        want, _ = Z.decode_step(params, toks.to(dev), cfg, eager)
        before = _launches()
        got, out_cache = step(params, toks, graphed)
        calls.append({k: v - before[k] for k, v in _launches().items()})
        held.append(got)
        assert out_cache is graphed
        assert torch.equal(got, want), f"tick {tick}: logits differ"
        assert Z.caches_equal(graphed, eager), f"tick {tick}: caches differ"
        toks = want.argmax(-1).cpu()
    assert (step.captures, step.replays) == (1, 5)
    assert calls[0] == {k: 2 * v for k, v in per_forward.items()}
    assert calls[1:] == [{k: 0 for k in per_forward}] * 5
    # each call's logits are its own: later replays did not overwrite them
    assert not any(torch.equal(a, b) for a, b in zip(held, held[1:]))


@pytest.mark.parametrize("name", ["granite-pallas", "bitbert-a1", "deepseek-v2-pallas",
                                  "recurrentgemma-pallas", "mamba2-pallas"])
def test_replayed_prefill_bitwise_equals_eager(dev, name):
    from repro_torch.runtime.serve_loop import make_prefill

    cfg, params, _ = _step_model(name, dev)
    fn = make_prefill(cfg, 1, 12, STEP_MAX_LEN, device=dev)
    cache = Z.init_cache(1, STEP_MAX_LEN, cfg, device=dev)
    for seed in range(3):  # capture, then two replays on other prompts
        prompt = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, size=(1, 12)))
        Z.cache_reset(cache, 0, cfg, STEP_MAX_LEN)
        got, _ = fn(params, prompt, cache)
        want, want_cache = Z.prefill(params, prompt.to(dev), cfg,
                                     Z.init_cache(1, STEP_MAX_LEN, cfg, device=dev))
        assert torch.equal(got, want), f"prompt {seed}: logits differ"
        assert Z.caches_equal(cache, want_cache), f"prompt {seed}: caches differ"
    assert (fn.captures, fn.replays) == (1, 2)


@pytest.mark.parametrize("name", ["whisper-pallas", "internvl2-pallas"])
def test_replayed_prefill_with_frontend_bitwise_equals_eager(dev, name):
    """``make_prefill`` with a frontend: one capture, then two replays on
    new prompts and new stub embeddings, each bitwise equal to the eager
    prefill on the same inputs (whisper's cache keeps the encoder output)."""
    from repro_torch.runtime.serve_loop import make_prefill

    cfg, params, _ = _step_model(name, dev)
    fn = make_prefill(cfg, 2, 14, STEP_MAX_LEN, device=dev)
    cache = Z.init_cache(2, STEP_MAX_LEN, cfg, device=dev)
    for seed in range(3):
        prompt = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, size=(2, 14)))
        frontend = torch.from_numpy(np.random.default_rng(seed).standard_normal(fn.frontend_shape)
                                    .astype(np.float32)).to(dev)
        for row in range(2):
            Z.cache_reset(cache, row, cfg, STEP_MAX_LEN)
        got, _ = fn(params, prompt, cache, frontend)
        want, want_cache = Z.prefill(params, prompt.to(dev), cfg,
                                     Z.init_cache(2, STEP_MAX_LEN, cfg, device=dev), frontend)
        assert torch.equal(got, want), f"prompt {seed}: logits differ"
        assert Z.caches_equal(cache, want_cache), f"prompt {seed}: caches differ"
    assert (fn.captures, fn.replays) == (1, 2)


def test_decode_step_captures_anew_for_another_cache(dev):
    from repro_torch.runtime.serve_loop import make_decode_step

    cfg, params, _ = _step_model("granite-pallas", dev)
    first, toks = _filled_cache(cfg, params, dev)
    second, eager = Z.cache_copy(first), Z.cache_copy(first)
    step = make_decode_step(cfg, 2, STEP_MAX_LEN, device=dev)
    for cache in (first, first, second, second):
        got, _ = step(params, toks, cache)
        if cache is second:
            want, _ = Z.decode_step(params, toks.to(dev), cfg, eager)
            assert torch.equal(got, want)
            assert Z.caches_equal(second, eager)
    assert (step.captures, step.replays) == (2, 2)


def test_engine_on_card_equals_serve_sequential(dev, name="granite-pallas"):
    """Greedy requests, two runs of one engine: one capture, replayed
    ticks, tokens equal to the eager one-at-a-time oracle."""
    from repro_torch.runtime.serve_loop import Request, ServeEngine, serve_sequential

    cfg, params, _ = _step_model(name, dev)

    def requests():
        rng = np.random.default_rng(2)
        return [Request(prompt=rng.integers(0, 256, size=(int(rng.integers(3, 11)),)),
                        max_new_tokens=int(rng.integers(3, 7))) for _ in range(5)]

    want = [r.output for r in serve_sequential(cfg, params, requests(), max_len=STEP_MAX_LEN,
                                               seed=0, device=dev)]
    engine = ServeEngine(cfg, params, batch_slots=2, max_len=STEP_MAX_LEN, seed=0, device=dev)
    for _ in range(2):
        assert [r.output for r in engine.run(requests())] == want
        kinds = [e["kind"] for e in engine.last_events]
        assert "decode_tick" in kinds
    assert engine.decode_fn.captures == 1 and engine.decode_fn.replays > 0


@pytest.mark.parametrize("name", ["recurrentgemma-pallas", "mamba2-pallas"])
def test_recurrent_engine_on_card_equals_serve_sequential(dev, name):
    """As for granite: a row's recurrent state does not depend on its batch."""
    test_engine_on_card_equals_serve_sequential(dev, name)


# ---- bitwise attention: the scores kernel and the binary-attention path

# ((B, H, S), (B, G, T), dh): bit-bert-base's prefill and 4-slot decode, a
# GQA decode, MLA's latent decode, ragged dh / T / S, folded rows and keys
# at the ends of a tile, bit-bert-base's 512-token and granite-8b's
# 1,024-token prefills, a 512-token GQA prefill, long decodes whose blocks
# walk 4 key tiles through a 3-stage ring (MLA's latent over 32,768 rows;
# 8,292 keys, the last group one tile); T one under and one over a key tile
# of 32 / 128, 15 / 16 / 17 folded rows, dw 9 (dh 288: one k-step and one
# word)
BINARY_ATTN_SHAPES = [
    ((1, 12, 128), (1, 12, 128), 64), ((4, 12, 1), (4, 12, 512), 64),
    ((4, 32, 1), (4, 8, 512), 128), ((4, 16, 1), (4, 1, 2048), 512),
    ((2, 6, 5), (2, 3, 333), 100), ((3, 4, 3), (3, 1, 129), 33),
    ((1, 2, 70), (1, 1, 1), 2048), ((2, 1, 1), (2, 1, 127), 32),
    ((1, 12, 512), (1, 12, 512), 64), ((1, 32, 1024), (1, 8, 1024), 128),
    ((1, 32, 512), (1, 8, 512), 128), ((4, 16, 1), (4, 1, 32768), 512), ((4, 12, 1), (4, 12, 8292), 64),
    ((1, 4, 2), (1, 1, 31), 64), ((1, 4, 2), (1, 1, 33), 64),
    ((2, 8, 8), (2, 1, 127), 64), ((2, 8, 8), (2, 1, 129), 64),
    ((3, 5, 3), (3, 1, 200), 128), ((2, 4, 4), (2, 1, 200), 128), ((1, 17, 1), (1, 1, 200), 128),
    ((2, 4, 3), (2, 2, 65), 288),
]


def _attn_planes(dev, q_shape, k_shape, dh, dirty=False):
    """Q a transposed view of ``(B, S, H, dw)`` words, K the packed cache
    ``(B, T, G, dw)`` permuted -- the model's layouts, neither contiguous;
    with ``dirty`` K's last word carries set bits past dh."""
    g = torch.Generator(device=dev).manual_seed(sum(q_shape) + sum(k_shape) + dh)
    (b, h, s), (_, kvh, t) = q_shape, k_shape
    q = packing.pack_bits(torch.randint(0, 2, (b, s, h, dh), generator=g, device=dev), 1).transpose(1, 2)
    k = packing.pack_bits(torch.randint(0, 2, (b, t, kvh, dh), generator=g, device=dev), 1)
    if dirty:
        junk = torch.randint(-2**31, 2**31, k.shape[:-1], generator=g, device=dev, dtype=torch.int32)
        k[..., -1] |= junk & -(1 << (dh % 32))
        assert bool((k[..., -1] & -(1 << (dh % 32))).any())
    return q, k.permute(0, 2, 1, 3)


@pytest.mark.parametrize("q_shape,k_shape,dh", BINARY_ATTN_SHAPES)
def test_binary_attn_equals_plain(dev, q_shape, k_shape, dh):
    """The kernel on the model's layouts equals its plain version bit for
    bit, on the card and on the CPU."""
    from repro_torch.kernels import binary_attn as K5

    q, k = _attn_planes(dev, q_shape, k_shape, dh)
    before = K5.binary_attn_scores_planes.launches
    got = K5.binary_attn_scores_planes(q, k, dh=dh)
    assert K5.binary_attn_scores_planes.launches == before + 1
    assert torch.equal(got, ref.binary_attn_scores_ref(q, k, dh))
    assert torch.equal(got.cpu(), ref.binary_attn_scores_ref(q.cpu(), k.cpu(), dh))


@pytest.mark.parametrize("q_shape,k_shape,dh", [((2, 8, 9), (2, 2, 300), 100), ((1, 4, 3), (1, 4, 70), 33),
                                                ((1, 32, 64), (1, 8, 700), 200)])
def test_binary_attn_masks_a_dirty_k_tail(dev, q_shape, k_shape, dh):
    """Set bits past dh in K's last word: Q's zero tail masks them."""
    from repro_torch.kernels import binary_attn as K5

    q, k = _attn_planes(dev, q_shape, k_shape, dh, dirty=True)
    got = K5.binary_attn_scores_planes(q, k, dh=dh)
    assert torch.equal(got, ref.binary_attn_scores_ref(q, k, dh))
    clean = k & torch.where(torch.arange(k.shape[-1], device=dev) == k.shape[-1] - 1,
                            (1 << (dh % 32)) - 1, -1).to(torch.int32)
    assert torch.equal(got, ref.binary_attn_scores_ref(q, clean, dh))


@pytest.mark.parametrize("per", [1, 2, 5])
@pytest.mark.parametrize("stages", [1, 2, 3])
@pytest.mark.parametrize("rows,keys", [(r, k) for r in (64, 32, 16, 8) for k in (128, 64, 32)])
def test_binary_attn_every_tile_and_ring_equals_plain(dev, monkeypatch, rows, keys, stages, per):
    """Every tile the kernel is built for, each block walking 1, 2 or 5 key
    tiles (the last block fewer) through a ring of 1-3 K tiles, at ragged
    rows, keys and words."""
    from repro_torch.kernels import binary_attn as K5

    q, k = _attn_planes(dev, (2, 6, 23), (2, 3, 301), 100)
    monkeypatch.setattr(K5, "plan", lambda *a: dict(rows=rows, keys=keys, tiles_per_block=per, stages=stages))
    if stages == 1 and per > 1:
        with pytest.raises(RuntimeError, match="cudaError"):  # a ring needs 2 stages
            K5.binary_attn_scores_planes(q, k, dh=100)
        return
    assert torch.equal(K5.binary_attn_scores_planes(q, k, dh=100), ref.binary_attn_scores_ref(q, k, 100))


def _binary_attn_cfg(name, site="attn.qk", backend="pallas"):
    cfg = smoke_variant(get_config(name))
    if name.startswith("bit-bert"):
        cfg = dataclasses.replace(cfg, n_layers=2)
    return dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, backend=backend, backend_overrides=((site, "binary"),)))


@pytest.mark.parametrize("name,site", [("bit-bert-base", "attn.qk"), ("granite-8b", "attn.qk"),
                                       ("deepseek-v2-lite-16b", "attn.qk_latent")])
def test_binary_attention_model_card_matches_cpu(dev, name, site, monkeypatch):
    """The smoke models with bitwise scores (autotuning off: the core is
    the kernel) on the card: the scores kernel runs once a layer a forward
    (MLA: each decode step's absorbed scores), the logits are bitwise equal
    with it swapped for its plain version on the same tokens, and the
    greedy tokens are the CPU's.  The GQA models' logits are also held to
    the CPU's within CROSS_DEVICE_TOL.  MLA's are not: its absorbed query
    is a float32 einsum summed in another order on each device, and at one
    bit a last-bit change at the grid's midpoint flips a query bit, which
    moves a score by a whole count step (0.05 in the logits, measured)."""
    from repro_torch.core import backend_registry
    from repro_torch.kernels import binary_attn as K5

    monkeypatch.setenv("REPRO_QMM_AUTOTUNE", "0")
    cfg = _binary_attn_cfg(name, site)
    params = Z.init_serving_params(3, cfg, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, 256, size=(1, 12)))

    def run(device, p, tokens=None):
        before = K5.binary_attn_scores_planes.launches
        cache = Z.init_cache(1, 48, cfg, device=device)
        logits, cache = Z.prefill(p, prompt.to(device), cfg, cache)
        out, toks = [logits.cpu()], []
        for i in range(6):
            toks.append(int(out[-1].argmax()) if tokens is None else tokens[i])
            logits, cache = Z.decode_step(p, torch.tensor([toks[-1]], device=device), cfg, cache)
            out.append(logits.cpu())
        return out, toks, K5.binary_attn_scores_planes.launches - before

    want, want_toks, _ = run("cpu", params)
    card_params = _to(params, dev)
    got, got_toks, launched = run(dev, card_params)
    assert launched == cfg.n_layers * (6 if site == "attn.qk_latent" else 7)
    spec = backend_registry.get_backend("binary")
    plain = dataclasses.replace(spec, run_scores=lambda q, k, *, dh: ref.binary_attn_scores_ref(q, k, dh))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(backend_registry._REGISTRY, "binary", plain)
        swapped, _, none = run(dev, card_params, got_toks)
    assert none == 0 and all(torch.equal(a, b) for a, b in zip(got, swapped))
    assert got_toks == want_toks
    if site == "attn.qk":
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= CROSS_DEVICE_TOL


def test_binary_attention_replayed_tick_with_autotuning(dev, tmp_path, monkeypatch):
    """``backend="auto"`` everywhere and ``attn.qk -> binary``, autotuning
    on: the capturing call resolves every key in its warm-up run (a
    capture never times), the replayed ticks equal the eager step bit for
    bit, and a second compiled step on a loaded cache times nothing."""
    from repro_torch.core import dispatch
    from repro_torch.runtime.serve_loop import make_decode_step

    monkeypatch.setenv("REPRO_QMM_AUTOTUNE", "1")
    cfg = _binary_attn_cfg("bit-bert-base", backend="auto")
    params = Z.init_serving_params(5, cfg, device=dev)
    cache = dispatch.reset_cache()
    try:
        eager, toks = _filled_cache(cfg, params, dev)
        graphed = Z.cache_copy(eager)
        step = make_decode_step(cfg, 2, STEP_MAX_LEN, device=dev)
        for tick in range(4):
            want, _ = Z.decode_step(params, toks.to(dev), cfg, eager)
            got, _ = step(params, toks, graphed)
            assert torch.equal(got, want) and Z.caches_equal(graphed, eager), f"tick {tick}"
            toks = want.argmax(-1).cpu()
        assert (step.captures, step.replays) == (1, 3)
        assert {k.family for k in cache.entries} == {"qmm", "scores"} and cache.timing_runs > 0
        path = str(tmp_path / "autotune.json")
        cache.save(path)
        loaded = dispatch.reset_cache()
        loaded.load(path)
        again = make_decode_step(cfg, 2, STEP_MAX_LEN, device=dev)
        got, _ = again(params, toks, Z.cache_copy(eager))
        assert loaded.timing_runs == 0 and again.captures == 1
    finally:
        dispatch.reset_cache()


def test_autotune_on_card_takes_kernels_only_and_raises_when_one_fails(dev, monkeypatch):
    """On a card ``"auto"`` chooses among the hand-written kernels only, and
    a kernel that fails to build or launch raises: with ``fused_qmm`` broken
    the timing of a qmm key raises, and with ``binary_attn`` broken the
    ``"binary"`` site's ``"auto"`` core raises in a model's prefill; no
    plain PyTorch core stands in."""
    from repro_torch.core import dispatch
    from repro_torch.kernels import binary_attn as K5
    from repro_torch.kernels import ops

    def broken(*a, **kw):
        raise RuntimeError("kernel broken on purpose")

    monkeypatch.setenv("REPRO_QMM_AUTOTUNE", "1")
    assert dispatch.candidate_backends(16, 768, 768, 1, 1, device=dev) == ("pallas", "fused")
    assert dispatch.candidate_backends(48, 64, 512, 1, 1, family="scores", device=dev) == ("binary",)
    with monkeypatch.context() as mp:
        mp.setattr(K2, "fused_qmm", broken)
        cache = dispatch.AutotuneCache()
        with pytest.raises(RuntimeError, match="'fused' failed on cuda"):
            cache.choose(16, 768, 768, 1, 1, tag="decode", device=dev)
        assert len(cache) == 0
    cfg = _binary_attn_cfg("bit-bert-base", backend="pallas")
    params = Z.init_serving_params(5, cfg, device=dev)
    q = packing.pack_bits(torch.randint(0, 2, (1, 12, 4, 64), device=dev), 1)
    dispatch.reset_cache()
    try:
        with monkeypatch.context() as mp:
            mp.setattr(K5, "_lib", broken)
            with pytest.raises(RuntimeError, match="broken on purpose"):
                ops.binary_attn_scores(q, q, dh=64)
            with pytest.raises(RuntimeError, match="broken on purpose"):
                Z.prefill(params, torch.tensor([[1, 2, 3]], device=dev), cfg, Z.init_cache(1, 16, cfg, device=dev))
    finally:
        dispatch.reset_cache()


def test_autotune_miss_during_capture_raises(dev):
    """A key that misses while a CUDA graph is captured raises, naming the
    key; nothing is timed."""
    from repro_torch.core import dispatch

    cache = dispatch.AutotuneCache()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="autotune miss during a CUDA graph capture"):
        with torch.cuda.graph(graph, stream=side):
            cache.choose(16, 768, 768, 1, 1, tag="decode", device=dev)
    torch.cuda.synchronize(dev)
    assert cache.timing_runs == 0 and len(cache) == 0


# ---- fault-tolerant serving, snapshots and float serving on the card


def _robust_requests(n=4, temperature=0.8):
    from repro_torch.runtime.serve_loop import Request

    rng = np.random.default_rng(1234)
    return [Request(prompt=rng.integers(0, 256, size=(3 + 2 * i,)).astype(np.int32), max_new_tokens=6,
                    temperature=temperature) for i in range(n)]


def test_robust_engine_under_faults_equals_its_unfailed_run(dev, tmp_path):
    """Transient tick faults, a NaN row, a prefill fault and a failed
    snapshot write on the card: every request ends ok with the unfailed
    run's tokens (T = 0.8 included), one capture, and the last snapshot
    resumes in a fresh engine to the same outputs."""
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.runtime.serve_loop import ServeEngine

    cfg, params, _ = _step_model("granite-pallas", dev)
    want = ServeEngine(cfg, params, batch_slots=2, max_len=STEP_MAX_LEN, seed=0, device=dev).run(
        _robust_requests())
    plan = FaultPlan(decode_fail_ticks=(1, 4), nan_ticks={2: 1}, prefill_fail_rids={3: 1},
                     snapshot_fail_at=(0,))
    snap = str(tmp_path / "snap")
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=STEP_MAX_LEN, seed=0, device=dev,
                      fault_plan=plan, snapshot_every=2, snapshot_dir=snap)
    got = eng.run(_robust_requests())
    assert [r.state for r in got] == ["ok"] * 4
    assert [r.output for r in got] == [r.output for r in want]
    kinds = [e["kind"] for e in eng.last_events]
    assert (kinds.count("step_fault"), kinds.count("nan_logits"), kinds.count("prefill_fault"),
            kinds.count("snapshot_failed")) == (2, 1, 1, 1)
    assert eng.decode_fn.captures == 1
    fresh = ServeEngine(cfg, params, batch_slots=2, max_len=STEP_MAX_LEN, seed=0, device=dev,
                        snapshot_dir=snap)
    assert [r.output for r in fresh.resume()] == [r.output for r in want]


@pytest.mark.parametrize("plain", ["mxu", "popcount"])
def test_plain_demote_to_raises_on_card(dev, plain):
    from repro_torch.runtime.serve_loop import ServeEngine

    cfg, params, _ = _step_model("granite-pallas", dev)
    with pytest.raises(ValueError, match="plain PyTorch core"):
        ServeEngine(cfg, params, batch_slots=2, max_len=STEP_MAX_LEN, device=dev, demote_to=plain)
    assert ServeEngine(cfg, params, batch_slots=2, max_len=STEP_MAX_LEN, device=dev).demote_to == "pallas"


def test_cuda_cache_snapshot_round_trips_bit_for_bit(dev, tmp_path):
    """Every leaf of a filled card cache (int8 rows, float32 affines, int32
    cursors; bf16 rows of a float cache) through the checkpoint manager and
    back onto the card, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import FLOAT_QUANT

    for cfg_q in (None, FLOAT_QUANT):
        cfg, params, _ = _step_model("granite-pallas", dev)
        if cfg_q is not None:
            cfg = dataclasses.replace(cfg, quant=cfg_q)
            params = Z.init_serving_params(5, cfg, device=dev)
        cache, _ = _filled_cache(cfg, params, dev)
        mgr = CheckpointManager(str(tmp_path / str(cfg_q is None)), keep=1)
        mgr.save(1, {"cache": cache})
        like = {"cache": Z.init_cache(2, STEP_MAX_LEN, cfg, device=dev)}
        _, out, _ = mgr.restore(like=like)
        assert all(t.device.type == dev.type for layer in out["cache"]["layers"] for t in layer.values())
        assert Z.caches_equal(out["cache"], cache)


def test_float_engine_greedy_tokens_equal_cpu(dev):
    """FLOAT_QUANT granite smoke (bf16 weights and caches): the engine on
    the card gives the CPU engine's greedy tokens, and serve_sequential's."""
    from repro_torch.configs.base import FLOAT_QUANT
    from repro_torch.runtime.serve_loop import ServeEngine, serve_sequential

    cfg = dataclasses.replace(smoke_variant(get_config("granite-8b")), quant=FLOAT_QUANT)
    params = Z.init_serving_params(5, cfg, device="cpu")
    runs = []
    for device, p in (("cpu", params), (dev, _to(params, dev))):
        eng = ServeEngine(cfg, p, batch_slots=2, max_len=STEP_MAX_LEN, seed=0, device=device)
        runs.append([r.output for r in eng.run(_robust_requests(n=5, temperature=0.0))])
    seq = serve_sequential(cfg, _to(params, dev), _robust_requests(n=5, temperature=0.0),
                           max_len=STEP_MAX_LEN, seed=0, device=dev)
    assert runs[1] == runs[0] == [r.output for r in seq]


def test_float_padded_prefill_on_card(dev):
    """prefill(length=) on the card, FLOAT_QUANT granite smoke (one layer,
    the setting of the reference's pad-isolation test): the pads' contents
    never reach the logits or the real cache rows (bitwise), and the logits
    and one decode step stay within the reference's 1e-4 of exact-length
    prefills.  At full depth the gap grows (chip_smoke.py [13f], ROADMAP
    section 3): the float reductions run over the bucket's rows."""
    from repro_torch.configs.base import FLOAT_QUANT

    cfg = dataclasses.replace(smoke_variant(get_config("granite-8b")), quant=FLOAT_QUANT)
    params = Z.init_serving_params(5, cfg, device=dev)
    rng = np.random.default_rng(11)
    lens = [3, 10, 7]
    prompts = [rng.integers(0, 256, size=(n,)) for n in lens]
    lengths = torch.tensor(lens, device=dev)
    runs = []
    for fill in (0, 255):
        toks = np.full((3, 12), fill, np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        runs.append(Z.prefill(params, torch.as_tensor(toks, device=dev), cfg,
                              Z.init_cache(3, STEP_MAX_LEN, cfg, device=dev), length=lengths))
    (logits, cache), (other, other_cache) = runs
    assert torch.equal(logits, other)
    for a, b in zip(cache["layers"], other_cache["layers"]):
        assert all(torch.equal(a[k][i, :n], b[k][i, :n]) for k in ("k", "v") for i, n in enumerate(lens))
    nxt = logits.argmax(-1)
    step, _ = Z.decode_step(params, nxt, cfg, cache)
    for i, p in enumerate(prompts):
        exact, c = Z.prefill(params, torch.as_tensor(p[None], device=dev), cfg,
                             Z.init_cache(1, STEP_MAX_LEN, cfg, device=dev))
        d, _ = Z.decode_step(params, nxt[i:i + 1], cfg, c)
        torch.testing.assert_close(logits[i], exact[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(step[i], d[0], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# QAT training on the card against the CPU
# ---------------------------------------------------------------------------

# The straight-through quantizers are elementwise IEEE operations and exact
# reductions (min, max, the ordered row sums), so the card equals the CPU
# bit for bit.  A train step is not: cuBLAS sums its float32 and bf16
# products in its own order, which moves a bf16 activation or gradient by
# an ulp now and then, and at W1A1 such an ulp can cross a quantizer's
# bucket edge.  chip_smoke.py [14b] logs the gaps on the same step.  TF32
# products would leave far larger gaps: the package turns TF32 off, and the
# step below checks that it is off.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-2  # of each gradient leaf's largest magnitude
# Stated bounds (ROADMAP section 3), (loss, gradient leaf), as chip_smoke.py
# holds them: where a float32 result on the card rounds to bf16 across a
# tie from the CPU's, an 8-bit per-tensor fake quantizer moves that
# element a whole bucket and the layers after it carry the step.
# gemma3-27b's 8 smoke layers: each layer's forward is bitwise the CPU's
# for two of four batches; for chip_smoke.py [14b]'s an element of layer 5
# flips (the loss 2.3e-5 off, a gradient leaf 2.2e-2), for this test's the
# loss is 8.4e-5 off and a leaf 0.126; with qk-norm off [14b]'s batch stays
# bitwise through every layer.
# whisper-tiny with frames: its encoder runs in the frames' float32
# (gradient gaps 1.6e-2 to 8.5e-2).
TRAIN_BOUNDS = {"gemma3-27b": (2e-4, 2e-1), "whisper-tiny": (1e-5, 2e-1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_fake_quant_card_matches_cpu(dev, bits, dtype):
    g = torch.Generator().manual_seed(bits)
    x = torch.randn((4, 128, 768), generator=g).to(dtype)
    ct = torch.randn((4, 128, 768), generator=g).to(dtype)
    out = []
    for device in ("cpu", dev):
        xi = x.to(device).requires_grad_(True)
        y = Q.fake_quant(xi, bits)
        (dx,) = torch.autograd.grad(y, xi, ct.to(device))
        out.append((y.detach().cpu(), dx.cpu()))
    (y0, d0), (y1, d1) = out
    assert torch.equal(y0, y1) and torch.equal(d0, d1)


@pytest.mark.parametrize("shape", [(768, 3072), (3072, 768), (100, 33)])
def test_fake_binarize_weight_card_matches_cpu(dev, shape):
    g = torch.Generator().manual_seed(shape[0])
    w = torch.randn(shape, generator=g)
    ct = torch.randn(shape, generator=g)
    out = []
    for device in ("cpu", dev):
        wi = w.to(device).requires_grad_(True)
        y = Q.fake_binarize_weight(wi)
        (dw,) = torch.autograd.grad(y, wi, ct.to(device))
        out.append((y.detach().cpu(), dw.cpu()))
    (y0, d0), (y1, d1) = out
    assert torch.equal(y0, y1) and torch.equal(d0, d1)


@pytest.mark.parametrize("name", ["bit-bert-base", "granite-8b", "gemma3-27b"])
def test_smoke_train_step_card_matches_cpu(dev, name):
    """One smoke train step from the same params and batch: the loss and
    every gradient leaf on the card against the CPU's (within
    TRAIN_LOSS_RTOL / TRAIN_GRAD_TOL, or the model's TRAIN_BOUNDS), and the
    updated params finite."""
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop as TL

    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    cfg = smoke_variant(get_config(name))
    tcfg = TL.TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=30))
    params = Z.init_params(0, cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, size=(4, 64)))
    runs = [TL.value_and_grad(_to(params, d), {"tokens": tokens.to(d)}, cfg, tcfg) for d in ("cpu", dev)]
    (m0, g0), (m1, g1) = runs
    want = float(m0["loss"])
    loss_tol, grad_tol = TRAIN_BOUNDS.get(name, (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL))
    loss_gap = abs(float(m1["loss"]) - want) / abs(want)
    assert all(a.is_cuda for a in tree.leaves(g1))
    grad_gap = max(float((a.cpu() - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(tree.leaves(g1), tree.leaves(g0)))
    assert loss_gap <= loss_tol and grad_gap <= grad_tol, (loss_gap, grad_gap)
    step = TL.make_train_step(cfg, tcfg, device=dev)
    new, opt, metrics = step(_to(params, dev), adamw.init_state(_to(params, dev)), {"tokens": tokens})
    assert all(bool(torch.isfinite(p).all()) for p in tree.leaves(new))
    assert int(opt.step) == 1 and np.isfinite(float(metrics["grad_norm"]))


# ---- QAT of the MoE / MLA and recurrent families on the card

NEW_TRAIN_FAMILIES = ["deepseek-v2-lite-16b", "deepseek-v3-671b", "recurrentgemma-2b", "mamba2-130m"]


def routes_and_step(params, tokens, cfg, tcfg, device):
    """One smoke step's (metrics, grads) on ``device`` and the routes
    (``experts`` of every ``moe._route`` call, in call order) it took."""
    from unittest import mock

    from repro_torch.models import moe as M
    from repro_torch.runtime import train_loop as TL

    routes, real = [], M._route

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        routes.append(out[1].cpu())
        return out

    with mock.patch.object(M, "_route", spy):
        metrics, grads = TL.value_and_grad(_to(params, device), {"tokens": tokens.to(device)}, cfg, tcfg)
    return routes, metrics, grads


@pytest.mark.parametrize("name", NEW_TRAIN_FAMILIES)
def test_new_family_train_step_card_matches_cpu(dev, name):
    """One smoke train step from the same params and batch on the card
    and on the CPU: an MoE model's routes first (every router call, the
    remat recompute's included), then the loss and every gradient leaf
    within TRAIN_LOSS_RTOL / TRAIN_GRAD_TOL, as the dense families'."""
    from repro_torch.runtime import train_loop as TL

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = smoke_variant(get_config(name))
    tcfg = TL.TrainConfig()
    params = Z.init_params(0, cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, size=(4, 64)))
    (r0, m0, g0), (r1, m1, g1) = (routes_and_step(params, tokens, cfg, tcfg, d) for d in ("cpu", dev))
    assert len(r0) == len(r1) == (2 * cfg.layer_kinds.count("Mm"))  # forward, then the remat recompute
    differing = [int((a != b).sum()) for a, b in zip(r0, r1)]
    assert differing == [0] * len(r0), f"routes differ card vs CPU: {differing}"
    want = float(m0["loss"])
    assert abs(float(m1["loss"]) - want) <= TRAIN_LOSS_RTOL * abs(want)
    assert (float(m0["aux"]) > 0) == (cfg.moe is not None)
    for (path, a), b in zip(tree.leaves_with_paths(g1), tree.leaves(g0)):
        assert a.is_cuda and float((a.cpu() - b).abs().max()) <= TRAIN_GRAD_TOL * float(b.abs().max()), path


def test_trained_moe_served_through_k1_bitwise(dev):
    """deepseek-v2-lite smoke trained 3 steps on the card, packed and
    served (a 12-token prefill and 2 decode steps) on ``pallas``: K1's
    launches equal the forward's sites, the routed experts one launch per
    expert, and logits and every cache leaf are bitwise those of the same
    forward with K1 swapped for its plain version."""
    from unittest import mock

    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop as TL

    cfg = smoke_variant(get_config("deepseek-v2-lite-16b"))
    tcfg = TL.TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3))
    params, opt = TL.init_train_state(0, cfg, device=dev)
    step = TL.make_train_step(cfg, tcfg, device=dev)
    rng = np.random.default_rng(7)
    for _ in range(3):
        params, opt, _ = step(params, opt, {"tokens": rng.integers(0, cfg.vocab_size, size=(4, 32))})
    scfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend="pallas"))
    served = Z.prepare_serving_params(params, scfg)
    assert "mtp" not in served
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, 12))).to(dev)

    def serve():
        cache = Z.init_cache(1, 32, scfg, device=dev)
        logits, cache = Z.prefill(served, prompt, scfg, cache)
        out = [logits]
        for _ in range(2):
            logits, cache = Z.decode_step(served, out[-1].argmax(-1), scfg, cache)
            out.append(logits)
        return out, cache

    before = K1.binary_qmm.launches
    got, cache = serve()
    torch.cuda.synchronize()
    assert K1.binary_qmm.launches - before == (deepseek_k1_per_forward(scfg, prefill=True)
                                               + 2 * deepseek_k1_per_forward(scfg))
    with mock.patch.object(ops._bq, "binary_qmm", ref.binary_qmm_ref):
        plain, plain_cache = serve()
    assert all(torch.equal(a, b) for a, b in zip(got, plain)) and Z.caches_equal(cache, plain_cache)
    assert all(bool(torch.isfinite(x).all()) for x in got)


def test_moe_resume_bitwise_on_card(dev, tmp_path):
    """deepseek-v2-lite smoke on the card: 6 straight steps equal 3, a
    checkpoint, a restore and 3 more, bit for bit (rank-3 expert leaves,
    the aux metric in the history)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim import adamw
    from repro_torch.runtime import fault_tolerance as FT
    from repro_torch.runtime import train_loop as TL

    cfg = smoke_variant(get_config("deepseek-v2-lite-16b"))

    def runner(name, total, every):
        tcfg = TL.TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6))
        return FT.TrainingRunner(
            TL.make_train_step(cfg, tcfg, device=dev),
            TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=2)),
            CheckpointManager(str(tmp_path / name), keep=1),
            FT.RunnerConfig(total_steps=total, checkpoint_every=every, log_every=1), log_fn=lambda *_: None)

    p0, o0 = TL.init_train_state(1, cfg, device=dev)
    pa, oa, hist = runner("straight", 6, 10**6).run(p0, o0)
    assert len(hist) == 6 and all(h["aux"] > 0 for h in hist)
    runner("cut", 3, 3).run(p0, o0)
    resumed = runner("cut", 6, 10**6)
    start, pr, orr = resumed.try_restore(*TL.init_train_state(2, cfg, device=dev))
    assert start == 3
    pb, ob, _ = resumed.run(pr, orr, start)
    for a, b in zip(tree.leaves((pa, oa)), tree.leaves((pb, ob))):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


# ---- QAT of the encoder frontends and the bf16 variants on the card

ENCODER_TRAIN_CASES = {  # name -> (model, config changes)
    "whisper-tiny": ("whisper-tiny", {}),
    "internvl2-2b": ("internvl2-2b", {}),
    "granite-8b-bf16": ("granite-8b", dict(attn_scores_dtype="bf16", logits_dtype="bf16")),
}


def _train_batch(cfg, seed: int = 1, batch: int = 4, seq: int = 64) -> dict:
    """The pipeline's tokens and, for a model with a frontend, its float32
    frontend rows."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline

    enc = cfg.encoder
    return TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed,
                                    frontend_positions=enc.n_positions if enc else 0,
                                    frontend_dim=(enc.d_input or cfg.d_model) if enc else 0)).next()


@pytest.mark.parametrize("case", sorted(ENCODER_TRAIN_CASES))
def test_encoder_and_bf16_train_step_card_matches_cpu(dev, case):
    """One smoke train step on the card against the CPU's: whisper-tiny
    over its frames (the encoder stack and cross-attention in train mode),
    internvl2-2b with its patch rows, granite-8b with bf16 scores and
    logits; the loss and every gradient leaf within TRAIN_LOSS_RTOL /
    TRAIN_GRAD_TOL, as the other families', or the model's TRAIN_BOUNDS."""
    from repro_torch.runtime import train_loop as TL

    assert not torch.backends.cuda.matmul.allow_tf32
    name, changes = ENCODER_TRAIN_CASES[case]
    cfg = dataclasses.replace(smoke_variant(get_config(name)), **changes)
    params = Z.init_params(0, cfg, device="cpu")
    batch = _train_batch(cfg)
    runs = [TL.value_and_grad(_to(params, d), {k: torch.as_tensor(v).to(d) for k, v in batch.items()}, cfg,
                              TL.TrainConfig()) for d in ("cpu", dev)]
    (m0, g0), (m1, g1) = runs
    want = float(m0["loss"])
    loss_tol, grad_tol = TRAIN_BOUNDS.get(case, (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL))
    assert abs(float(m1["loss"]) - want) <= loss_tol * abs(want)
    for (path, a), b in zip(tree.leaves_with_paths(g1), tree.leaves(g0)):
        assert a.is_cuda and float((a.cpu() - b).abs().max()) <= grad_tol * float(b.abs().max()), path


@pytest.mark.parametrize("name", ["whisper-tiny", "internvl2-2b"])
def test_trained_encoder_model_served_through_k1_bitwise(dev, name):
    """The encoder families' smoke models trained 3 steps on the card with
    their frontends, packed and served on ``pallas`` through the compiled
    steps: internvl2's image prefill and whisper's prefill over its frames
    plus 2 decode steps.  K1's wrapper launches equal the sites of the
    captures (warm-up run + capture), the compiled prefill's logits are
    the eager one's, and logits and every cache leaf of the eager run are
    bitwise those with K1 swapped for its plain version."""
    from unittest import mock

    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop as TL
    from repro_torch.runtime.serve_loop import make_decode_step, make_prefill

    cfg = smoke_variant(get_config(name))
    enc = cfg.encoder
    params, opt = TL.init_train_state(0, cfg, device=dev)
    step = TL.make_train_step(cfg, TL.TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                                              total_steps=3)), device=dev)
    for i in range(3):
        params, opt, _ = step(params, opt, _train_batch(cfg, seed=i, seq=32))
    scfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend="pallas"))
    served = Z.prepare_serving_params(params, scfg)
    rng = np.random.default_rng(9)
    b, plen, max_len = (1, enc.n_positions + 4, 32) if name == "internvl2-2b" else (2, 4, 32)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, plen))).to(dev)
    frontend = torch.from_numpy(rng.standard_normal((b, enc.n_positions, enc.d_input or cfg.d_model),
                                                    dtype=np.float32)).to(dev)
    n_decode = 0 if name == "internvl2-2b" else 2
    sites = 7 if name == "internvl2-2b" else 10  # a decoder layer's K1 sites (whisper: + cross-attention)
    per_decode = sites * cfg.n_layers
    per_prefill = per_decode + (6 * enc.n_layers if enc.n_layers else 0)

    def eager(tokens=None):
        cache = Z.init_cache(b, max_len, scfg, device=dev)
        out = [Z.prefill(served, prompt, scfg, cache, frontend)[0]]
        fed = []
        for i in range(n_decode):
            fed.append(out[-1].argmax(-1) if tokens is None else tokens[i])
            out.append(Z.decode_step(served, fed[-1], scfg, cache)[0])
        return out, fed, cache

    pre = make_prefill(scfg, b, plen, max_len, device=dev)
    cache = Z.init_cache(b, max_len, scfg, device=dev)
    before = K1.binary_qmm.launches
    first, _ = pre(served, prompt, cache, frontend)
    if n_decode:
        dec = make_decode_step(scfg, b, max_len, device=dev)
        tok = first.argmax(-1)
        for _ in range(n_decode):
            tok = dec(served, tok, cache)[0].argmax(-1)
    torch.cuda.synchronize()
    assert K1.binary_qmm.launches - before == 2 * per_prefill + (2 * per_decode if n_decode else 0)
    got, fed, got_cache = eager()
    assert torch.equal(first, got[0])
    with mock.patch.object(ops._bq, "binary_qmm", ref.binary_qmm_ref):
        plain, _, plain_cache = eager(fed)
    assert all(torch.equal(x, y) for x, y in zip(got, plain)) and Z.caches_equal(got_cache, plain_cache)
    assert all(bool(torch.isfinite(x).all()) and x.shape == (b, cfg.vocab_size) for x in got)


# the measurement modules on the card: a cell's operands rotate past twice
# the L2, so no kernel cell reads more than its roof (the share <= 1)
@pytest.mark.parametrize("backend,site", [("pallas", (4, 4096, 14336, 8, 1)), ("fused", (4, 4096, 14336, 8, 1)),
                                          ("pallas", (128, 768, 3072, 1, 1)), ("pallas", (128, 64, 128, 8, 8))])
def test_roofline_cell_on_card(dev, backend, site):
    from unittest import mock

    from repro_torch.core import qmm_roofline as R
    from repro_torch.kernels import ops

    cell = R.measure_cell(backend, *site, device=dev)
    assert 0 < cell["roof_us"] <= cell["measured_us"]
    xq, wq, colsum = R.make_problem(*site, dev)
    got = QE.qmm(xq, wq, backend=backend, w_colsum=colsum)
    with mock.patch.object(ops._bq, "binary_qmm", ref.binary_qmm_ref), \
            mock.patch.object(ops._fq, "fused_qmm", ref.fused_qmm_ref), \
            mock.patch.object(ops._pq, "popcount_qmm", lambda a, b: ref.popcount_qmm_ref(a, b, 32 * a.shape[1])), \
            mock.patch.object(ops._bs, "bitserial_qmm", lambda a, b: ref.bitserial_qmm_ref(a, b, 32 * a.shape[-1])):
        assert torch.equal(got, QE.qmm(xq, wq, backend=backend, w_colsum=colsum))


def test_scores_bench_on_card(dev):
    from repro_torch.core import attn_bench as A

    doc = A.run_attn_bench([(4, 12, 12, 1, 512, 64)], device=dev, reps=1)
    assert doc["platform"] == "cuda" and {"name", "power_limit"} <= set(doc["hardware"])
    assert all(0 < c["roof_us"] <= c["measured_us"] for c in A.validate_attn_bench(doc)["cells"])


# ---------------------------------------------------------------------------
# multi-device training on the card (chip_smoke.py [18a] / [18d] at smoke size)
# ---------------------------------------------------------------------------

MESH_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _mesh_batches(cfg, n: int = 3):
    rng = np.random.default_rng(5)
    return [{"tokens": rng.integers(0, cfg.vocab_size, size=(8, 32)).astype(np.int32)} for _ in range(n)]


def test_two_ranks_on_one_card_train_as_one_rank(dev, tmp_path):
    """bit-bert smoke in 2 gloo ranks sharing the card (mesh 2x1): the
    first step's loss within 1e-5 of the 1-rank step's on the card (global
    fake-quant ranges) and its first moments within 2**-6 of a leaf's
    largest (each rank's bf16 gradient share; the CPU test's bound), later
    steps within 2e-2 (chip_smoke.MD_LOSS_RTOL), params within 3 x 2 lr;
    the collectives of CUDA tensors went through the host."""
    from torch_dist_workers import _cfg, run_ranks

    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop as TL

    cfg = _cfg("bit-bert-base")
    batches = _mesh_batches(cfg)
    out = run_ranks("card_mesh_worker", 2, tmp_path, {"opt": MESH_OPT, "batches": batches})
    params, opt = TL.init_train_state(0, cfg, device=dev)
    step = TL.make_train_step(cfg, TL.TrainConfig(optimizer=adamw.AdamWConfig(**MESH_OPT)), device=dev)
    losses, first_mu = [], None
    for b in batches:
        params, opt, met = step(params, opt, b)
        losses.append(float(met["loss"]))
        first_mu = tree.leaves(opt.mu) if first_mu is None else first_mu
    gaps = [abs(x - y) / abs(y) for x, y in zip(out[0]["losses"], losses)]
    assert out[1]["losses"] == out[0]["losses"]
    assert gaps[0] <= 1e-5 and max(gaps) <= 2e-2, gaps
    for got, want in zip(out[0]["first_mu"], first_mu):
        want = want.cpu()
        assert float((got - want).abs().max()) <= 2.0 ** -6 * float(want.abs().max()), (got, want)
    for got, want in zip(out[0]["params"], tree.leaves(params)):
        assert float((got - want.cpu()).abs().max()) <= 3 * 2 * MESH_OPT["lr"] * (1 + 1e-3)
    assert {"all_gather", "reduce_scatter", "all_reduce"} <= set(out[0]["staged"])


def test_two_ranks_on_one_card_train_moe_as_one_rank(dev, tmp_path):
    """deepseek-v2-lite smoke in 2 gloo ranks sharing the card (mesh 2x1),
    its MoE layer routing the global microbatch: the first step's routes,
    keep, dest and expert buffer those of the 1-rank step on the card,
    its loss and balance loss within 1e-5, its first moments within 2**-6
    of a leaf's largest; later steps within 2e-2."""
    from torch_dist_workers import _cfg, moe_spy, run_ranks

    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop as TL

    cfg = _cfg("deepseek-v2-lite-16b")
    batches = _mesh_batches(cfg)
    out = run_ranks("card_mesh_worker", 2, tmp_path, {"opt": MESH_OPT, "batches": batches,
                                                      "name": "deepseek-v2-lite-16b"})
    params, opt = TL.init_train_state(0, cfg, device=dev)
    step = TL.make_train_step(cfg, TL.TrainConfig(optimizer=adamw.AdamWConfig(**MESH_OPT)), device=dev)
    losses, auxes, first_mu, seen = [], [], None, []
    for b in batches:
        with moe_spy(seen) if first_mu is None else contextlib.nullcontext():
            params, opt, met = step(params, opt, b)
        losses.append(float(met["loss"]))
        auxes.append(float(met["aux"]))
        first_mu = tree.leaves(opt.mu) if first_mu is None else first_mu
    assert out[1]["losses"] == out[0]["losses"] and out[1]["auxes"] == out[0]["auxes"]
    for ours, want in ((out[0]["losses"], losses), (out[0]["auxes"], auxes)):
        gaps = [abs(x - y) / abs(y) for x, y in zip(ours, want)]
        assert gaps[0] <= 1e-5 and max(gaps) <= 2e-2, gaps
    for got, want in zip(out[0]["first_mu"], first_mu):
        want = want.cpu()
        assert float((got - want).abs().max()) <= 2.0 ** -6 * float(want.abs().max())
    for r in range(2):
        got = out[r]["seen"]
        assert len(got) == len(seen) > 0
        for g, w in zip(got, seen):
            t = g["experts"].shape[0]
            mine = w["st"].cpu() // t == r
            assert torch.equal(g["experts"], w["experts"][r * t:(r + 1) * t].cpu())
            for key in ("keep", "dest"):
                assert torch.equal(g[key], w[key].cpu()[mine]), key
            assert torch.equal(g["h_in"], w["h_in"].cpu())


def test_global_dispatch_given_logits_on_card(dev, tmp_path):
    """2 gloo ranks on the card, outside any step: given a microbatch's MoE
    input and router logits at deepseek-v2-lite's expert count and top-k
    (2 x 512 tokens a rank, capacity 240), each rank's global dispatch of
    its rows equals the 1-rank dispatch of the whole on the card (routes,
    order, keep, dest, the expert buffer), and the routing traffic is the
    plan's counts and buffer parts."""
    from torch_dist_workers import run_ranks

    gen = torch.Generator().manual_seed(7)
    t, d = 1024, 256
    x = torch.randn((2 * t, d), generator=gen).to(torch.bfloat16)
    logits = torch.randn((2 * t, 64), generator=gen) * 2
    logits[:, :4] += 3  # experts 0-3 overflow the global capacity
    logits[:t, 4] += 6  # rank 0 fills expert 4: rank 1's routes to it drop
    out = run_ranks("card_dispatch_worker", 2, tmp_path, {"x": x, "logits": logits})
    for r in out:
        assert r["capacity"] == (240, 240) and r["experts"] and r["order"] and r["buffer"]
        assert all(r["dispatch"]), r["dispatch"]
        assert r["routing"]["counts"] == {"bytes": 2 * 64 * 4, "count": 1}
        assert r["routing"]["buffer"] == {"bytes": 2 * (t * d * 2 + t * 6 * 4), "count": 1}
    assert sum(r["dropped"] for r in out) > 0


def test_one_rank_over_nccl_is_the_step_without_a_group(dev, tmp_path):
    """A world of one NCCL rank: the mesh step (gathers, reduce-scatters,
    range and loss all-reduces, the sharded global norm) bit for bit the
    step without a process group."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop as TL

    cfg = dataclasses.replace(smoke_variant(get_config("bit-bert-base")), n_layers=2)
    tcfg = TL.TrainConfig(optimizer=adamw.AdamWConfig(**MESH_OPT))
    batch = _mesh_batches(cfg, 1)[0]
    p0, o0 = TL.init_train_state(0, cfg, device=dev)
    plain = TL.make_train_step(cfg, tcfg, device=dev)(p0, o0, batch)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device="cuda")
        ps, os_ = TL.init_train_state(0, cfg, device=dev, mesh=mesh)
        meshed = TL.make_train_step(cfg, tcfg, device=dev, mesh=mesh)(ps, os_, batch)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    for a, b in zip(tree.leaves(meshed[:2]), tree.leaves(plain[:2])):
        assert torch.equal(a, b)
    assert all(torch.equal(meshed[2][k], plain[2][k]) for k in plain[2])


def test_train_cli_spawns_ranks_that_share_the_card(dev, tmp_path):
    """``python -m repro_torch.launch.train --devices 2 --mesh 2x1`` on the
    card (one card: more ranks than cards, so gloo with both ranks on it;
    NCCL where each rank has one): 2 steps, rank 0's checkpoint, then a
    resume on 1x2."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "bit-bert-base", "--smoke", "--devices",
            "2", "--batch", "4", "--seq", "32", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ck")]
    first = subprocess.run(args + ["--mesh", "2x1", "--steps", "2"], cwd=root, env=env, capture_output=True,
                           text=True, timeout=300)
    assert first.returncode == 0, first.stderr[-3000:]
    again = subprocess.run(args + ["--mesh", "1x2", "--steps", "4"], cwd=root, env=env, capture_output=True,
                           text=True, timeout=300)
    assert again.returncode == 0 and "resumed from step 2" in again.stdout, again.stderr[-3000:]
    assert (tmp_path / "ck" / "step_000000004" / "_COMMITTED").exists()


def _tp_granite():
    cfg = dataclasses.replace(smoke_variant(get_config("granite-8b")), n_kv_heads=2)
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend="pallas"))


def test_sharded_serving_two_ranks_on_one_card(dev, tmp_path):
    """granite smoke (2 kv heads) over a 1x2 mesh in two gloo ranks on the
    card (K1 at the local shapes): each rank's cache its shard of the
    unmeshed step's bit for bit, after the prefill and at the end, the
    greedy tokens equal and the logits within 1e-5 of their largest."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from torch_dist_workers import run_ranks, serve_greedy

    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime.serve_loop import make_decode_step, make_prefill

    cfg = _tp_granite()
    params = Z.init_serving_params(0, cfg, device="cpu")
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(2, 9))
    want = serve_greedy(make_prefill, make_decode_step, cfg, _to(params, dev), prompts, 4, 32, device=dev)
    out = run_ranks("card_serve_worker", 2, tmp_path, {"cfg": cfg, "params": params, "prompts": prompts,
                                                       "n_decode": 4, "max_len": 32})
    mesh = abstract_mesh((1, 2), ("data", "model"))
    for got in out:
        assert got["modes"] == ("eager", "eager")
        assert [t.tolist() for t in got["fed"]] == [t.cpu().tolist() for t in want["fed"]]
        scale = max(float(w.abs().max()) for w in want["logits"])
        for g, w in zip(got["logits"], want["logits"]):
            assert float((g - w.cpu()).abs().max()) <= 1e-5 * scale
        for when in ("prefill", "end"):
            whole = want[when]
            shard = SH.shard_tree(whole, SH.cache_shardings(whole, mesh, 2, cfg), got["coords"])
            for a, b in zip(tree.leaves(shard), tree.leaves(got[when])):
                assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


def _tp_deepseek(binary: bool = False):
    cfg = smoke_variant(get_config("deepseek-v2-lite-16b"))
    quant = dataclasses.replace(cfg.quant, backend="pallas")
    if binary:
        quant = dataclasses.replace(quant, backend_overrides=(("attn.qk_latent", "binary"),))
    return dataclasses.replace(cfg, quant=quant)


@pytest.mark.parametrize("shape,binary", [((1, 2), False), ((2, 1), False), ((1, 2), True)])
def test_sharded_mla_moe_serving_two_ranks_on_one_card(dev, tmp_path, shape, binary):
    """deepseek-v2-lite smoke over a 1x2 mesh (the latent cache's columns
    and the routed experts over ``model``; with ``attn.qk_latent ->
    binary`` the scores kernel on a rank's 8 latent columns) and over 2x1
    (each MoE layer routing the global batch) in two gloo ranks on the
    card: each rank's cache its shard of the unmeshed step's bit for bit,
    after the prefill and at the end, the greedy tokens equal and the
    logits within 1e-5 of their largest."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from torch_dist_workers import run_ranks, serve_greedy

    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime.serve_loop import make_decode_step, make_prefill

    cfg = _tp_deepseek(binary)
    params = Z.init_serving_params(0, cfg, device="cpu")
    prompts = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(4, 9))
    want = serve_greedy(make_prefill, make_decode_step, cfg, _to(params, dev), prompts, 4, 32, device=dev)
    out = run_ranks("card_serve_worker", 2, tmp_path, {"cfg": cfg, "params": params, "prompts": prompts,
                                                       "n_decode": 4, "max_len": 32, "shape": shape})
    mesh = abstract_mesh(shape, ("data", "model"))
    for got in out:
        assert got["modes"] == ("eager", "eager")
        assert [t.tolist() for t in got["fed"]] == [t.cpu().tolist() for t in want["fed"]]
        scale = max(float(w.abs().max()) for w in want["logits"])
        for g, w in zip(got["logits"], want["logits"]):
            assert float((g - w.cpu()).abs().max()) <= 1e-5 * scale
        for when in ("prefill", "end"):
            whole = want[when]
            shard = SH.shard_tree(whole, SH.cache_shardings(whole, mesh, 4, cfg), got["coords"])
            for a, b in zip(tree.leaves(shard), tree.leaves(got[when])):
                assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("r,ranks", [(512, 2), (16, 2), (512, 16)])
def test_binary_attn_at_a_ranks_latent_columns(dev, r, ranks):
    """The scores kernel on one model rank's latent columns, as the absorbed
    decode packs them (the whole 1-bit query's column slice; the int8
    cache's columns re-binarized), equals its plain version at dh = R / m,
    and the ranks' counts summed in int32 are the whole latent's."""
    from repro_torch.kernels import binary_attn as K5
    from repro_torch.models import attention as A

    g = torch.Generator(device=dev).manual_seed(r + ranks)
    b, h, t, part = 4, 16, 512, r // ranks
    q_bits = torch.randint(0, 2, (b, 1, h, r), generator=g, device=dev, dtype=torch.int8)
    ckv = torch.randint(-128, 128, (b, t, r), generator=g, device=dev, dtype=torch.int8)
    whole = ref.binary_attn_scores_ref(A._pack_q_heads(q_bits), packing.pack_bits(ckv >= 0, 1)[:, None], r)
    total = torch.zeros_like(whole)
    for i in range(ranks):
        cols = slice(i * part, (i + 1) * part)
        q = A._pack_q_heads(q_bits[..., cols])
        k = packing.pack_bits(ckv[..., cols].contiguous() >= 0, 1, axis=-1)[:, None]
        got = K5.binary_attn_scores_planes(q, k, dh=part)
        assert torch.equal(got, ref.binary_attn_scores_ref(q, k, part))
        total += got
    assert torch.equal(total, whole)


def test_one_nccl_rank_captures_the_mesh_step(dev, tmp_path):
    """A world of one NCCL rank, mesh 1x1: ``make_prefill`` /
    ``make_decode_step`` with the mesh are captured with their collectives
    (mode ``graph``) and replayed bitwise the unmeshed compiled steps."""
    import sys

    import torch.distributed as dist

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from torch_dist_workers import serve_greedy

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.serve_loop import make_decode_step, make_prefill

    cfg = _tp_granite()
    params = Z.init_serving_params(0, cfg, device=dev)
    prompts = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(2, 9))
    want = serve_greedy(make_prefill, make_decode_step, cfg, params, prompts, 4, 32, device=dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init", rank=0, world_size=1)
    try:
        got = serve_greedy(make_prefill, make_decode_step, cfg, params, prompts, 4, 32, device=dev,
                           mesh=make_host_mesh(1, 1, device="cuda"))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert got["modes"] == ("graph", "graph")
    assert all(torch.equal(a, b) for a, b in zip(got["logits"], want["logits"]))
    assert Z.caches_equal(got["prefill"], want["prefill"]) and Z.caches_equal(got["end"], want["end"])


SMOKE_MLA = dict(dn=16, dr=8, r=16, dv=16)


@pytest.mark.parametrize("b,h,ranks,widths", [(4, 16, 2, {}), (2, 16, 2, {}), (4, 128, 16, {}),
                                              (4, 4, 2, SMOKE_MLA), (2, 4, 2, SMOKE_MLA)])
def test_absorbed_products_on_a_ranks_heads(dev, b, h, ranks, widths):
    """The absorbed decode's float32 products on the card, as a model rank
    runs them, against all heads at once: deepseek-v2-lite's 16 heads over
    2 ranks at [20e]'s 4 local rows and a 2x2 mesh's 2, deepseek-v3's 128
    over 16, and the smokes' 4 heads over 2.  The form ``MeshStep`` runs
    (every head's query gathered, folded through the whole ``k_up``) is
    the one-card step's bit for bit.  The products on a rank's heads alone
    are printed: cuBLAS sums ``q_abs`` over a rank's heads in another order
    at some of these shapes (ROADMAP section 3), which is why the step
    holds whole copies of the up-projections."""
    from torch_dist_workers import absorbed_products_by_heads

    got = absorbed_products_by_heads(b, h, ranks, device=dev, **widths)
    print(f"absorbed products b={b} h={h} ranks={ranks} on {torch.cuda.get_device_name(0)}: bitwise {got}")
    assert got["q_gathered"]
