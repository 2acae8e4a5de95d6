"""Pass 1 -- the invariant verifier of the quantized datapath (port of
``repro.analysis.verifier``).

The paper's efficiency claims rest on invariants the type system never sees
(section III-A, the computation flow abstraction): packed bit-planes may
only meet integer or bitwise operations until a popcount consumes them,
accumulation stays integer across bit significance, cache slots keep their
initialised dtypes, and every serve-mode QMM site quantizes to the
precision its ``QuantConfig`` declares.  The reference traces jaxprs; the
port runs the real code eagerly and watches every aten operator it issues
(a ``TorchDispatchMode``), enforcing:

  INV-PACKED-FLOAT  a packed-bit-plane value (int32 words from
                    ``core/packing.py``) reaches a floating-point result
  INV-ACCUM-LOWFP   a popcount / kernel accumulator is converted to
                    bf16 / f16 (f32 / f64 epilogue casts are the legal exit)
  INV-INT-DOT       an integer-operand ``mm`` / ``bmm`` / ``matmul`` /
                    ``einsum`` / ``_int_mm`` accumulates in anything but
                    int32 / int64
  INV-CACHE-DTYPE   a prefill / decode leaves a cache leaf in another dtype
                    than ``init_cache`` made it
  INV-CACHE-SHAPE   ... or in another shape
  INV-CACHE-STRUCT  ... or the cache tree's structure itself changed
  INV-SITE-NAME     a serve-mode qlinear QMM ran at an unnamed site
                    (unnameable sites cannot get backend overrides)
  INV-SITE-BITS     a site quantized to a precision other than the one
                    its QuantConfig declares
  INV-SITE-MANTISSA a site produced a mantissa dtype violating the
                    quantizer contract (uint8 for <=8 bits, int8 after
                    re-centering, int32 above)

Taint semantics.  Taints follow storage, not Python objects, so a view, an
in-place operator, a ``copy_`` or an ``index_put_`` into the cache (which
the port writes in place) carries them; a storage's taints only grow.
Boolean results drop taint.  The boundaries are marked functions
(``core/marks.py``): the outputs of ``pack_bits`` / ``pack_bitplanes`` /
``to_bitplanes`` carry "packed", ``unpack_bits`` launders it; ``popcount32``
and the five kernel wrappers (trusted boundaries: their insides are held to
their plain versions by the parity tests and on the card) consume packed
words and emit "counts" on integer outputs.  The walk does not enter a
marked function: on the CPU the plain version runs inside the mark, on the
card the kernel's launch.  Converting counts to f32 / f64 is the legal
epilogue exit, including a kernel that applies the affine epilogue itself
and returns f32 (K2, ``fused_qmm``); a kernel or cast producing bf16 / f16
from packed or counted operands is INV-ACCUM-LOWFP.  Operators that read
only a tensor's metadata (``empty_like``, ``zeros_like``, ...) make fresh,
clean storage.  Int32 words carry no dtype of their own, so the packed
inputs of :func:`check_function` are named (``packed_argnums``), and a
model's packed weights are its ``w_packed`` leaves.

Autograd functions' bodies and checkpoints are walked, since dispatch sees
them.  A CUDA-graph replay issues no aten operator, so every trace here
runs eager forwards.  Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.findings import Finding
from repro_torch.core import backend_registry, marks, packing, site_log
from repro_torch.core import qmm as QE
from repro_torch.core.quantization import QuantTensor

__all__ = [
    "check_function",
    "check_cache_contract",
    "verify_backends",
    "verify_binary_attention",
    "verify_arch",
    "verify_archs",
    "CROSSED",
    "RECORDS",
]

TAINT_PACKED = "packed"
TAINT_COUNTS = "counts"

#: kernel boundaries the walks crossed, by wrapper name (phase [19] of
#: ``chip_smoke.py`` holds them to the wrappers' launch counts)
CROSSED: collections.Counter = collections.Counter()
#: the site records of each model trace's last run, by trace name
RECORDS: Dict[str, List[dict]] = {}

_INT_ACCUM_DTYPES = {torch.int32, torch.int64}
# referenced as *data* (the dtypes the rule is about), hence by name
_LOWFP_DTYPES = {getattr(torch, n) for n in ("bfloat16", "float16")}
#: integer products: the decompositions of ``matmul`` / ``einsum`` included
_DOT_OPS = frozenset({"mm", "bmm", "matmul", "einsum", "_int_mm", "dot", "mv", "addmm", "baddbmm",
                      "addbmm", "addmv"})
#: operators that read only their input's metadata: fresh storage, no taint
_FRESH_OPS = frozenset({"empty_like", "zeros_like", "ones_like", "full_like", "rand_like",
                        "randn_like", "randint_like", "new_empty", "new_empty_strided",
                        "new_zeros", "new_ones", "new_full"})


def _is_int(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex() or t.dtype == torch.bool)


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _name(dtype) -> str:
    return site_log.dtype_name(dtype)


class _Walk(TorchDispatchMode):
    """One taint-propagation walk: the dispatch mode that sees every aten
    operator, and the observer of the boundary marks."""

    def __init__(self, trace_name: str):
        super().__init__()
        self.trace_name = trace_name
        self.findings: List[Finding] = []
        self._seen: Set[Tuple[str, str, str]] = set()  # dedup per trace
        # storage -> taints; the storage object is held so that its address
        # is not reused by another while the walk runs
        self._taints: Dict[int, Tuple[object, Set[str]]] = {}
        self._depth = 0  # > 0 inside a marked function

    # -- taints --------------------------------------------------------------

    def taints(self, t: torch.Tensor) -> Set[str]:
        entry = self._taints.get(t.untyped_storage()._cdata)
        return entry[1] if entry else set()

    def add(self, t: torch.Tensor, taint: str) -> None:
        s = t.untyped_storage()
        self._taints.setdefault(s._cdata, (s, set()))[1].add(taint)

    def _joined(self, ts) -> Set[str]:
        out: Set[str] = set()
        for t in ts:
            out |= self.taints(t)
        return out

    # -- findings ------------------------------------------------------------

    def violate(self, rule: str, op: str, message: str, hint: str) -> None:
        key = (rule, op, message)
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(
            Finding(
                rule=rule,
                path=f"trace:{self.trace_name}",
                line=0,
                symbol=self.trace_name,
                message=f"[{op}] {message}",
                hint=hint,
            )
        )

    # -- the operators -------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._depth:
            return func(*args, **kwargs)
        op = func._overloadpacket.__name__
        ins = _tensors((args, kwargs))
        joined = set() if op in _FRESH_OPS else self._joined(ins)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if op in _DOT_OPS:
            operands = [a for a in args if isinstance(a, torch.Tensor)]
            if operands and all(_is_int(a) for a in operands):
                bad = [o for o in outs if o.dtype not in _INT_ACCUM_DTYPES]
                if bad:
                    self.violate(
                        "INV-INT-DOT", op,
                        f"integer-operand {op} accumulates in {[_name(o.dtype) for o in bad]}",
                        "multiply integers in int32 (torch._int_mm) or exactly in float64 "
                        "(flow_abstraction.exact_int_matmul) -- integer QMM accumulation must "
                        "stay exact (paper section III-A)",
                    )
        self._generic(op, joined, outs)
        return out

    def _generic(self, op: str, joined: Set[str], outs: Sequence[torch.Tensor]) -> None:
        """Default propagation: packed / counts flow through integer
        operators; floating outputs are either violations (packed; counts
        to bf16 / f16) or the legal f32 / f64 epilogue exit (counts); bool
        outputs (comparisons, masks) drop taint."""
        if not joined:
            return
        float_outs = [o for o in outs if o.is_floating_point()]
        if TAINT_PACKED in joined:
            if float_outs:
                self.violate(
                    "INV-PACKED-FLOAT", op,
                    "packed bit-plane words reach a floating-point value "
                    f"({[_name(o.dtype) for o in float_outs]})",
                    "packed int32 words are storage, not numbers: unpack "
                    "(core.packing.unpack_bits) or popcount before any float math",
                )
            else:
                for o in outs:
                    if _is_int(o):
                        self.add(o, TAINT_PACKED)
        if TAINT_COUNTS in joined:
            lowfp = [o for o in float_outs if o.dtype in _LOWFP_DTYPES]
            if lowfp:
                self.violate(
                    "INV-ACCUM-LOWFP", op,
                    f"integer accumulator converted to {[_name(o.dtype) for o in lowfp]} -- "
                    "low-precision float accumulation loses popcount exactness",
                    "keep accumulators int32; cast to f32 (not bf16/f16) in the affine epilogue",
                )
            for o in outs:
                if _is_int(o):
                    self.add(o, TAINT_COUNTS)

    # -- the marked functions ------------------------------------------------

    def boundary(self, kind: str, name: str, fn, args, kwargs):
        if kind == marks.KERNEL:
            CROSSED[name] += 1
        outer = self._depth == 0
        joined = self._joined(_tensors((args, kwargs))) if outer else set()
        self._depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._depth -= 1
        if not outer:
            return out
        outs = _tensors(out)
        if kind == marks.PACKED:
            for o in outs:
                self.add(o, TAINT_PACKED)
        elif kind == marks.COUNTS:
            for o in outs:
                self.add(o, TAINT_COUNTS)
        elif kind == marks.KERNEL:
            # A kernel fed packed / counted operands may exit in two legal
            # ways: an integer accumulator ("counts"), or f32 / f64 -- the
            # fused kernel's affine epilogue.  bf16 / f16 output would mean
            # the popcount accumulation was finished in a low-precision float.
            if joined & {TAINT_PACKED, TAINT_COUNTS}:
                lowfp = [o for o in outs if o.dtype in _LOWFP_DTYPES]
                if lowfp:
                    self.violate(
                        "INV-ACCUM-LOWFP", f"kernel:{name}",
                        "packed/accumulator operands feed a kernel with low-precision float "
                        f"output {[_name(o.dtype) for o in lowfp]}",
                        "kernels must return integer accumulators or finish the epilogue in "
                        "f32 (the fused-kernel exit) -- bf16/f16 loses popcount exactness",
                    )
                for o in outs:
                    if _is_int(o):
                        self.add(o, TAINT_COUNTS)
        # UNPACKED: logical mantissas come out clean (fresh storage)
        return out

    def run(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` under this walk."""
        with marks.observing(self), self:
            return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to verify on the CPU")
    return dev


def check_function(fn, *args, name: str = "fn", packed_argnums: Sequence[int] = ()) -> List[Finding]:
    """Run ``fn(*args)`` (tensors, on any device) under a taint walk.

    ``packed_argnums`` names the *flattened* input positions that are
    packed bit-planes (int32 words carry no dtype of their own, where the
    reference seeds its uint32 inputs).
    """
    walk = _Walk(name)
    flat = tree_leaves(list(args))
    for i in packed_argnums:
        walk.add(flat[i], TAINT_PACKED)
    walk.run(fn, *args)
    return walk.findings


def _keystr(path: Tuple) -> str:
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


def _cache_spec(cache, path: Tuple = ()) -> Dict[str, Tuple[torch.dtype, Tuple[int, ...]]]:
    """``{keystr: (dtype, shape)}`` of every leaf, as ``jax.tree_util.keystr``
    writes a path."""
    out: Dict[str, Tuple[torch.dtype, Tuple[int, ...]]] = {}
    if isinstance(cache, dict):
        for k, v in cache.items():
            out.update(_cache_spec(v, path + (k,)))
    elif isinstance(cache, (list, tuple)):
        for i, v in enumerate(cache):
            out.update(_cache_spec(v, path + (i,)))
    else:
        out[_keystr(path)] = (cache.dtype, tuple(cache.shape))
    return out


def _compare_cache(init_spec: Dict, out_cache, trace_name: str) -> List[Finding]:
    """Pathwise dtype / shape compare of a step's cache against its init's
    spec (taken before the step: the port writes caches in place)."""
    path = f"trace:{trace_name}"
    out_spec = _cache_spec(out_cache)
    if sorted(init_spec) != sorted(out_spec):
        return [
            Finding(
                rule="INV-CACHE-STRUCT",
                path=path,
                line=0,
                symbol=trace_name,
                message="cache pytree structure changed across the step",
                hint="steps must return the cache with the exact init structure (slots are "
                "written in place)",
            )
        ]
    out: List[Finding] = []
    for leaf in sorted(init_spec):
        (da, sa), (db, sb) = init_spec[leaf], out_spec[leaf]
        if da != db:
            out.append(
                Finding(
                    rule="INV-CACHE-DTYPE",
                    path=path,
                    line=0,
                    symbol=leaf,
                    message=f"cache leaf {leaf} initialized {_name(da)} but the step writes {_name(db)}",
                    hint="derive the write dtype from the cache leaf (cache[...].dtype), never a "
                    "literal -- init/write drift makes batched decode diverge (the PR 6 bug)",
                )
            )
        if sa != sb:
            out.append(
                Finding(
                    rule="INV-CACHE-SHAPE",
                    path=path,
                    line=0,
                    symbol=leaf,
                    message=f"cache leaf {leaf} initialized {sa} but the step returns {sb}",
                    hint="cache leaves are fixed-capacity ring/linear buffers; steps may not grow them",
                )
            )
    return out


def check_cache_contract(init_thunk, step_fn, *step_args, name: str = "cache") -> List[Finding]:
    """``init_thunk() -> cache``; ``step_fn(cache, *step_args) -> cache``.

    Both run eagerly on whatever device they make their tensors on (``meta``
    gives shapes alone); returns INV-CACHE-* findings for any dtype / shape /
    structure drift between the init's leaves and the step's.
    """
    cache = init_thunk()
    spec = _cache_spec(cache)
    with torch.no_grad():
        out = step_fn(cache, *step_args)
    return _compare_cache(spec, out, name)


# ---------------------------------------------------------------------------
# backend sweep
# ---------------------------------------------------------------------------

_M, _K, _N = 8, 64, 16


def _backend_cases(backend: str, m: int, k: int, n: int, gen: torch.Generator, dev):
    """(case name, fn, args, packed flattened positions): one per paper QMM
    type x precision."""
    f32 = dict(dtype=torch.float32, device=dev)

    def mantissa(shape, bits):
        return torch.randint(0, 2**bits, shape, generator=gen, dtype=torch.uint8, device=dev)

    def affine(shape):
        return torch.rand(shape, generator=gen, **f32) + 0.01, torch.randn(shape, generator=gen, **f32)

    def w1a8(xm, xs, xo, wp, ws, wo, colsum):
        x = QuantTensor(mantissa=xm, scale=xs, offset=xo, bits=8)
        w = QuantTensor(mantissa=wp, scale=ws, offset=wo, bits=1, packed=True, packed_axis=0, length=k)
        return QE.qmm(x, w, backend=backend, w_colsum=colsum)

    def w1a1(xm, xs, xo, wp, ws, wo):
        x = QuantTensor(mantissa=xm, scale=xs, offset=xo, bits=1)
        w = QuantTensor(mantissa=wp, scale=ws, offset=wo, bits=1, packed=True, packed_axis=0, length=k)
        return QE.qmm(x, w, backend=backend)

    def a8a8(xm, xs, xo, ym, ys, yo):
        x = QuantTensor(mantissa=xm, scale=xs, offset=xo, bits=8)
        y = QuantTensor(mantissa=ym, scale=ys, offset=yo, bits=8)
        return QE.qmm(x, y, backend=backend)

    w_bits = mantissa((k, n), 1)
    wp = packing.pack_bits(w_bits, 1, axis=0)
    colsum = w_bits.to(torch.int32).sum(dim=0, dtype=torch.int32)  # 1-bit: raw == re-centered
    ws, wo = affine((1, n))
    return [
        ("w1a8", w1a8, (mantissa((m, k), 8), *affine((m, 1)), wp, ws, wo, colsum), (3,)),  # act x weight
        ("w1a1", w1a1, (mantissa((m, k), 1), *affine(()), wp, ws, wo), (3,)),  # fully binary
        ("a8a8", a8a8, (mantissa((m, k), 8), *affine(()), mantissa((k, n), 8), *affine(())), ()),
    ]


def verify_backends(backends: Optional[Sequence[str]] = None, device=None,
                    shape: Tuple[int, int, int] = (_M, _K, _N)) -> List[Finding]:
    """Taint-walk every registered QMM backend across the QMM-type grid
    (W1A8, W1A1, A8xA8) at ``shape`` ``(M, K, N)``, operands from seed 0 on
    ``device``.

    The sweep enumerates the registry's qmm family, so a newly registered
    QMM backend is verified with zero edits here.  Scores-family backends
    have a different calling convention and are covered by
    :func:`verify_binary_attention`."""
    dev = _device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out: List[Finding] = []
    with torch.no_grad():
        for backend in backends or backend_registry.backend_names(family="qmm"):
            for case, fn, args, packed in _backend_cases(backend, *shape, gen, dev):
                out.extend(check_function(fn, *args, name=f"backend:{backend}:{case}",
                                          packed_argnums=packed))
    return out


# ---------------------------------------------------------------------------
# model-zoo arch sweep
# ---------------------------------------------------------------------------

# batch / cache capacity / prompt length for the serving runs: the prompt
# must cover patch_stub splicing (encoder.n_positions patches over the prefix)
_B, _T, _S = 2, 32, 16


def _default_archs() -> Tuple[str, ...]:
    from repro_torch.configs import ASSIGNED

    return ASSIGNED + ("bit-bert-base",)


def _scores_only_backend(name: str) -> bool:
    """Is ``name`` a scores-family-only backend (a bitwise-attention
    engagement when it appears on an attn site record)?"""
    try:
        spec = backend_registry.get_backend(name)
    except (KeyError, ValueError):
        return False
    return "scores" in spec.families and "qmm" not in spec.families


def _site_findings(sites: Sequence[dict], cfg, trace_name: str) -> List[Finding]:
    path = f"trace:{trace_name}"
    out: List[Finding] = []

    def add(rule, symbol, message, hint):
        out.append(Finding(rule=rule, path=path, line=0, symbol=symbol, message=message, hint=hint))

    for s in sites:
        kind = s.get("kind", "")
        site = s.get("site", "")
        bits = s.get("bits")
        mdt = s.get("mantissa_dtype", "")
        if kind == "qlinear":
            if not site:
                add(
                    "INV-SITE-NAME",
                    "<unnamed>",
                    "serve-mode qlinear QMM ran at an unnamed site",
                    "pass name= at the call site -- unnamed sites cannot receive "
                    "backend_overrides or autotune phase tags",
                )
                continue
            if bits != s.get("cfg_bits"):
                add(
                    "INV-SITE-BITS",
                    site,
                    f"site quantized activations to {bits} bits but the QuantConfig declares "
                    f"act_bits={s.get('cfg_bits')}",
                    "per-site precision overrides are not part of the engine contract; fix the "
                    "call site or the config",
                )
            expected = "uint8" if (bits or 0) <= 8 else "int32"
            if mdt != expected:
                add(
                    "INV-SITE-MANTISSA",
                    site,
                    f"site produced mantissa dtype {mdt}, quantizer contract says {expected} for "
                    f"{bits}-bit activations",
                    "quantize_activation stores uint8 mantissas up to 8 bits; wider precisions "
                    "use int32",
                )
        elif kind == "attn":
            if _scores_only_backend(s.get("backend", "auto")):
                # bitwise engagement: the site elastically binarizes Q to
                # 1 bit by family contract, whatever attn_act_bits says
                if bits != 1:
                    add(
                        "INV-SITE-BITS",
                        site,
                        f"bitwise attention site ran at {bits} bits; a scores-family "
                        "engagement binarizes to exactly 1",
                        "scores backends consume packed 1-bit planes -- the site must quantize "
                        "with bits=1",
                    )
                expected = "uint8"
                hint = ("elastic binarization stores {0,1} uint8 mantissas; re-centering does "
                        "not apply at 1 bit")
            else:
                if bits != cfg.quant.attn_act_bits:
                    add(
                        "INV-SITE-BITS",
                        site,
                        f"attention act x act QMM ran at {bits} bits but "
                        f"attn_act_bits={cfg.quant.attn_act_bits}",
                        "the act x act precision is a single engine mode knob "
                        "(QuantConfig.attn_act_bits)",
                    )
                expected = "int8" if (bits or 0) > 1 else "uint8"
                hint = ("Q.recenter must run before the integer attention product so mantissas "
                        "fit int8")
            if mdt != expected:
                add("INV-SITE-MANTISSA", site,
                    f"attention site mantissa dtype {mdt}, expected {expected}", hint)
    return out


def _seed_params(walk: _Walk, params) -> None:
    """A model's packed weights are its ``w_packed`` leaves (the serving
    format of ``layers.pack_linear_for_serving`` and
    ``moe.pack_experts_for_serving``)."""
    if isinstance(params, dict):
        for k, v in params.items():
            if k == "w_packed" and isinstance(v, torch.Tensor):
                walk.add(v, TAINT_PACKED)
            else:
                _seed_params(walk, v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            _seed_params(walk, v)


def _model_traces(cfg, params, dev, batch: int, max_len: int, prompt_len: int, prefix: str,
                  extra=None) -> List[Finding]:
    """A prefill from an empty cache, then a decode step on it, each under
    a taint walk with the site log recording; the cache contract against
    ``init_cache``'s leaves.  ``params`` default to the seed-0 serving
    params on ``dev``; ``extra(trace_name, sites)`` adds findings of a
    caller's own."""
    from repro_torch.models import model_zoo as Z

    if params is None:
        params = Z.prepare_serving_params(Z.init_params(0, cfg, device=dev), cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=dev)
    frontend = None
    if cfg.encoder is not None:
        d_in = cfg.encoder.d_input or cfg.d_model
        frontend = torch.randn((batch, cfg.encoder.n_positions, d_in), generator=gen,
                               dtype=torch.float32, device=dev)
    cache = Z.init_cache(batch, max_len, cfg, device=dev)
    spec = _cache_spec(cache)
    findings: List[Finding] = []
    steps = (
        ("prefill", lambda c: Z.prefill(params, tokens, cfg, c, frontend)),
        ("decode", lambda c: Z.decode_step(params, tokens[:, -1], cfg, c)),
    )
    for step, fn in steps:
        trace = f"{prefix}:{step}"
        walk = _Walk(trace)
        _seed_params(walk, params)
        with torch.no_grad(), site_log.recording() as sites:
            _, cache = walk.run(fn, cache)
        RECORDS[trace] = list(sites)
        findings.extend(walk.findings)
        findings.extend(_compare_cache(spec, cache, trace))
        findings.extend(_site_findings(sites, cfg, trace))
        if extra is not None:
            findings.extend(extra(trace, sites))
    return findings


def verify_arch(name: str, device=None, cfg=None, params=None, batch: int = _B,
                max_len: int = _T, prompt_len: int = _S) -> List[Finding]:
    """Run one model-zoo arch's prefill + decode and enforce the packed /
    accumulator taints, the cache init-vs-step contract, and the per-site
    quantization log.

    By default the arch's smoke variant on seed-0 params; ``cfg`` (and its
    serving ``params``) verify another size, e.g. the full width on the
    card."""
    from repro_torch.configs import get_config
    from repro_torch.configs.smoke import smoke_variant

    cfg = smoke_variant(get_config(name)) if cfg is None else cfg
    if not cfg.has_decoder:
        return []  # encoder-only: no serving step to verify (assignment rule)
    return _model_traces(cfg, params, _device(device), batch, max_len, prompt_len, f"arch:{name}")


def verify_archs(names: Optional[Sequence[str]] = None, device=None) -> List[Finding]:
    out: List[Finding] = []
    for name in names or _default_archs():
        out.extend(verify_arch(name, device=device))
    return out


# ---------------------------------------------------------------------------
# bitwise-attention sweep (scores backend family)
# ---------------------------------------------------------------------------


def verify_binary_attention(device=None, cfg=None, params=None, batch: int = _B,
                            max_len: int = _T, prompt_len: int = _S) -> List[Finding]:
    """Taint-walk the bitwise-attention path: every scores-family core, plus
    prefill / decode of the 1-bit encoder arch with ``attn.qk -> "binary"``
    (bit-bert-base's smoke variant by default; ``cfg`` / ``params`` another
    size).

    The scores family has its own calling convention (packed rank-4 planes
    in, int32 counts out), so :func:`verify_backends` cannot sweep it; and
    bit-bert-base is encoder-family (the serving arch sweep skips it), so
    the model runs here directly.  Site assertions: every ``attn.qk`` record
    must carry the binary engagement at exactly 1 bit, and the packed K
    cache must keep the cache contract.
    """
    import functools

    from repro_torch.configs import get_config
    from repro_torch.configs.smoke import smoke_variant

    dev = _device(device)
    findings: List[Finding] = []

    # ---- every registered scores core keeps the packed / counts taints ----
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    words = dict(dtype=torch.int32, device=dev)
    q = torch.randint(-2**31, 2**31 - 1, (1, 4, 6, 2), generator=gen, **words)  # (B, H, S, dw): dh 48
    k = torch.randint(-2**31, 2**31 - 1, (1, 2, 5, 2), generator=gen, **words)  # (B, G, T, dw), G < H
    q[..., -1] &= 0xFFFF  # packing leaves the 16 bits past dh = 48 zero
    k[..., -1] &= 0xFFFF
    with torch.no_grad():
        for name in backend_registry.backend_names(family="scores"):
            spec = backend_registry.get_backend(name)
            findings.extend(check_function(functools.partial(spec.run_scores, dh=48), q, k,
                                           name=f"scores:{name}", packed_argnums=(0, 1)))

    # ---- model traces with the binary engagement ----
    if cfg is None:
        base = smoke_variant(get_config("bit-bert-base"))
        cfg = dataclasses.replace(
            base, quant=dataclasses.replace(base.quant, backend_overrides=(("attn.qk", "binary"),)))

    def qk_checks(trace_name: str, sites) -> List[Finding]:
        qk = [s for s in sites if s.get("site") == "attn.qk"]
        path = f"trace:{trace_name}"
        out: List[Finding] = []
        if not qk:
            out.append(Finding(
                rule="INV-SITE-NAME", path=path, line=0, symbol="attn.qk",
                message="binary-attention trace recorded no attn.qk site",
                hint="the override did not engage -- check QuantConfig.backend_for and "
                "_binary_scores_site",
            ))
        for s in qk:
            if s.get("backend") != "binary" or s.get("bits") != 1:
                out.append(Finding(
                    rule="INV-SITE-BITS", path=path, line=0, symbol="attn.qk",
                    message="attn.qk record is not the binary engagement "
                    f"(backend={s.get('backend')!r}, bits={s.get('bits')})",
                    hint="backend_overrides=(('attn.qk', 'binary'),) must reach the site and "
                    "binarize to 1 bit",
                ))
        return out

    findings.extend(_model_traces(cfg, params, dev, batch, max_len, prompt_len, "binary-attn", qk_checks))
    return findings
