"""Ranks for the port's multi-device CPU tests: ``run_ranks`` spawns
``world`` processes that join one gloo process group (``init_method``
``file://`` under the test's temporary directory, so concurrent test
workers never share a port) and run one of this module's workers; each
rank's result comes back through a file.  The workers import the port and
torch only, never JAX, so a rank starts in a few seconds."""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 300


def _entry(rank: int, world: int, tmp: str, worker: str, payload) -> None:
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    out = Path(tmp) / f"rank{rank}.pt"
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/init", rank=rank, world_size=world)
        result = globals()[worker](rank, world, payload)
        torch.save(result, out)
        dist.destroy_process_group()
    except BaseException:
        (Path(tmp) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_ranks(worker: str, world: int, tmp_path, payload=None) -> list:
    """Each rank's return value of ``worker(rank, world, payload)``."""
    import torch.multiprocessing as mp

    tmp = Path(tmp_path) / f"ranks-{worker}"
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, str(tmp), worker, payload)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [f.read_text() for f in sorted(tmp.glob("rank*.err"))]
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"ranks failed (exit codes {[p.exitcode for p in procs]}):\n" + "\n".join(errors))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# optim/compression.py
# ---------------------------------------------------------------------------


def psum_worker(rank: int, world: int, payload):
    """``compressed_psum`` of this rank's gradients and error state, on and
    off, over the whole group."""
    from repro_torch.optim import compression
    from repro_torch.runtime import collectives as C

    grads = {k: torch.from_numpy(v[rank]) for k, v in payload["grads"].items()}
    errs = {k: torch.from_numpy(v[rank]) for k, v in payload["errs"].items()}
    carried = {}
    C.BYTES.clear()
    on = compression.compressed_psum(grads, errs, None, enabled=True)
    carried["on"] = dict(C.BYTES)
    C.BYTES.clear()
    off = compression.compressed_psum(grads, errs, None, enabled=False)
    carried["off"] = dict(C.BYTES)
    gathered = C.all_gather(torch.tensor([rank, 10 * rank], dtype=torch.int32))
    return {"on": on, "off": off, "gathered": gathered, "carried": carried}


# ---------------------------------------------------------------------------
# runtime/train_loop.py over meshes
# ---------------------------------------------------------------------------


def _cfg(name: str, **quant):
    from repro_torch.configs import get_config
    from repro_torch.configs.smoke import smoke_variant

    cfg = smoke_variant(get_config(name))
    cfg = dataclasses.replace(cfg, n_layers=2) if name == "bit-bert-base" else cfg
    if quant:
        cfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, **quant))
    return cfg


def _mesh(shape, ranks):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.tensor(ranks).view(*shape), mesh_dim_names=("data", "model"))


def _global(tree_, shardings):
    from repro_torch.runtime import sharding as SH

    return SH.gather_tree(tree_, shardings)


@contextlib.contextmanager
def moe_spy(seen: list):
    """Record every train-mode MoE layer's routes (``_route``'s experts),
    dispatch (``_dispatch``'s order, token, keep and destination) and
    expert buffer (``h_in``, the input of the first ``expert_qlinear`` of
    each layer), in call order: the forward's, then remat's recompute."""
    from unittest import mock

    from repro_torch.models import moe as M

    route, dispatch, qlinear = M._route, M._dispatch, M.expert_qlinear
    calls = []

    def spy_route(*a, **k):
        out = route(*a, **k)
        seen.append({"experts": out[1].detach().clone()})
        calls.clear()
        return out

    def spy_dispatch(*a, **k):
        out = dispatch(*a, **k)
        seen[-1].update(zip(("order", "st", "keep", "dest"), (x.clone() for x in out)))
        return out

    def spy_qlinear(p, x, *a, **k):
        if not calls:
            seen[-1]["h_in"] = x.detach().clone()
        calls.append(1)
        return qlinear(p, x, *a, **k)

    with mock.patch.object(M, "_route", spy_route), mock.patch.object(M, "_dispatch", spy_dispatch), \
            mock.patch.object(M, "expert_qlinear", spy_qlinear):
        yield seen


#: the MoE scenarios of ``train_worker``: (name, mesh shape or "pair",
#: TrainConfig fields, the balance gradient's backward left as the identity)
MOE_CASES = {
    "v2_pair": ("deepseek-v2-lite-16b", "pair", {}, False),
    "v2_full": ("deepseek-v2-lite-16b", (2, 2), {}, False),
    "v3_pair": ("deepseek-v3-671b", "pair", {}, False),
    "v3_full": ("deepseek-v3-671b", (2, 2), {}, False),
    "v2_accum": ("deepseek-v2-lite-16b", "pair", {"accum_steps": 2}, False),
    "v2_aux": ("deepseek-v2-lite-16b", "pair", {"aux_weight": 1.0}, False),
    "v2_aux_identity": ("deepseek-v2-lite-16b", "pair", {"aux_weight": 1.0}, True),
}


def moe_tcfg(opt: dict, **fields):
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop as TL

    return TL.TrainConfig(optimizer=adamw.AdamWConfig(**opt), **fields)


def _moe_cases(rank: int, payload, pairs, full) -> dict:
    """Each of ``MOE_CASES``' first steps on this rank: the global trees,
    the metrics, every MoE layer's spied routing and the routing
    collectives' traffic."""
    from unittest import mock

    from repro_torch.models import moe as M
    from repro_torch.runtime import train_loop as TL

    out = {}
    on_pair = (2, 1) if rank < 2 else (1, 2)
    for key, (name, shape, fields, identity) in MOE_CASES.items():
        mesh = pairs[on_pair] if shape == "pair" else full
        cfg = _cfg(name)
        params, opt = TL.init_train_state(0, cfg, device="cpu", mesh=mesh)
        step = TL.make_train_step(cfg, moe_tcfg(payload["opt"], **fields), device="cpu", mesh=mesh)
        M.clear_routing_traffic()
        seen = []
        with moe_spy(seen), contextlib.ExitStack() as stack:
            if identity:  # the balance statistics' gradient not summed over the ranks
                stack.enter_context(mock.patch.object(M._SumOverRanks, "backward",
                                                      staticmethod(lambda ctx, g: (g, None))))
            p2, o2, met = step(params, opt, payload["batch"][name])
        p_sh, _ = TL.train_shardings(cfg, mesh)
        out[key] = {"metrics": met, "params": _global(p2, p_sh), "mu": _global(o2.mu, p_sh),
                    "nu": _global(o2.nu, p_sh), "seen": seen,
                    "routing": {k: dict(v) for k, v in M.ROUTING.items()}}
    return out


def train_worker(rank: int, world: int, payload):
    """Every scenario of ``tests/test_torch_multidevice_train.py`` in one
    group of 4 ranks: the meshes' first steps (2x1 on ranks 0-1 beside 1x2
    on ranks 2-3, then 2x2), the fake-quant ranges, the prebinarized step,
    the compressed step, a sharded checkpoint restored onto other meshes,
    and the MoE models' steps with their routing spied (``MOE_CASES``)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import quantization as Q
    from repro_torch.core import tree
    from repro_torch.optim import adamw, compression
    from repro_torch.runtime import collectives as C
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime import train_loop as TL

    tcfg = TL.TrainConfig(optimizer=adamw.AdamWConfig(**payload["opt"]))
    batch = payload["batch"]
    out = {}
    # DeviceMesh creation is collective over the group: every rank makes
    # every mesh, in one order
    pairs = {(2, 1): _mesh((2, 1), [0, 1]), (1, 2): _mesh((1, 2), [2, 3])}
    full = _mesh((2, 2), [0, 1, 2, 3])
    on_pair = (2, 1) if rank < 2 else (1, 2)

    def first_step(name, mesh, spy=None, **quant):
        cfg = _cfg(name, **quant)
        params, opt = TL.init_train_state(0, cfg, device="cpu", mesh=mesh)
        step = TL.make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
        TL.GATHERED.update(packed=0, latent=0, latent_equiv=0)
        p2, o2, met = step(params, opt, batch[name])
        p_sh, o_sh = TL.train_shardings(cfg, mesh)
        res = {"metrics": met, "params": _global(p2, p_sh), "mu": _global(o2.mu, p_sh),
               "nu": _global(o2.nu, p_sh), "gathered": dict(TL.GATHERED)}
        return res, (p2, o2, p_sh, o_sh)

    for name in ("granite-8b", "bit-bert-base"):
        mesh = pairs[on_pair]
        out[(name, on_pair)], _ = first_step(name, mesh)
        out[(name, (2, 2))], state = first_step(name, full)
        if name == "granite-8b":
            granite_state = state

    # the fake-quant ranges of the 2x1 step: each site's own and the reduced
    seen = []
    calibrate = Q._calibrate

    def spy(xd):
        own = (xd.amin().clone(), xd.amax().clone())
        lo, hi = calibrate(xd)
        seen.append((own, (lo.clone(), hi.clone())))
        return lo, hi

    Q._calibrate = spy
    try:
        if rank < 2:
            cfg = _cfg("granite-8b")
            params, opt = TL.init_train_state(0, cfg, device="cpu", mesh=pairs[(2, 1)])
            TL.make_train_step(cfg, tcfg, device="cpu", mesh=pairs[(2, 1)])(params, opt, batch["granite-8b"])
    finally:
        Q._calibrate = calibrate
    out["ranges"] = seen

    # packed-weight gather on 2x2 (K split over data at column-parallel
    # sites, over model at row-parallel ones)
    out["prebinarized"], _ = first_step("granite-8b", full, prebinarize_gather=True)

    # compressed DP on 2x1 (ranks 0-1) beside 1x2 (ranks 2-3): each rank's
    # own gradients, as compressed_psum receives them
    cfg = _cfg("bit-bert-base")
    params, opt = TL.init_train_state(0, cfg, device="cpu")
    local = []
    psum = compression.compressed_psum

    def grab(grads, err, group, enabled=True):
        local.append(grads)
        return psum(grads, err, group, enabled)

    compression.compressed_psum = grab
    try:
        step = TL.make_compressed_dp_step(cfg, tcfg, pairs[on_pair], compress=True, device="cpu")
        err = compression.init_error_state(params)
        p2, o2, err2, met = step(params, opt, err, batch["bit-bert-base"])
        off = TL.make_compressed_dp_step(cfg, tcfg, pairs[on_pair], compress=False, device="cpu")
        p3, _, _, met3 = off(params, opt, compression.init_error_state(params), batch["bit-bert-base"])
    finally:
        compression.compressed_psum = psum
    out["compressed"] = {"local": local[0], "params": p2, "err": err2, "metrics": met,
                         "plain_params": p3, "plain_metrics": met3}

    # a sharded save on 2x2, restored onto 2x1 / 1x2 and onto 2x2
    p2, o2, p_sh, o_sh = granite_state
    ckdir = payload["ckpt_dir"]
    manager = CheckpointManager(ckdir, keep=2, writer=rank == 0)
    shardings = {"params": p_sh, "opt": o_sh}
    got = []

    def gather(t):
        got.append(SH.gather_tree_to(t, shardings, bucket=1 << 12))  # several buckets a dtype
        return got[-1]

    manager.save(7, {"params": p2, "opt": o2}, {"note": "2x2"}, gather=gather)
    C.barrier([full.get_group(a) for a in full.mesh_dim_names])
    out["gathered_to"] = got[0]
    restored = {}
    for label, mesh in (("pair", pairs[on_pair]), ("full", full)):
        cfg = _cfg("granite-8b")
        like_p, like_o = TL.init_train_state(1, cfg, device="cpu", mesh=mesh)
        q_sh, r_sh = TL.train_shardings(cfg, mesh)
        step_no, tree_, extras = CheckpointManager(ckdir, writer=False).restore(
            like={"params": like_p, "opt": like_o}, shardings={"params": q_sh, "opt": r_sh})
        restored[label] = {"step": step_no, "extras": extras, "params": tree_["params"],
                           "opt": tree_["opt"], "coords": SH.coordinates(mesh),
                           "specs": [s.spec for s in tree.leaves(q_sh)]}
    out["restored"] = restored

    out["moe"] = _moe_cases(rank, payload, pairs, full)
    return out


def card_mesh_worker(rank: int, world: int, payload):
    """Two ranks on one card (gloo, CUDA tensors staged through the host):
    ``payload["name"]``'s smoke model (bit-bert by default) over a 2x1
    mesh, one step a batch of ``payload``; the losses and balance losses,
    the gathered params, the first step's first moments and MoE routing
    (``moe_spy``), and the staged ops."""
    from repro_torch.core import tree
    from repro_torch.runtime import collectives as C
    from repro_torch.runtime import train_loop as TL

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = _cfg(payload.get("name", "bit-bert-base"))
    mesh = _mesh((2, 1), [0, 1])
    params, opt = TL.init_train_state(0, cfg, device=dev, mesh=mesh)
    step = TL.make_train_step(cfg, moe_tcfg(payload["opt"]), device=dev, mesh=mesh)
    p_sh, _ = TL.train_shardings(cfg, mesh)
    C.STAGED.clear()
    losses, auxes, first_mu, seen = [], [], None, []
    for batch in payload["batches"]:
        with moe_spy(seen) if first_mu is None else contextlib.nullcontext():
            params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
        auxes.append(float(met["aux"]))
        if first_mu is None:
            first_mu = [t.cpu() for t in tree.leaves(_global(opt.mu, p_sh))]
    full = _global(params, p_sh)
    return {"losses": losses, "auxes": auxes, "params": [t.cpu() for t in tree.leaves(full)],
            "first_mu": first_mu, "staged": dict(C.STAGED),
            "seen": [{k: v.cpu() for k, v in x.items()} for x in seen]}


def card_dispatch_worker(rank: int, world: int, payload):
    """Two ranks on one card: the global dispatch given the whole
    microbatch's MoE input and router logits (``payload``), this rank's
    rows routed over the gloo group outside any step, against the 1-rank
    dispatch of the whole, computed here on the card."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.runtime import train_loop as TL

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    e = get_config("deepseek-v2-lite-16b").moe
    x, logits = payload["x"].to(dev), payload["logits"].to(dev)
    t = x.shape[0] // world
    mine = slice(rank * t, (rank + 1) * t)
    with torch.no_grad():
        _, whole = M._route(logits, e, e.top_k)
        capacity, want, want_buf, _ = M._place(x, whole, e, None, True)
        _, experts = M._route(logits[mine], e, e.top_k)
        M.clear_routing_traffic()
        cap, got, buf, _ = M._place(x[mine], experts, e, TL._routing(dist.group.WORLD, rank, world), True)
    sel = want[1] // t == rank
    return {"capacity": (cap, capacity), "experts": torch.equal(experts, whole[mine]),
            "dispatch": [torch.equal(a, b[sel]) for a, b in zip(got[2:], want[2:])],  # keep, dest
            "order": torch.equal(got[1] + rank * t, want[1][sel]), "buffer": torch.equal(buf[:-1], want_buf[:-1]),
            "dropped": int((~got[2]).sum()), "routing": {k: dict(v) for k, v in M.ROUTING.items()}}



def staged_worker(rank: int, world: int, payload):
    """The collectives' host-staged path (a CUDA tensor under gloo: pieces
    of ``_CHUNK`` elements through page-locked memory), run on CPU tensors
    with 7-element pieces and ordinary host buffers, beside the direct
    path."""
    from unittest import mock

    from repro_torch.runtime import collectives as C

    t = torch.arange(30, dtype=torch.float32).view(6, 5) * (rank + 1) - 40
    direct = [C.all_reduce(t), C.all_reduce(t, "max"), C.all_gather(t), C.reduce_scatter(t), C.gather_to(t)]
    with mock.patch.object(C, "_CHUNK", 7), mock.patch.object(C, "_host", lambda x, g, op: True), \
            mock.patch.object(C, "_pinned", lambda x: x.clone()), \
            mock.patch.object(C, "_host_empty", lambda n, dtype: torch.empty((n,), dtype=dtype)):
        staged = [C.all_reduce(t), C.all_reduce(t, "max"), C.all_gather(t), C.reduce_scatter(t), C.gather_to(t)]
    return {"direct": direct, "staged": staged, "input": t}


# ---------------------------------------------------------------------------
# runtime/serve_loop.py: the serving steps over meshes
# ---------------------------------------------------------------------------

#: the sharded serving scenarios: label -> (model, mesh shape, the ranks of
#: its mesh); the 1x2 and 2x1 meshes of ranks 0-1 run beside those of 2-3
SERVE_CASES = {
    "granite_2x1": ("granite", (2, 1), (0, 1)),
    "gemma3_1x2": ("gemma3", (1, 2), (0, 1)),
    "granite_1x2": ("granite", (1, 2), (2, 3)),
    "bert_1x2": ("bert", (1, 2), (2, 3)),
    "granite_2x2": ("granite", (2, 2), (0, 1, 2, 3)),
}


def _snap(cache) -> dict:
    from repro_torch.models import model_zoo as Z

    return Z.cache_copy(cache)


def serve_greedy(make_prefill, make_decode_step, cfg, params, prompts, n_decode: int, max_len: int,
                 device="cpu", mesh=None, spy=None):
    """A prefill of ``prompts`` (B, S) and ``n_decode`` greedy steps through
    the compiled steps (over ``mesh`` when given: ``params`` whole, sharded
    here).  Returns the logits of each call, the tokens fed, the cache after
    the prefill and at the end, and the collectives' bytes of each call
    (``collectives.BYTES``, by op)."""
    from repro_torch.runtime import collectives as C

    b, s = prompts.shape
    prefill = make_prefill(cfg, b, s, max_len, device=device, mesh=mesh)
    step = make_decode_step(cfg, b, max_len, device=device, mesh=mesh)
    if mesh is None:
        from repro_torch.models import model_zoo as Z

        cache = Z.init_cache(b, max_len, cfg, device=device)
    else:
        params, cache = prefill.shard_params(params), prefill.init_cache(device)
    logits, fed, carried = [], [], []
    C.BYTES.clear()
    out, cache = prefill(params, torch.as_tensor(prompts, dtype=torch.int64), cache)
    carried.append(dict(C.BYTES))
    after_prefill = _snap(cache)
    for _ in range(n_decode):
        logits.append(out)
        tok = out.argmax(-1)
        fed.append(tok)
        C.BYTES.clear()
        out, cache = step(params, tok, cache)
        carried.append(dict(C.BYTES))
    logits.append(out)
    return {"logits": logits, "fed": fed, "prefill": after_prefill, "end": _snap(cache),
            "bytes": carried, "modes": (prefill.mode, step.mode)}


def serve_worker(rank: int, world: int, payload):
    """Every scenario of ``tests/test_torch_sharded_serving.py`` in one group
    of 4 gloo ranks: each of ``SERVE_CASES`` this rank is on (the whole
    params in ``payload["params"]``, sharded by the step); on granite 1x2 a
    prefill again with each rank calibrating attention on its own heads."""
    from unittest import mock

    from repro_torch.models import attention as A
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime.serve_loop import make_decode_step, make_prefill

    meshes = {}
    for label, (_, shape, ranks) in SERVE_CASES.items():  # collective: every rank, one order
        meshes[label] = _mesh(shape, list(ranks))
    out = {}
    for label, (model, shape, ranks) in SERVE_CASES.items():
        if rank not in ranks:
            continue
        cfg = payload["cfgs"][model]
        mesh = meshes[label]
        res = serve_greedy(make_prefill, make_decode_step, cfg, payload["params"][model],
                           payload["prompts"][model], payload["n_decode"], payload["max_len"][model], mesh=mesh)
        res["coords"] = SH.coordinates(mesh)
        out[label] = res
        if label == "granite_1x2":
            with mock.patch.object(A, "_row_ranges", lambda: None):
                own = serve_greedy(make_prefill, make_decode_step, cfg, payload["params"][model],
                                   payload["prompts"][model], 0, payload["max_len"][model], mesh=mesh)
            out["own_heads"] = own["prefill"]
    return out


#: the deepseek family's sharded serving scenarios: label -> (model, mesh
#: shape, the ranks of its mesh); 1x2 on ranks 0-1 beside 2x1 on ranks 2-3
MLA_MOE_CASES = {
    "v2_1x2": ("v2", (1, 2), (0, 1)),
    "v2_2x1": ("v2", (2, 1), (2, 3)),
    "v3_1x2": ("v3", (1, 2), (0, 1)),
    "v3_2x1": ("v3", (2, 1), (2, 3)),
    "v2bin_1x2": ("v2bin", (1, 2), (0, 1)),
    "v2bin_2x1": ("v2bin", (2, 1), (2, 3)),
    "v2_2x2": ("v2", (2, 2), (0, 1, 2, 3)),
    "v3_2x2": ("v3", (2, 2), (0, 1, 2, 3)),
}


@contextlib.contextmanager
def latent_spy(seen: list):
    """Record the whole query ``q_abs`` that each absorbed decode's latent
    scores take (int8 or 1-bit), in call order."""
    from unittest import mock

    from repro_torch.models import attention as A

    def wrap(fn):
        def spy(q_abs, *a, **k):
            seen.append(q_abs.detach().clone())
            return fn(q_abs, *a, **k)
        return spy

    with mock.patch.object(A, "_scores_int_latent", wrap(A._scores_int_latent)), \
            mock.patch.object(A, "_scores_binary_latent", wrap(A._scores_binary_latent)):
        yield seen


def mla_moe_serve_worker(rank: int, world: int, payload):
    """Every scenario of ``tests/test_torch_sharded_serving_mla_moe.py`` in
    one group of 4 gloo ranks: each of ``MLA_MOE_CASES`` this rank is on,
    with every MoE layer's routing (``moe_spy``) and every absorbed
    decode's ``q_abs`` (``latent_spy``) recorded; on the 2x1 meshes the
    same run again with each data rank routing its own rows alone."""
    from unittest import mock

    from repro_torch.models import moe as M
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime.serve_loop import make_decode_step, make_prefill

    meshes = {label: _mesh(shape, list(ranks)) for label, (_, shape, ranks) in MLA_MOE_CASES.items()}
    out = {}
    for label, (model, shape, ranks) in MLA_MOE_CASES.items():
        if rank not in ranks:
            continue
        cfg, mesh = payload["cfgs"][model], meshes[label]

        def run(n_decode):
            return serve_greedy(make_prefill, make_decode_step, cfg, payload["params"][model],
                                payload["prompts"][model], n_decode, payload["max_len"], mesh=mesh)

        routes, lat = [], []
        with moe_spy(routes), latent_spy(lat):
            res = run(payload["n_decode"])
        res.update(coords=SH.coordinates(mesh), routes=routes, q_abs=lat)
        out[label] = res
        if shape == (2, 1) and model != "v2bin":  # each data rank's rows routed alone
            alone = []
            with moe_spy(alone), mock.patch.object(M, "routing_global", lambda glob: contextlib.nullcontext()):
                res = run(payload["n_decode"])
            out[label + "_alone"] = dict(res, routes=alone)
    return out


def card_serve_worker(rank: int, world: int, payload):
    """Two ranks on one card (gloo): ``payload["cfg"]`` over a 1x2 mesh (or
    ``payload["shape"]``), a prefill and greedy steps of
    ``payload["prompts"]`` through the sharded steps, results on the host."""
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime.serve_loop import make_decode_step, make_prefill

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = _mesh(payload.get("shape", (1, 2)), [0, 1])
    params = _to(payload["params"], dev)
    res = serve_greedy(make_prefill, make_decode_step, payload["cfg"], params,
                       payload["prompts"], payload["n_decode"], payload["max_len"], device=dev, mesh=mesh)
    res["coords"] = SH.coordinates(mesh)
    return _to(res, "cpu")


def _to(tree_, device):
    """A tree of dicts, lists and tuples with its tensors on ``device``."""
    if isinstance(tree_, torch.Tensor):
        return tree_.to(device)
    if isinstance(tree_, dict):
        return {k: _to(v, device) for k, v in tree_.items()}
    if isinstance(tree_, (list, tuple)):
        return type(tree_)(_to(v, device) for v in tree_)
    return tree_


def absorbed_products_by_heads(b: int, h: int, ranks: int, device="cpu", dn=128, dr=64, r=512, dv=128,
                               seed=0) -> dict:
    """The absorbed decode's float32 products (``attention._absorb_query``
    and ``_unfold_context``) as a model rank could run them, against all
    ``h`` heads at once as the one-card step does (deepseek-v2-lite's
    widths by default), with the operands in the layouts the steps give
    them.  Returns whether each is the one-card step's bit for bit:

    * ``q_heads`` / ``ctx_heads``: one flag a rank for the products on the
      rank's ``h / ranks`` heads alone (its query heads, its own copy of
      the up-projection's columns);
    * ``q_gathered``: the form ``MeshStep`` runs, every rank's query heads
      gathered (a contiguous copy) and folded through the whole ``k_up``
      (the context is unfolded from the whole latent through the whole
      ``v_up``, the one-card product itself)."""
    from repro_torch.models import attention as A

    g = torch.Generator(device=device).manual_seed(seed)
    hr, qd = h // ranks, dn + dr
    q = torch.randn(b, 1, h * qd, generator=g, device=device)
    w_uk = torch.randn(r, h * dn, generator=g, device=device)
    w_uv = torch.randn(r, h * dv, generator=g, device=device)
    ctx_lat = torch.randn(b, 1, h, r, generator=g, device=device)
    q_abs = A._absorb_query(q.reshape(b, 1, h, qd)[..., :dn], w_uk.reshape(r, h, dn))
    ctx = A._unfold_context(ctx_lat, w_uv.reshape(r, h, dv))
    out = {"q_heads": [], "ctx_heads": []}
    q_parts = []
    for i in range(ranks):
        heads = slice(i * hr, (i + 1) * hr)
        q_i = q[..., i * hr * qd:(i + 1) * hr * qd].contiguous().reshape(b, 1, hr, qd)[..., :dn]
        q_parts.append(q_i.reshape(b, 1, -1))
        uk = w_uk[:, i * hr * dn:(i + 1) * hr * dn].contiguous().reshape(r, hr, dn)
        uv = w_uv[:, i * hr * dv:(i + 1) * hr * dv].contiguous().reshape(r, hr, dv)
        out["q_heads"].append(torch.equal(A._absorb_query(q_i, uk), q_abs[:, :, heads]))
        out["ctx_heads"].append(torch.equal(A._unfold_context(ctx_lat[:, :, heads], uv), ctx[:, :, heads]))
    q_all = torch.cat(q_parts, dim=-1).reshape(b, 1, h, dn)
    out["q_gathered"] = torch.equal(A._absorb_query(q_all, w_uk.reshape(r, h, dn)), q_abs)
    return out
