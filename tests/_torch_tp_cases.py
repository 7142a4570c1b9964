"""The rank functions of the port's tensor-parallel serving tests
(``test_torch_tp_serving.py``): they run in spawned ranks, so this module
imports neither JAX nor ``repro`` (a rank then starts in about a second)."""
import dataclasses

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.prefix_cache import PrefixCacheConfig
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.spec_decode import DraftConfig

from _torch_ranks import stream

REF = SamplingParams(max_new=8, logprobs=True, top_logprobs=2)
KW = dict(n_slots=2, max_seq=64)
SPEC = DraftConfig(k=2, layers=0)
#: (state dtype, draft) cases, as repro's identity test runs them
CASES = [(sd, spec) for sd in (None, "int8") for spec in (None, SPEC)]


def prompts(n=4, seed=0, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(L)).astype(np.int32)
            for L in rng.choice((6, 8, 12, 16), size=n)]


def serve(eng, ps, params=REF):
    reqs = [eng.submit(p, params) for p in ps]
    eng.run()
    return [stream(r) for r in reqs]


def _tp_mesh(world):
    from repro_torch.launch.mesh import make_serving_mesh
    return make_serving_mesh(world)


def _tp_cases(rank, world, tcfg, tp, ps):
    """Every case of the tp=2 spawn, on each rank."""
    from repro_torch.parallel import sharding
    mesh = _tp_mesh(world)
    out = {}
    for sd, spec in CASES:
        sharding.reset_counts()
        eng = Engine(tcfg, tp, EngineConfig(device="cpu", mesh=mesh,
                                            state_dtype=sd, draft=spec, **KW))
        got = serve(eng, ps)
        # the pool is sharded: some leaf is smaller than its full shape
        full = registry.tree_leaves(eng.pool._full)
        local = registry.tree_leaves(eng.pool.cache)
        out[sd, spec is not None] = dict(
            streams=got, counts=dict(sharding.COUNTS),
            sharded=[a.shape != b.shape for a, b in zip(full, local)],
            bytes=(eng.pool.state_bytes_per_slot(),
                   eng.pool.device_state_bytes_per_slot()))
    # the all-reduces of one decode step over the pool
    eng = Engine(tcfg, tp, EngineConfig(device="cpu", mesh=mesh, **KW))
    toks = torch.zeros(eng.pool.n_total, 1, dtype=torch.int64)
    with sharding.use_mesh(mesh):
        sharding.reset_counts()
        registry.decode_step(eng.cfg, eng.params, eng.pool.cache,
                             {"tokens": toks})
        out["step_counts"] = dict(sharding.COUNTS)
    # the prefix cache: hits restore a shard-local snapshot
    pc = PrefixCacheConfig(block=4)
    shared = [np.concatenate([np.arange(1, 13, dtype=np.int32), [20 + i]])
              .astype(np.int32) for i in range(4)]
    eng = Engine(tcfg, tp, EngineConfig(device="cpu", mesh=mesh,
                                        prefix_cache=pc, **KW))
    out["prefix"] = serve(eng, shared)
    out["prefix_hits"] = eng.stats.summary()["prefix_hits"]
    cold = []
    for p in shared[1:]:
        c = Engine(tcfg, tp, EngineConfig(device="cpu", mesh=mesh,
                                          prefix_cache=pc, **KW))
        cold.append(serve(c, [p])[0])
    out["prefix_cold"] = cold
    out["prefix_off"] = serve(Engine(tcfg, tp, EngineConfig(
        device="cpu", mesh=mesh, **KW)), shared)
    # streaming and a cancel from the victim's own callback, during a
    # speculative pass (a scratch lease live)
    eng = Engine(tcfg, tp, EngineConfig(device="cpu", mesh=mesh,
                                        draft=SPEC, **KW))
    got = {}
    params = dataclasses.replace(REF, max_new=10)
    two = prompts(n=2, seed=3)

    def cb(req, new_toks):
        got.setdefault(req.req_id, []).extend(new_toks)
        if req.req_id == victim.req_id and len(req.tokens) >= 3:
            eng.cancel(req.req_id)

    victim = eng.submit(two[0], params, stream_cb=cb)
    keeper = eng.submit(two[1], params, stream_cb=cb)
    eng.run()
    out["cancel"] = dict(
        victim=stream(victim), keeper=stream(keeper),
        delivered=got.get(keeper.req_id), n_active=eng.pool.n_active,
        n_free=eng.pool.n_free, scratch_free=len(eng.pool._scratch_free))
    out["cancel_ref"] = serve(Engine(tcfg, tp, EngineConfig(
        device="cpu", mesh=mesh, draft=SPEC, **KW)), two, params)
    # K3 cannot sum between a layer's row-parallel contractions
    try:
        Engine(tcfg, tp, EngineConfig(device="cpu", mesh=mesh,
                                      step_impl="megakernel", **KW))
        out["megakernel"] = None
    except ValueError as e:
        out["megakernel"] = str(e)
    return out


def _tp_streams(rank, world, tcfg, tp, ps, mesh_group_nccl=False):
    """f32 and int8-state greedy streams (and one decode step's logits)
    at tp = world."""
    from repro_torch.parallel import sharding
    mesh = _tp_mesh(world)
    out = {}
    for sd in (None, "int8"):
        eng = Engine(tcfg, tp, EngineConfig(device="cpu", mesh=mesh,
                                            state_dtype=sd, **KW))
        out[sd] = serve(eng, ps)
    eng = Engine(tcfg, tp, EngineConfig(device="cpu", mesh=mesh, **KW))
    toks = torch.arange(eng.pool.n_total)[:, None] + 1
    with sharding.use_mesh(mesh):
        lg, _ = registry.prefill(eng.cfg, eng.params, eng.pool.fresh,
                                 {"tokens": torch.as_tensor(ps[0][None])})
        out["prefill_logits"] = lg
        lg, _ = registry.decode_step(eng.cfg, eng.params, eng.pool.cache,
                                     {"tokens": toks})
        out["step_logits"] = lg
    return out


def _sp_scan_cases(rank, world, arrs, cases):
    """``sp_selective_scan`` over this rank's chunk of L, each case a
    (with D, with z) pair; returns [(y chunk, h_last)]."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.parallel.sp_scan import sp_selective_scan
    mesh = make_serving_mesh(world, axis="sp")
    L = arrs["x"].shape[1] // world
    sl = slice(rank * L, (rank + 1) * L)
    t = {k: torch.from_numpy(v) for k, v in arrs.items() if v is not None}
    out = []
    for with_d, with_z in cases:
        y, h = sp_selective_scan(
            mesh, t["x"][:, sl], t["dt"][:, sl], t["A"], t["B"][:, sl],
            t["C"][:, sl], D=t["D"] if with_d else None,
            z=t["z"][:, sl] if with_z else None)
        out.append((y, h))
    return out


def _local_mesh_sums(rank, world):
    """A (2, 2) ("data", "model") mesh of the 4 ranks: this rank's
    coordinates, and the sum of the ranks' ids over each axis' group and
    over both."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding
    mesh = make_local_mesh((2, 2), ("data", "model"))
    out = {"coords": mesh.coords}
    with sharding.use_mesh(mesh):
        for axes in ("data", "model", ("data", "model")):
            t = torch.tensor([float(rank)])
            out[axes] = float(sharding.all_reduce_sum(t, axes)[0])
    return out


def _family_cases(rank, world, runs):
    """Each run (label, cfg, params, EngineConfig kwargs, prompts) served
    at tp = world; returns {label: (streams, {leaf path: local shape})} and
    the refusals of the MoE's "ep" dispatch."""
    from repro_torch.parallel import sharding
    mesh = _tp_mesh(world)
    out = {}
    for label, cfg, params, kw, ps in runs:
        eng = Engine(cfg, params, EngineConfig(device="cpu", mesh=mesh,
                                               **KW, **kw))
        got = serve(eng, ps, dataclasses.replace(REF, max_new=6))
        shapes = {sharding.keystr(p): tuple(t.shape) for p, t in
                  sharding._walk({"params": eng.params,
                                  "cache": eng.pool.cache})}
        out[label] = (got, shapes, eng.cfg.moe_impl)
    moe = [r for r in runs if r[1].n_experts]
    if moe:
        _, cfg, params, kw, _ = moe[0]
        try:
            Engine(dataclasses.replace(cfg, moe_impl="ep"), params,
                   EngineConfig(device="cpu", mesh=mesh, **KW, **kw))
            out["ep"] = None
        except ValueError as e:
            out["ep"] = str(e)
    return out


# ---------------------------------------------------------------------------
# The card tests' rank functions (``test_torch_cuda.py``): two gloo ranks on
# the one card, or rank 0 alone in an NCCL group
# ---------------------------------------------------------------------------

def _cuda_sp_scan(rank, world, dtype, tol):
    """One sp scan a rank (K4 once) at d 96 against one K4 launch over the
    whole sequence; returns the launches, the largest error of y beyond
    ``tol`` of the reference's magnitude, and h_last's largest error."""
    from repro_torch import resolve_device
    from repro_torch.kernels import ops, selective_scan
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.parallel.sp_scan import sp_selective_scan
    from _torch_inputs import scan_arrays, to_torch
    dev = resolve_device("cuda")
    mesh = make_serving_mesh(world, axis="sp")
    t = to_torch(scan_arrays(1, 64 * world, 96, 16, seed=5, h0=False),
                 dtype, dev)
    y_ref, h_ref = ops.selective_scan(t["x"], t["dt"], t["A"], t["B"],
                                      t["C"], D=t["D"], z=t["z"])
    L = t["x"].shape[1] // world
    sl = slice(rank * L, (rank + 1) * L)
    n0 = selective_scan.launches
    y, h = sp_selective_scan(mesh, t["x"][:, sl], t["dt"][:, sl], t["A"],
                             t["B"][:, sl], t["C"][:, sl], D=t["D"],
                             z=t["z"][:, sl], axis_name="sp")
    torch.cuda.synchronize()
    want = y_ref[:, sl].float()
    return (selective_scan.launches - n0,
            float(((y.float() - want).abs() - tol * want.abs()).max()),
            float((h - h_ref).abs().max()))


def _cuda_straddle(rank, world, sd):
    """The straddled-group step of this rank's half of d 1536 (768
    channels: the middle scale group cut) against the single-device K2
    step: (K1 launches, K2 launches, largest code distance, largest
    relative scale difference, largest y error)."""
    from repro_torch import configs, resolve_device
    from repro_torch.core import state_quant
    from repro_torch.kernels import decode_step, ops
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import mamba
    from repro_torch.parallel import sharding
    from _torch_inputs import code_ordinals, step_arrays, to_torch
    dev = resolve_device("cuda")
    mesh = make_serving_mesh(world)
    d, n, slots = 1536, 16, 3
    t = to_torch(step_arrays(slots, d, n, seed=9), "float32", dev)
    hq, scale = state_quant.quantize_h(4.0 * t["h"], sd)
    args = (t["x_t"], t["dt_t"], t["A"], t["B_t"], t["C_t"])
    y_ref, hq_ref, s_ref = ops.selective_state_step_q(
        hq, scale, *args, D=t["D"], z_t=t["z_t"], state_dtype=sd)
    cfg = dataclasses.replace(configs.get_config("mamba-130m"),
                              state_dtype=sd)
    assert cfg.d_inner == d
    loc = d // world
    sl = slice(rank * loc, (rank + 1) * loc)
    k1, k2 = decode_step.launches, decode_step.launches_q
    with sharding.use_mesh(mesh):
        y, hq_loc, s_loc = mamba._step_q(
            cfg, hq[:, sl].contiguous(), scale, t["x_t"][:, sl],
            t["dt_t"][:, sl], t["A"][sl].contiguous(), t["B_t"], t["C_t"],
            t["D"][sl].contiguous(), t["z_t"][:, sl], "fused", None)
    torch.cuda.synchronize()
    return (decode_step.launches - k1, decode_step.launches_q - k2,
            int((code_ordinals(hq_loc) - code_ordinals(hq_ref[:, sl]))
                .abs().max()),
            float(((s_loc - s_ref).abs() / s_ref.clamp_min(1e-30)).max()),
            float((y - y_ref[:, sl]).abs().max()))


def _cuda_nccl_tp1(rank, world):
    """tp=1 over NCCL (rank 0 alone in an NCCL group): the mamba smoke
    engine's streams and logprobs bitwise the no-mesh engine's."""
    import torch.distributed as dist
    from repro_torch import configs, resolve_device
    from repro_torch.launch.mesh import make_serving_mesh
    dev = resolve_device("cuda")
    group = dist.new_group([0], backend="nccl")
    if rank:
        return None
    mesh = make_serving_mesh(1, group=group)
    cfg = dataclasses.replace(configs.smoke_variant(configs.get_config(
        "mamba-130m")), vocab=64, dtype="float32", step_impl="fused")
    params = registry.init_params(cfg, seed=0, device=dev)
    out = []
    for m in (None, mesh):
        eng = Engine(cfg, params, EngineConfig(device="cuda", mesh=m, **KW))
        out.append([(s.tokens, s.logprobs) for s in serve(eng, prompts())])
    return out
