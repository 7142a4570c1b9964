"""Tensor-parallel serving of the port's other families on the CPU (gloo
ranks, ``_torch_ranks.run_ranks``): jamba (experts split over "expert",
the router replicated and the dispatch the dense one; "ep" refused under
a mesh, "auto" served as "dense"), xLSTM (heads split where the mesh
divides them; where it does not, as for 4 heads on 8 ranks or 1 head on
2, the heads kept whole on every rank over a channel shard, as
``repro``'s ``spec_for_shape`` lays them out), qwen2-7b with grouped
query heads (2 KV heads for 4
query heads, so each rank keeps a query group with its KV head, and the
KV cache holds the rank's heads) and qwen2-moe-a2.7b (64 padded experts,
a shared expert).  Greedy streams at tp=2 (and all but the grouped-query
qwen2-7b's at tp=4, where its 2 KV heads would split inside a head)
equal the port's single-device engine's, or first differ where its top two
logits are within 1e-4; so do xLSTM's at tp=8.  The single-device engines' streams are held to
``repro``'s by the families' engine tests (``test_torch_jamba_engine``,
``test_torch_xlstm_engine``, ``test_torch_transformer_engine``), and
here once more for the grouped-query qwen2-7b this file adds (the
other families' ``repro`` compiles would take this file past its time
budget)."""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro.runtime import engine as jengine
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import registry
from repro_torch.runtime.engine import Engine, EngineConfig

from _torch_inputs import assert_streams_tie_equal
from _torch_ranks import run_ranks
from _torch_tp_cases import KW, REF, SPEC, _family_cases, prompts, serve

TIE_TOL = 1e-4
PARAMS = dataclasses.replace(REF, max_new=6)


def cfgs(arch, **kw):
    j = jconfigs.get_config(arch)
    kw = {"vocab": 64, "dtype": "float32",
          "capacity_factor": float(max(j.n_experts, 1)), **kw}
    return (dataclasses.replace(jconfigs.smoke_variant(j), **kw),
            dataclasses.replace(tconfigs.smoke_variant(
                tconfigs.get_config(arch)), **kw))


#: (label, arch, config overrides, EngineConfig kwargs, tp degrees)
RUNS = [
    ("jamba", "jamba-v0.1-52b", {}, {}, (2, 4)),
    ("jamba int8", "jamba-v0.1-52b", {},
     dict(weight_dtype="int8", state_dtype="int8", kv_cache_dtype="int8"),
     (2,)),
    ("xlstm", "xlstm-350m", {}, {}, (2, 4, 8)),
    ("xlstm 1 head", "xlstm-350m", {"n_heads": 1},
     dict(state_dtype="int8", draft=SPEC), (2,)),
    ("qwen2-7b gqa", "qwen2-7b", {"n_kv_heads": 2}, {}, (2,)),
    ("qwen2-7b gqa int8", "qwen2-7b", {"n_kv_heads": 2},
     dict(weight_dtype="int8", kv_cache_dtype="int8"), (2,)),
    ("qwen2-moe", "qwen2-moe-a2.7b", {}, {}, (2, 4)),
]

_MODELS = {}


def model(arch, over):
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        jcfg, tcfg = cfgs(arch, **over)
        tp = registry.init_params(tcfg, seed=0)
        _MODELS[key] = (jcfg, tcfg, tp)
    return _MODELS[key]


def runs_at(tp_degree):
    out = []
    for label, arch, over, kw, tps in RUNS:
        if tp_degree in tps:
            _, tcfg, tp = model(arch, over)
            out.append((label, tcfg, tp, kw, prompts(n=2, seed=1)))
    return out


def single(run):
    label, tcfg, tp, kw, ps = run
    return serve(Engine(tcfg, tp, EngineConfig(device="cpu", **KW, **kw)),
                 ps, PARAMS)


def test_tp2_families(tmp_path):
    runs = runs_at(2)
    res = run_ranks(_family_cases, 2, tmp_path, runs)[0]
    for run in runs:
        label, tcfg = run[0], run[1]
        got, shapes, moe_impl = res[label]
        assert_streams_tie_equal(got, single(run), TIE_TOL, f"tp2 {label}")
        if tcfg.family == "jamba":
            # 4 experts, 2 a rank; the attention position's KV on 2 of 4
            # heads; the mamba state on half of d_inner
            g = "['params']['groups'][0]"
            assert shapes[g + "['pos1']['moe']['w1']"][0] == 2
            kv = "['cache']['layers']['pos4']['k']"
            assert shapes[kv][-1] == tcfg.n_kv_heads * tcfg.head_dim // 2
            assert shapes["['cache']['layers']['pos0']['h']"][2] == 64
            assert moe_impl == "dense"
        if label == "xlstm":
            assert shapes["['params']['layers'][0]['mlstm']['wq']"][0] == 2
            assert shapes["['cache']['layers'][0]['mlstm']['C']"][1] == 2
        if label == "xlstm 1 head":
            assert_heads_whole(shapes, tcfg, 2)
        if label.startswith("qwen2-7b"):
            # 2 of 4 query heads and 1 of 2 KV heads a rank
            wq = "['params']['layers'][0]['attn']['wq']['w']"
            wk = "['params']['layers'][0]['attn']['wk']['w']"
            assert shapes[wq][-1] == 2 * tcfg.head_dim
            assert shapes[wk][-1] == tcfg.head_dim
            assert shapes["['cache']['k']"][-1] == tcfg.head_dim
        if label == "qwen2-moe":
            assert shapes["['params']['layers'][0]['moe']['w1']"][0] == 32
    assert res["ep"] and "moe_impl='ep'" in res["ep"]


def assert_heads_whole(shapes, cfg, tp):
    """Every head on the rank, over its shard of the channels: the
    head-wise leaves whole, the channel-wise ones split."""
    ml, sl = "['layers'][0]['mlstm']", f"['layers'][{cfg.slstm_offset}]"
    di, d = 2 * cfg.d_model, cfg.d_model
    assert shapes[f"['params']{ml}['wq']"][0] == cfg.n_heads
    assert shapes[f"['cache']{ml}['C']"][1] == cfg.n_heads
    assert shapes[f"['params']{ml}['up']['w']"][-1] == 2 * di // tp
    assert shapes[f"['cache']{ml}['conv']"][-1] == di // tp
    assert shapes[f"['params']{sl}['slstm']['r']"][1] == cfg.n_heads
    assert shapes[f"['params']{sl}['slstm']['wx']['w']"][-1] == 4 * d // tp
    assert shapes[f"['cache']{sl}['slstm']['h']"][1] == cfg.n_heads


def test_tp4_families(tmp_path):
    runs = runs_at(4)
    res = run_ranks(_family_cases, 4, tmp_path, runs)[0]
    for run in runs:
        assert_streams_tie_equal(res[run[0]][0], single(run), TIE_TOL,
                                 f"tp4 {run[0]}")


def test_tp8_xlstm_heads_whole(tmp_path):
    """xlstm's 4 heads on 8 ranks: whole on every rank, the channels
    split 8 ways."""
    runs = runs_at(8)
    res = run_ranks(_family_cases, 8, tmp_path, runs)[0]
    for run in runs:
        got, shapes, _ = res[run[0]]
        assert_heads_whole(shapes, run[1], 8)
        assert_streams_tie_equal(got, single(run), TIE_TOL,
                                 f"tp8 {run[0]}")


@pytest.mark.parametrize("label", ["qwen2-7b gqa"])
def test_single_device_streams_are_repros(label):
    """The references above, held to repro's single-device engine on
    bridged weights (f32)."""
    _, arch, over, kw, _ = next(r for r in RUNS if r[0] == label)
    jcfg, tcfg, tp = model(arch, over)
    ps = prompts(n=2, seed=1)
    jeng = jengine.Engine(jcfg, bridge.params_to_repro(tp),
                          jengine.EngineConfig(**KW))
    want = [jeng.submit(p, max_new=PARAMS.max_new) for p in ps]
    jeng.run()
    got = single((label, tcfg, tp, kw, ps))
    assert [g.tokens for g in got] == [w.tokens for w in want]
