"""The paper's analytic models in the port (``repro_torch.core.op_graph``,
``buffer_manager``, ``marca_model`` and ``configs.shapes``) against
``repro``'s, on the CPU.

They are pure Python on both sides, so every output is held exactly:
the op lists (every field of every op), ``summarize``, ``per_op_traffic``,
``simulate`` and ``policy_table`` under each buffer policy, ``op_time``,
``model_time``, ``speedup`` and ``energy_ratio`` for each ``Platform``
pair, for every Table-1 mamba config at several lengths; the platforms'
constants; and ``applicable_shapes`` / ``skip_reason`` for every arch of
the zoo and every shape.
"""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.core import buffer_manager as jbm
from repro.core import marca_model as jmm
from repro.core import op_graph as jog
from repro_torch import configs as tconfigs
from repro_torch.configs import shapes as tshapes
from repro_torch.core import buffer_manager as tbm
from repro_torch.core import marca_model as tmm
from repro_torch.core import op_graph as tog

MAMBA_TABLE1 = ["mamba-130m", "mamba-370m", "mamba-790m", "mamba-1.4b",
                "mamba-2.8b"]
LENGTHS = [1, 64, 1024, 4096]
PLATFORMS = ["MARCA", "CPU", "GPU", "TENSOR_CORE_ONLY"]


def _ops(op):
    return [dataclasses.astuple(o) + (o.intensity, o.rw_ratio) for o in op]


def _traffic(t):
    return (t.read, t.write, t.total)


def test_platforms_and_constants_equal_repros():
    for name in PLATFORMS:
        assert (dataclasses.asdict(getattr(tmm, name))
                == dataclasses.asdict(getattr(jmm, name))), name
    assert tmm._CLS_RATE == jmm._CLS_RATE
    assert (tbm.BUFFER_BYTES, tbm.TILE, tbm.REFETCH_CAP, tbm.EW_CLASSES) == (
        jbm.BUFFER_BYTES, jbm.TILE, jbm.REFETCH_CAP, jbm.EW_CLASSES)
    assert (tog.BYTES, tog.CLASS_GROUPS) == (jog.BYTES, jog.CLASS_GROUPS)
    for cls in ("linear", "ew1", "ew2", "exp", "silu", "softplus", "norm",
                "update", "other", "nope"):
        assert tog.group_of(cls) == jog.group_of(cls)
    assert tog.t("x", 3, 5, 7) == jog.t("x", 3, 5, 7)


@pytest.mark.parametrize("name", MAMBA_TABLE1)
def test_op_graph_and_buffer_policies_equal_repros(name):
    tcfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
    for L in LENGTHS:
        for layer in (0, 5):
            assert _ops(tog.mamba_block_ops(tcfg, L, layer)) == _ops(
                jog.mamba_block_ops(jcfg, L, layer))
        tops = tog.mamba_model_ops(tcfg, L)
        jops = jog.mamba_model_ops(jcfg, L)
        assert _ops(tops) == _ops(jops)
        assert tog.summarize(tops) == jog.summarize(jops)
        for intra in (False, True):
            for inter in (False, True):
                for buf in (tbm.BUFFER_BYTES, 1 << 20):
                    got = tbm.per_op_traffic(tops, intra, inter, buf)
                    want = jbm.per_op_traffic(jops, intra, inter, buf)
                    assert [(o.name, r, w) for o, r, w in got] == [
                        (o.name, r, w) for o, r, w in want]
                    assert _traffic(tbm.simulate(tops, intra, inter, buf)) \
                        == _traffic(jbm.simulate(jops, intra, inter, buf))
        tt, jt = tbm.policy_table(tops), jbm.policy_table(jops)
        assert {k: _traffic(v) for k, v in tt.items()} == {
            k: _traffic(v) for k, v in jt.items()}


@pytest.mark.parametrize("name", MAMBA_TABLE1)
def test_cycle_model_equals_repros(name):
    tcfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
    for L in LENGTHS:
        tops = tog.mamba_model_ops(tcfg, L)
        jops = jog.mamba_model_ops(jcfg, L)
        for pn in PLATFORMS:
            tp, jp = getattr(tmm, pn), getattr(jmm, pn)
            assert tmm.model_time(tops, tp) == jmm.model_time(jops, jp)
            assert [tmm.op_time(o, tp, 12345.0) for o in tops] == [
                jmm.op_time(o, jp, 12345.0) for o in jops]
            for qn in PLATFORMS:
                tq, jq = getattr(tmm, qn), getattr(jmm, qn)
                assert tmm.speedup(tops, tp, tq) == jmm.speedup(jops, jp, jq)
                assert tmm.energy_ratio(tops, tp, tq) == jmm.energy_ratio(
                    jops, jp, jq)
            assert tmm.speedup(tops, tp) == jmm.speedup(jops, jp)
            assert tmm.energy_ratio(tops, tp) == jmm.energy_ratio(jops, jp)


def test_shapes_equal_repros():
    assert ({k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()})
    assert tshapes.SUBQUADRATIC_FAMILIES == jshapes.SUBQUADRATIC_FAMILIES
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for arch in tconfigs.list_archs():
        tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
        assert tshapes.applicable_shapes(tcfg) == jshapes.applicable_shapes(
            jcfg), arch
        for shape in tshapes.SHAPES:
            assert tshapes.skip_reason(tcfg, shape) == jshapes.skip_reason(
                jcfg, shape), (arch, shape)
