"""The port's MARCA nonlinearities (repro_torch.core.approx) against
repro.core.approx on the same seeded inputs, passed as numpy arrays; and
the f32 literals the CUDA kernels bake in (csrc/common.cuh, K9's table in
csrc/approx_units.cu) against approx's constants."""
import inspect
import re
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx as japprox
from repro_torch.core import approx as tapprox

jax.config.update("jax_platform_name", "cpu")


def _inputs(seed, shape=(4, 257), scale=4.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _both(fn_name, x, dtype="float32"):
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(getattr(japprox, fn_name)(jx), np.float32)
    got = getattr(tapprox, fn_name)(tx).float().numpy()
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn_name", ["fast_exp", "our_exp"])
def test_fast_exp_matches_repro(fn_name, dtype):
    """The dt*A range (mostly [-7, 0)) plus wide values and the clamp."""
    x = np.concatenate([_inputs(1, (1000,), 3.0, -2.0),
                        np.array([-1e9, -100.0, -80.0, 0.0, 80.0, 100.0],
                                 np.float32)])
    got, want = _both(fn_name, x, dtype)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-30)


def test_fast_exp_truncates_toward_zero():
    """float -> int32 truncates as astype(int32) does: negative products
    round up, so the bit pattern is repro's exactly in f32."""
    x = _inputs(2, (4096,), 3.0, -3.0)
    got, want = _both("fast_exp", x)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn_name", ["piecewise_silu",
                                     "piecewise_silu_paper"])
def test_piecewise_silu_matches_repro(fn_name, dtype):
    # every segment, including the breakpoints themselves
    breaks = np.asarray(japprox.SILU_BREAKS + (-1.5, 0.75, 12.0, -12.0),
                        np.float32)
    x = np.concatenate([_inputs(3, (2000,), 5.0), breaks])
    got, want = _both(fn_name, x, dtype)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_constants_are_copied():
    for name in ("FAST_EXP_B_SHIFT", "OUR_EXP_B_SHIFT", "OUR_EXP_C",
                 "SILU_BREAKS", "SILU_COEFS", "SIGMOID_BREAKS",
                 "SIGMOID_COEFS", "LN2", "_EXP_CLAMP"):
        assert getattr(tapprox, name) == getattr(japprox, name), name


@pytest.mark.parametrize("kind,names", [("exp", ("exact", "ours", "fast")),
                                        ("silu", ("exact", "ours", "paper")),
                                        ("sigmoid", ("exact", "ours"))])
def test_dispatch_tables_match_repro(kind, names):
    getter_t = getattr(tapprox, f"get_{kind}")
    getter_j = getattr(japprox, f"get_{kind}")
    x = _inputs(4, (512,), 2.0, -1.0)
    for name in names:
        want = np.asarray(getter_j(name)(jnp.asarray(x)))
        got = getter_t(name)(torch.from_numpy(x)).numpy()
        rtol = 5e-3 if kind == "exp" and name != "exact" else 1e-5
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
    with pytest.raises(KeyError):
        getter_t("nope")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_piecewise_sigmoid_matches_repro(dtype):
    breaks = np.asarray(japprox.SIGMOID_BREAKS + (12.0, -12.0), np.float32)
    x = np.concatenate([_inputs(5, (2000,), 5.0), breaks])
    got, want = _both("piecewise_sigmoid", x, dtype)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_exp_density_set_matches_repro():
    for n in (200, 37):
        np.testing.assert_array_equal(tapprox.exp_density_set(n),
                                      japprox.exp_density_set(n))


def test_calibrate_exp_bias_matches_repro():
    """The same grid search on the same set: the same (b_shift, c), near
    the baked-in constants (tests/test_approx.py's bounds)."""
    b, c = tapprox.calibrate_exp_bias()
    assert (b, c) == japprox.calibrate_exp_bias()
    assert abs(b - tapprox.OUR_EXP_B_SHIFT) < 5e-3
    assert abs(c - tapprox.OUR_EXP_C) < 1e-3


def test_fit_piecewise_silu_matches_repro():
    got = tapprox.fit_piecewise_silu()
    np.testing.assert_array_equal(got, japprox.fit_piecewise_silu())
    assert np.allclose(got, np.asarray(tapprox.SILU_COEFS), atol=1e-4)


# ---------------------------------------------------------------------------
# The kernels' f32 literals
# ---------------------------------------------------------------------------

CSRC = Path(tapprox.__file__).resolve().parents[1] / "csrc"
_F = r"(-?\d+\.\d*(?:e-?\d+)?)f"


def _body(src, name):
    """The text of device function ``name`` in ``src``."""
    start = src.index(f" {name}(")
    return src[start:src.index("\n}\n", start)]


def _f32s(xs):
    return [np.float32(float(v)) for v in xs]


def _ours_table():
    units = (CSRC / "approx_units.cu").read_text()
    table = re.search(r"kSiluOursTable\[7\]\[3\] = \{(.*?)\n\};", units,
                      re.S).group(1)
    rows = re.findall(rf"\{{{_F}, {_F}, {_F}\}}", table)
    return [_f32s(r) for r in rows]


def _paper_literals(src):
    return set(_f32s(re.findall(_F, src)))


def test_kernel_exp_literals_are_approx_constants():
    common = (CSRC / "common.cuh").read_text()
    assert float(re.search(r"kLn2 = ([\d.]+);", common).group(1)) == \
        tapprox.LN2
    assert float(re.search(r"kS23 = ([\d.]+);", common).group(1)) == \
        tapprox._S23
    for name, shift in (("kFastBias", tapprox.FAST_EXP_B_SHIFT),
                        ("kOursBias", tapprox.OUR_EXP_B_SHIFT)):
        m = re.search(rf"{name} = \(float\)\(\(127\.0 - ([\d.]+)\) \* "
                      r"kS23\);", common)
        assert -float(m.group(1)) == shift, name
    m = re.search(r"kOursC = \(float\)([\d.e-]+);", common)
    assert float(m.group(1)) == tapprox.OUR_EXP_C
    # the clamp that keeps a NaN: PTX max.NaN / min.NaN with hex f32
    # immediates
    m = re.search(r"max\.NaN\.f32 %0, %0, 0f([0-9A-F]{8});\\n\\t"
                  r"min\.NaN\.f32 %0, %0, 0f([0-9A-F]{8});",
                  _body(common, "fast_exp"))
    lo, hi = (struct.unpack(">f", bytes.fromhex(h))[0] for h in m.groups())
    assert (lo, hi) == (-tapprox._EXP_CLAMP, tapprox._EXP_CLAMP)


def test_kernel_silu_literals_are_approx_constants():
    """common.cuh's silu_ours chain and K9's range detection and table hold
    approx's breaks and coefficients rounded to f32; both "paper" forms
    hold approx.piecewise_silu_paper's constants (the range-detect form
    adds the exact 0 and 1 of its unified evaluation)."""
    common = (CSRC / "common.cuh").read_text()
    units = (CSRC / "approx_units.cu").read_text()
    breaks = _f32s(tapprox.SILU_BREAKS)
    coefs = [_f32s(r) for r in tapprox.SILU_COEFS]
    chain = re.findall(rf"x >= {_F} \? quad\(x, {_F}, {_F}, {_F}\)",
                       _body(common, "silu_ours"))
    assert [_f32s(r[:1])[0] for r in chain] == breaks[:-1]
    assert [_f32s(r[1:]) for r in chain] == coefs
    assert re.search(rf"return x > {_F} \? x : y;",
                     _body(common, "silu_ours")).group(1) == "9.0"
    table = _ours_table()
    assert table[0] == [0.0] * 3 and table[1:] == coefs
    rd = _body(units, "silu_ours_rd")
    assert _f32s(re.findall(rf"\(x >= {_F}\)", rd)) == breaks[:-1]
    assert _f32s(re.findall(rf"x > {_F} \? x", rd)) == breaks[-1:]
    want = set(_f32s(re.findall(r"-?\d+\.\d+", inspect.getsource(
        tapprox.piecewise_silu_paper))))
    assert _paper_literals(_body(common, "silu_paper")) == want
    assert _paper_literals(_body(units, "silu_paper_rd")) == want | {
        np.float32(0.0), np.float32(1.0)}


def _emulate_ours_rd(x):
    """silu_ours_rd of approx_units.cu in numpy f32, from the source's
    table and breaks: numpy rounds each operation, as __fmul_rn and
    __fadd_rn do."""
    units = (CSRC / "approx_units.cu").read_text()
    rd = _body(units, "silu_ours_rd")
    brk = _f32s(re.findall(rf"\(x >= {_F}\)", rd))
    hi = _f32s(re.findall(rf"x > {_F} \? x", rd))[0]
    tab = np.asarray(_ours_table(), np.float32)
    s = sum((x >= b).astype(np.int64) for b in brk)
    a2, a1, a0 = tab[s, 0], tab[s, 1], tab[s, 2]
    lo = _f32s(re.findall(rf"fmaxf\(x, {_F}\)", rd))[0]
    xq = np.fmax(x, lo)
    return np.where(x > hi, x, (a2 * xq + a1) * xq + a0)


def _emulate_paper_rd(x):
    """silu_paper_rd of approx_units.cu in numpy f32."""
    f = np.float32
    lo, mid, hi = x < f(-5.0), ~(x < f(-1.5)), ~(x <= f(0.75))
    sq = mid & ~hi
    t = x + np.where(sq, f(1.181), f(0.0))
    w = np.where(sq, t, f(1.0))
    p = np.where(hi, f(1.05), np.where(mid, f(0.232), f(-0.06244)))
    q = np.where(hi, f(-0.2781), np.where(mid, f(-0.275), f(-0.3457)))
    return np.where(lo, f(-0.0135), p * (t * w) + q)


@pytest.mark.parametrize("variant", ["ours", "paper"])
def test_range_detect_form_is_bitwise_the_plain_version(variant):
    """K9's range-detect-first form (one segment's evaluation an element)
    gives the plain version's bits: over every bf16 bit pattern as f32,
    the breaks with their f32 neighbours, specials and a seeded sample of
    f32; a NaN result matches as NaN."""
    bf = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    x = np.concatenate([
        bf.view(torch.bfloat16).float().numpy(),
        np.asarray([np.nextafter(np.float32(b), np.float32(d))
                    for b in tapprox.SILU_BREAKS for d in (-np.inf, np.inf)],
                   np.float32),
        np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45],
                   np.float32),
        _inputs(9, (200000,), 6.0)])
    with np.errstate(invalid="ignore", over="ignore"):
        got = (_emulate_ours_rd if variant == "ours" else _emulate_paper_rd)(x)
    plain = (tapprox.piecewise_silu if variant == "ours"
             else tapprox.piecewise_silu_paper)
    want = plain(torch.from_numpy(x)).numpy()
    both_nan = np.isnan(got) & np.isnan(want)
    assert ((got.view(np.int32) == want.view(np.int32)) | both_nan).all()
