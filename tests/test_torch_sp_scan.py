"""The port's sequence-parallel scan (``parallel/sp_scan.py``) on the CPU:
four gloo ranks, each holding a quarter of the sequence, against
``repro``'s sequential reference scan (``kernels.ref.selective_scan``)
over the whole sequence, with and without D and the z gate, f32, within
2e-4.  Pass 1 is the scan wrapper's plain version here (K4 on the
card).  The same four ranks lay out a (2, 2) mesh: the row-major
coordinates and each axis' group, as ``jax.make_mesh`` orders devices."""
import jax.numpy as jnp
import numpy as np

from repro.kernels import ref as jref

from _torch_inputs import scan_arrays
from _torch_ranks import run_ranks
from _torch_tp_cases import _local_mesh_sums, _sp_scan_cases

TOL = 2e-4
WORLD = 4
CASES = [(True, True), (False, False), (True, False), (False, True)]


def test_sp_scan_matches_reference(tmp_path):
    arrs = scan_arrays(2, 4 * 24, 32, 16, seed=3, h0=False)
    res = run_ranks(_sp_scan_cases, WORLD, tmp_path, arrs, CASES)
    for c, (with_d, with_z) in enumerate(CASES):
        want_y, want_h = jref.selective_scan(
            jnp.asarray(arrs["x"]), jnp.asarray(arrs["dt"]),
            jnp.asarray(arrs["A"]), jnp.asarray(arrs["B"]),
            jnp.asarray(arrs["C"]),
            D=jnp.asarray(arrs["D"]) if with_d else None,
            z=jnp.asarray(arrs["z"]) if with_z else None)
        y = np.concatenate([np.asarray(r[c][0]) for r in res], axis=1)
        np.testing.assert_allclose(y, np.asarray(want_y), rtol=TOL, atol=TOL)
        for r in res:
            # every rank holds the whole sequence's final state
            np.testing.assert_allclose(np.asarray(r[c][1]),
                                       np.asarray(want_h), rtol=TOL,
                                       atol=TOL)


def test_local_mesh_groups(tmp_path):
    """Rank r of a (2, 2) ("data", "model") mesh sits at (r // 2, r % 2);
    a sum over "model" adds the two ranks of its row, over "data" the
    two of its column, over both all four."""
    res = run_ranks(_local_mesh_sums, WORLD, tmp_path)
    for r, got in enumerate(res):
        d, m = divmod(r, 2)
        assert got["coords"] == {"data": d, "model": m}
        assert got["model"] == 2 * d + 2 * d + 1
        assert got["data"] == m + (2 + m)
        assert got[("data", "model")] == 0 + 1 + 2 + 3
