"""Seeded numpy inputs for the port's kernel tests, and their conversion
to tensors: the same arrays feed repro (as JAX arrays) and the port."""
import numpy as np
import torch

VARIANTS = [("exact", "exact"), ("ours", "ours"), ("fast", "paper")]

# token-stream inputs take the compute dtype; A, D and the state stay f32
STREAM = ("x", "dt", "B", "C", "z", "x_t", "dt_t", "B_t", "C_t", "z_t",
          "x_prev")


def np_input(seed, *shape, softplus=False, neg_exp=False):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if softplus:
        a = np.log1p(np.exp(a)).astype(np.float32)
    if neg_exp:
        a = -np.exp(0.5 * a).astype(np.float32)
    return a


def scan_arrays(b, L, d, n, seed=0, h0=True):
    """x, dt, A, B, C, D, z, h0 (dt softplus'd, A < 0)."""
    return dict(x=np_input(seed, b, L, d),
                dt=np_input(seed + 1, b, L, d, softplus=True),
                A=np_input(seed + 2, d, n, neg_exp=True),
                B=np_input(seed + 3, b, L, n), C=np_input(seed + 4, b, L, n),
                D=np_input(seed + 5, d), z=np_input(seed + 6, b, L, d),
                h0=np_input(seed + 7, b, d, n) if h0 else None)


def step_arrays(b, d, n, seed=0):
    """h, x_t, dt_t, A, B_t, C_t, D, z_t of one pooled decode step."""
    return dict(h=np_input(seed, b, d, n), x_t=np_input(seed + 1, b, d),
                dt_t=np_input(seed + 2, b, d, softplus=True),
                A=np_input(seed + 3, d, n, neg_exp=True),
                B_t=np_input(seed + 4, b, n), C_t=np_input(seed + 5, b, n),
                D=np_input(seed + 6, d), z_t=np_input(seed + 7, b, d))


def to_torch(arrs, dtype="float32", device="cpu"):
    return {k: None if v is None else torch.from_numpy(v).to(
        device, getattr(torch, dtype) if k in STREAM else torch.float32)
        for k, v in arrs.items()}


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def scan_call(fn, t, **kw):
    """Call a scan (wrapper or plain version) on a to_torch() dict."""
    return fn(t["x"], t["dt"], t["A"], t["B"], t["C"], D=t["D"], z=t["z"],
              h0=t["h0"], **kw)
