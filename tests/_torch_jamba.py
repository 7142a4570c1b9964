"""Shared set-up of the jamba tests: repro's and the port's smoke configs
of jamba-v0.1-52b (vocab 64, f32) and variants, repro's seeded weights
as numpy, and seeded inputs."""
import dataclasses

import jax
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.parallel import sharding
from repro_torch import configs as tconfigs

ARCH = "jamba-v0.1-52b"
TOL = 1e-4
VARIANTS = {"moe": {}, "gqa": {"n_kv_heads": 2}, "dense": {"n_experts": 0}}


def cfgs(variant="moe", **kw):
    kw = {"vocab": 64, "dtype": "float32", **VARIANTS[variant], **kw}
    return (dataclasses.replace(jconfigs.smoke_variant(
                jconfigs.get_config(ARCH)), **kw),
            dataclasses.replace(tconfigs.smoke_variant(
                tconfigs.get_config(ARCH)), **kw))


_WEIGHTS = {}


def repro_weights(variant):
    """repro's initialized smoke weights as numpy, made once per variant."""
    if variant not in _WEIGHTS:
        jcfg, _ = cfgs(variant)
        _WEIGHTS[variant] = jax.tree.map(np.asarray, sharding.tree_values(
            jregistry.init_params(jcfg, jax.random.key(1))))
    return _WEIGHTS[variant]


def rng(seed):
    return np.random.default_rng(seed)


def normal(seed, *shape):
    return rng(seed).normal(size=shape).astype(np.float32)


def tokens(seed, b, L, vocab=64):
    return rng(seed).integers(0, vocab, size=(b, L)).astype(np.int32)


def tensor(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got), np.asarray(want, np.float32),
        rtol=tol, atol=tol, err_msg=msg)


