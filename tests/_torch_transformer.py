"""Shared set-up of the transformer tests: repro's and the port's smoke
configs of the zoo's transformer archs (vocab 64, f32, expert capacity =
expert count so no assignment drops by batch), repro's seeded weights as
numpy with every 1-D leaf (norm scales and biases, QKV biases) moved off
its init value so that it counts, and the seeded batches of each
frontend."""
import dataclasses

import jax
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.parallel import sharding
from repro_torch import configs as tconfigs

#: the zoo's transformer archs
ARCHS = ["granite-20b", "olmo-1b", "qwen2-7b", "qwen2.5-14b",
         "musicgen-large", "phi-3-vision-4.2b", "qwen2-moe-a2.7b",
         "arctic-480b"]
TOL = 1e-4


def cfgs(arch, **kw):
    j = jconfigs.get_config(arch)
    kw = {"vocab": 64, "dtype": "float32",
          "capacity_factor": float(max(j.n_experts, 1)), **kw}
    return (dataclasses.replace(jconfigs.smoke_variant(j), **kw),
            dataclasses.replace(tconfigs.smoke_variant(
                tconfigs.get_config(arch)), **kw))


_WEIGHTS = {}

#: the leaves initialized to ones or zeros: norm scales and biases, QKV
#: biases
_FLAT = ("scale", "bias", "b")


def _perturb(tree, rng):
    return {k: (_perturb(v, rng) if isinstance(v, dict) else
                (v + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)
                if k in _FLAT else v)
            for k, v in tree.items()}


def repro_weights(arch):
    """repro's initialized smoke weights as numpy, made once per arch."""
    if arch not in _WEIGHTS:
        jcfg, _ = cfgs(arch)
        w = jax.tree.map(np.asarray, sharding.tree_values(
            jregistry.init_params(jcfg, jax.random.key(1))))
        _WEIGHTS[arch] = _perturb(w, np.random.default_rng(7))
    return _WEIGHTS[arch]


def batch(cfg, b, l, seed=0):
    """A forward/prefill batch of cfg's frontend as numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "audio_stub":
        out["embeds"] = rng.normal(size=(b, l, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, size=(b, l)).astype(
            np.int32)
    if cfg.frontend == "vision_stub":
        out["img_embeds"] = rng.normal(
            size=(b, cfg.img_tokens, cfg.d_model)).astype(np.float32)
    return out


def to_jax(b):
    return {k: jax.numpy.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got), np.asarray(want, np.float32),
        rtol=tol, atol=tol, err_msg=msg)
