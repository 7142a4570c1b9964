"""The port's prefix-cache admission for xLSTM on the CPU, against
repro's (mamba's in ``test_torch_prefix_cache.py``): with an f32 and
an int8 state the port's greedy streams and prefix counters are repro's
on the same (bridged) weights, each hit is bitwise a cold admission of
its prompt, and in f32 the cache-off engine's streams agree under the
tie rule (``_torch_serving.cached_admission_equal_repros``)."""
import pytest

from _torch_serving import cached_admission_equal_repros


@pytest.mark.parametrize("state_dtype", [None, "int8"])
def test_cached_admission_equal_repros(state_dtype):
    cached_admission_equal_repros("xlstm-350m", state_dtype)
