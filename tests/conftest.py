"""Shared test fixtures + suite configuration.

* `slow` marker: naive-simulator oracle runs (micro-op-by-micro-op command
  streams) are orders of magnitude slower than the vectorized path; they are
  excluded by default so tier-1 stays fast. Run them with `-m slow`, or
  pass any explicit `-m` expression (e.g. `-m "slow or not slow"`) to
  override the default entirely.
* hypothesis shim: the container may not ship `hypothesis`; a minimal
  deterministic stand-in (seeded example sampling for the few strategies the
  suite uses) keeps those property tests collectable and meaningful.
"""
import functools
import inspect
import random
import sys
import types

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: naive-simulator oracle tests (excluded by default; "
                   "run with -m slow)")
    config.addinivalue_line(
        "markers", "cuda: runs CUDA kernels on an NVIDIA GPU (skips where "
                   "there is none)")
    # Default to "not slow" only when the user passed no -m at all, so an
    # explicit `-m ""` / `-m "slow or not slow"` can still select everything.
    m_passed = any(a.startswith("-m") or a.startswith("--markexpr")
                   for a in config.invocation_params.args)
    if not m_passed and not config.option.markexpr:
        config.option.markexpr = "not slow"


# ---------------------------------------------------------------------------
# Minimal hypothesis stand-in (only used when the real package is absent)
# ---------------------------------------------------------------------------

def _install_hypothesis_stub():
    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def integers(min_value, max_value):
        return _Strategy(lambda r: r.randint(min_value, max_value))

    def sampled_from(elements):
        elements = list(elements)
        return _Strategy(lambda r: elements[r.randrange(len(elements))])

    def booleans():
        return _Strategy(lambda r: bool(r.getrandbits(1)))

    def floats(min_value=0.0, max_value=1.0, **_):
        return _Strategy(lambda r: r.uniform(min_value, max_value))

    def given(**strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_stub_max_examples", 10)
                rng = random.Random(fn.__qualname__)
                for _ in range(n):
                    drawn = {k: s.draw(rng) for k, s in strategies.items()}
                    fn(*args, **kwargs, **drawn)

            # hide strategy params from pytest's fixture resolution
            sig = inspect.signature(fn)
            kept = [p for name, p in sig.parameters.items()
                    if name not in strategies]
            wrapper.__signature__ = sig.replace(parameters=kept)
            return wrapper
        return deco

    def settings(max_examples=10, **_):
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn
        return deco

    st = types.ModuleType("hypothesis.strategies")
    st.integers = integers
    st.sampled_from = sampled_from
    st.booleans = booleans
    st.floats = floats
    hyp = types.ModuleType("hypothesis")
    hyp.given = given
    hyp.settings = settings
    hyp.strategies = st
    hyp.HealthCheck = types.SimpleNamespace(all=lambda: [])
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st


try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    _install_hypothesis_stub()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def assert_close(a, b, rtol=2e-5, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=msg)
