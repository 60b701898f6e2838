"""Shared fixtures. NB: no XLA_FLAGS here — smoke tests must see the real
single CPU device; multi-device tests spawn subprocesses with forced host
device counts (see test_multidevice.py).

Also installs a deterministic mini-`hypothesis` shim when the real package
is absent, so the property-test modules (test_checkpoint / test_data /
test_fingerprint / test_optim) still collect and run: each @given test is
executed over a fixed number of seeded pseudo-random examples instead of
being skipped wholesale. The shim covers exactly the API surface those
modules use (given, settings, st.integers / sampled_from / composite).
"""
import functools
import inspect
import os
import random
import sys
import types

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Initialize repro.core before any test module can import repro.checkpoint
# first: checkpoint.tiers -> obs.estimator -> repro.core -> recovery ->
# checkpoint.tiers is a cycle that only resolves when repro.core is already
# in sys.modules (running a single checkpoint-first test file used to die
# on a partially-initialized-module ImportError).
import repro.core  # noqa: E402,F401


def _install_hypothesis_shim() -> None:
    try:
        import hypothesis  # noqa: F401
        return
    except ImportError:
        pass

    SHIM_EXAMPLES = 5

    class _Strategy:
        """A strategy is just a seeded generator function."""

        def __init__(self, gen):
            self._gen = gen

        def __repr__(self):
            return "<shim strategy>"

    def integers(min_value=0, max_value=2**31 - 1):
        return _Strategy(lambda r: r.randint(min_value, max_value))

    def sampled_from(items):
        items = list(items)
        return _Strategy(lambda r: items[r.randrange(len(items))])

    def floats(min_value=0.0, max_value=1.0, **_kw):
        return _Strategy(lambda r: r.uniform(min_value, max_value))

    def booleans():
        return _Strategy(lambda r: bool(r.randrange(2)))

    def lists(elements, min_size=0, max_size=8, **_kw):
        return _Strategy(lambda r: [elements._gen(r) for _ in
                                    range(r.randint(min_size, max_size))])

    def just(value):
        return _Strategy(lambda r: value)

    def composite(fn):
        def build(*args, **kwargs):
            def gen(r):
                return fn((lambda strat: strat._gen(r)), *args, **kwargs)
            return _Strategy(gen)
        return build

    def given(*strats, **kwstrats):
        def deco(test):
            sig = inspect.signature(test)
            names = list(sig.parameters)
            # hypothesis semantics: positional strategies bind to the LAST
            # parameters; anything before them is a pytest fixture
            bound = names[len(names) - len(strats):] if strats else []
            fixture_names = [n for n in names
                             if n not in bound and n not in kwstrats]

            @functools.wraps(test)
            def wrapper(**fixture_kwargs):
                rnd = random.Random(0)
                for _ in range(SHIM_EXAMPLES):
                    vals = {n: s._gen(rnd) for n, s in zip(bound, strats)}
                    vals.update({k: s._gen(rnd)
                                 for k, s in kwstrats.items()})
                    test(**fixture_kwargs, **vals)

            # hide strategy-bound params from pytest's fixture resolution
            wrapper.__signature__ = sig.replace(
                parameters=[sig.parameters[n] for n in fixture_names])
            if hasattr(wrapper, "__wrapped__"):
                del wrapper.__wrapped__
            wrapper._hypothesis_shim = True
            return wrapper
        return deco

    def settings(*args, **_kwargs):
        # used both as @settings(...) and settings(...)(fn)
        if args and callable(args[0]):
            return args[0]
        return lambda fn: fn

    st = types.ModuleType("hypothesis.strategies")
    st.integers = integers
    st.sampled_from = sampled_from
    st.floats = floats
    st.booleans = booleans
    st.lists = lists
    st.just = just
    st.composite = composite

    hyp = types.ModuleType("hypothesis")
    hyp.given = given
    hyp.settings = settings
    hyp.strategies = st
    hyp.HealthCheck = types.SimpleNamespace(too_slow=None, data_too_large=None)
    hyp.__version__ = "0.0-shim"

    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st


_install_hypothesis_shim()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA "
        "kernels); skips where there is none")


@pytest.fixture(scope="session")
def rng():
    import jax
    return jax.random.PRNGKey(0)


@pytest.fixture()
def tmp_workdir(tmp_path):
    return str(tmp_path / "work")
