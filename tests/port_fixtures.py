"""Fixtures and hooks of the port's tests, loaded by each `tests/test_torch_*.py`
as a plugin: `pytest_plugins = ("port_fixtures",)`.

- Every test of a module that loads this plugin runs on one torch intra-op
  thread and under a time limit a phase (`TIME_LIMIT_S`).  A plugin's hooks
  and autouse fixtures reach every test of the run once it is registered, so
  both act only on the tests of the modules that load it.
- `jax_tiny(seed=0, **flags)` and `jax_port(jeng, **engine_fields)` hand out
  the JAX reference engines and the port's engines converted from them,
  built once a flag set in each worker process.  JAX is imported only when
  they build one: the port's tests also run on a GPU machine without it.
"""

import copy
import os
import signal

import numpy as np
import pytest
import torch


def _loads_us(module) -> bool:
    return __name__ in getattr(module, "pytest_plugins", ())


# ---------------------------------------------------------------------------
# a time limit on every test phase: a stuck test fails with its stack after
# TIME_LIMIT_S instead of holding its worker to the end of the run.
# TEST_TIME_LIMIT_S overrides it, for the test of the limit itself.
# ---------------------------------------------------------------------------

TIME_LIMIT_S = float(os.environ.get("TEST_TIME_LIMIT_S", "300"))


def _over_time(signum, frame):
    pytest.fail(f"test phase over its time limit of {TIME_LIMIT_S:g} s")


def _time_limited(item):
    """Arm SIGALRM around one phase (pytest-xdist runs tests on its workers'
    main threads, where the handler is called).  The timer repeats every 5 s
    in case a callback swallows the first failure."""
    if not _loads_us(getattr(item, "module", None)):
        return (yield)
    old = signal.signal(signal.SIGALRM, _over_time)
    signal.setitimer(signal.ITIMER_REAL, TIME_LIMIT_S, 5.0)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _time_limited(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _time_limited(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    return (yield from _time_limited(item))


@pytest.fixture(autouse=True)
def one_thread(request):
    """One intra-op thread a test: the tiny models' ops are too small to
    share, and the test run's workers share the host's cores."""
    if not _loads_us(request.module):
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# shared JAX reference engines.  A new `voice_tts_tpu` engine compiles every
# model's init again (~60-70 s for `TTSEngine.tiny()`), so each worker builds
# the tiny weights once a seed, constructs one engine a flag set from them
# (~5 s), and hands it out as built: each call puts back the attributes and
# config the engine was built with, empties its caches and restarts its
# random stream.  A test that changes a shared engine otherwise (`monkeypatch`
# of a method) puts it back itself.
# ---------------------------------------------------------------------------

_CACHES = ("_spk_cache", "_emo_cache", "_cap_hint", "_gen_cache", "_job_streams",
           "last_metrics")


class _AsBuilt:
    """An engine and what `reset` puts back: its attributes and config."""

    def __init__(self, engine):
        self.engine = engine
        self.attrs = dict(vars(engine))
        self.cfg = copy.deepcopy(engine.cfg)

    def reset(self):
        """The engine as built.  `cfg.engine` is not put back but checked:
        the engines read its fields when they build and trace their stages,
        so a changed field would leave a stale graph behind."""
        eng = self.engine
        changed = sorted(k for k, v in vars(self.cfg.engine).items()
                         if vars(eng.cfg.engine).get(k) != v)
        if changed:
            raise RuntimeError(
                f"a shared engine's cfg.engine was changed ({', '.join(changed)}): "
                "set engine flags through jax_tiny(**flags) or "
                "jax_port(jeng, **engine_fields)")
        for name in set(vars(eng)) - set(self.attrs):
            delattr(eng, name)
        vars(eng).update(self.attrs)
        vars(eng.cfg).update(copy.deepcopy(vars(self.cfg)))
        for name in _CACHES:
            if name in self.attrs:
                self.attrs[name].clear()
        if isinstance(getattr(eng, "generator", None), torch.Generator):
            eng.generator.manual_seed(eng.cfg.engine.seed)
        return eng


class JaxEngines:
    """`jax_tiny(seed=0, **flags)`: `voice_tts_tpu`'s
    `TTSEngine.tiny(seed, **flags)`, built once a flag set in this worker and
    handed out as built.  The flags are `cfg.engine` fields, on which the
    random weights do not depend: the first engine of a seed is
    `TTSEngine.tiny(seed)`, and every other one is constructed from its
    config, weights and extras as `TTSEngine.random` constructs it, with the
    flags set."""

    def __init__(self):
        self._weights = {}      # seed -> (config, params, extras) of tiny(seed)
        self._built = {}        # (seed, flags) -> _AsBuilt
        self._by_id = {}        # id of each engine -> its _AsBuilt

    def __call__(self, seed=0, **flags):
        key = (seed, tuple(sorted(flags.items())))
        if key not in self._built:
            self._add(key, self._build(seed, flags))
        return self._built[key].reset()

    def as_built(self, jeng) -> _AsBuilt:
        return self._by_id[id(jeng)]

    def _add(self, key, engine):
        self._built[key] = self._by_id[id(engine)] = _AsBuilt(engine)

    def _build(self, seed, flags):
        import jax
        from voice_tts_tpu.engine.engine import HashTokenizer, TTSEngine

        if seed not in self._weights:
            eng = TTSEngine.tiny(seed=seed)
            extras = {"w2v_mean": np.asarray(eng.w2v_mean),
                      "w2v_std": np.asarray(eng.w2v_std),
                      "emo_matrix": eng.emo_matrix, "spk_matrix": eng.spk_matrix}
            self._weights[seed] = (copy.deepcopy(eng.cfg),
                                   jax.tree.map(lambda x: x, eng.params), extras)
            if not flags:
                return eng
            self._add((seed, ()), eng)
        cfg, params, extras = self._weights[seed]
        cfg = copy.deepcopy(cfg)
        for name, value in flags.items():
            if not hasattr(cfg.engine, name):
                raise AttributeError(f"unknown engine config field: {name}")
            setattr(cfg.engine, name, value)
        return TTSEngine(cfg, jax.tree.map(lambda x: x, params),
                         HashTokenizer(cfg.gpt.number_text_tokens), dict(extras))


@pytest.fixture(scope="session")
def jax_tiny():
    return JaxEngines()


@pytest.fixture(scope="session")
def jax_port(jax_tiny):
    """`jax_port(jeng, **engine_fields)`: the port's engine holding the
    weights and extras of the shared JAX engine `jeng`, converted from its
    as-built config with `engine_fields` set on `cfg.engine`; built once in
    this worker and handed out as built (CPU)."""
    import jax
    from voice_tts_tpu_torch.config import TTSConfig
    from voice_tts_tpu_torch.engine.engine import TTSEngine

    built = {}

    def port(jeng, **engine_fields):
        key = (id(jeng), tuple(sorted(engine_fields.items())))
        if key not in built:
            cfg = TTSConfig.from_dict(jax_tiny.as_built(jeng).cfg.to_dict())
            for name, value in engine_fields.items():
                if not hasattr(cfg.engine, name):
                    raise AttributeError(f"unknown engine config field: {name}")
                setattr(cfg.engine, name, value)
            extras = {"w2v_mean": np.asarray(jeng.w2v_mean),
                      "w2v_std": np.asarray(jeng.w2v_std),
                      "emo_matrix": [np.asarray(m) for m in jeng.emo_matrix],
                      "spk_matrix": [np.asarray(m) for m in jeng.spk_matrix]}
            built[key] = _AsBuilt(TTSEngine.from_jax_params(
                cfg, jax.tree.map(np.asarray, jeng.params), jeng.tokenizer, extras,
                device="cpu"))
        return built[key].reset()
    return port
