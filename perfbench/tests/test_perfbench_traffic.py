"""The traffic generator: deterministic for a seed, shaped as each mix says."""

import statistics

import pytest

from helpers import REPO  # noqa: F401  (puts the repo on sys.path)
from perfbench import traffic
from perfbench.registry import Registry

SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def reg():
    return Registry()


@pytest.mark.parametrize("name", ["single", "poisson", "jobs4"])
def test_deterministic_for_a_seed(reg, name):
    mix = reg.traffic(name)
    a = traffic.schedule(mix, SEED, 50)
    assert a == traffic.schedule(mix, SEED, 50)
    assert a != traffic.schedule(mix, SEED + 1, 50)
    va, vb = traffic.voices(mix, SEED, a), traffic.voices(mix, SEED, a)
    assert va == vb and len(set(va.values())) == len(va)


@pytest.mark.parametrize("name", ["single", "poisson", "jobs4"])
def test_texts_distinct_and_in_range(reg, name):
    mix = reg.traffic(name)
    reqs = traffic.schedule(mix, SEED, 50)
    lo, hi = mix["text_chars"]
    assert all(lo <= len(r["text"]) <= hi for r in reqs)
    assert len({r["text"] for r in reqs}) == len(reqs)
    lens = [len(r["text"]) for r in reqs]
    assert abs(statistics.fmean(lens) - (lo + hi) / 2) < 1.0


def test_poisson_rate_and_same_arrivals_every_seed(reg):
    mix = reg.traffic("poisson")
    rate, secs = mix["rate_per_s"], 50
    runs = [traffic.schedule(mix, s, secs) for s in (1, 2, 3)]
    for reqs in runs:
        assert all(0 <= r["due"] < secs for r in reqs)
        assert abs(len(reqs) - rate * secs) <= 2
    # every seed offers the same arrival times, and deals its own texts
    assert [r["due"] for r in runs[0]] == [r["due"] for r in runs[1]] == [r["due"] for r in runs[2]]
    assert [r["text"] for r in runs[0]] != [r["text"] for r in runs[1]]
    gaps = [b["due"] - a["due"] for a, b in zip(runs[0], runs[0][1:])]
    assert abs(statistics.fmean(gaps) - 1 / rate) < 0.15 / rate
    # a Poisson process: exponential gaps (their spread is their mean)
    assert abs(statistics.pstdev(gaps) / statistics.fmean(gaps) - 1) < 0.25


def test_poisson_voice_mix(reg):
    mix = reg.traffic("poisson")
    reqs = traffic.schedule(mix, SEED, 200)
    cold = [r for r in reqs if r["voice"].startswith("cold")]
    assert abs(len(cold) / len(reqs) - 1 / mix["cold_every"]) < 0.02
    assert len({r["voice"] for r in cold}) == len(cold)
    warm = {r["voice"] for r in reqs if not r["voice"].startswith("cold")}
    assert warm == {f"v{k}" for k in range(mix["voices"])}


def test_jobs_deal_the_same_lengths_every_seed(reg):
    mix = reg.traffic("jobs4")
    a, b = traffic.schedule(mix, 1, 50), traffic.schedule(mix, 2, 50)
    assert [len(r["text"]) for r in a] == [len(r["text"]) for r in b]
    assert [r["text"] for r in a] != [r["text"] for r in b]


def test_jobs_have_distinct_voices(reg):
    mix = reg.traffic("jobs4")
    reqs = traffic.schedule(mix, SEED, 50)
    jobs = {}
    for r in reqs:
        jobs.setdefault(r["job"], []).append(r)
    for job in list(jobs.values())[:50]:
        assert len(job) == mix["job_size"]
        assert len({r["voice"] for r in job}) == mix["job_size"]


def test_voice_wav_is_a_prompt():
    import io
    import wave

    data = traffic.voice_wav(SEED, 3, 5.0)
    with wave.open(io.BytesIO(data)) as w:
        assert (w.getframerate(), w.getsampwidth(), w.getnchannels()) == (22050, 2, 1)
        assert w.getnframes() == 5 * 22050
