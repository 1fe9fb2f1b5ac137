"""Traffic, weights and tables are made from the seed alone."""

import numpy as np
import pytest
import torch

from benchmark import common, generate
from benchmark.tests import small

CFG = common.load_json("configs", "vawgan-vcc2016")


def corpus(seed, **kw):
    t = {**common.load_json("traffic", "corpus"), **small.CORPUS, **kw}
    return generate.CorpusTraffic(seed, t, CFG, "cpu")


def test_corpus_pool_is_the_seeds_alone():
    a, b, c = corpus(2**31 + 5), corpus(2**31 + 5), corpus(2**31 + 6)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a.waves, b.waves))
    assert any(x.tobytes() != y.tobytes() for x, y in zip(a.waves, c.waves))
    ra, rb = a.requests(), b.requests()
    for _ in range(6):
        for u, v in zip(next(ra), next(rb)):
            assert np.array_equal(u, v)


def test_every_seed_gets_the_same_lengths_in_another_order():
    dist = {"median": 3.5, "ln_sigma": 0.35, "min": 1.5, "max": 6.0}
    n = generate.stratified_lengths(256, dist, 16000)
    assert np.all(np.diff(n) >= 0)
    assert n[0] >= 1.5 * 16000 and n[-1] == 6 * 16000
    assert abs(np.median(n) / 16000 - 3.5) < 0.05
    a = corpus(1, pool=16, utts_per_request=4)
    b = corpus(2, pool=16, utts_per_request=4)
    assert np.array_equal(a.lengths, b.lengths)


def test_requests_deal_the_pool_with_the_longest_in_each():
    t = corpus(9, pool=16, utts_per_request=4)
    req = t.requests()
    seen, seeds = [], set()
    for _ in range(4):                       # one pass over the pool
        k, rows, trg, s = next(req)
        assert t.lengths[rows].max() == t.lengths.max()
        assert np.all(trg != t.src[rows])
        assert np.all((trg >= 0) & (trg < 10))
        seen += list(rows)
        seeds |= set(s.tolist())
    assert sorted(seen) == list(range(16))
    assert len(seeds) == 16


def test_live_streams_are_seeded_and_paired():
    t = {**common.load_json("traffic", "live"), **small.LIVE}
    a = generate.LiveTraffic(4, t, CFG, "cpu")
    b = generate.LiveTraffic(4, t, CFG, "cpu")
    c = generate.LiveTraffic(5, t, CFG, "cpu")
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a.audio, b.audio))
    assert any(x.tobytes() != y.tobytes() for x, y in zip(a.audio, c.audio))
    assert np.all(a.src != a.trg)
    assert all(len(x) == int(t["max_audio_s"] * 16000) for x in a.audio)


def test_frame_table_and_weights_are_the_seeds_alone():
    t = {**common.load_json("traffic", "train"), **small.TRAIN}
    x1, y1 = generate.frame_table(3, t, CFG, "cpu")
    x2, y2 = generate.frame_table(3, t, CFG, "cpu")
    x3, _ = generate.frame_table(4, t, CFG, "cpu")
    assert x1.tobytes() == x2.tobytes() and np.array_equal(y1, y2)
    assert x1.tobytes() != x3.tobytes()
    per = int(t["utt_s"] * 200) + 1
    assert x1.shape == (10 * t["utts_per_speaker"] * per, 513)
    assert np.bincount(y1).tolist() == [t["utts_per_speaker"] * per] * 10
    shapes = {"a.weight": torch.Size([4, 3, 7]), "a.bias": torch.Size([4]),
              "n.norm.weight": torch.Size([4]), "d.embed": torch.Size([10, 8])}
    w1 = generate.weights(3, "g", shapes, "cpu")
    w2 = generate.weights(3, "g", shapes, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in shapes)
    assert torch.all(w1["a.bias"] == 0) and torch.all(w1["n.norm.weight"] == 1)
    std = 1 / np.sqrt(21) / 0.87962566103423978
    assert float(w1["a.weight"].abs().max()) <= 2 * std + 1e-6


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_large_seeds_derive(seed):
    assert 0 <= generate.derive(seed, "x") < 2**63
    assert generate.derive(seed, "x") != generate.derive(seed, "y")
