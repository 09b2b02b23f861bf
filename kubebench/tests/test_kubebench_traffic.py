"""The traffic generator: the same seed gives the same requests, every
seed the same work in another order."""

import numpy as np

from kubebench import traffic as gen

MIX = {"prompt_tokens": {"dist": "loguniform", "min": 256, "max": 4096, "points": 32},
       "token_pool": 1 << 22}
BIG = 2 ** 31 + 12345  # seeds past 32 signed bits


def _stream(seed, client=0, n=96):
    c = gen.Client(MIX, seed, client)
    return [c.next() for _ in range(n)]


def test_same_seed_same_requests():
    assert _stream(BIG) == _stream(BIG)
    assert _stream(BIG) != _stream(BIG + 1)
    assert _stream(BIG, 0) != _stream(BIG, 1)


def test_every_pass_is_the_whole_mix():
    lengths = gen.lengths(MIX["prompt_tokens"])
    assert lengths[0] == 256 and lengths[-1] == 4096 and len(set(lengths)) == 32
    reqs = _stream(2 ** 62 + 5)
    for k in range(3):
        assert sorted(r.length for r in reqs[32 * k:32 * (k + 1)]) == lengths


def test_any_stretch_holds_the_same_mix():
    # eight consecutive requests take one length from each band, so a
    # window's work barely moves with the seed
    bands = np.array_split(np.arange(32), gen.STRATA)
    lengths = gen.lengths(MIX["prompt_tokens"])
    band_of = {lengths[i]: b for b, idx in enumerate(bands) for i in idx}
    for seed in (1, BIG, 2 ** 50):
        reqs = _stream(seed)
        for k in range(0, 96, 8):
            assert sorted(band_of[r.length] for r in reqs[k:k + 8]) == list(range(8))


def test_offsets_stay_in_the_pool():
    for r in _stream(BIG, n=500):
        assert 0 <= r.offset and r.offset + r.length <= MIX["token_pool"]


def test_check_sample_takes_the_longest_and_is_seeded():
    reqs = _stream(BIG, n=100)
    a = gen.check_sample(reqs, BIG, 4)
    assert a == gen.check_sample(reqs, BIG, 4)
    assert a[0].length == max(r.length for r in reqs) and len(a) == 4
    assert len({(r.client, r.index) for r in a}) == 4


def test_subseed_is_63_bits_and_distinct():
    seeds = {gen.subseed(BIG, 10, i) for i in range(100)}
    assert len(seeds) == 100 and all(0 <= s < 2 ** 63 for s in seeds)


def test_percentile_nearest_rank():
    assert gen.percentile(list(range(1, 101)), 95) == 95
    assert gen.percentile([5.0], 95) == 5.0

